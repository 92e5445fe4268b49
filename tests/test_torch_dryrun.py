"""voxtral_tpu_torch/dryrun.py: the port's multi-device dry run on 8
spawned gloo CPU ranks (the analog of the conftest's 8 virtual devices)
with the JAX package's mid_config weights (the real 26-layer 32q/8kv and
32-layer 32-head lattice at reduced widths).  Every case's ids equal the
JAX package's, unsharded and, for the two serving meshes, sharded on the
virtual devices (tests/test_mesh.py's runs); and entry() runs a decode
step."""

import jax
import numpy as np
import pytest
import torch

from voxtral_tpu.config import mid_config as jax_mid
from voxtral_tpu.models.params import init_params as jax_init
from voxtral_tpu.parallel import serving as jsv
from voxtral_tpu.parallel.mesh import (
    batch_shardings,
    cache_shardings,
    make_mesh,
    param_shardings,
    shard_params,
)
from voxtral_tpu.parallel.scheduler import StreamPool as JPool
from voxtral_tpu.runtime.engine import VoxtralEngine as JEngine
from voxtral_tpu_torch import dryrun
from voxtral_tpu_torch.config import mid_config

torch.set_num_threads(1)

KW = dict(buckets=(16, 4, 1), enc_kv_ring=64)


@pytest.fixture(scope="module")
def mid():
    cfg = jax_mid(enc_kv_ring=64, dec_kv_ring=64)
    params = jax_init(cfg, seed=0)
    return cfg, params, jax.tree.map(np.asarray, params)


def _mel(cfg, batch):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((batch, 320, cfg.encoder.n_mel)) * 0.3
            ).astype(np.float32)


def _jax_serve(engine, batch, mesh=None):
    """The JAX dry run's serving case (its _dryrun_serving), optionally
    with the caches and tails sharded over `mesh`."""
    tr = jsv.BatchedTranscriber(engine, batch)
    if mesh is not None:
        cs, bs = cache_shardings(mesh), batch_shardings(mesh)
        for name in ("enc_cache", "dec_cache"):
            c = getattr(tr, name)
            setattr(tr, name, type(c)(jax.device_put(c.k, cs),
                                      jax.device_put(c.v, cs)))
        tr.c0_tail = jax.device_put(tr.c0_tail, bs)
        tr.c1_tail = jax.device_put(tr.c1_tail, bs)
    tr.feed_mel(_mel(engine.cfg, batch))
    tr.run_decoder()
    assert tr.gen_pos == tr.total_adapter == 40
    return tr.tokens


def _jax_pool(engine, n_slots):
    """The JAX dry run's pool case unsharded: every slot fed the same
    audio; each slot's raw ids."""
    pool = JPool(engine, n_slots, dec_kv_ring=64, enc_mode="ring")
    ids = {}
    inner = pool._process_tokens

    def wrap(s, tokens, *rest):
        got = ids.setdefault(id(s.queue), [])
        for t in tokens:
            got.append(int(t))
            if int(t) == 2:
                break
        return inner(s, tokens, *rest)

    pool._process_tokens = wrap
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(4 * 16000) * 0.05).astype(np.float32)
    slots = [pool.add_stream() for _ in range(n_slots)]
    for s in slots:
        pool.set_processing_interval(s, 0.25)
    for off in range(0, len(audio), 8000):
        for s in slots:
            pool.feed(s, audio[off: off + 8000])
        pool.tick()
    for s in slots:
        pool.finish(s)
    return [ids.get(id(pool.slots[s].queue), []) for s in slots]


def test_dryrun_multichip_8_ranks_equals_jax(mid, tiny_tokenizer, tmp_path,
                                            capfd):
    cfg, params, params_np = mid
    res = dryrun.dryrun_multichip(8, device="cpu", backend="gloo",
                                  params_np=params_np, workdir=tmp_path)
    out = capfd.readouterr().out
    for tag in ("serve dp4xtp2", "serve dp2xtp4", "pool", "int4-serve",
                "serve flash-bigring"):
        assert f"dryrun[{tag}] ok" in out
    assert "dryrun_multichip ok: 2 meshes + pool + int4 + flash-bigring on " \
           "8 ranks" in out
    assert res["hits"]["flash"] > 0 and res["hits"]["int4"] > 0

    plain = JEngine(cfg, params, tokenizer=tiny_tokenizer, dec_kv_ring=64,
                    **KW)
    want = _jax_serve(plain, 8)
    assert sum(len(t) for t in want) >= 8
    assert res["serve dp4xtp2"] == want
    assert res["serve dp2xtp4"] == want[:4]
    for dp, tp in ((4, 2), (2, 4)):
        mesh = make_mesh(dp, tp)
        sharded = JEngine(cfg, shard_params(params, param_shardings(cfg, mesh)),
                          tokenizer=tiny_tokenizer, dec_kv_ring=64, **KW)
        assert res[f"serve dp{dp}xtp{tp}"] == _jax_serve(sharded, 2 * dp,
                                                         mesh)
    pool = _jax_pool(plain, 4)
    assert all(len(p) > 20 for p in pool)
    assert res["pool"] == pool
    int4 = JEngine(cfg, params, tokenizer=tiny_tokenizer, dec_kv_ring=64,
                   quantize="int4", **KW)
    assert res["int4-serve"] == _jax_serve(int4, 16)
    big = JEngine(cfg, params, tokenizer=tiny_tokenizer, dec_kv_ring=1152,
                  **KW)
    assert res["serve flash-bigring"] == _jax_serve(big, 8)


def test_entry_decode_step():
    """entry(): one greedy decode step over the 8192-slot ring (here
    mid_config's decoder with zero weights on the CPU; by default the full
    config on the card)."""
    cfg = mid_config(dec_kv_ring=8192)
    fn, args = dryrun.entry(device="cpu", cfg=cfg)
    cache = args[3]
    assert cache.k.shape == (1, 26, 8, 8192, 8)
    with torch.no_grad():
        tokens, out = fn(*args)
    assert out is cache and tuple(tokens.shape) == (1, 1)
    assert 0 <= int(tokens[0, 0]) < cfg.decoder.vocab_size


def test_dryrun_config_takes_the_kernels_head_dims_on_cuda():
    """On the CPU the dry run runs mid_config as the JAX package's does; on
    CUDA the same lattice at the kernels' head dims, f32 with the encoder
    on its plain attention (flash-encode takes bf16 queries), and bf16 for
    the int4 case (the int4 kernel takes bf16 activations)."""
    assert dryrun.dryrun_config("cpu") == mid_config(enc_kv_ring=64,
                                                     dec_kv_ring=64)
    f32, bf16 = (dryrun.dryrun_config("cuda", dt)
                 for dt in ("float32", "bfloat16"))
    for c in (f32, bf16):
        assert (c.encoder.n_layers, c.encoder.n_heads, c.encoder.head_dim) \
            == (32, 32, 64)
        assert (c.decoder.n_layers, c.decoder.n_heads, c.decoder.n_kv_heads,
                c.decoder.head_dim) == (26, 32, 8, 128)
    assert f32.cdtype == torch.float32 and f32.encoder.attn_impl == "xla"
    assert bf16.cdtype == torch.bfloat16 and bf16.encoder.attn_impl == "auto"
