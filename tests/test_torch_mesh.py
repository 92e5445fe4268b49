"""parallel/mesh.py of the port: the dp x tp layout, and serving on meshes
of spawned CPU ranks joined over gloo, held against the JAX package on
tiny_config() float32 with the same weights.

Every spawned world runs a rank task of voxtral_tpu_torch.dryrun or of
torch_rank_tasks beside this file (the children import no JAX), meets
through a FileStore under tmp_path, and
every collective has a timeout (parallel/mesh.py DEFAULT_TIMEOUT_S).
Tolerances: token ids exactly equal; layer outputs within 1e-5 of max
|JAX| (f32, the tp partial sums added in another order); the argmax and
the embedding lookup exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_tasks
from conftest import make_audio
from voxtral_tpu.config import TOKEN_EOS
from voxtral_tpu.models import bulk_encode as jbulk
from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.parallel import serving as jsv
from voxtral_tpu.parallel.scheduler import StreamPool as JPool
from voxtral_tpu.runtime.engine import VoxtralEngine as JEngine
from voxtral_tpu.runtime.engine import decompose
from voxtral_tpu_torch import dryrun
from voxtral_tpu_torch.config import mid_config, tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models.params import from_jax_numpy, init_params
from voxtral_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

KW = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
LAYER_REL_TOL = 1e-5


def _mel(cfg, batch, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n_frames, cfg.encoder.n_mel)) * 0.3
            ).astype(np.float32)


def _leaves(tree, specs, path=""):
    for k, v in tree.items():
        assert k in specs, path + k
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], f"{path}{k}.")
        else:
            yield path + k, v, specs[k]


# --- the layout -------------------------------------------------------------

@pytest.mark.parametrize("name,tp", [("tiny", 2), ("mid", 2), ("mid", 4)])
def test_param_shardings_cover_params_and_divide(name, tp):
    """param_shardings mirrors the params tree (no leaf without a layout,
    no layout without a leaf), and every split segment divides by tp."""
    cfg = tiny_config() if name == "tiny" else mid_config()
    params = init_params(cfg, seed=0, device="cpu")
    specs = tmesh.param_shardings(cfg)
    seen = 0
    for path, x, spec in _leaves(params, specs):
        seen += 1
        if spec is None:
            continue
        segs = spec.segments or (x.shape[spec.axis],)
        assert sum(segs) == x.shape[spec.axis], path
        assert all(n % tp == 0 for n in segs), (path, segs, tp)
    n_specs = sum(1 for _ in _leaves(specs, specs))
    assert seen == n_specs == 26


@pytest.mark.parametrize("name,tp", [("tiny", 2), ("mid", 4)])
def test_rank_slices_reassemble_the_full_tensors(name, tp):
    """Concatenating the ranks' slices, segment by segment, gives back
    every split tensor; replicated leaves are shared, not copied."""
    cfg = tiny_config() if name == "tiny" else mid_config()
    params = init_params(cfg, seed=1, device="cpu")
    for path, x, spec in _leaves(params, tmesh.param_shardings(cfg)):
        parts = [tmesh.shard_leaf(x, spec, tp, r) for r in range(tp)]
        if spec is None:
            assert all(p is x for p in parts), path
            continue
        segs = spec.segments or (x.shape[spec.axis],)
        pieces = [p.split([n // tp for n in segs], dim=spec.axis)
                  for p in parts]
        back = torch.cat([pieces[r][i] for i in range(len(segs))
                          for r in range(tp)], dim=spec.axis)
        assert parts[0].is_contiguous()
        torch.testing.assert_close(back, x, rtol=0, atol=0, msg=path)


@pytest.mark.parametrize("tp", [2, 4])
def test_gqa_groups_aligned(tp):
    """mid_config's decoder (32 q / 8 KV heads): rank r's local q head j
    is global head r H/tp + j, whose KV head (h // G) is rank r's own
    local KV head j // G; the local wqkv rows are those heads' rows."""
    cfg = mid_config()
    d = cfg.decoder
    w = init_params(cfg, seed=2, device="cpu")["decoder"]["layers"]["wqkv"]
    g = d.n_heads // d.n_kv_heads
    hl, khl, hd = d.n_heads // tp, d.n_kv_heads // tp, d.head_dim
    spec = tmesh.param_shardings(cfg)["decoder"]["layers"]["wqkv"]
    for r in range(tp):
        local = tmesh.shard_leaf(w, spec, tp, r)
        assert local.shape[1] == (hl + 2 * khl) * hd
        for j in range(hl):
            h = r * hl + j
            assert h // g == r * khl + j // g
            torch.testing.assert_close(
                local[:, j * hd:(j + 1) * hd], w[:, h * hd:(h + 1) * hd],
                rtol=0, atol=0)
        for kind in (1, 2):                     # k, then v segment
            lo = d.q_dim + (kind - 1) * d.kv_dim + r * khl * hd
            llo = hl * hd + (kind - 1) * khl * hd
            torch.testing.assert_close(local[:, llo: llo + khl * hd],
                                       w[:, lo: lo + khl * hd], rtol=0,
                                       atol=0)


def test_rank_config_widths():
    """Heads, KV heads and FFN hidden of both stacks and the adapter's
    hidden divide by tp; dim, head_dim, windows, rings and vocab stay."""
    cfg = mid_config()
    tp = tmesh.TensorParallel(None, 4, 1)
    rc = tmesh.rank_config(cfg, tp)
    assert (rc.encoder.n_heads, rc.encoder.n_kv_heads, rc.encoder.hidden) \
        == (8, 8, 64)
    assert (rc.decoder.n_heads, rc.decoder.n_kv_heads, rc.decoder.hidden) \
        == (8, 2, 64)
    assert rc.adapter_hidden == 16
    for sub in ("encoder", "decoder"):
        a, b = getattr(cfg, sub), getattr(rc, sub)
        for f in ("dim", "head_dim", "window", "kv_ring", "n_layers"):
            assert getattr(a, f) == getattr(b, f)
        assert tmesh.tp_of(b) is tp
    assert rc.decoder.vocab_size == cfg.decoder.vocab_size
    assert tmesh.tp_of(rc) is tp and tmesh.tp_of(cfg) is None
    assert rc.replace(delay_tokens=3).tp is tp
    with pytest.raises(ValueError, match="does not split"):
        tmesh.rank_config(tiny_config(), tmesh.TensorParallel(None, 4, 0))


def test_shape_plans_at_rank_head_counts():
    """Flash-decode's split plan reads the KV heads: at one tp-2 rank's 4
    KV heads the B=16 serve shape takes 2 splits where the full 8 take 1
    (one wave of 132 blocks either way); at tp 4 (2 KV heads), 4."""
    from voxtral_tpu_torch.ops.flash_decode import flash_decode_splits

    assert flash_decode_splits(896, 16, 8) == 1
    assert flash_decode_splits(896, 16, 4) == 2
    assert flash_decode_splits(896, 16, 2) == 4
    for kh in (2, 4, 8):
        assert 16 * kh * flash_decode_splits(896, 16, kh) <= 132


def test_backend_is_explicit_and_nccl_refuses_shared_cards(monkeypatch):
    """None means NCCL on CUDA and gloo on the CPU; NCCL with two ranks on
    one card raises before any process starts or group forms."""
    assert tmesh.resolve_backend("cuda", None) == "nccl"
    assert tmesh.resolve_backend("cpu", None) == "gloo"
    assert tmesh.resolve_backend("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="CUDA devices only"):
        tmesh.resolve_backend("cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        tmesh.make_mesh(1, 2, device="cuda")
    with pytest.raises(ValueError, match="one card per rank"):
        tmesh.run_ranks(dryrun.mesh_serve, 2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="one card per rank"):
        dryrun.dryrun_multichip(2, device="cuda")
    tmesh.check_cards("cuda", "nccl", 1)
    tmesh.check_cards("cuda", "gloo", 8)


# --- spawned meshes against JAX --------------------------------------------

def _jax_tokens(engine, mel):
    tr = jsv.BatchedTranscriber(engine, mel.shape[0])
    tr.feed_mel(mel)
    tr.run_decoder()
    return tr.tokens


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_serving_ids_equal_jax(engine, params_np, tmp_path, dp, tp):
    """The BatchedTranscriber on a dp x tp mesh: the ranks' blocks of ids,
    concatenated in dp order, equal the JAX package's unsharded ids; every
    rank agrees; caches hold the rank's streams and KV heads."""
    cfg = tiny_config()
    batch = 2 * dp
    mel = _mel(cfg, batch, 640)
    want = _jax_tokens(engine, mel)
    assert sum(len(t) for t in want) > 40 * batch
    outs = tmesh.run_ranks(dryrun.mesh_serve, dp * tp,
                           (dp, tp, cfg, params_np, mel, KW),
                           device="cpu", backend="gloo", workdir=tmp_path)
    d = cfg.decoder
    for o in outs:
        assert o["tokens"] == want
        assert o["dec_cache_shape"] == (2, d.n_layers, d.n_kv_heads // tp,
                                        64, d.head_dim)
        assert o["enc_cache_shape"][:3] == (2, cfg.encoder.n_layers,
                                            cfg.encoder.n_kv_heads // tp)
        assert not any(o["launches"].values())     # CPU: no kernel


def _jax_serve_clips(engine, mel):
    """bench.py's B=N pipeline in the JAX package (its run_once with the
    bulk encoder): encode_clips_bulk, the vmapped prompt embeds, bprefill
    of the first L-1 rows, then bdecode_burst over the engine's buckets
    from position L-1 with the feedback token on the device; each
    stream's ids cut at EOS."""
    cfg, dp = engine.cfg, engine.params["decoder"]
    bsz, plen = mel.shape[0], engine.prompt_len
    rows = engine.encode_clips_bulk(mel)
    cache = jsv.batched_dec_cache(cfg, bsz, engine.dec_kv_ring)
    prompt = jax.vmap(engine.prompt_embeds)(rows[:, :plen])
    cache = jsv.bprefill(dp, cfg, prompt[:, : plen - 1], cache,
                         jnp.zeros((bsz,), jnp.int32), engine.ada())
    prev, pos, parts = jnp.full((bsz,), 32, jnp.int32), plen - 1, []
    for b in decompose(rows.shape[1] - pos, engine.buckets):
        toks, _, _, _, cache = jsv.bdecode_burst(
            dp, cfg, rows[:, pos: pos + b], prev, cache,
            jnp.full((bsz,), pos, jnp.int32), engine.ada())
        parts.append(toks)
        prev = toks[:, -1].astype(jnp.int32)
        pos += b
    host = np.asarray(jnp.concatenate(parts, axis=1)).tolist()
    return [t[: t.index(TOKEN_EOS)] if TOKEN_EOS in t else t for t in host]


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_serve_clips_ids_equal_jax(engine, params_np, tmp_path, dp, tp):
    """serving.serve_clips (bulk encode of the rank's streams, batched
    prefill, bursts to the last adapter row, the EOS cut) on a dp x tp
    mesh: the ranks' blocks of ids, concatenated in dp order, equal the
    JAX package's bench pipeline on the same weights and mel; every rank
    agrees, and each rank decodes every position of its clips."""
    cfg = tiny_config()
    batch = 2 * dp
    mel = _mel(cfg, batch, 640, seed=5)
    want = _jax_serve_clips(engine, mel)
    assert sum(len(t) for t in want) > 20 * batch
    outs = tmesh.run_ranks(dryrun.mesh_serve, dp * tp,
                           (dp, tp, cfg, params_np, mel, KW, "cpu", "gloo",
                            True),
                           device="cpu", backend="gloo", workdir=tmp_path)
    for o in outs:      # rank d * tp + t: the hidden state replicated
        assert o["tokens"] == want
        assert o["decode_steps"] == 640 // 8 - (engine.prompt_len - 1)
        h = o["prefill_last_hidden"]
        assert h.shape == (2, cfg.decoder.dim) and np.isfinite(h).all()
        np.testing.assert_array_equal(
            h, outs[o["rank"] // tp * tp]["prefill_last_hidden"])


def test_pool_ring_ids_equal_jax(engine, params_np, tmp_path):
    """A ring-mode StreamPool of 4 continuous slots on a 2 x 2 mesh (two
    slots per dp group, restarts firing on random weights): every slot's
    ids and token queue equal the JAX StreamPool's on the same feeds."""
    audios = [make_audio(2.4, seed=s) for s in range(1, 5)]
    jp = JPool(engine, 4, dec_kv_ring=64, enc_mode="ring")
    got_ids = {}
    inner = jp._process_tokens

    def wrap(s, tokens, *rest):
        ids = got_ids.setdefault(id(s.queue), [])
        for t in tokens:
            ids.append(int(t))
            if int(t) == 2:
                break
        return inner(s, tokens, *rest)

    jp._process_tokens = wrap
    slots = []
    for a in audios:
        i = jp.add_stream()
        jp.set_processing_interval(i, 0.25)
        jp.set_continuous(i, True)
        slots.append(i)
    for off in range(0, len(audios[0]), 8000):
        for i, a in zip(slots, audios):
            jp.feed(i, a[off: off + 8000])
        jp.tick()
    for i in slots:
        jp.finish(i)
    want_ids = [got_ids.get(id(jp.slots[i].queue), []) for i in slots]
    want_q = [jp.get(i) for i in slots]
    assert all(len(w) > 20 for w in want_ids)
    outs = tmesh.run_ranks(
        dryrun.mesh_pool, 4,
        (2, 2, tiny_config(), params_np, audios, KW,
         dict(dec_kv_ring=64, enc_mode="ring")),
        device="cpu", backend="gloo", workdir=tmp_path)
    for o in outs:
        assert o["ids"] == want_ids
        assert o["queues"] == want_q


def test_int4_serving_dp2_equals_jax(cfg, params, params_np, tiny_tokenizer,
                                     tmp_path):
    """int4 serving on a dp-only mesh (2 x 1: the packed weights
    replicated, the streams split) equals the JAX int4 engine's ids."""
    jeng = JEngine(cfg, params, tokenizer=tiny_tokenizer, quantize="int4",
                   **KW)
    mel = _mel(cfg, 4, 640, seed=3)
    want = _jax_tokens(jeng, mel)
    outs = tmesh.run_ranks(dryrun.mesh_serve, 2,
                           (2, 1, tiny_config(), params_np, mel, KW, "cpu",
                            "gloo", False, "int4"),
                           device="cpu", backend="gloo", workdir=tmp_path)
    assert outs[0]["tokens"] == outs[1]["tokens"] == want


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def test_layers_at_tp2_equal_jax_and_refusals(cfg, params, params_np,
                                              tmp_path):
    """tp = 2: the decoder's hidden state, the streaming encoder's output,
    the adapter and the bulk encoder within LAYER_REL_TOL of JAX's; the
    vocab-parallel argmax (ties across and within the ranks' slices, at
    the slice boundary) equal torch.argmax of the full logits; the
    vocab-parallel embedding lookup bit-equal to the full table's; a
    greedy burst with 3 alts (from the gathered logits) equal to the
    port's unsharded burst (ids exact, probabilities within 1e-5); and the
    quantized rungs, Jacobi, VoxStream and a window or unnamed pool mode
    refused on the mesh."""
    rng = np.random.default_rng(7)
    d = cfg.decoder
    v = d.vocab_size
    emb = rng.standard_normal((2, 12, d.dim)).astype(np.float32)
    enc_x = rng.standard_normal((2, 20, cfg.encoder.dim)).astype(np.float32)
    enc_out = rng.standard_normal((2, 16, cfg.encoder.dim)).astype(np.float32)
    mel = rng.standard_normal((2, 96, cfg.encoder.n_mel)).astype(np.float32)
    logits = rng.standard_normal((5, v)).astype(np.float32)
    h = v // 2
    for row, (i, j) in enumerate([(5, h + 7), (h + 1, h + 9),
                                  (h - 1, h), (3, 9)]):
        logits[row, [i, j]] = 9.0                      # tied maxima
    logits[4, v - 1] = 9.0
    ids = np.array([[0, h - 1, h, v - 1], [1, 32, 2, h + 5]], np.int64)
    chunk = rng.standard_normal((2, 6, d.dim)).astype(np.float32)
    inputs = dict(embeds=emb, enc_x=enc_x, enc_out=enc_out, mel=mel,
                  logits=logits, ids=ids, chunk=chunk)
    outs = tmesh.run_ranks(torch_rank_tasks.mesh_layers, 2,
                           (2, tiny_config(), params_np, inputs),
                           device="cpu", backend="gloo", workdir=tmp_path)

    ada = jdec.ada_scales(params["decoder"], cfg)
    hid, enc, ad, rows = [], [], [], []
    for b in range(2):
        x, _ = jdec.decoder_forward(
            params["decoder"], cfg, jnp.asarray(emb[b]),
            jdec.KVCache.create(d, jnp.float32, 64), jnp.int32(0), ada)
        hid.append(np.asarray(x))
        y, _ = jenc.encode_chunk(params["encoder"], cfg, jnp.asarray(enc_x[b]),
                                 jenc.EncKVCache.create(cfg.encoder,
                                                        jnp.float32, 64),
                                 jnp.int32(0))
        enc.append(np.asarray(y))
        ad.append(np.asarray(jenc.adapter_forward(params["adapter"], cfg,
                                                  jnp.asarray(enc_out[b]))))
        rows.append(np.asarray(jbulk.bulk_encode_clip(
            params["encoder"], params["adapter"], cfg, jnp.asarray(mel[b]))))
    table = params_np["decoder"]["tok_embeddings"]
    tcfg = tiny_config()
    tdp = from_jax_numpy(params_np)["decoder"]
    want_burst = tdec.decode_burst(
        tdp, tcfg, torch.from_numpy(chunk),
        torch.full((2,), 32, dtype=torch.int32),
        tdec.KVCache.create(tcfg.decoder, torch.float32, 64, batch=2), 0,
        tdec.ada_scales(tdp, tcfg), n_alt=3)
    for o in outs:
        toks, alt_ids, alt_p, best_p = o["burst"]
        np.testing.assert_array_equal(toks, want_burst[0].numpy())
        np.testing.assert_array_equal(alt_ids, want_burst[1].numpy())
        np.testing.assert_allclose(alt_p, want_burst[2].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(best_p, want_burst[3].numpy(), rtol=1e-5,
                                   atol=1e-7)
        assert _rel(o["hidden"], np.stack(hid)) <= LAYER_REL_TOL
        assert _rel(o["enc_out"], np.stack(enc)) <= LAYER_REL_TOL
        assert _rel(o["adapter"], np.stack(ad)) <= LAYER_REL_TOL
        assert _rel(o["bulk_rows"], np.stack(rows)) <= LAYER_REL_TOL
        np.testing.assert_array_equal(o["argmax"],
                                      np.argmax(logits, axis=-1))
        assert list(o["argmax"][:4]) == [5, h + 1, h - 1, 3]
        np.testing.assert_array_equal(o["embed"], table[ids])
        assert (o["q_heads"], o["kv_heads"]) == (d.n_heads // 2,
                                                 d.n_kv_heads // 2)
        assert o["dec_cache_shape"] == (2, d.n_layers, d.n_kv_heads // 2,
                                        64, d.head_dim)
        assert set(o["refused"]) == {"int8", "int4", "jacobi", "voxstream",
                                     "pool_window", "pool_auto"}
        assert "do not split by heads" in o["refused"]["int4"]
