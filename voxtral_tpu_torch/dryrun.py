"""Entry points of the port: a full-width decode step, and the multi-device
dry run.

PyTorch counterpart of __graft_entry__.py.

    python -m voxtral_tpu_torch.dryrun                 # entry() once on the card
    python -m voxtral_tpu_torch.dryrun --dryrun 8 --device cpu
                                                       # 8 gloo ranks on the CPU
    python -m voxtral_tpu_torch.dryrun --dryrun 4 --backend gloo
                                                       # 4 ranks sharing a card

`dryrun_multichip` runs the cases of the JAX dry run (its `_dryrun_impl`)
in a world of n spawned ranks joined by torch.distributed, at mid_config's
real partition lattice (decoder 26 layers x 32 q / 8 KV heads, encoder 32
layers x 32 heads, at reduced widths; on CUDA at the kernels' head dims,
`dryrun_config`): the BatchedTranscriber on the
(n/2 x 2) and (n/4 x 4) dp x tp meshes, whose common streams must give
equal ids; a StreamPool in ring mode on the first mesh; int4 serving on a
dp-only (n x 1) mesh (the quantized rungs run at tp = 1: weights
replicated, streams split, as JAX's int4 dry run lays them out); and the
first mesh with a 1152-slot decoder ring.  Its counters: flash-decode and
the int4 product must run (on CUDA their kernels' launches, on the CPU the
calls of their plain versions).
"""

from __future__ import annotations

import sys
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any


def entry(device: str = "cuda", cfg=None):
    """(fn, example_args): one greedy decode step (a T=1 burst) of the
    decoder of `cfg` (default: the flagship full_config) over its
    8192-slot ring KV cache, with zero weights on `device`."""
    from .config import full_config
    from .models import decoder as dec_mod
    from .models.decoder import KVCache

    cfg = cfg or full_config()
    d = cfg.decoder
    pd = cfg.pdtype
    L = d.n_layers

    def zeros(*shape, dtype=pd):
        return torch.zeros(shape, dtype=dtype, device=device)

    f32 = torch.float32
    params = {
        "tok_embeddings": zeros(d.vocab_size, d.dim),
        "layers": {
            "attn_norm": zeros(L, d.dim, dtype=f32),
            "wqkv": zeros(L, d.q_dim + 2 * d.kv_dim, d.dim),
            "wo": zeros(L, d.dim, d.q_dim),
            "ffn_norm": zeros(L, d.dim, dtype=f32),
            "w13": zeros(L, 2 * d.hidden, d.dim),
            "w2": zeros(L, d.dim, d.hidden),
            "ada_down": zeros(L, d.ada_dim, d.dim),
            "ada_up": zeros(L, d.dim, d.ada_dim),
        },
        "final_norm": zeros(d.dim, dtype=f32),
    }
    cache = KVCache.create(d, cfg.kvdtype, device=device)
    chunk = zeros(1, 1, d.dim, dtype=f32)
    ada = zeros(L, d.dim, dtype=f32)

    def fn(params, chunk, prev, cache, pos, ada):
        tokens, _, _, _, cache = dec_mod.decode_burst(
            params, cfg, chunk, prev, cache, pos, ada, n_alt=0)
        return tokens, cache

    prev = torch.tensor([32], dtype=torch.int32, device=device)
    return fn, (params, chunk, prev, cache, 40, ada)


# --------------------------------------------------------------------------
# rank tasks: serving on a mesh in a spawned rank (parallel/mesh.py
# run_ranks), and the same serving unsharded, to hold one against the other
# --------------------------------------------------------------------------

def _rank_params(cfg, params, device):
    """A numpy tree in the engine layout on `device`, or, for an int,
    init_params(cfg, seed=params) made on `device`."""
    from .models.params import from_jax_numpy, init_params

    if isinstance(params, int):
        return init_params(cfg, seed=params, device=device)
    return from_jax_numpy(params, device)


def _counters():
    from .ops.banded_encode import banded_attention_batched
    from .ops.flash_decode import flash_decode
    from .ops.flash_encode import flash_bulk_attention_batched
    from .ops.quant_mm import int4_mm

    return (banded_attention_batched, flash_decode,
            flash_bulk_attention_batched, int4_mm)


def _launches() -> dict:
    return {f.__name__: f.launches for f in _counters()}


def _reset_launches() -> None:
    for f in _counters():
        f.launches = 0


def run_serving(eng, mel, clips: bool = False) -> dict:
    """Serve B streams on `eng` (on a mesh: this rank's block): the
    streaming BatchedTranscriber over mel [B, T, 128], or, with `clips`,
    serving.serve_clips over padded clips.  Returns every stream's tokens,
    the kernel launches (counted from 0 here), the caches' shapes or, with
    `clips`, the walls and the prefill's last hidden state of this rank's
    streams as float32 numpy."""
    from .parallel.mesh import gather_streams
    from .parallel.serving import BatchedTranscriber, serve_clips

    dev = eng.device
    out: dict = {}
    _sync(dev)
    _reset_launches()
    if clips:
        ids, st = serve_clips(eng, mel)
        hidden = st.pop("prefill_last_hidden")
        del st["adapter_rows"]
        out.update(st, prefill_last_hidden=hidden.float().cpu().numpy(),
                   tokens=gather_streams(eng.mesh, ids))
    else:
        tr = BatchedTranscriber(eng, mel.shape[0])
        tr.feed_mel(mel)
        tr.run_decoder()
        out.update(tokens=tr.all_tokens(), decode_steps=tr.decode_steps,
                   enc_chunk_calls=tr.n_enc_chunk_calls,
                   dec_cache_shape=tuple(tr.dec_cache.k.shape),
                   enc_cache_shape=tuple(tr.enc_cache.k.shape))
    _sync(dev)
    out["launches"] = _launches()
    return out


def run_pool(eng, audios, pool_kw: dict) -> dict:
    """A StreamPool of len(audios) continuous slots on `eng` (on a mesh:
    this rank's dp block of them) at a 0.25 s interval, slot i fed
    audios[i] in lockstep chunks of 0.5 s with a tick after each round,
    then every slot finished.  Returns every slot's raw ids and token
    queue (dp order), this rank's encode calls, bursts and burst rows, and
    its kernel launches (counted from 0 here)."""
    from .parallel.mesh import batch_shardings, gather_streams
    from .parallel.scheduler import StreamPool

    pool = StreamPool(eng, len(audios), **pool_kw)
    pool.record_ids = True
    mine = audios[batch_shardings(eng.mesh, len(audios))]
    _sync(eng.device)
    _reset_launches()
    slots = []
    for _ in mine:
        i = pool.add_stream()
        pool.set_processing_interval(i, 0.25)
        pool.set_continuous(i, True)
        slots.append(i)
    step = 8000
    for off in range(0, max(len(a) for a in audios), step):
        for i, a in zip(slots, mine):
            if off < len(a):
                pool.feed(i, a[off: off + step])
        pool.tick()
    for i in slots:
        pool.finish(i)
    _sync(eng.device)
    return {"ids": gather_streams(eng.mesh, [pool.slots[i].generated_ids
                                             for i in slots]),
            "queues": gather_streams(eng.mesh, [pool.get(i) for i in slots]),
            "enc_calls": pool.n_enc_calls, "bursts": pool.n_bursts,
            "burst_rows": pool.burst_rows, "launches": _launches()}


def mesh_serve(rank: int, dp: int, tp: int, cfg, params, mel,
               engine_kw: dict, device: str = "cpu", backend: str = "gloo",
               clips: bool = False, quantize=False, runs: int = 1) -> dict:
    """run_serving `runs` times on a dp x tp mesh (the last run's result;
    every run must give the same tokens), the engine built from `params`
    (a numpy tree or a seed, _rank_params); the full tree is freed once
    the engine holds its slices."""
    from .parallel.mesh import make_mesh
    from .runtime.engine import VoxtralEngine

    mesh = make_mesh(dp, tp, device, backend)
    full = _rank_params(cfg, params, device)
    eng = VoxtralEngine(cfg, full, tokenizer=_tokenizer(), mesh=mesh,
                        quantize=quantize, **engine_kw)
    del full
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    first = None
    for _ in range(runs):
        out = run_serving(eng, mel, clips)
        first = first or out["tokens"]
        if out["tokens"] != first:
            raise AssertionError(f"rank {rank}: a second run gave other ids")
    return {"rank": rank, **out}


def mesh_pool(rank: int, dp: int, tp: int, cfg, params, audios,
              engine_kw: dict, pool_kw: dict, device: str = "cpu",
              backend: str = "gloo") -> dict:
    """run_pool on a dp x tp mesh, the engine built from `params`."""
    from .parallel.mesh import make_mesh
    from .runtime.engine import VoxtralEngine

    mesh = make_mesh(dp, tp, device, backend)
    eng = VoxtralEngine(cfg, _rank_params(cfg, params, device),
                        tokenizer=_tokenizer(), mesh=mesh, **engine_kw)
    return {"rank": rank, **run_pool(eng, audios, pool_kw)}


# --------------------------------------------------------------------------
# the dry run, one rank
# --------------------------------------------------------------------------

def _tokenizer():
    from .tokenizer import TekkenTokenizer

    return TekkenTokenizer([bytes([i]) for i in range(256)], 1000)


def _say(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(msg, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dryrun_serving(cfg, params, mesh, tag, device, quantize=False,
                    dec_kv_ring=64) -> list:
    """The full serving step (conv stem -> encoder -> adapter -> prefill ->
    burst decode) of a BatchedTranscriber on `mesh`, two streams per dp
    group; returns every stream's tokens (all ranks get them)."""
    from .parallel.mesh import mesh_dims
    from .parallel.serving import BatchedTranscriber
    from .runtime.engine import VoxtralEngine

    dp, tp, _, _ = mesh_dims(mesh)
    eng = VoxtralEngine(cfg, params, tokenizer=_tokenizer(),
                        buckets=(16, 4, 1), enc_kv_ring=64,
                        dec_kv_ring=dec_kv_ring,
                        quantize="int4" if quantize else False, mesh=mesh)
    batch = dp * 2
    tr = BatchedTranscriber(eng, batch)
    rng = np.random.default_rng(0)
    # 320 mel frames -> 160 encoder positions -> 40 adapter rows >= the
    # 39-row prompt, so prefill and a decode burst both run
    mel = (rng.standard_normal((batch, 320, cfg.encoder.n_mel)) * 0.3
           ).astype(np.float32)
    tr.feed_mel(mel)
    tr.run_decoder()
    assert tr.decoder_started
    assert tr.gen_pos == tr.total_adapter == 40
    toks = tr.all_tokens()
    n_toks = [len(t) for t in toks]
    assert len(toks) == batch
    assert all(n <= 1 + (40 - eng.prompt_len) for n in n_toks)
    _sync(device)
    _say(f"dryrun[{tag}] ok: dp={dp} tp={tp}, batch={batch}, "
         f"tokens/stream={n_toks[0]}")
    return toks


def _dryrun_pool(cfg, params, mesh, tag, device) -> list:
    """A live StreamPool in ring mode (join/feed/tick/finish), one slot per
    dp group, each fed the same 4 s of audio; returns every slot's raw
    ids."""
    from .parallel.mesh import gather_streams, mesh_dims
    from .parallel.scheduler import StreamPool
    from .runtime.engine import VoxtralEngine

    dp, tp, _, _ = mesh_dims(mesh)
    eng = VoxtralEngine(cfg, params, tokenizer=_tokenizer(),
                        buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64,
                        mesh=mesh)
    pool = StreamPool(eng, dp, dec_kv_ring=64, enc_mode="ring")
    pool.record_ids = True
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(4 * 16000) * 0.05).astype(np.float32)
    slots = [pool.add_stream() for _ in range(pool.b)]
    for s in slots:
        pool.set_processing_interval(s, 0.25)
    step = 8000
    for off in range(0, len(audio), step):
        for s in slots:
            pool.feed(s, audio[off: off + step])
        pool.tick()
    for s in slots:
        pool.finish(s)
    made = gather_streams(mesh, [pool.slots[s].n_generated for s in slots])
    ids = gather_streams(mesh, [pool.slots[s].generated_ids for s in slots])
    assert len(made) == dp and all(m > 0 for m in made), made
    _sync(device)
    _say(f"dryrun[{tag}] ok: StreamPool dp={dp} tp={tp}, "
         f"tokens/slot={made[0]}")
    return ids


def dryrun_config(device: str, compute_dtype: str = "float32"):
    """The dry run's config: mid_config (the real layer and head lattice at
    reduced widths).  On CUDA its head dims become the kernels' (encoder
    64, decoder 128), and a float32 config's encoder attends on its plain
    path ("xla": the flash-encode kernel takes bf16 queries only)."""
    import dataclasses

    from .config import mid_config

    cfg = mid_config(enc_kv_ring=64, dec_kv_ring=64,
                     compute_dtype=compute_dtype)
    if torch.device(device).type != "cuda":
        return cfg
    return cfg.replace(
        encoder=dataclasses.replace(
            cfg.encoder, head_dim=64,
            attn_impl="xla" if compute_dtype == "float32" else "auto"),
        decoder=dataclasses.replace(cfg.decoder, head_dim=128))


def _dryrun_rank(rank: int, n: int, device: str, backend: str,
                 params_np: Optional[PyTree]) -> dict:
    """The dry run's cases on one rank (module docstring)."""
    from .models.params import from_jax_numpy, init_params
    from .ops import flash_decode as fd_mod
    from .ops import quant_mm
    from .parallel.mesh import make_mesh

    cfg = dryrun_config(device)
    params = (init_params(cfg, seed=0, device=device) if params_np is None
              else from_jax_numpy(params_np, device))
    # the int4 case: on CUDA in bf16 (the int4 kernel takes bf16
    # activations), with weights of its own from the same seed
    q_cfg, q_params = cfg, params
    if torch.device(device).type == "cuda":
        q_cfg = dryrun_config(device, "bfloat16")
        q_params = init_params(q_cfg, seed=0, device=device)
    meshes = []
    if n % 2 == 0:
        meshes.append(make_mesh(n // 2, 2, device, backend))
    if n % 4 == 0:
        meshes.append(make_mesh(n // 4, 4, device, backend))
    if not meshes:
        meshes.append(make_mesh(n, 1, device, backend))

    # the counters: on CUDA the kernels' launches (their wrappers count
    # them), on the CPU the calls of the plain versions the wrappers take
    # for CPU tensors
    on_gpu = torch.device(device).type == "cuda"
    hits = {"flash": 0, "int4": 0}
    plain = ((fd_mod, "flash_decode_plain", "flash"),
             (quant_mm, "int4_mm_plain", "int4"))
    saved = [getattr(mod, name) for mod, name, _ in plain]

    def counted(fn, key):
        def f(*a, **kw):
            hits[key] += 1
            return fn(*a, **kw)
        return f

    def count(key):
        if on_gpu:
            return (fd_mod.flash_decode if key == "flash"
                    else quant_mm.int4_mm).launches
        return hits[key]

    if on_gpu:
        fd_mod.flash_decode.launches = quant_mm.int4_mm.launches = 0
    else:
        for (mod, name, key), fn in zip(plain, saved):
            setattr(mod, name, counted(fn, key))
    out: dict = {}
    try:
        names = []
        for m in meshes:
            dp, tp = m["dp"].size(), m["tp"].size()
            name = f"serve dp{dp}xtp{tp}"
            out[name] = _dryrun_serving(cfg, params, m, name, device)
            names.append(name)
        if len(names) > 1:
            a, b = out[names[0]], out[names[1]]
            k = min(len(a), len(b))
            assert a[:k] == b[:k], "mesh geometries disagree"
        out["pool"] = _dryrun_pool(cfg, params, meshes[0], "pool", device)
        out["int4-serve"] = _dryrun_serving(
            q_cfg, q_params, make_mesh(n, 1, device, backend), "int4-serve",
            device, quantize=True)
        flash_before = count("flash")
        out["serve flash-bigring"] = _dryrun_serving(
            cfg, params, meshes[0], "serve flash-bigring", device,
            dec_kv_ring=1152)
        assert count("flash") > flash_before, "big-ring case never flashed"
    finally:
        for (mod, name, _), fn in zip(plain, saved):
            setattr(mod, name, fn)
    hits = {key: count(key) for key in hits}
    assert hits["flash"] > 0, "flash-decode never ran on the mesh"
    assert hits["int4"] > 0, "the int4 product never ran on the mesh"
    what = "kernel launches" if on_gpu else "plain versions' calls"
    _say(f"dryrun_multichip ok: {len(meshes)} meshes + pool + int4 + "
         f"flash-bigring on {n} ranks over {backend} (mid_config: real "
         f"26Lx32q/8kv lattice; {what} per rank: flash x{hits['flash']}, "
         f"int4-mm x{hits['int4']})")
    out["hits"] = hits
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     params_np: Optional[PyTree] = None,
                     workdir: Optional[str] = None) -> dict:
    """The multi-device dry run (module docstring) in n_devices spawned
    ranks on `device`, over `backend` (None: NCCL on CUDA, one card per
    rank; gloo on the CPU; several ranks on one card need "gloo").  The
    weights are init_params(seed=0) on each rank, or `params_np` (a numpy
    tree in the engine layout, e.g. the JAX package's).  Raises if a case
    fails; returns rank 0's results: the ids of every case and the entry
    points' call counts (`hits`)."""
    from .parallel.mesh import resolve_backend, run_ranks

    backend = resolve_backend(device, backend)
    outs = run_ranks(_dryrun_rank, n_devices,
                     (n_devices, device, backend, params_np),
                     device=device, backend=backend, workdir=workdir)
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            if k != "hits" and v != outs[0][k]:
                raise AssertionError(f"rank {r} disagrees on {k}")
    return outs[0]


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m voxtral_tpu_torch.dryrun")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="the multi-device dry run on N ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device, args.backend)
        return 0
    fn, ex = entry(args.device)
    with torch.no_grad():
        tokens, _ = fn(*ex)
    print(f"entry ok: one full-width decode step on {args.device}, "
          f"token {tokens.tolist()}")
    return 0


if __name__ == "__main__":
    # run through the module's own name, so the spawned ranks find the rank
    # function as voxtral_tpu_torch.dryrun._dryrun_rank
    from voxtral_tpu_torch import dryrun as _self

    sys.exit(_self.main(sys.argv[1:]))
