"""Rank tasks of the port's mesh tests: functions a spawned rank runs
(voxtral_tpu_torch/parallel/mesh.py run_ranks) that only the tests need.
The module imports no JAX, so the spawned ranks load none; they import it
by this name from the tests directory, which the test run puts on
sys.path."""

import sys
import time

import torch

from voxtral_tpu_torch import dryrun
from voxtral_tpu_torch.models import decoder as dec_mod
from voxtral_tpu_torch.models.bulk_encode import bulk_encode_clip
from voxtral_tpu_torch.models.encoder import (
    EncKVCache,
    adapter_forward,
    encode_chunk,
)
from voxtral_tpu_torch.models.quant import embed_rows
from voxtral_tpu_torch.parallel.mesh import make_mesh, tensor_parallel
from voxtral_tpu_torch.parallel.scheduler import StreamPool
from voxtral_tpu_torch.runtime.engine import VoxtralEngine
from voxtral_tpu_torch.runtime.stream import VoxStream


def rank_modules(rank: int) -> list:
    """The modules a spawned rank has loaded (what the tests read to show
    that the ranks import no JAX)."""
    return sorted(sys.modules)


def rank_sleep(rank: int, seconds: float) -> None:
    """A rank that outlives its world's time limit."""
    time.sleep(seconds)


def mesh_layers(rank: int, tp: int, cfg, params, inputs: dict,
                device: str = "cpu", backend: str = "gloo") -> dict:
    """One tp group (dp = 1) of the model's layers against their inputs:
    the decoder over `inputs["embeds"]` [B, T, dim] from position 0 (its
    hidden state), the streaming encoder over `inputs["enc_x"]` [B, T, dim]
    (its output), the adapter over `inputs["enc_out"]`, the bulk encoder
    and adapter over `inputs["mel"]`, the vocab-parallel argmax of
    `inputs["logits"]` [B, V] (this rank's slice of it) and the embedding
    lookup of `inputs["ids"]`, a greedy burst with 3 alts over
    `inputs["chunk"]` [B, T, dim] from position 0 (tokens, alt ids, alt
    and best probabilities), all as numpy; and the refusals of a tp mesh
    (the quantized rungs, Jacobi, VoxStream, a window-mode pool), as their
    messages."""
    mesh = make_mesh(1, tp, device, backend)
    full = dryrun._rank_params(cfg, params, device)
    eng = VoxtralEngine(cfg, full, tokenizer=dryrun._tokenizer(), mesh=mesh,
                        buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
    rc, p = eng.cfg, eng.params
    t = lambda a: torch.as_tensor(a).to(device)           # noqa: E731
    n = lambda x: x.float().cpu().numpy()                  # noqa: E731
    emb = t(inputs["embeds"])
    cache = dec_mod.KVCache.create(rc.decoder, rc.kvdtype, 64,
                                   batch=emb.shape[0], device=device)
    x, _ = dec_mod.decoder_forward(p["decoder"], rc, emb, cache,
                                   torch.zeros(emb.shape[0], dtype=torch.int32,
                                               device=device), eng.ada())
    enc_x = t(inputs["enc_x"])
    ecache = EncKVCache.create(rc.encoder, rc.enc_kvdtype, 64,
                               batch=enc_x.shape[0], device=device)
    y, _ = encode_chunk(p["encoder"], rc, enc_x, ecache, 0)
    chunk = t(inputs["chunk"])
    burst = dec_mod.decode_burst(
        p["decoder"], rc, chunk,
        torch.full((chunk.shape[0],), 32, dtype=torch.int32, device=device),
        dec_mod.KVCache.create(rc.decoder, rc.kvdtype, 64,
                               batch=chunk.shape[0], device=device),
        0, eng.ada(), n_alt=3)
    logits = t(inputs["logits"])
    tpg = tensor_parallel(mesh)
    v = logits.shape[-1] // tp
    out = {
        "rank": rank, "hidden": n(x), "enc_out": n(y),
        "adapter": n(adapter_forward(p["adapter"], rc, t(inputs["enc_out"]))),
        "bulk_rows": n(bulk_encode_clip(p["encoder"], p["adapter"], rc,
                                        t(inputs["mel"]))),
        "argmax": n(tpg.argmax(logits[:, rank * v: (rank + 1) * v])),
        "embed": n(embed_rows(p["decoder"], t(inputs["ids"]), tp=tpg)),
        "burst": [x.cpu().numpy() for x in burst[:4]],
        "q_heads": rc.decoder.n_heads, "kv_heads": rc.decoder.n_kv_heads,
        "dec_cache_shape": tuple(cache.k.shape),
    }
    refused = {}
    tries = {
        "int8": lambda: VoxtralEngine(cfg, full, mesh=mesh, quantize="int8"),
        "int4": lambda: VoxtralEngine(cfg, full, mesh=mesh, quantize="int4"),
        "jacobi": lambda: VoxtralEngine(cfg, full, mesh=mesh,
                                        decode_mode="auto"),
        "voxstream": lambda: VoxStream(eng),
        "pool_window": lambda: StreamPool(eng, 2, enc_mode="window"),
        "pool_auto": lambda: StreamPool(eng, 2),
    }
    for name, fn in tries.items():
        try:
            fn()
        except ValueError as err:
            refused[name] = str(err)
    out["refused"] = refused
    return out
