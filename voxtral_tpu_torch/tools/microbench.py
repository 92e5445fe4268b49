"""Micro-benchmarks of the hot calls on the card.

PyTorch counterpart of tools/microbench.py.  Usage:

    python -m voxtral_tpu_torch.tools.microbench
        [decode|prefill|encode|single|jacobi|logits|all] [--device cuda|cpu]

Env: MB_BATCH (default 16), MB_RING (1024), MB_BURST (64), MB_ATTN
(auto|xla|flash: the decoder's attn_impl), MB_KV (the decoder ring dtype,
e.g. float8_e4m3fn), MB_INT8=1 / MB_INT4=1 (the decode variants on the
int8 or int4 decoder).  MB_UNROLL, the JAX layer-scan unroll factor, has
no counterpart here (the port runs no scan) and exits 2.

Reports ms/step of the batched decode burst under each attention path,
the prefill, the batched encoder chunk, the B=1 sequential burst, a Jacobi
burst and the logits + argmax, with the JAX tool's lines.  The calls are
the engine's own: on the card the decode steps, encoder chunks and Jacobi
windows replay their CUDA graphs (ops/graphs.py), and each time is CUDA
events around the calls after two warm ones.  Weights are seeded random
(`init_params(seed=0)`); nothing is downloaded.  The roofline of a decode
step is its weight bytes over HBM_BYTES_PER_S (3.35 TB/s, the H100's):
6.86 GB of bf16 layers and table at full width, 2.05 ms.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from . import pick_device, timeit

WHICH = ("decode", "prefill", "encode", "single", "jacobi", "logits", "all")


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests use a small
    model."""
    p = argparse.ArgumentParser(prog="microbench")
    p.add_argument("which", nargs="?", default="all", choices=WHICH)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if os.environ.get("MB_UNROLL"):
        print("[microbench] MB_UNROLL sets the JAX layer scan's unroll "
              "factor; the port runs its layers as a Python loop (or one "
              "CUDA graph) and has no scan to unroll", file=sys.stderr)
        return 2
    dev = pick_device(args.device, "microbench")
    if dev is None:
        return 1
    which = args.which
    batch = int(os.environ.get("MB_BATCH", "16"))
    ring = int(os.environ.get("MB_RING", "1024"))
    burst = int(os.environ.get("MB_BURST", "64"))

    from ..config import full_config
    from ..models import decoder as dmod
    from ..models.decoder import KVCache, final_logits
    from ..models.jacobi import decode_burst_jacobi
    from ..models.params import init_params
    from ..models.quant import quantize_params
    from ..parallel import serving as sv
    from ..runtime.engine import VoxtralEngine
    from ..tokenizer import TekkenTokenizer

    print(f"device={dev} batch={batch} ring={ring} burst={burst}",
          file=sys.stderr)
    cfg = cfg or full_config()
    if os.environ.get("MB_ATTN"):
        cfg = cfg.replace(decoder=dataclasses.replace(
            cfg.decoder, attn_impl=os.environ["MB_ATTN"]))
    if os.environ.get("MB_KV"):
        cfg = cfg.replace(kv_dtype=os.environ["MB_KV"])
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device=dev)
    print(f"init_params on device: {time.monotonic() - t0:.1f}s",
          file=sys.stderr)
    tok = TekkenTokenizer([b"x"] * 1000, 1000)
    eng = VoxtralEngine(cfg, params, tokenizer=tok,
                        buckets=(256, 64, 16, 4, 1), enc_kv_ring=1024,
                        dec_kv_ring=ring)
    ada = eng.ada()

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if which in ("decode", "all"):
        chunk = torch.zeros((batch, burst, cfg.decoder.dim), device=dev)
        prev, pos = full((batch,), 32), full((batch,), 500)
        dparams = eng.params["decoder"]
        if os.environ.get("MB_INT8") or os.environ.get("MB_INT4"):
            bits = 4 if os.environ.get("MB_INT4") else 8
            dparams = quantize_params(eng.params, encoder=False,
                                      bits=bits)["decoder"]
        for name in ("auto", "xla", "flash"):
            c = cfg.replace(decoder=dataclasses.replace(cfg.decoder,
                                                        attn_impl=name))
            cache = sv.batched_dec_cache(cfg, batch, ring, device=dev)

            def step(c=c, cache=cache):
                return sv.bdecode_burst(dparams, c, chunk, prev, cache, pos,
                                        ada)[0]

            t = timeit(step, 5, dev)
            ms = 1000 * t / burst
            print(f"decode burst [{name}]: {1000*t:.1f} ms / {burst} steps = "
                  f"{ms:.2f} ms/step ({batch} streams) -> "
                  f"{batch*80/ms:.1f}x realtime aggregate")

    if which in ("prefill", "all"):
        cache = sv.batched_dec_cache(cfg, batch, ring, device=dev)
        embeds = torch.zeros((batch, 38, cfg.decoder.dim), device=dev)
        zero = full((batch,), 0)
        t = timeit(lambda: sv.bprefill(eng.params["decoder"], cfg, embeds,
                                       cache, zero, ada), 5, dev)
        print(f"prefill(38): {1000*t:.1f} ms ({batch} streams)")

    if which in ("encode", "all"):
        ecache = sv.batched_enc_cache(cfg, batch, 1024, device=dev)
        x = torch.zeros((batch, 256, cfg.encoder.dim), dtype=torch.bfloat16,
                        device=dev)
        at = full((batch,), 100)
        t = timeit(lambda: sv.bencode(eng.params["encoder"], cfg, x, ecache,
                                      at)[0], 5, dev)
        # 256 encoder positions = 20.48 s of audio
        print(f"encode chunk 256: {1000*t:.1f} ms ({batch} streams) "
              f"-> {batch*256*0.08/t:.0f}x realtime aggregate")

    if which in ("single", "all"):
        cache = KVCache.create(cfg.decoder, cfg.kvdtype, ring, device=dev)
        chunk = torch.zeros((1, burst, cfg.decoder.dim), device=dev)
        t = timeit(lambda: dmod.decode_burst(
            eng.params["decoder"], cfg, chunk, full((1,), 32), cache, 500,
            ada)[0], 5, dev)
        ms = 1000 * t / burst
        print(f"single-stream sequential: {ms:.2f} ms/step "
              f"-> {80/ms:.1f}x realtime")

    if which in ("jacobi", "all"):
        cache = KVCache.create(cfg.decoder, cfg.kvdtype, ring, device=dev)
        chunk = torch.zeros((1, burst, cfg.decoder.dim), device=dev)
        state = {}

        def jstep():
            toks, _, _, _, _, state["it"] = decode_burst_jacobi(
                eng.params["decoder"], cfg, chunk, full((1,), 32), cache,
                500, ada, window=min(64, burst))
            return toks

        t = timeit(jstep, 5, dev)
        iters = state["it"]
        per_iter = 1000 * t / max(iters, 1)
        print(f"jacobi: {1000*t:.1f} ms / {burst} tokens in {iters} iters "
              f"({per_iter:.2f} ms/iter; random weights ~= worst case). "
              f"Speedup vs sequential = tokens-settled-per-iter.")

    if which in ("logits", "all"):
        x = torch.zeros((batch, 1, cfg.decoder.dim), device=dev)
        t = timeit(lambda: final_logits(eng.params["decoder"], cfg,
                                        x).argmax(-1), 5, dev)
        print(f"logits+argmax: {1000*t:.2f} ms ({batch} streams)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
