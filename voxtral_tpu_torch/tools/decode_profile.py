"""Decompose the batched decode step into measured terms on the card.

PyTorch counterpart of tools/decode_profile.py.  Each term is timed in
isolation with the shapes, dtypes and cache fill of a mid-clip decode
step, then the ledger is printed with the JAX tool's lines:

  weights   one full read of every decoder layer tensor and the embedding
            table (a sum over each: the step's weight stream)
  logits    [B, dim] x [vocab, dim] tied-embedding product + argmax
  attn      26 flash-decode launches (csrc/flash_decode.cu, the row write
            off) over a filled ring; the JAX tool's "grid" and "flat"
            kernels (TPU kernels #2 and #3) are one kernel here, so both
            lines time it
  xla       the plain whole-ring attention (ops/ring.py ring_attention) of
            the 26 layers
  rowwrite  26 row writes (csrc/ring_rows_write.cu, TPU kernel #5)
  matmuls   the 26-layer qkv/wo/w13/w2 chain with attention stubbed out
  step      the real batched burst (parallel/serving.py bdecode_burst), ms
            per token: on the card it replays the decoder step's CUDA graph
            (ops/graphs.py), so the terms above are what it should approach

The terms are captured, DP_REP calls each, in one CUDA graph and replayed
between CUDA events (no host gaps); the step is timed with CUDA events
around its bursts, as a caller sees it.  Weights are seeded random
(`init_params(seed=0)`).

Usage:

    python -m voxtral_tpu_torch.tools.decode_profile [--device cuda|cpu]

Env: DP_BATCH (32), DP_RING (896), DP_POS (500), DP_BURST (64), DP_KV
(the ring dtype), DP_ATTN (the step's attn_impl), DP_QUANT (int8|int4),
DP_REP (4), DP_TERMS (a subset of weights,logits,attn,xla,rowwrite,
matmuls,step).  DP_BLOCK, the JAX kernel's block size, has no counterpart
(the port's kernel plans its split from the shapes) and exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from . import graph_time, pick_device, timeit


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests use a small
    model."""
    p = argparse.ArgumentParser(prog="decode_profile")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if os.environ.get("DP_BLOCK"):
        print("[decode_profile] DP_BLOCK sets the JAX Pallas kernel's block "
              "size; the port's flash-decode kernel plans its split from the "
              "shapes (ops/flash_decode.py flash_decode_splits)",
              file=sys.stderr)
        return 2
    dev = pick_device(args.device, "decode_profile")
    if dev is None:
        return 1
    batch = int(os.environ.get("DP_BATCH", "32"))
    ring = int(os.environ.get("DP_RING", "896"))
    pos_v = int(os.environ.get("DP_POS", "500"))
    burst = int(os.environ.get("DP_BURST", "64"))

    from ..config import full_config
    from ..models import decoder as dmod
    from ..models import quant
    from ..models.params import init_params
    from ..ops.flash_decode import flash_decode
    from ..ops.norms import rms_norm, silu
    from ..ops.ring import ring_attention, ring_rows_write
    from ..parallel import serving as sv

    cfg = cfg or full_config()
    if os.environ.get("DP_KV"):
        cfg = cfg.replace(kv_dtype=os.environ["DP_KV"])
    if os.environ.get("DP_ATTN"):   # the full step's attention path
        cfg = cfg.replace(decoder=dataclasses.replace(
            cfg.decoder, attn_impl=os.environ["DP_ATTN"]))
    d = cfg.decoder
    print(f"device={dev} B={batch} ring={ring} pos={pos_v} "
          f"kv={cfg.kv_dtype}", file=sys.stderr, flush=True)

    params = init_params(cfg, seed=0, device=dev)
    dp = params["decoder"]
    # the decode phase only: the encoder and adapter weights go
    params.pop("encoder", None)
    params.pop("adapter", None)
    ada = dmod.ada_scales(dp, cfg)
    quant_mode = os.environ.get("DP_QUANT", "")
    if quant_mode == "int8":
        dp = dict(dp)
        dp["layers"] = quant.quantize_layer_stack(dp["layers"])
    elif quant_mode == "int4":
        dp = quant.quantize_params({"decoder": dp}, encoder=False,
                                   bits=4)["decoder"]
    if quant_mode:
        print(f"quant={quant_mode}", file=sys.stderr, flush=True)
    params["decoder"] = dp

    gib = 1 << 30
    rep = int(os.environ.get("DP_REP", "4"))
    terms = set(os.environ.get(
        "DP_TERMS", "weights,logits,attn,xla,rowwrite,matmuls,step"
    ).split(","))

    def bytes_of(t):
        return t.numel() * t.element_size()

    layer_bytes = sum(bytes_of(v) for v in dp["layers"].values())
    embed_bytes = bytes_of(dp["tok_embeddings"])

    # --- term: pure weight stream ---------------------------------------
    t_w = 0.0
    if "weights" in terms:
        leaves = list(dp["layers"].values()) + [dp["tok_embeddings"]]

        def weight_stream():
            return sum(v.sum(dtype=torch.float32) for v in leaves)

        t_w = graph_time(weight_stream, rep, dev)
        wb = (layer_bytes + embed_bytes) / gib
        print(f"weights : {1000*t_w:7.2f} ms   ({wb:.2f} GiB -> "
              f"{wb/t_w:.0f} GiB/s)")

    # --- term: logits + argmax ------------------------------------------
    t_l = 0.0
    if "logits" in terms:
        x_l = torch.ones((batch, 1, d.dim), device=dev)
        t_l = graph_time(lambda: dmod.final_logits(dp, cfg, x_l).argmax(-1),
                         rep, dev)
        print(f"logits  : {1000*t_l:7.2f} ms   ({embed_bytes/gib:.2f} GiB -> "
              f"{embed_bytes/gib/t_l:.0f} GiB/s)")

    # --- terms over a filled batched cache -------------------------------
    kv_shape = (batch, d.n_layers, d.n_kv_heads, ring, d.head_dim)
    cache = sv.KVCache(torch.ones(kv_shape, device=dev).to(cfg.kvdtype),
                       torch.ones(kv_shape, device=dev).to(cfg.kvdtype))
    pos = torch.full((batch,), pos_v, dtype=torch.int32, device=dev)
    q = torch.zeros((batch, d.n_heads, d.head_dim), dtype=torch.bfloat16,
                    device=dev)
    krow = torch.zeros((batch, d.n_kv_heads, d.head_dim), device=dev)

    def attn26():
        for li in range(d.n_layers):
            flash_decode(q, cache.k, cache.v, li, pos, window=d.window,
                         out_dtype=torch.bfloat16)

    valid = min(pos_v + 1, d.window, ring)
    kv_gib = 2 * batch * d.n_layers * d.n_kv_heads * valid * d.head_dim * \
        cache.k.element_size() / gib
    t_a = 0.0
    if "attn" in terms:
        for tag in ("grid", "flat"):
            t_a = graph_time(attn26, rep, dev)
            print(f"attn/{tag}: {1000*t_a:7.2f} ms   (26 flash launches; "
                  f"~{kv_gib:.2f} GiB live KV -> {kv_gib/t_a:.0f} GiB/s)",
                  flush=True)

    if "xla" in terms:
        q4 = q[:, None]

        def attn26_xla():
            for li in range(d.n_layers):
                ring_attention(q4, cache.k[:, li], cache.v[:, li], pos,
                               window=d.window, out_dtype=torch.bfloat16)

        t_ax = graph_time(attn26_xla, rep, dev)
        full_gib = 2 * batch * d.n_layers * d.n_kv_heads * ring * \
            d.head_dim * cache.k.element_size() / gib
        print(f"attn/xla: {1000*t_ax:7.2f} ms   (whole-ring reads; "
              f"{full_gib:.2f} GiB -> {full_gib/t_ax:.0f} GiB/s)")

    t_rw = 0.0
    if "rowwrite" in terms:
        def write26():
            for li in range(d.n_layers):
                ring_rows_write(cache.k, cache.v, krow, krow, li, pos)

        t_rw = graph_time(write26, rep, dev)
        print(f"rowwrite: {1000*t_rw:7.2f} ms   (26 batched CUDA row "
              f"writes)", flush=True)
    del cache

    # --- term: matmul+norm chain, attention stubbed ---------------------
    cdtype = cfg.cdtype
    x_m = torch.zeros((batch, d.dim), device=dev)

    def matmuls_only():
        x = x_m
        for li in range(d.n_layers):
            lp = {k: v[li] for k, v in dp["layers"].items()}
            xn = rms_norm(x, lp["attn_norm"], d.norm_eps).to(cdtype)
            qkv = quant.mm(xn, lp, "wqkv")
            attn = qkv[:, : d.q_dim]                      # stub: no KV/flash
            x = x + quant.mm(attn.to(cdtype), lp, "wo").to(x.dtype)
            hn = rms_norm(x, lp["ffn_norm"], d.norm_eps).float()
            hn = (hn * (1.0 + ada[li])).to(cdtype)
            g13 = quant.mm(hn, lp, "w13")
            gate = silu(g13[:, : d.hidden]) * g13[:, d.hidden:]
            ffn = quant.mm(gate.to(cdtype), lp, "w2")
            x = x + ffn.to(x.dtype)
        return x

    t_m = 0.0
    if "matmuls" in terms:
        t_m = graph_time(matmuls_only, rep, dev)
        print(f"matmuls : {1000*t_m:7.2f} ms   (26-layer qkv/wo/w13/w2 "
              f"chain, {layer_bytes/gib:.2f} GiB -> "
              f"{layer_bytes/gib/t_m:.0f} GiB/s)")

    # --- the real step ---------------------------------------------------
    cache2 = sv.batched_dec_cache(cfg, batch, ring, device=dev)
    chunk = torch.zeros((batch, burst, d.dim), device=dev)
    prev = torch.full((batch,), 32, dtype=torch.int32, device=dev)
    t_s = timeit(lambda: sv.bdecode_burst(dp, cfg, chunk, prev, cache2, pos,
                                          ada)[0], 5, dev)
    ms = 1000 * t_s / burst
    terms_ms = 1000 * (t_m + t_l + t_a + t_rw)
    print(f"step    : {ms:7.2f} ms/token (burst {burst}, B={batch}) — "
          f"terms sum {terms_ms:.2f} ms "
          f"-> residual {ms - terms_ms:+.2f} ms "
          f"(graph replay and host overhead)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
