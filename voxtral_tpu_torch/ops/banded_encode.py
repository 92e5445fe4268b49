"""Banded attention for the NO-RING bulk (offline) encoder.

The batch encoder attends over positions 0..T-1 of a whole clip (no ring,
no logical-position state), so its causal sliding window is a static band:
each query q sees keys k with k <= q, k > q - window and k >= kv_lo[b]
(kv_lo hides leading positions of a stream; 0 for a plain clip).  Scores,
softmax and both accumulations are float32; a query row that sees no key
gets 0.

`banded_attention_batched` dispatches on the device of its inputs:
  * CUDA tensors launch the hand-written kernel
    `voxtral_tpu_torch/csrc/banded_attention.cu` (which replaces the Pallas
    kernel voxtral_tpu/ops/banded_encode.py:_kernel; its header says what
    bounds it on the H100 and how it is laid out; its core is the attention
    tile `csrc/attn_tile.cuh`, shared with the flash-encode kernel).  It
    takes bf16 q/k/v with head_dim 64 and raises on anything else; there is
    no fallback.
  * CPU tensors take `banded_attention_plain`, the same function in plain
    PyTorch.  The CPU tests hold it against the JAX kernel, and the GPU
    smoke run holds the kernel against it.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

def banded_attention_plain(q, k, v, kv_lo=None, *, window: int,
                           out_dtype=None):
    """Plain PyTorch banded attention: q [B,T,H,D], k/v [B,T,KH,D],
    kv_lo int [B] -> [B,T,H,D] in out_dtype (default q.dtype).

    The PV product takes the probabilities rounded to q's dtype, as the
    Pallas kernel does, with float32 accumulation (operands are widened to
    f32, exact for the products)."""
    bsz, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    out_dtype = out_dtype or q.dtype
    if kv_lo is None:
        kv_lo = torch.zeros(bsz, dtype=torch.int32, device=q.device)
    pos = torch.arange(t, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    valid = band[None] & (pos[None, None, :] >= kv_lo.reshape(bsz, 1, 1))
    qg = q.reshape(bsz, t, kh, g, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (1.0 / math.sqrt(d))
    valid = valid[:, None, None]                               # [B,1,1,T,T]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)                                  # masked -> 0
    l = p.sum(dim=-1, keepdim=True)
    probs = torch.where(l > 0, p / l.clamp_min(1e-30), torch.zeros_like(p))
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(q.dtype).float(), v.float())
    return out.reshape(bsz, t, h, d).to(out_dtype)


def banded_attention_batched(q, k, v, kv_lo=None, *, window: int,
                             out_dtype=None):
    """Sliding-window causal attention over positions 0..T-1 (no ring).
    q [B,T,H,D], k/v [B,T,KH,D], kv_lo int [B] or None -> [B,T,H,D]."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, kv_lo, window=window,
                                      out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(f"banded_attention on {q.device}")
    bsz, t, h, d = q.shape
    kh = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(f"banded kernel: {name} must be bf16 on {q.device}")
    if k.shape != (bsz, t, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"banded kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d != 64:
        raise ValueError(f"banded kernel supports head_dim 64, got {d}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"banded kernel: out_dtype {out_dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_lo is None:
        kv_lo = torch.zeros(bsz, dtype=torch.int32, device=q.device)
    kv_lo = kv_lo.to(device=q.device, dtype=torch.int32).reshape(bsz).contiguous()
    out = torch.empty((bsz, t, h, d), dtype=out_dtype, device=q.device)
    lib = cuda_lib.kernels()
    err = lib.vt_banded_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lo.data_ptr(),
        out.data_ptr(), bsz, t, h, kh, d, window,
        int(out_dtype == torch.float32),
        cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, "banded_attention")
    banded_attention_batched.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
banded_attention_batched.launches = 0
