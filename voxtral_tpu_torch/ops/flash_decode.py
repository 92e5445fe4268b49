"""Flash-decode: single-token GQA attention over the stacked KV ring, with
an optional in-place write of this step's K/V row.

For stream b at query position pos[b] the live window is the last
valid = min(pos + 1, window, cap) logical positions, held at ring slots
(pos - valid + 1 .. pos) mod cap of layer `li` (the JAX package's `_info`
arithmetic).  With k_rows/v_rows given, the row is first written at slot
pos % cap of layer li, in place, and attention sees it there.  Softmax and
accumulation are float32; the result is cast to out_dtype.

`flash_decode` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/flash_decode.cu`, one
    launch per call doing the row write and the attention (it replaces the
    Pallas kernels `_kernel`, `_kernel_flat` and `_kernel_flat_fused` of
    voxtral_tpu/ops/flash_decode.py, and the B=1 row write before them).
    It takes bf16 or f32 rings with head_dim 128 and raises on anything
    else (fp8 rings stay on the plain ring path, models/decoder.py).
  * CPU tensors take `flash_decode_plain`, the same function in plain
    PyTorch: the in-place row write of ops/ring.py, then masked softmax
    attention over the whole ring in f32.

The decoder's attn_impl="xla" path (ring_rows_write + ring_attention)
computes the same function; it differs only in rounding (ring_attention
takes its products in the ring dtype, as the JAX one does).
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .ring import ring_rows_write, slot_logical_positions


def flash_decode_plain(q, k_all, v_all, li: int, pos, k_rows=None,
                       v_rows=None, *, window: int, out_dtype=None):
    """Plain PyTorch flash-decode.  q [B,H,D]; k_all/v_all [B,L,KH,cap,D];
    pos int [B]; k_rows/v_rows [B,KH,D] or None.  Returns [B,H,D]."""
    bsz, h, d = q.shape
    kh, cap = k_all.shape[2], k_all.shape[3]
    g = h // kh
    out_dtype = out_dtype or q.dtype
    pos = pos.reshape(bsz)
    if k_rows is not None:
        ring_rows_write(k_all, v_all, k_rows, v_rows, li, pos)
    lpos = slot_logical_positions(pos, cap)                    # [B, cap]
    p = pos[:, None]
    valid = (lpos >= 0) & (lpos > p - window) & (lpos <= p)
    # q scaled before the dot, as the kernels do
    qg = q.float().reshape(bsz, kh, g, d) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_all[:, li].float())
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_all[:, li].float())
    return out.reshape(bsz, h, d).to(out_dtype)


def flash_decode(q, k_all, v_all, li: int, pos, k_rows=None, v_rows=None,
                 *, window: int, out_dtype=None):
    """Attention output [B,H,D] for the query at pos[b] over layer li of the
    stacked caches; with k_rows/v_rows, writes them at pos % cap first (in
    place).  Pass the STACKED cache and the layer index."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_all, v_all, li, pos, k_rows, v_rows,
                                  window=window, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_decode on {q.device}")
    bsz, h, d = q.shape
    _, n_layers, kh, cap, _ = k_all.shape
    rdt = k_all.dtype
    if rdt not in (torch.bfloat16, torch.float32) or v_all.dtype != rdt:
        raise ValueError(f"flash-decode kernel takes bf16/f32 rings, got {rdt}")
    if d != 128 or h % kh or (h // kh) not in (1, 2, 4):
        raise ValueError(f"flash-decode kernel: H={h} KH={kh} D={d} "
                         "(needs D=128, H/KH in 1, 2, 4)")
    if v_all.shape != k_all.shape or k_all.shape[0] != bsz:
        raise ValueError("flash-decode kernel: cache shapes")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError("flash-decode kernel: caches must be contiguous "
                         "(they are written in place)")
    if not 0 <= li < n_layers:
        raise ValueError(f"flash-decode kernel: layer {li} of {n_layers}")
    write = k_rows is not None
    q32 = q.to(torch.float32).contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).reshape(bsz).contiguous()
    if write:
        kn = k_rows.to(rdt).contiguous()
        vn = v_rows.to(rdt).contiguous()
        if kn.shape != (bsz, kh, d) or vn.shape != kn.shape:
            raise ValueError("flash-decode kernel: k_rows/v_rows shapes")
        kn_ptr, vn_ptr = kn.data_ptr(), vn.data_ptr()
    else:
        kn_ptr = vn_ptr = None
    out = torch.empty((bsz, h, d), dtype=torch.float32, device=q.device)
    lib = cuda_lib.kernels()
    err = lib.vt_flash_decode(
        q32.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), kn_ptr, vn_ptr,
        pos32.data_ptr(), out.data_ptr(), bsz, n_layers, h, kh, cap, d, li,
        window, int(write), int(rdt == torch.float32),
        cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, "flash_decode")
    flash_decode.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


# kernel launches since the last reset (CPU calls never count)
flash_decode.launches = 0
