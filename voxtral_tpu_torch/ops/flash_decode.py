"""Flash-decode: single-token GQA attention over the stacked KV ring, with
an optional in-place write of this step's K/V row.

For stream b at query position pos[b] the live window is the last
valid = min(pos + 1, window, cap) logical positions, held at ring slots
(pos - valid + 1 .. pos) mod cap of layer `li` (the JAX package's `_info`
arithmetic).  With k_rows/v_rows given, the row is first written at slot
pos % cap of layer li, in place (cast to the ring dtype as
`ops/ring.py:to_ring_dtype` casts: fp8 saturates at +-448), and attention
sees it there.  Softmax and accumulation are float32; the result is in
out_dtype.

`flash_decode` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/flash_decode.cu`, one
    launch per call doing the row write and the attention, and nothing
    else (it replaces the Pallas kernels `_kernel`, `_kernel_flat` and
    `_kernel_flat_fused` of voxtral_tpu/ops/flash_decode.py, and the B=1
    row write before them).  It takes f32, bf16 or fp8 e4m3fn rings with
    head_dim 128, q in bf16 or f32, rows in f32 or the ring dtype, and
    writes a bf16 or f32 output; it raises on anything else.  The window
    is split over `flash_decode_splits(min(cap, window), B, KH)` blocks
    per KV head, whose partials the kernel folds in a fixed order, so a
    call gives the same bits every time.
  * CPU tensors take `flash_decode_plain`, the same function in plain
    PyTorch: the in-place row write of `ring_rows_write_plain`, then masked
    softmax attention over the whole ring widened to f32.  It launches no
    kernel on CUDA tensors either, so it serves as the kernel's reference
    there.

The decoder's attn_impl="xla" path (ring_rows_write + ring_attention)
computes the same function; it differs only in rounding (ring_attention
takes its products in the ring dtype, or q's for fp8 rings, as the JAX one
does).
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .ring import RING_KINDS, ring_rows_write_plain, slot_logical_positions

# the kernel's split plan: at most one wave of blocks on an H100 (132 SMs;
# the kernel's 192-254 registers a thread hold one 256-thread block per
# SM), at most a portable thread-block cluster (8 blocks) per KV head, at
# least 64 window slots per split
WAVE_BLOCKS = 132
MAX_SPLITS = 8
MIN_SPLIT_SLOTS = 64


def flash_decode_splits(span: int, bsz: int, kv_heads: int) -> int:
    """Into how many splits the kernel cuts the window indices
    0 .. span - 1 (span = min(cap, window)) of each of the bsz * kv_heads
    (stream, KV head) groups: split s takes indices [s C, (s + 1) C) with
    C = ceil(span / S), the newest position first.  A function of the
    shapes alone, never of the positions (the host cannot read them
    without a sync): B=1 with 8 KV heads takes 8 splits of a ring of 512
    slots or more, B=3 takes 5, B=16 one (128 blocks: a second wave of
    blocks cost more than the split saved, PERF.md section 6)."""
    want = WAVE_BLOCKS // (bsz * kv_heads)
    return max(1, min(MAX_SPLITS, want, span // MIN_SPLIT_SLOTS))


def flash_decode_plain(q, k_all, v_all, li: int, pos, k_rows=None,
                       v_rows=None, *, window: int, out_dtype=None):
    """Plain PyTorch flash-decode.  q [B,H,D]; k_all/v_all [B,L,KH,cap,D]
    (any float ring, fp8 included); pos int [B]; k_rows/v_rows [B,KH,D] or
    None.  Returns [B,H,D]."""
    bsz, h, d = q.shape
    kh, cap = k_all.shape[2], k_all.shape[3]
    g = h // kh
    out_dtype = out_dtype or q.dtype
    pos = pos.reshape(bsz)
    if k_rows is not None:
        ring_rows_write_plain(k_all, v_all, k_rows, v_rows, li, pos)
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


_FLOATS = (torch.float32, torch.bfloat16)


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
    kind = RING_KINDS.get(k_all.dtype)
    if kind is None or v_all.dtype != k_all.dtype:
        raise ValueError("flash-decode kernel takes f32, bf16 or fp8 e4m3fn "
                         f"rings, got {k_all.dtype}, {v_all.dtype}")
    if q.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"flash-decode kernel: q {q.dtype}, out_dtype "
                         f"{out_dtype} (needs bf16 or f32)")
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
    # each a no-op on the decoder's tensors: nothing is launched but the
    # kernel
    q = q.contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).reshape(bsz).contiguous()
    write = k_rows is not None
    rows_ptr, rows_stride, rows_f32 = (None, None), (0, 0), 1
    if write:
        if (k_rows.dtype not in (torch.float32, k_all.dtype)
                or v_rows.dtype != k_rows.dtype
                or k_rows.shape != (bsz, kh, d) or v_rows.shape != k_rows.shape
                or k_rows.device != q.device or v_rows.device != q.device):
            raise ValueError("flash-decode kernel: k_rows/v_rows must be "
                             f"[{bsz}, {kh}, {d}] in f32 or the ring dtype "
                             f"on {q.device}")
        # read in place with any stride between streams (the decoder's v
        # row is a slice of the qkv product)
        k_rows, v_rows = (r if r.stride()[1:] == (d, 1) else r.contiguous()
                          for r in (k_rows, v_rows))
        rows_ptr = (k_rows.data_ptr(), v_rows.data_ptr())
        rows_stride = (k_rows.stride(0), v_rows.stride(0))
        rows_f32 = int(k_rows.dtype == torch.float32)
    out = torch.empty((bsz, h, d), dtype=out_dtype, device=q.device)
    elt = k_rows.element_size() if write else 1
    if any(t.data_ptr() % 16 for t in (q, k_all, v_all, out)) or any(
            ptr % 16 or st * elt % 16 for ptr, st in zip(rows_ptr, rows_stride)
            if ptr is not None):
        raise ValueError("flash-decode kernel: tensors must be 16-byte "
                         "aligned")
    lib = cuda_lib.kernels()
    err = lib.vt_flash_decode(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *rows_ptr,
        pos32.data_ptr(), out.data_ptr(), bsz, n_layers, h, kh, cap, d, li,
        window, int(write), kind, int(q.dtype == torch.float32), rows_f32,
        int(out_dtype == torch.float32), *rows_stride,
        flash_decode_splits(min(cap, window), bsz, kh),
        cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
flash_decode.launches = 0
