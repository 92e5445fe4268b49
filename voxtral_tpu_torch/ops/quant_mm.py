"""int4 weight-only matmul (W4A16): nibble-packed weights, unpacked on chip.

Packing (models/quant.py `_quantize4`): low nibbles hold input columns
[0, in/2), high nibbles [in/2, in); one f32 scale per (output row, half).
The product is

    y = (x[:, :in/2] @ lo.T) * s[:, 0] + (x[:, in/2:] @ hi.T) * s[:, 1]

with f32 accumulation and an f32 result [rows, out].

`int4_mm` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/int4_mm.cu` (it replaces
    the Pallas kernel voxtral_tpu/ops/quant_mm.py:_kernel; its header says
    what bounds it on the H100).  It takes bf16 x with an input dim that is
    a multiple of 32, contiguous operands, and raises on anything else.
  * CPU tensors take `int4_mm_plain` (the JAX package's `_mm4`).

Both take the STACKED [L, out, in/2] weight and a layer index, the JAX
function's signature; for the logits table pass p[None] with li=0.  The
stream axis is folded into the rows by the caller, so one launch reads the
weights once for every stream of the batch.
"""

from __future__ import annotations

import torch

from ..models.quant import _mm4
from . import cuda_lib

def int4_mm_plain(x, p_all, s_all, li: int):
    """Plain PyTorch int4 product: x [rows, in], p_all nibble-packed int8
    [L, out, in/2], s_all f32 [L, out, 2] -> f32 [rows, out].  Unpacks to
    x's dtype, then two f32-result products and the per-half scales."""
    return _mm4(x, p_all[li], s_all[li], x.dtype)


def int4_mm(x, p_all, s_all, li: int):
    """f32 [rows, out] = x @ unpack(p_all[li]).T with per-half scales."""
    if x.device.type == "cpu":
        return int4_mm_plain(x, p_all, s_all, li)
    if x.device.type != "cuda":
        raise NotImplementedError(f"int4_mm on {x.device}")
    if x.dim() != 2 or p_all.dim() != 3 or s_all.dim() != 3:
        raise ValueError(f"int4_mm kernel: x{tuple(x.shape)} "
                         f"p{tuple(p_all.shape)} s{tuple(s_all.shape)}")
    rows, in_dim = x.shape
    n_layers, out_dim, half = p_all.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int4_mm kernel takes bf16 x, got {x.dtype}")
    if p_all.dtype != torch.int8 or s_all.dtype != torch.float32:
        raise ValueError("int4_mm kernel takes int8 packed weights and f32 "
                         f"scales, got {p_all.dtype}, {s_all.dtype}")
    if in_dim != 2 * half or in_dim % 32:
        raise ValueError(f"int4_mm kernel: in {in_dim} against packed "
                         f"{half} (needs in = 2 * packed, a multiple of 32)")
    if s_all.shape != (n_layers, out_dim, 2):
        raise ValueError(f"int4_mm kernel: scales {tuple(s_all.shape)}")
    if not 0 <= li < n_layers:
        raise ValueError(f"int4_mm kernel: layer {li} of {n_layers}")
    for name, t in (("x", x), ("p_all", p_all), ("s_all", s_all)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"int4_mm kernel: {name} must be contiguous "
                             f"on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"int4_mm kernel: {name} not 16-byte aligned")
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    lib = cuda_lib.kernels()
    # the narrow decode shapes split the K range over more blocks; their
    # partial sums go through an f32 workspace
    k_split = lib.vt_int4_mm_k_split(rows, out_dim, half)
    splits = -(-half // k_split)
    work = (torch.empty((splits, rows, out_dim), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    err = lib.vt_int4_mm(
        x.data_ptr(), p_all.data_ptr(), s_all.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), rows, out_dim, half, li,
        k_split, cuda_lib.stream_handle(x.device),
    )
    cuda_lib.check(err, "int4_mm")
    int4_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
int4_mm.launches = 0
