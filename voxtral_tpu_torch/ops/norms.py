"""RMSNorm and activations — float32 islands inside the bf16 model.

Semantics follow python_simple_implementation.py:229-237 (RMSNorm always in
float32) and voxtral_tpu/ops/norms.py (exact erf GELU, SiLU).

`rms_norm` on CUDA tensors launches `voxtral_tpu_torch/csrc/rms_norm.cu`
(one block a row, the sum of squares in an order fixed by the width), so
a row's bits never depend on how many rows share the call: torch's own
reduction picks its layout by the row count and rounds a 1280- or
3072-wide row differently at 2-15 rows than at more.  CPU tensors take
`rms_norm_plain`, the same arithmetic in torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32, cast back to x.dtype.

    x: [..., dim]; weight: [dim] float32.
    """
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32, cast back to x.dtype, each row's bits
    independent of the row count on the card.  x: [..., dim] bf16 or f32;
    weight: [dim] f32.  CPU tensors take `rms_norm_plain`."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise NotImplementedError(f"rms_norm on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rms_norm kernel takes bf16 or f32 x, got {x.dtype}")
    dim = x.shape[-1]
    if weight.dtype != torch.float32 or weight.shape != (dim,) \
            or weight.device != x.device:
        raise ValueError(f"rms_norm kernel: weight {weight.dtype} "
                         f"{tuple(weight.shape)} on {weight.device} (needs "
                         f"f32 [{dim}] on {x.device})")
    x = x.contiguous()
    weight = weight.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // dim
    if rows == 0:
        return out
    err = cuda_lib.kernels().vt_rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, dim,
        int(x.dtype == torch.bfloat16), float(eps),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "rms_norm")
    rms_norm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
rms_norm.launches = 0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package and the Python spec use
    (python_simple_implementation.py:366-367, 459)."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
