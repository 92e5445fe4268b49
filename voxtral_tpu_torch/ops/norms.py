"""RMSNorm and activations — float32 islands inside the bf16 model.

Semantics follow python_simple_implementation.py:229-237 (RMSNorm always in
float32) and voxtral_tpu/ops/norms.py (exact erf GELU, SiLU).

`add_rms_norm` is the layers' residual add, norm and ada scale in one call
(what XLA fuses into one pass in the JAX package's layers,
voxtral_tpu/models/decoder.py:170-177 and encoder.py:149-155): on CUDA
tensors one launch of `voxtral_tpu_torch/csrc/rms_norm.cu` (one block a
row, the sum of squares in an order fixed by the width), so a row's bits
never depend on how many rows share the call: torch's own reduction picks
its layout by the row count and rounds a 1280- or 3072-wide row
differently at 2-15 rows than at more.  `rms_norm` is its norm-only case.
CPU tensors take `add_rms_norm_plain` / `rms_norm_plain`, the same
sequence in torch.
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


def add_rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-5, y: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None,
                       ada: torch.Tensor | None = None):
    """The sequence `add_rms_norm` computes, in torch: x_new = x + (y
    [+ bias]).to(x.dtype) (x itself without y), the norm of x_new rounded
    to x.dtype, then with ada (n.float() * (1 + ada)).to(x.dtype).
    Returns (x_new, normed)."""
    if y is not None:
        x = x + (y if bias is None else y + bias).to(x.dtype)
    n = rms_norm_plain(x, weight, eps)
    if ada is not None:
        n = (n.float() * (1.0 + ada)).to(x.dtype)
    return x, n


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _vec(name: str, t: torch.Tensor | None, x: torch.Tensor):
    """A weight, bias or ada argument checked for the kernel: None, or f32
    [dim] on x's device, made contiguous."""
    dim = x.shape[-1]
    if t is None:
        return None
    if t.dtype != torch.float32 or t.shape != (dim,) or t.device != x.device:
        raise ValueError(f"rms_norm kernel: {name} {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} (needs f32 "
                         f"[{dim}] on {x.device})")
    return t.contiguous()


def add_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                 y: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 ada: torch.Tensor | None = None):
    """Residual add + RMSNorm (+ ada scale) -> (x_new, normed), each row's
    bits independent of the row count on the card.

    x: [..., dim] bf16 or f32, the residual; y: x's shape, f32 (a
    product's output, summed over tp ranks), added after `bias` in f32
    and a cast to x.dtype; weight, bias, ada: f32 [dim]; normed in
    x.dtype.  Without y, x_new is x itself.  On CUDA tensors one kernel
    launch (rows of at most 4096: the kernel refuses wider ones), which
    may start before the stream's previous kernel ends and reads all of
    its inputs only once that kernel's writes are visible.  CPU tensors
    take `add_rms_norm_plain`."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, weight, eps, y, bias, ada)
    if x.device.type != "cuda":
        raise NotImplementedError(f"rms_norm on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rms_norm kernel takes bf16 or f32, got x "
                         f"{x.dtype}")
    dim = x.shape[-1]
    weight, bias, ada = (_vec("weight", weight, x), _vec("bias", bias, x),
                         _vec("ada", ada, x))
    if bias is not None and y is None:
        raise ValueError("rms_norm kernel: a bias without y")
    x = x.contiguous()
    out = torch.empty_like(x)
    x_new = x
    if y is not None:
        if y.dtype != torch.float32 or y.shape != x.shape \
                or y.device != x.device:
            raise ValueError(f"rms_norm kernel: y {y.dtype} "
                             f"{tuple(y.shape)} on {y.device} (needs f32 "
                             f"{tuple(x.shape)} on {x.device})")
        y = y.contiguous()
        x_new = torch.empty_like(x)
    rows = x.numel() // dim
    if rows == 0:
        return x_new, out
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = cuda_lib.kernels().vt_rms_norm(
        x.data_ptr(), ptr(y), ptr(bias), ptr(ada), weight.data_ptr(),
        None if y is None else x_new.data_ptr(), out.data_ptr(), rows, dim,
        int(x.dtype == torch.bfloat16), float(eps),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "rms_norm")
    rms_norm.launches += 1
    return x_new, out


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32, cast back to x.dtype: `add_rms_norm`'s
    norm-only case (its launches count here, as every launch of the
    kernel does).  x: [..., dim] bf16 or f32; weight: [dim] f32.  CPU
    tensors take `rms_norm_plain`."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return add_rms_norm(x, weight, eps)[1]


# kernel launches since the last reset (CPU calls never count)
rms_norm.launches = 0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package and the Python spec use
    (python_simple_implementation.py:366-367, 459)."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
