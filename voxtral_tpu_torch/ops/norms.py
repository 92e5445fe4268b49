"""RMSNorm and activations — float32 islands inside the bf16 model.

Semantics follow python_simple_implementation.py:229-237 (RMSNorm always in
float32) and voxtral_tpu/ops/norms.py (exact erf GELU, SiLU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32, cast back to x.dtype.

    x: [..., dim]; weight: [dim] float32.
    """
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * weight.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package and the Python spec use
    (python_simple_implementation.py:366-367, 459)."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
