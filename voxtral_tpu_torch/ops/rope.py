"""Interleaved (GPT-J style) rotary position embeddings.

Mistral safetensors store Q/K weights in interleaved format per head, so
interleaved RoPE applied to *unpermuted* weights is exact
(python_simple_implementation.py:494-496, MODEL.md:223-227).

RoPE is always computed in float32 (an f32 island inside the bf16 model,
mirroring python_simple_implementation.py:552-559).
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions.

    positions: int [...], returns (cos, sin) each float32 [..., head_dim//2].
    (python_simple_implementation.py:243-247)
    """
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (0,1),(2,3),... of the last axis.

    x: [..., seq, n_heads, head_dim] (any float dtype; computed in f32)
    cos/sin: [..., seq, head_dim//2] (broadcast over the heads axis)
    (python_simple_implementation.py:249-275, is_neox_style=False branch)
    """
    orig_dtype = x.dtype
    xf = x.float()
    shape = xf.shape
    xf = xf.reshape(*shape[:-1], shape[-1] // 2, 2)
    x1 = xf[..., 0]
    x2 = xf[..., 1]
    c = cos[..., None, :]  # broadcast over heads axis
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(shape)
    return out.to(orig_dtype)
