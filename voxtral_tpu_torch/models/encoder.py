"""Conv-stem im2col and the audio-to-decoder adapter.

This is the subset of voxtral_tpu/models/encoder.py the offline path runs.
The streaming pieces (conv chunks with tails, the ring-cache encoder
layers) are not ported yet (ROADMAP.md, queue 1: "Streaming").

Conv stem contract (voxtral_kernels.c:293-340, python:327-338):
  conv0: causal conv1d(128->1280, k3, s1) + GELU
  conv1: causal conv1d(1280->1280, k3, s2) + GELU
Causal padding = k - s zeros on the left; with an explicit 2-frame tail of
zeros this is exactly "prepend tail, drop the first ceil((k-s)/s) outputs".
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import DOWNSAMPLE_FACTOR, VoxtralConfig
from ..ops.norms import gelu
from .quant import mm

PyTree = Any


def _im2col(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x: [..., Tin, C] (tail already prepended).  Returns [..., Tout,
    kernel*C] where output j reads rows (stride*j + offset + k), offset =
    stride - 1 relative to a 2-frame tail for k=3."""
    tin = x.shape[-2]
    start = stride - 1  # k=3, tail=2: s1 -> rows [t..t+2]; s2 -> rows [2j+1..2j+3]
    tout = (tin - start - kernel) // stride + 1
    cols = [
        x[..., start + k: start + k + stride * (tout - 1) + 1: stride, :]
        for k in range(kernel)
    ]
    return torch.cat(cols, dim=-1)


def adapter_forward(adapter_params: PyTree, cfg: VoxtralConfig,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """[B, 4G, 1280] -> 4x downsample reshape -> MLP -> [B, G, 3072] in the
    compute dtype (voxtral_encoder.c:642-674, python:446-463).  No
    normalization."""
    cdtype = cfg.cdtype
    *lead, t, dim = enc_out.shape
    g = t // DOWNSAMPLE_FACTOR
    ds = enc_out.reshape(*lead, g, DOWNSAMPLE_FACTOR * dim).to(cdtype)
    h = gelu(mm(ds, adapter_params, "w0")).to(cdtype)
    return mm(h, adapter_params, "w1").to(cdtype)
