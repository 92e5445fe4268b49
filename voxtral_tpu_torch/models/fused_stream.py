"""Fused streaming encode step: conv stem + encoder + adapter in one call.

PyTorch counterpart of voxtral_tpu/models/fused_stream.py.  For
quantum-aligned chunks (a multiple of 8 mel frames) there are no stride or
grouping residuals:

    Q mel -> conv0 -> Q -> conv1/2 -> Q/2 enc positions -> adapter -> Q/8 rows

so the stream runs the whole audio side as one call carrying the conv tails
and the encoder ring as explicit state, and keeps the exact bucketed path
(engine.conv0/conv1/encode/adapter) for the unaligned remainder.
Batched-first: [B, ...], B=1 for one stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import VoxtralConfig
from .bulk_encode import _conv_stem
from .encoder import EncKVCache, adapter_forward, encoder_layers

PyTree = Any


@dataclasses.dataclass
class ConvTails:
    mel_tail: torch.Tensor   # [B, 2, 128] f32
    c0_tail: torch.Tensor    # [B, 2, 1280] cdtype

    @classmethod
    def create(cls, cfg: VoxtralConfig, batch: int = 1,
               device="cpu") -> "ConvTails":
        return cls(
            torch.zeros((batch, 2, cfg.encoder.n_mel), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, 2, cfg.encoder.dim), dtype=cfg.cdtype,
                        device=device),
        )


@torch.no_grad()
def fused_encode_chunk(enc_params: PyTree, adapter_params: PyTree,
                       cfg: VoxtralConfig, mel: torch.Tensor,
                       tails: ConvTails, cache: EncKVCache,
                       enc_pos: torch.Tensor):
    """mel [B, Q, 128] (Q a multiple of 8) at encoder positions enc_pos
    int [B] (of the first conv output) -> (adapter rows [B, Q//8, 3072] in
    the compute dtype, new tails, cache updated in place)."""
    if mel.shape[1] % 8:
        raise ValueError(f"fused chunk of {mel.shape[1]} mel frames is not a "
                         "multiple of 8")
    x, mel_tail, c0_tail = _conv_stem(enc_params, cfg, mel, tails.mel_tail,
                                      tails.c0_tail, "stream")
    y = encoder_layers(enc_params, cfg, x, cache, enc_pos)
    rows = adapter_forward(adapter_params, cfg, y)
    return rows, ConvTails(mel_tail, c0_tail), cache
