"""Bulk (offline) whole-clip encoder: conv stem + 32 layers + adapter with
NO ring cache — the reference's batch `vox_encoder_forward` analog
(voxtral_encoder.c:135-312).

When the whole clip is available there is no cache state at all: k/v are
plain [B, T, KH, D] activations and attention is the static-band op of
ops/banded_encode.py (the hand-written CUDA kernel on the GPU).  The conv
stem stays two im2col matmuls, as in the JAX package.

Everything is batched-first ([B, ...], B=1 for one clip).
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import VoxtralConfig
from ..ops.banded_encode import banded_attention_batched
from ..ops.norms import rms_norm, silu
from ..ops.rope import apply_rope_interleaved, rope_cos_sin
from .encoder import adapter_forward, conv0_chunk, conv1_chunk
from .quant import mm

PyTree = Any


def _conv_stem(enc_params: PyTree, cfg: VoxtralConfig, mel: torch.Tensor,
               mel_tail: torch.Tensor, c0_tail: torch.Tensor):
    """conv0 + conv1 over one chunk with explicit boundary tails ->
    (x [B, Tm//2, dim], new_mel_tail, new_c0_tail)."""
    c0, mel_tail = conv0_chunk(enc_params, mel, mel_tail, cfg.cdtype)
    x, c0_tail = conv1_chunk(enc_params, c0, c0_tail, cfg.cdtype)
    return x, mel_tail, c0_tail


def bulk_transformer(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                     kv_lo=None) -> torch.Tensor:
    """32-layer no-ring transformer over [B, T, dim] at positions 0..T-1
    (banded attention), final-normed.  `kv_lo` (int [B]) hides leading
    positions.  One banded-attention launch per layer."""
    e = cfg.encoder
    cdtype = cfg.cdtype
    bsz, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(positions, e.head_dim, e.rope_theta)
    qkv_dim = e.qkv_dim
    x = x.to(cdtype)
    layers = enc_params["layers"]
    for li in range(e.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        xn = rms_norm(x, lp["attn_norm"], e.norm_eps).to(cdtype)
        qkv = mm(xn, lp, "wqkv") + lp["bqkv"]
        q = qkv[..., :qkv_dim].reshape(bsz, t, e.n_heads, e.head_dim)
        k = qkv[..., qkv_dim: 2 * qkv_dim].reshape(bsz, t, e.n_kv_heads, e.head_dim)
        v = qkv[..., 2 * qkv_dim:].reshape(bsz, t, e.n_kv_heads, e.head_dim)
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        attn = banded_attention_batched(
            q.to(cdtype), k.to(cdtype), v.to(cdtype), kv_lo,
            window=e.window, out_dtype=cdtype,
        ).reshape(bsz, t, qkv_dim)
        x = x + (mm(attn, lp, "wo") + lp["bo"]).to(x.dtype)
        hn = rms_norm(x, lp["ffn_norm"], e.norm_eps).to(cdtype)
        g13 = mm(hn, lp, "w13")
        gate = silu(g13[..., : e.hidden]) * g13[..., e.hidden:]
        ffn = mm(gate.to(cdtype), lp, "w2") + lp["b2"]
        x = x + ffn.to(x.dtype)
    return rms_norm(x, enc_params["final_norm"], e.norm_eps).to(cdtype)


@torch.no_grad()
def bulk_encode_clip(
    enc_params: PyTree,
    adapter_params: PyTree,
    cfg: VoxtralConfig,
    mel: torch.Tensor,        # [B, Tm, 128] whole padded clips, Tm % 8 == 0
) -> torch.Tensor:
    """Whole-clip mel -> adapter rows [B, Tm//8, 3072] (f32).

    Same math as the incremental path with zero conv tails and positions
    0..T-1; only the attention mechanism differs."""
    e = cfg.encoder
    if mel.dim() != 3 or mel.shape[1] % 8:
        raise ValueError(f"mel must be [B, Tm, 128] with Tm % 8 == 0, got "
                         f"{tuple(mel.shape)}")
    bsz = mel.shape[0]
    x, _, _ = _conv_stem(
        enc_params, cfg, mel,
        torch.zeros((bsz, 2, e.n_mel), dtype=mel.dtype, device=mel.device),
        torch.zeros((bsz, 2, e.dim), dtype=cfg.cdtype, device=mel.device),
    )
    y = bulk_transformer(enc_params, cfg, x)
    return adapter_forward(adapter_params, cfg, y).float()
