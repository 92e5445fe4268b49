"""Bulk (offline) whole-clip encoder: conv stem + 32 layers + adapter with
NO ring cache — the reference's batch `vox_encoder_forward` analog
(voxtral_encoder.c:135-312).

When the whole clip is available there is no cache state at all: k/v are
plain [B, T, KH, D] activations and attention is the static-band op of
ops/banded_encode.py.  EncoderConfig.attn_impl picks its version by the
streaming encoder's rule (decoder._use_flash with no ring): "flash" and
"auto" the wrapper (the hand-written CUDA kernel for CUDA tensors, bf16 or
float32), "xla" the plain `banded_attention_plain`.  The conv stem stays
two im2col matmuls, as in the JAX package.

`window_encode_chunk` is the StreamPool's window-recompute streaming mode
(parallel/scheduler.py): the same no-ring transformer over a per-stream
context window, each stream's stale leading context hidden by its own
`kv_lo`.

Everything is batched-first ([B, ...], B=1 for one clip).
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import VoxtralConfig
from ..ops.banded_encode import banded_attention_batched, banded_attention_plain
from ..ops.norms import add_rms_norm, silu
from ..ops.rope import qkv_rope, rope_cos_sin
from ..parallel.mesh import tp_sum
from .decoder import _use_flash
from .encoder import adapter_forward, conv0_chunk, conv1_chunk
from .quant import mm

PyTree = Any


def _conv_stem(enc_params: PyTree, cfg: VoxtralConfig, mel: torch.Tensor,
               mel_tail: torch.Tensor, c0_tail: torch.Tensor, call: str):
    """conv0 + conv1 over one chunk with explicit boundary tails ->
    (x [B, Tm//2, dim], new_mel_tail, new_c0_tail).  `call`: "bulk" (the
    bulk encoder, window mode) or "stream" (the fused streaming chunk),
    decoder._use_rowinv's."""
    c0, mel_tail = conv0_chunk(enc_params, mel, mel_tail, cfg.cdtype, call)
    x, c0_tail = conv1_chunk(enc_params, c0, c0_tail, cfg.cdtype, call)
    return x, mel_tail, c0_tail


def bulk_transformer(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                     kv_lo=None) -> torch.Tensor:
    """32-layer no-ring transformer over [B, T, dim] at positions 0..T-1
    (banded attention), final-normed.  `kv_lo` (int [B]) hides leading
    positions.  On the kernel path (module docstring) one banded-attention
    launch per layer, at the config's (per-rank, on a tp mesh) head
    count."""
    e = cfg.encoder
    cdtype = cfg.cdtype
    bsz, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(positions, e.head_dim, e.rope_theta)
    qkv_dim = e.qkv_dim
    banded = (banded_attention_batched if _use_flash(e)
              else banded_attention_plain)
    # each norm is one add_rms_norm call with the residual add of the
    # previous product's output (and its bias) fused in; `tail` holds the
    # last FFN output still to add
    x, tail = x.to(cdtype), ()
    layers = enc_params["layers"]
    for li in range(e.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        x, xn = add_rms_norm(x, lp["attn_norm"], e.norm_eps, *tail)
        q, k, v = qkv_rope(mm(xn, lp, "wqkv"), cos, sin, n_heads=e.n_heads,
                           n_kv_heads=e.n_kv_heads, head_dim=e.head_dim,
                           bias=lp["bqkv"], q_dtype=cdtype, kv_dtype=cdtype)
        attn = banded(q, k, v, kv_lo, window=e.window, out_dtype=cdtype,
                      ).reshape(bsz, t, qkv_dim)
        # row-parallel products: on a tp mesh, summed over the ranks in
        # f32, the bias added once after the sum (parallel/mesh.py)
        x, hn = add_rms_norm(x, lp["ffn_norm"], e.norm_eps,
                             tp_sum(mm(attn, lp, "wo"), e), lp["bo"])
        g13 = mm(hn, lp, "w13")
        gate = silu(g13[..., : e.hidden]) * g13[..., e.hidden:]
        tail = (tp_sum(mm(gate.to(cdtype), lp, "w2"), e), lp["b2"])
    return add_rms_norm(x, enc_params["final_norm"], e.norm_eps, *tail)[1]


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
        "bulk",
    )
    y = bulk_transformer(enc_params, cfg, x)
    return adapter_forward(adapter_params, cfg, y, "bulk").float()


# the batched whole-clip encode under the JAX package's name: the port's
# bulk_encode_clip is batched-first already (one banded launch per layer
# for all clips)
bulk_encode_clips = bulk_encode_clip


def window_pad(cfg: VoxtralConfig, extra: int = 0) -> int:
    """Rows of encoder-INPUT context the window-recompute mode keeps
    (8-aligned).  The minimum (extra=0) is window - 1: every kept query
    sees its full layer-1 window.  Layer l reaches l * (window - 1) inputs
    back, so the recompute truncates deeper layers' receptive fields; each
    `extra` window of context makes it exact one attention hop deeper
    (through layer 1 + extra)."""
    return -(-((1 + extra) * (cfg.encoder.window - 1)) // 8) * 8


@torch.no_grad()
def window_encode_chunk(
    enc_params: PyTree,
    adapter_params: PyTree,
    cfg: VoxtralConfig,
    mel: torch.Tensor,        # [B, Q, 128], Q % 8 == 0
    mel_tail: torch.Tensor,   # [B, 2, 128]
    c0_tail: torch.Tensor,    # [B, 2, dim]
    xwin: torch.Tensor,       # [B, Wp, dim] last Wp conv outputs
    n_ctx: torch.Tensor,      # int [B]: valid rows at the END of xwin
):
    """Window-RECOMPUTE streaming encode: instead of a per-stream encoder
    KV ring, keep only the last Wp encoder INPUTS per stream and re-run the
    transformer over [context + chunk] each call, keeping the chunk's
    outputs.  Each stream's leading stale context is hidden by its own
    kv_lo = max(Wp - n_ctx, 0), so one batched banded call per layer
    serves every stream.

    The block-streaming APPROXIMATION of the JAX function: kept queries
    see their full layer-1 window, deeper layers see truncated context
    (size xwin with window_pad(cfg, extra=k) to push the truncation k hops
    deeper).  RoPE is relative, so the position shift adds nothing beyond
    reduction order.

    Returns (rows [B, Q//8, 3072] f32, new_mel_tail, new_c0_tail,
    new_xwin, new_n_ctx)."""
    if mel.dim() != 3 or mel.shape[1] % 8:
        raise ValueError(f"mel must be [B, Q, 128] with Q % 8 == 0, got "
                         f"{tuple(mel.shape)}")
    wp = xwin.shape[1]
    c1, new_mel_tail, new_c0_tail = _conv_stem(enc_params, cfg, mel,
                                               mel_tail, c0_tail, "bulk")
    t = c1.shape[1]
    x_full = torch.cat([xwin, c1.to(xwin.dtype)], dim=1)   # [B, Wp + t, dim]
    n_ctx = n_ctx.to(device=mel.device, dtype=torch.int32)
    kv_lo = torch.clamp(wp - n_ctx, min=0)
    y = bulk_transformer(enc_params, cfg, x_full, kv_lo)[:, wp:]
    rows = adapter_forward(adapter_params, cfg, y, "bulk").float()
    return (rows, new_mel_tail, new_c0_tail, x_full[:, t:],
            torch.clamp(n_ctx + t, max=wp))
