"""Ministral-3 decoder: prefill and burst decode, batched-first.

PyTorch counterpart of voxtral_tpu/models/decoder.py.  Every tensor carries
a leading stream axis B (B=1 for one clip): embeddings [B, T, dim], caches
[B, L, KH, cap, D], positions int [B].  `jit`/`scan` become eager Python
loops over layers and steps; CUDA graphs are later work.

  - The rolling KV cache is a fixed ring (ops/ring.py); RoPE uses logical
    positions, so ring reuse is exact.
  - Cache updates happen IN PLACE: where the JAX functions take the cache
    as a donated argument and return a new one, these mutate the tensors of
    the KVCache they are given and return that same KVCache.
  - Burst decode keeps the argmax token on the device and feeds it to the
    next step; the host reads the tokens once per burst.

Single-token decode attention (DecoderConfig.attn_impl):
  - "flash": ops/flash_decode.py writes the new K/V row and attends over
    the live window in one call (the hand-written CUDA kernel for CUDA
    tensors, its plain version for CPU tensors);
  - "xla":   the plain path: ring_rows_write (in-place row write: the
    hand-written CUDA kernel for CUDA tensors), then ring_attention over
    the whole ring with a mask;
  - "auto":  "flash" whenever the ring is a float type of >= 2 bytes or
    fp8 e4m3fn, at any B and any ring capacity.  The JAX package takes
    flash at B=1 only above FLASH_RING_THRESHOLD ring slots, and never on
    fp8 rings; both are TPU measurements (its decoder.py:116-130).  On the
    GPU the first would keep the kernel off every clip shorter than about
    72 s, and the second would widen the whole fp8 ring to f32 on every
    step, where the kernel reads only the live window at one byte per
    element (H100 timings of both paths: PERF.md section 6).
Both paths compute the same function; they differ only in the order of
float operations (and the plain path rounds its probabilities to the
matmul dtype).

Numerics follow python_simple_implementation.py:522-664: RMSNorm, RoPE,
softmax and logits in float32; matmuls take compute-dtype operands and
return float32 (models/quant.py, which also carries the int8 and int4
weight rungs: int4 products go through the hand-written int4 kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..config import TOKEN_TEXT_MIN, DecoderConfig, VoxtralConfig
from ..ops import quant_mm
from ..ops.flash_decode import flash_decode
from ..ops.norms import gelu, rms_norm, silu
from ..ops.ring import ring_attention, ring_rows_write, ring_write
from ..ops.rope import apply_rope_interleaved, rope_cos_sin
from ..parallel.mesh import tp_of, tp_sum
from . import quant

PyTree = Any


@dataclasses.dataclass
class KVCache:
    """Per-layer ring buffers: k/v are [B, L, KH, cap, D] (head-major, so the
    slot axis is contiguous per head).  Mutated in place by the decoder."""
    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: DecoderConfig, kv_dtype, cap: int | None = None,
               batch: int = 1, device="cpu") -> "KVCache":
        cap = cap or cfg.kv_ring
        shape = (batch, cfg.n_layers, cfg.n_kv_heads, cap, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=kv_dtype, device=device),
                   torch.zeros(shape, dtype=kv_dtype, device=device))


def time_embedding(t_value: float, dim: int, theta: float = 10_000.0,
                   device="cpu") -> torch.Tensor:
    """Sinusoidal embedding of the delay scalar -> [dim] float32
    (python_simple_implementation.py:344-349)."""
    half = dim // 2
    inv_freq = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=device) / half
    )
    emb = torch.tensor(t_value, dtype=torch.float32, device=device) * inv_freq
    return torch.cat([torch.cos(emb), torch.sin(emb)])


def ada_scales(dec_params: PyTree, cfg: VoxtralConfig) -> torch.Tensor:
    """Per-layer ada-RMSNorm scale for the configured delay:
    ada_up(GELU(ada_down(t_cond))) -> [L, dim] float32 (the reference
    precomputes it too, voxtral.c:57-79)."""
    lp = dec_params["layers"]
    down = lp["ada_down"]
    t_cond = time_embedding(float(cfg.delay_tokens), cfg.decoder.dim,
                            cfg.decoder.ada_theta, device=down.device)
    hid = gelu(torch.einsum("d,lad->la", t_cond, down.float()))
    return torch.einsum("la,lda->ld", hid, lp["ada_up"].float())


def _use_flash(cfg, ring: torch.Tensor | None = None,
               fp8: bool = False) -> bool:
    """Whether cfg.attn_impl (decoder or encoder config) takes the kernel
    path for this ring (module docstring): float rings of >= 2 bytes, and
    fp8 e4m3fn rings where the kernel reads them (`fp8`: the decoder's
    flash-decode does, unlike the JAX package's; the encoder's
    flash-encode does not).  No ring: the bulk encoder's banded attention,
    which reads plain activations.  The query's dtype plays no part: every
    kernel takes the compute dtypes (bf16, float32)."""
    if cfg.attn_impl == "xla":
        return False
    if cfg.attn_impl not in ("flash", "auto"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if ring is None:
        return True
    if ring.dtype == torch.float8_e4m3fn:
        return fp8
    return ring.dtype.is_floating_point and ring.element_size() >= 2


def _layer_step(
    cfg: DecoderConfig,
    cdtype,
    x: torch.Tensor,          # [B, T, dim]
    lp: PyTree,               # one layer's params (leading L axis indexed away)
    ada: torch.Tensor,        # [dim] f32
    cache: KVCache,           # [B, L, KH, cap, D], written in place
    li: int,                  # layer index
    pos0: torch.Tensor,       # int [B]: logical position of x[:, 0]
    cos: torch.Tensor,        # [B, T, D/2]
    sin: torch.Tensor,
) -> torch.Tensor:
    bsz, t, _ = x.shape
    q_dim = cfg.q_dim

    xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps).to(cdtype)
    qkv = quant.mm(xn, lp, "wqkv")                   # f32
    q = qkv[..., :q_dim].reshape(bsz, t, cfg.n_heads, cfg.head_dim)
    k = qkv[..., q_dim: q_dim + cfg.kv_dim].reshape(
        bsz, t, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[..., q_dim + cfg.kv_dim:].reshape(
        bsz, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope_interleaved(q, cos, sin)
    k = apply_rope_interleaved(k, cos, sin)

    if t == 1 and _use_flash(cfg, cache.k, fp8=True):
        # one call writes the row at pos % cap of layer li (in place) and
        # attends over the live window: one kernel launch per layer per step
        attn = flash_decode(
            q[:, 0].to(cdtype), cache.k, cache.v, li, pos0, k[:, 0], v[:, 0],
            window=cfg.window, out_dtype=cdtype,
        ).reshape(bsz, t, q_dim)
    else:
        k_ring, v_ring = cache.k[:, li], cache.v[:, li]      # views
        if t == 1:
            ring_rows_write(cache.k, cache.v, k[:, 0], v[:, 0], li, pos0)
        else:
            ring_write(k_ring, k, pos0)                      # in place
            ring_write(v_ring, v, pos0)
        attn = ring_attention(
            q.to(cdtype), k_ring, v_ring, pos0, window=cfg.window,
            out_dtype=cdtype,
        ).reshape(bsz, t, q_dim)

    # row-parallel products: on a tp mesh, summed over the ranks in f32
    # before the cast (parallel/mesh.py)
    x = x + tp_sum(quant.mm(attn, lp, "wo"), cfg).to(x.dtype)

    # ada-RMSNorm (python:607-616): the norm rounds to x's dtype first
    hn = rms_norm(x, lp["ffn_norm"], cfg.norm_eps).float()
    hn = (hn * (1.0 + ada)).to(cdtype)
    g13 = quant.mm(hn, lp, "w13")
    gate = silu(g13[..., : cfg.hidden]) * g13[..., cfg.hidden:]
    ffn = tp_sum(quant.mm(gate.to(cdtype), lp, "w2"), cfg)
    return x + ffn.to(x.dtype)


def decoder_forward(
    params: PyTree,
    cfg: VoxtralConfig,
    embeds: torch.Tensor,     # [B, T, dim] input embeddings
    cache: KVCache,
    pos0: torch.Tensor,       # int [B]
    ada: torch.Tensor,        # [L, dim] f32 precomputed ada scales
):
    """Run all layers over T embeddings per stream.  Writes the T positions'
    K/V into the cache in place.  Returns (hidden [B, T, dim], cache)."""
    d = cfg.decoder
    cdtype = cfg.cdtype
    bsz, t, _ = embeds.shape
    pos0 = _positions(pos0, bsz, embeds.device)
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32,
                                             device=embeds.device)
    cos, sin = rope_cos_sin(positions, d.head_dim, d.rope_theta)
    x = embeds.to(cdtype)
    layers = params["layers"]
    for li in range(d.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        x = _layer_step(d, cdtype, x, lp, ada[li], cache, li, pos0, cos, sin)
    return x, cache


def final_logits(params: PyTree, cfg: VoxtralConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """RMSNorm + tied-embedding logits with f32 accumulation (python:657-664).
    Operands stay in the embedding dtype; int8 and int4 tables take bf16
    activations.  x: [..., dim] -> [..., vocab] f32; on a tp mesh, this
    rank's slice of the vocab [..., vocab / tp] (parallel/mesh.py)."""
    emb = params["tok_embeddings"]
    s = params.get("tok_embeddings_scale")
    xn = rms_norm(x, params["final_norm"], cfg.decoder.norm_eps)
    if quant._is_packed4(emb, s):
        # nibble-packed int4 table, per-half scales [V, 2]: the int4 kernel
        y = quant_mm.int4_mm(xn.to(torch.bfloat16).reshape(-1, x.shape[-1]),
                             emb[None], s[None], 0)
        return y.reshape(*x.shape[:-1], emb.shape[0])
    if emb.dtype == torch.int8:
        # int8 table: widened to bf16 for the product, rescaled per vocab row
        return quant.matmul_f32(xn.to(torch.bfloat16),
                                emb.to(torch.bfloat16).t()) * s
    return quant.matmul_f32(xn.to(emb.dtype), emb.t())


@torch.no_grad()
def prefill(params: PyTree, cfg: VoxtralConfig, embeds: torch.Tensor,
            cache: KVCache, pos0, ada: torch.Tensor) -> KVCache:
    """Teacher-forced prefill: write KV for `embeds` [B, T, dim] into the
    cache (in place), discard hidden states (vox_decoder_prefill analog,
    voxtral_decoder.c:410-558).  `params` is the decoder subtree."""
    decoder_forward(params, cfg, embeds, cache, pos0, ada)
    return cache


def _alts_from_logits(logits: torch.Tensor, n_alt: int):
    """Top-`n_alt` text-range candidates (ids >= TOKEN_TEXT_MIN) by
    probability, plus the argmax token and its probability.  logits [B, V]
    f32 -> (best [B], best_prob [B], alt_ids [B, n_alt], alt_probs
    [B, n_alt]).  Iterated argmaxes, so ties resolve to the first index as
    in the JAX function."""
    probs = torch.softmax(logits, dim=-1)
    best = torch.argmax(logits, dim=-1)
    best_prob = probs.gather(-1, best[:, None])[:, 0]
    rem = probs[:, TOKEN_TEXT_MIN:].clone()
    vals, idxs = [], []
    for _ in range(n_alt):
        j = torch.argmax(rem, dim=-1, keepdim=True)
        vals.append(rem.gather(-1, j))
        idxs.append(j)
        rem.scatter_(-1, j, float("-inf"))
    top_p = torch.cat(vals, dim=-1)
    top_i = torch.cat(idxs, dim=-1).to(torch.int32) + TOKEN_TEXT_MIN
    return best.to(torch.int32), best_prob, top_i, top_p


@torch.no_grad()
def decode_burst(
    params: PyTree,
    cfg: VoxtralConfig,
    adapter_chunk: torch.Tensor,   # [B, T, dim] audio embeddings at pos0..
    prev_token: torch.Tensor,      # int [B] (or [1]), on the device
    cache: KVCache,
    pos0,                          # int [B] (or int): position of step 0
    ada: torch.Tensor,             # [L, dim]
    n_alt: int = 0,
):
    """Greedy burst decode of T steps per stream with on-device token
    feedback: step t embeds adapter_chunk[:, t] + tok_embeddings[prev],
    runs the decoder, takes the argmax.

    Returns (tokens [B, T] i32, alt_ids [B, T, n_alt] i32, alt_probs
    [B, T, n_alt] f32, best_probs [B, T] f32, cache), all on the device:
    nothing here waits for the device.  Post-EOS steps still run; the host
    discards them (the reference never decodes again without a cache reset
    after EOS, voxtral.c:1049, 1137-1186)."""
    bsz, t_total, _ = adapter_chunk.shape
    dev = adapter_chunk.device
    pos0 = _positions(pos0, bsz, dev)
    prev = prev_token.to(device=dev, dtype=torch.int32).reshape(-1).expand(bsz)
    tp = tp_of(cfg)
    toks, alt_i, alt_p, best_p = [], [], [], []
    for t in range(t_total):
        embed = (adapter_chunk[:, t].float()
                 + quant.embed_rows(params, prev, tp=tp))[:, None]
        x, _ = decoder_forward(params, cfg, embed, cache, pos0 + t, ada)
        logits = final_logits(params, cfg, x)[:, 0]
        if n_alt > 0:
            if tp is not None:
                logits = tp.gather_last(logits)
            prev, bp, ai, ap = _alts_from_logits(logits, n_alt)
            best_p.append(bp)
            alt_i.append(ai)
            alt_p.append(ap)
        elif tp is not None:
            prev = tp.argmax(logits)
        else:
            prev = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(prev)
    tokens = torch.stack(toks, dim=1)
    if n_alt > 0:
        return (tokens, torch.stack(alt_i, dim=1), torch.stack(alt_p, dim=1),
                torch.stack(best_p, dim=1), cache)
    return (tokens,
            torch.zeros((bsz, t_total, 0), dtype=torch.int32, device=dev),
            torch.zeros((bsz, t_total, 0), dtype=torch.float32, device=dev),
            torch.zeros((bsz, t_total), dtype=torch.float32, device=dev),
            cache)


def _positions(pos, bsz: int, device) -> torch.Tensor:
    """An int or int tensor of positions -> int32 [B] on `device`."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(bsz)
    return torch.full((bsz,), int(pos), dtype=torch.int32, device=device)
