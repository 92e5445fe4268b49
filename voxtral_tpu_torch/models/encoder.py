"""Causal audio encoder (32 layers, window 750) + conv stem + adapter, for
the streaming path; batched-first ([B, ...], B=1 for one stream).

PyTorch counterpart of voxtral_tpu/models/encoder.py.  Processing a
sequence as one chunk or as any partition into chunks yields the same
results, because
  - the conv stem takes its 2-frame boundary tail as an explicit input
    (the stream state machine owns the tails, voxtral.c:537-715), and
  - the transformer attends through a ring KV cache with logical positions
    (vox_encoder_forward_incremental, voxtral_encoder.c:452-636).
The caches are updated IN PLACE (the JAX functions donate and return
them).

Conv stem contract (voxtral_kernels.c:293-340, python:327-338):
  conv0: causal conv1d(128->1280, k3, s1) + GELU
  conv1: causal conv1d(1280->1280, k3, s2) + GELU
Causal padding = k - s zeros on the left; with an explicit 2-frame tail of
zeros this is exactly "prepend tail, drop the first ceil((k-s)/s) outputs".

Chunk attention (EncoderConfig.attn_impl), for chunks of T > 1 rows after
`ring_chunk_write`:
  - "flash": ops/flash_encode.py (the hand-written CUDA kernel for CUDA
    tensors, its plain version for CPU tensors);
  - "xla":   the plain `ring_attention` over the whole ring with a mask;
  - "auto":  "flash" whenever the ring is a float type of >= 2 bytes or
    fp8 e4m3fn (the kernel widens e4m3 exactly as it loads it), at any B,
    for bf16 and float32 queries alike (the kernel has a float32
    instantiation, as the TPU kernel computes an f32 config in f32).  The
    JAX package resolves "auto" to xla from a TPU measurement
    (voxtral_tpu/ops/flash_encode.py STATUS) and keeps fp8 rings on xla
    (voxtral_tpu/models/encoder.py:132); on the GPU the plain path widens
    the whole ring to f32 and keeps an f32 [B, KH, G, T, cap] score tensor
    per layer, which the kernel never writes, and its batched einsums
    round a row by the rows and streams that share the call, so on the
    card an fp8 ring's chunk takes the kernel too (the rows' bits then
    follow neither the feed nor the batch).
Both compute the same function; decoder._use_flash holds the rule, for
the bulk encoder too.  A T == 1 chunk writes its slot directly and takes
`ring_attention`, as in the JAX package, but on the row-invariant route
(below) it attends through the chunk path like any other chunk
(`chunk_attention`), so that a row attends in the same order whatever the
size of its chunk.

Row invariance (decoder._use_rowinv): in a bf16 config the streaming side
here (conv stem, ring layers, adapter) takes the products whose rows' bits
do not depend on how many rows share a call (`quant.mm(rowinv=True)`,
`quant.matmul_rows`), so that a stream's rows do not depend on how its
audio was chunked (the norms' kernel, `ops/norms.py:add_rms_norm`, is
row-invariant on every path).  The bulk encoder passes call="bulk" to the
functions it shares with the stream and keeps torch.mm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..config import DOWNSAMPLE_FACTOR, EncoderConfig, VoxtralConfig
from ..ops.flash_encode import flash_bulk_attention_batched
from ..ops.graphs import GraphStore, graph_key
from ..ops.norms import add_rms_norm, gelu, silu
from ..ops.ring import ring_attention, ring_chunk_write, ring_rows_write_plain
from ..ops.rope import qkv_rope, rope_cos_sin
from ..parallel.mesh import tp_sum
from .decoder import _positions, _use_flash, _use_graph, _use_rowinv
from .quant import matmul_f32, matmul_rows, mm

PyTree = Any


@dataclasses.dataclass
class EncKVCache:
    """Per-layer encoder rings: k/v are [B, L, KH, cap, D].  Mutated in
    place by the encoder.  `graphs` holds the CUDA graphs captured on these
    buffers (None: the encoder runs this cache eagerly; ops/graphs.py)."""
    k: torch.Tensor
    v: torch.Tensor
    graphs: Optional[GraphStore] = dataclasses.field(
        default=None, compare=False, repr=False)

    @classmethod
    def create(cls, cfg: EncoderConfig, kv_dtype, cap: int | None = None,
               batch: int = 1, device="cpu",
               graphs: bool = True) -> "EncKVCache":
        cap = cap or cfg.kv_ring
        shape = (batch, cfg.n_layers, cfg.n_kv_heads, cap, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=kv_dtype, device=device),
                   torch.zeros(shape, dtype=kv_dtype, device=device),
                   GraphStore() if graphs else None)

    @property
    def batch(self) -> int:
        return self.k.shape[0]

    @property
    def device(self) -> torch.device:
        return self.k.device


# ---------------------------------------------------------------------------
# Conv stem
# ---------------------------------------------------------------------------

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


def _conv(enc_params: PyTree, name: str, stride: int, x: torch.Tensor,
          tail: torch.Tensor, cdtype, call: str):
    xin = torch.cat([tail, x], dim=-2)
    cols = _im2col(xin, 3, stride).to(cdtype)
    w = enc_params[f"{name}_w"]
    y = (matmul_rows(cols, w.t()) if _use_rowinv(cdtype, call)
         else matmul_f32(cols, w))
    y = gelu(y + enc_params[f"{name}_b"])
    return y.to(cdtype), xin[..., -2:, :]


def conv0_chunk(enc_params: PyTree, mel: torch.Tensor, tail: torch.Tensor,
                cdtype, call: str = "stream"):
    """mel: [B, T, 128]; tail: [B, 2, 128] (zeros for the first chunk) ->
    ([B, T, 1280] GELU'd conv0 output, new tail [B, 2, 128]).  `call`:
    decoder._use_rowinv's ("bulk" from the bulk encoder)."""
    return _conv(enc_params, "conv0", 1, mel, tail, cdtype, call)


def conv1_chunk(enc_params: PyTree, feed: torch.Tensor, tail: torch.Tensor,
                cdtype, call: str = "stream"):
    """feed: [B, F, 1280] (F even); tail: [B, 2, 1280] (zeros first) ->
    ([B, F//2, 1280], new tail [B, 2, 1280])."""
    return _conv(enc_params, "conv1", 2, feed, tail, cdtype, call)


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------

def chunk_attention(t: int, cdtype) -> bool:
    """Whether a streaming encoder chunk of t rows takes the chunk path
    (ring_chunk_write's attention: flash-encode where decoder._use_flash
    allows): T > 1, and on the row-invariant route T == 1 too.  The
    streams count these chunks (`n_enc_chunk_calls`)."""
    return t > 1 or _use_rowinv(cdtype, "stream")


def _enc_layer_step(cfg: EncoderConfig, cdtype, x, tail, lp,
                    cache: EncKVCache, li: int, pos0, cos, sin):
    """One ring-cache layer.  `tail` is the previous layer's FFN output
    still to add to the residual x, (y f32, its bias), or () before layer
    0: it is added in the call of this layer's attn_norm.  Returns (x,
    tail) for the next layer or the final norm; each norm is one
    `add_rms_norm` call with the residual add, the bias and the casts
    around it."""
    bsz, t, _ = x.shape
    qkv_dim = cfg.qkv_dim
    ri = _use_rowinv(cdtype, "stream")

    x, xn = add_rms_norm(x, lp["attn_norm"], cfg.norm_eps, *tail)
    # k and v in f32: the ring writes round them to the ring's dtype once
    q, k, v = qkv_rope(mm(xn, lp, "wqkv", ri), cos, sin,
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, bias=lp["bqkv"],
                       q_dtype=cdtype, kv_dtype=torch.float32)

    if t == 1:
        ring_rows_write_plain(cache.k, cache.v, k[:, 0], v[:, 0], li, pos0)
        k_ring, v_ring = cache.k[:, li], cache.v[:, li]
    else:
        _, _, k_ring, v_ring = ring_chunk_write(cache.k, cache.v, k, v, li,
                                                pos0)
    if chunk_attention(t, cdtype) and _use_flash(cfg, k_ring):
        attn = flash_bulk_attention_batched(
            q, k_ring, v_ring, pos0, window=cfg.window, out_dtype=cdtype)
    else:
        attn = ring_attention(q, k_ring, v_ring, pos0,
                              window=cfg.window, out_dtype=cdtype)
    attn = attn.reshape(bsz, t, qkv_dim)
    # row-parallel products: on a tp mesh, summed over the ranks in f32,
    # the bias added once after the sum (parallel/mesh.py)
    x, hn = add_rms_norm(x, lp["ffn_norm"], cfg.norm_eps,
                         tp_sum(mm(attn, lp, "wo", ri), cfg), lp["bo"])
    g13 = mm(hn, lp, "w13", ri)
    gate = silu(g13[..., : cfg.hidden]) * g13[..., cfg.hidden:]
    return x, (tp_sum(mm(gate.to(cdtype), lp, "w2", ri), cfg), lp["b2"])


def encoder_layers(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                   cache: EncKVCache, pos0: torch.Tensor) -> torch.Tensor:
    """The 32 ring-cache layers over x [B, T, dim] at per-stream positions
    pos0 int [B] .. pos0+T-1, final-normed; writes the rings in place.  On
    a CUDA device the chunk replays one CUDA graph per (B, T) captured on
    the cache (decoder._use_graph; ops/graphs.py), bit-equal to eager."""
    if not _use_graph(cfg, cache, x, "encoder"):
        return _encoder_layers(enc_params, cfg, x, cache, pos0)
    key = graph_key("encoder", enc_params, None, cfg, tuple(x.shape),
                    x.dtype, cache.k.data_ptr(), cache.v.data_ptr())
    _, y = cache.graphs.call(
        key, lambda x_, p_: _encoder_layers(enc_params, cfg, x_, cache, p_),
        (x, pos0), keep=(enc_params,))
    return y.clone()     # the graph's output is rewritten by its next replay


def _encoder_layers(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                    cache: EncKVCache, pos0: torch.Tensor) -> torch.Tensor:
    e = cfg.encoder
    cdtype = cfg.cdtype
    t = x.shape[1]
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32,
                                             device=x.device)
    cos, sin = rope_cos_sin(positions, e.head_dim, e.rope_theta)
    x, tail = x.to(cdtype), ()
    layers = enc_params["layers"]
    for li in range(e.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        x, tail = _enc_layer_step(e, cdtype, x, tail, lp, cache, li, pos0,
                                  cos, sin)
    return add_rms_norm(x, enc_params["final_norm"], e.norm_eps, *tail)[1]


@torch.no_grad()
def encode_chunk(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                 cache: EncKVCache, pos0):
    """Incremental encoder forward over one chunk x [B, T, 1280] (post-conv
    positions) at pos0 (int or int [B]); returns the final-normed chunk
    output [B, T, 1280] and the cache, updated in place."""
    return encoder_layers(enc_params, cfg, x, cache,
                          _positions(pos0, x.shape[0], x.device)), cache


def adapter_forward(adapter_params: PyTree, cfg: VoxtralConfig,
                    enc_out: torch.Tensor, call: str = "stream"
                    ) -> torch.Tensor:
    """[B, 4G, 1280] -> 4x downsample reshape -> MLP -> [B, G, 3072] in the
    compute dtype (voxtral_encoder.c:642-674, python:446-463).  No
    normalization.  On a tp mesh w0 is column- and w1 row-parallel, with
    one sum over the ranks (parallel/mesh.py).  `call`:
    decoder._use_rowinv's ("bulk" from the bulk encoder)."""
    cdtype = cfg.cdtype
    ri = _use_rowinv(cdtype, call)
    *lead, t, dim = enc_out.shape
    g = t // DOWNSAMPLE_FACTOR
    ds = enc_out.reshape(*lead, g, DOWNSAMPLE_FACTOR * dim).to(cdtype)
    h = gelu(mm(ds, adapter_params, "w0", ri)).to(cdtype)
    return tp_sum(mm(h, adapter_params, "w1", ri), cfg).to(cdtype)
