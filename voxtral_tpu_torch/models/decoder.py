"""Ministral-3 decoder: prefill and burst decode, batched-first.

PyTorch counterpart of voxtral_tpu/models/decoder.py.  Every tensor carries
a leading stream axis B (B=1 for one clip): embeddings [B, T, dim], caches
[B, L, KH, cap, D], positions int [B].  `jit`/`scan` become eager Python
loops over layers and steps.  On a CUDA device a burst's steps replay
one CUDA graph of the whole step (ops/graphs.py; `_use_graph` holds the
rule), captured on the cache at its first step.

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
from typing import Any, Optional

import torch

from ..config import TOKEN_TEXT_MIN, DecoderConfig, VoxtralConfig
from ..ops import quant_mm
from ..ops.flash_decode import flash_decode
from ..ops.graphs import GraphStore, graph_key
from ..ops.norms import add_rms_norm, gelu, silu
from ..ops.ring import ring_attention, ring_rows_write, ring_write
from ..ops.rope import qkv_rope, rope_cos_sin
from ..parallel.mesh import tp_of, tp_sum
from . import quant

PyTree = Any


@dataclasses.dataclass
class KVCache:
    """Per-layer ring buffers: k/v are [B, L, KH, cap, D] (head-major, so the
    slot axis is contiguous per head).  Mutated in place by the decoder.
    `graphs` holds the CUDA graphs captured on these buffers (None: the
    decoder runs this cache eagerly; ops/graphs.py)."""
    k: torch.Tensor
    v: torch.Tensor
    graphs: Optional[GraphStore] = dataclasses.field(
        default=None, compare=False, repr=False)

    @classmethod
    def create(cls, cfg: DecoderConfig, kv_dtype, cap: int | None = None,
               batch: int = 1, device="cpu", graphs: bool = True) -> "KVCache":
        cap = cap or cfg.kv_ring
        shape = (batch, cfg.n_layers, cfg.n_kv_heads, cap, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=kv_dtype, device=device),
                   torch.zeros(shape, dtype=kv_dtype, device=device),
                   GraphStore() if graphs else None)


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


def _use_flash(cfg, ring: torch.Tensor | None = None) -> bool:
    """Whether cfg.attn_impl (decoder or encoder config) takes the kernel
    path for this ring (module docstring): float rings of >= 2 bytes and
    fp8 e4m3fn rings, which both attention kernels read (flash-decode and
    flash-encode widen e4m3 as they load it; the JAX package keeps fp8
    rings on its plain path, a deliberate divergence: the same function,
    since e4m3 widens exactly).  No ring: the bulk encoder's banded
    attention, which reads plain activations.  The query's dtype plays no
    part: every kernel takes the compute dtypes (bf16, float32)."""
    if cfg.attn_impl == "xla":
        return False
    if cfg.attn_impl not in ("flash", "auto"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if ring is None:
        return True
    return ring.dtype == torch.float8_e4m3fn or (
        ring.dtype.is_floating_point and ring.element_size() >= 2)


# the calls that replay as CUDA graphs (ops/graphs.py); every other call
# ("prefill": the decoder at T > 1 outside Jacobi; "bulk": the bulk
# encoder and window_encode_chunk) runs eagerly
GRAPHED_CALLS = ("step", "encoder", "jacobi")


def _use_graph(cfg, cache, x: torch.Tensor, call: str) -> bool:
    """Whether `call` on x replays as a CUDA graph captured on `cache`
    (ops/graphs.py): a call of GRAPHED_CALLS on a CUDA device, on a cache
    made with graphs on, off a tp > 1 mesh (its all-reduces run through
    gloo on the host).  Everything else runs eagerly: CPU tensors, the
    prefill and bulk calls, tp > 1, and caches made with graphs off
    (`VoxtralEngine(cuda_graphs=False)`, the switch)."""
    return (call in GRAPHED_CALLS and x.device.type == "cuda"
            and cache.graphs is not None and tp_of(cfg) is None)


# the callers whose products take the row-invariant route in a bf16
# config: the streaming encoder side and the decoder
ROWINV_CALLS = ("stream", "decoder")


def _use_rowinv(cdtype, call: str) -> bool:
    """Whether `call`'s products take the row-invariant kernels
    (ops/bf16_mm.py, the int4 and int8 kernels' row-invariant plans),
    whose rows' bits do not depend on how many rows share a call.  The
    rule: in a bf16 config (the bf16, fp8kv, int8 and int4 rungs: their
    activations are bf16) a row that one stream owns depends only on that
    stream's inputs and the weights, never on how many streams or rows
    share the call.  So both callers of ROWINV_CALLS take the route: the
    streaming encoder side ("stream": the conv stem, the ring layers and
    the adapter of a streaming chunk, whose row count follows the feed),
    and the decoder ("decoder": every call of it, a step's B rows, a
    prefill's B x T, a Jacobi window's; the tied-embedding logits too, and
    the ring path's attention products, `ring_attention(per_stream=True)`;
    flash-decode's split takes no batch size and the norms' kernel none
    either), so that a stream's transcript depends neither on how its
    audio was chunked nor on how many streams share its decode.  On a
    tp > 1 mesh the same rule holds for each rank's shards (the simplest;
    its all-reduces still sum in rank order).  Everything else keeps
    torch.mm: the bulk encoder and window mode ("bulk": one chunk per
    clip, or a recompute by design), and float32 configs (the witnesses).
    The device plays no part: on CPU tensors the wrappers take their
    plain versions."""
    return call in ROWINV_CALLS and cdtype == torch.bfloat16


def _layer_step(
    cfg: DecoderConfig,
    cdtype,
    x: torch.Tensor,          # [B, T, dim] the residual
    y: torch.Tensor | None,   # [B, T, dim] f32: the FFN output still to add
    lp: PyTree,               # one layer's params (leading L axis indexed away)
    ada: torch.Tensor,        # [dim] f32
    cache: KVCache,           # [B, L, KH, cap, D], written in place
    li: int,                  # layer index
    pos0: torch.Tensor,       # int [B]: logical position of x[:, 0]
    cos: torch.Tensor,        # [B, T, D/2]
    sin: torch.Tensor,
):
    """One layer.  The previous layer's FFN output y (None before layer 0)
    is added to the residual x in the call of this layer's attn_norm, and
    this layer's own is handed on: returns (x, y) for the next layer (or
    the final norm, `final_logits`).  Each norm is one `add_rms_norm` call
    with the residual add, the ada scale and the casts around it, as XLA
    fuses them into one pass."""
    bsz, t, _ = x.shape
    q_dim = cfg.q_dim
    ri = _use_rowinv(cdtype, "decoder")

    x, xn = add_rms_norm(x, lp["attn_norm"], cfg.norm_eps, y=y)
    # q rotated in the compute dtype; k rotated and v in f32, rounded to
    # the ring's dtype once, by the row write
    q, k, v = qkv_rope(quant.mm(xn, lp, "wqkv", rowinv=ri), cos, sin,
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, q_dtype=cdtype,
                       kv_dtype=torch.float32)

    if t == 1 and _use_flash(cfg, cache.k):
        # one call writes the row at pos % cap of layer li (in place) and
        # attends over the live window: one kernel launch per layer per step
        attn = flash_decode(
            q[:, 0], cache.k, cache.v, li, pos0, k[:, 0], v[:, 0],
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
            q, k_ring, v_ring, pos0, window=cfg.window,
            out_dtype=cdtype, per_stream=ri,
        ).reshape(bsz, t, q_dim)

    # row-parallel products: on a tp mesh, summed over the ranks in f32
    # before the cast (parallel/mesh.py); the residual add and the
    # ada-RMSNorm (python:607-616: the norm rounds to x's dtype first)
    x, hn = add_rms_norm(
        x, lp["ffn_norm"], cfg.norm_eps,
        y=tp_sum(quant.mm(attn, lp, "wo", rowinv=ri), cfg), ada=ada)
    g13 = quant.mm(hn, lp, "w13", rowinv=ri)
    gate = silu(g13[..., : cfg.hidden]) * g13[..., cfg.hidden:]
    return x, tp_sum(quant.mm(gate.to(cdtype), lp, "w2", rowinv=ri), cfg)


def decoder_forward(
    params: PyTree,
    cfg: VoxtralConfig,
    embeds: torch.Tensor,     # [B, T, dim] input embeddings
    cache: KVCache,
    pos0: torch.Tensor,       # int [B]
    ada: torch.Tensor,        # [L, dim] f32 precomputed ada scales
):
    """Run all layers over T embeddings per stream.  Writes the T positions'
    K/V into the cache in place.  Returns (hidden [B, T, dim], cache): the
    last layer's FFN output is added here in torch (the callers that go on
    to the logits take `decoder_layers` and fuse that add into the final
    norm instead)."""
    x, y = decoder_layers(params, cfg, embeds, cache, pos0, ada)
    return x + y.to(x.dtype), cache


def decoder_layers(
    params: PyTree,
    cfg: VoxtralConfig,
    embeds: torch.Tensor,     # [B, T, dim] input embeddings
    cache: KVCache,
    pos0: torch.Tensor,       # int [B]
    ada: torch.Tensor,        # [L, dim] f32 precomputed ada scales
):
    """`decoder_forward` without the last residual add: returns (x, y),
    the residual before the last layer's FFN output y (f32) is added,
    for `final_logits(params, cfg, x, y)`.  Writes the cache in place."""
    d = cfg.decoder
    cdtype = cfg.cdtype
    bsz, t, _ = embeds.shape
    pos0 = _positions(pos0, bsz, embeds.device)
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32,
                                             device=embeds.device)
    cos, sin = rope_cos_sin(positions, d.head_dim, d.rope_theta)
    x, y = embeds.to(cdtype), None
    layers = params["layers"]
    for li in range(d.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        x, y = _layer_step(d, cdtype, x, y, lp, ada[li], cache, li, pos0,
                           cos, sin)
    return x, y


def final_logits(params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor:
    """RMSNorm + tied-embedding logits with f32 accumulation (python:657-664),
    of x, or with y (`decoder_layers`' pending FFN output) of x + y, the
    add fused into the norm's call.
    Operands stay in the embedding dtype; int8 and int4 tables take bf16
    activations.  x: [..., dim] -> [..., vocab] f32; on a tp mesh, this
    rank's slice of the vocab [..., vocab / tp] (parallel/mesh.py).  On
    the row-invariant route (`_use_rowinv(cfg.cdtype, "decoder")`) a bf16
    table goes through `quant.matmul_rows` and the int tables through
    their kernels' row-invariant plans."""
    emb = params["tok_embeddings"]
    s = params.get("tok_embeddings_scale")
    ri = _use_rowinv(cfg.cdtype, "decoder")
    _, xn = add_rms_norm(x, params["final_norm"], cfg.decoder.norm_eps, y=y)
    if quant._is_packed4(emb, s):
        # nibble-packed int4 table, per-half scales [V, 2]: the int4 kernel
        lg = quant_mm.int4_mm(xn.to(torch.bfloat16).reshape(-1, x.shape[-1]),
                              emb[None], s[None], 0, rowinv=ri)
        return lg.reshape(*x.shape[:-1], emb.shape[0])
    if emb.dtype == torch.int8:
        # int8 table, one scale per vocab row [V]: the int8 kernel
        lg = quant_mm.int8_mm(xn.to(torch.bfloat16).reshape(-1, x.shape[-1]),
                              emb[None], s[None], 0, rowinv=ri)
        return lg.reshape(*x.shape[:-1], emb.shape[0])
    if ri and emb.dtype == torch.bfloat16:
        return quant.matmul_rows(xn.to(emb.dtype), emb)
    return quant.matmul_f32(xn.to(emb.dtype), emb.t())


@torch.no_grad()
def prefill(params: PyTree, cfg: VoxtralConfig, embeds: torch.Tensor,
            cache: KVCache, pos0, ada: torch.Tensor) -> KVCache:
    """Teacher-forced prefill: write KV for `embeds` [B, T, dim] into the
    cache (in place), discard hidden states (vox_decoder_prefill analog,
    voxtral_decoder.c:410-558).  `params` is the decoder subtree."""
    decoder_layers(params, cfg, embeds, cache, pos0, ada)
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


def _step(params: PyTree, cfg: VoxtralConfig, row: torch.Tensor,
          prev: torch.Tensor, pos: torch.Tensor, cache: KVCache,
          ada: torch.Tensor, n_alt: int):
    """One decode step of B streams: embed row [B, dim] + the embedding of
    prev int [B], every layer at positions pos int [B] (writing their K/V),
    the logits and the argmax.  Returns (token [B] i32,) or, with n_alt,
    (token, best_prob, alt_ids, alt_probs)."""
    tp = tp_of(cfg)
    embed = (row.float() + quant.embed_rows(params, prev, tp=tp))[:, None]
    x, y = decoder_layers(params, cfg, embed, cache, pos, ada)
    logits = final_logits(params, cfg, x, y)[:, 0]
    if n_alt > 0:
        if tp is not None:
            logits = tp.gather_last(logits)
        return _alts_from_logits(logits, n_alt)
    if tp is not None:
        return (tp.argmax(logits),)
    return (torch.argmax(logits, dim=-1).to(torch.int32),)


def _graphed_steps(params, cfg, adapter_chunk, prev, cache, pos0, ada,
                   n_alt: int, outs: list):
    """The burst's steps as replays of one CUDA graph of `_step` on this
    cache (ops/graphs.py): prev and pos live in the graph's static inputs,
    and the graph advances them itself; between replays only the step's
    adapter row goes in and its outputs come out, into `outs` (the burst's
    [B, T, ...] tensors).  The key's first step runs eagerly, then is
    captured."""
    bsz, t_total, _ = adapter_chunk.shape

    def body(row, prev_s, pos_s):
        out = _step(params, cfg, row, prev_s, pos_s, cache, ada, n_alt)
        prev_s.copy_(out[0])
        pos_s.add_(1)
        return out

    key = graph_key("step", params, ada, cfg, bsz, n_alt,
                    adapter_chunk.dtype, cache.k.data_ptr(),
                    cache.v.data_ptr())
    graph, t0 = cache.graphs.lookup(key), 0
    if graph is None:
        graph, out = cache.graphs.call(
            key, body, (adapter_chunk[:, 0], prev, pos0), keep=(params, ada))
        for dst, src in zip(outs, out):
            dst[:, 0].copy_(src)
        t0 = 1
    else:
        graph.static[1].copy_(prev)
        graph.static[2].copy_(pos0)
    for t in range(t0, t_total):
        for dst, src in zip(outs, graph(adapter_chunk[:, t], None, None)):
            dst[:, t].copy_(src)


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
    runs the decoder, takes the argmax.  On a CUDA device every step
    replays one CUDA graph (`_use_graph`); the results are bit-equal to
    the eager loop's.

    Returns (tokens [B, T] i32, alt_ids [B, T, n_alt] i32, alt_probs
    [B, T, n_alt] f32, best_probs [B, T] f32, cache), all on the device:
    nothing here waits for the device.  Post-EOS steps still run; the host
    discards them (the reference never decodes again without a cache reset
    after EOS, voxtral.c:1049, 1137-1186)."""
    bsz, t_total, _ = adapter_chunk.shape
    dev = adapter_chunk.device
    pos0 = _positions(pos0, bsz, dev)
    prev = prev_token.to(device=dev, dtype=torch.int32).reshape(-1).expand(bsz)
    if _use_graph(cfg, cache, adapter_chunk, "step"):
        tokens = torch.empty((bsz, t_total), dtype=torch.int32, device=dev)
        alt_i = torch.empty((bsz, t_total, n_alt), dtype=torch.int32,
                            device=dev)
        alt_p = torch.empty((bsz, t_total, n_alt), dtype=torch.float32,
                            device=dev)
        best_p = torch.zeros((bsz, t_total), dtype=torch.float32, device=dev)
        outs = [tokens, best_p, alt_i, alt_p] if n_alt > 0 else [tokens]
        if t_total:
            _graphed_steps(params, cfg, adapter_chunk, prev, cache, pos0, ada,
                           n_alt, outs)
        return tokens, alt_i, alt_p, best_p, cache
    toks, alt_i, alt_p, best_p = [], [], [], []
    for t in range(t_total):
        out = _step(params, cfg, adapter_chunk[:, t], prev, pos0 + t, cache,
                    ada, n_alt)
        prev = out[0]
        toks.append(prev)
        if n_alt > 0:
            best_p.append(out[1])
            alt_i.append(out[2])
            alt_p.append(out[3])
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
