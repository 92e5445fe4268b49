"""Flash encode: T-row sliding-window attention over the encoder's KV ring.

For stream b the chunk's queries sit at positions pos0[b] .. pos0[b]+T-1
and their K/V rows are already in the ring (ops/ring.py ring_chunk_write).
With pos_hi = pos0 + T - 1, slot s holds the logical position
l(s) = pos_hi - ((pos_hi - s) mod cap), and the query at position q sees it
iff 0 <= l(s) <= q and l(s) > q - window.  Scores are q.k / sqrt(D) in
float32, the softmax is float32, and the probabilities are rounded to the
query's dtype (the compute dtype) before the PV product, which accumulates
in float32; the ring is read in the query's dtype.  A row that sees no key
gets 0.

`flash_bulk_attention_batched` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/flash_encode.cu` (it
    replaces the Pallas kernel voxtral_tpu/ops/flash_encode.py:_kernel; its
    header says what bounds it on the H100 and how it is laid out; its core
    is the attention tile `csrc/attn_tile.cuh`, shared with the banded
    kernel).  It takes bf16 queries, or float32 ones (a float32 config:
    the f32 row walk of `csrc/attn_f32.cuh`, which reads the ring as f32
    and has no split), with head_dim 64 and bf16 or f32 rings,
    reads the rings in place through their strides (pass the layer's view
    of the stacked cache, `k_all[:, li]`), and raises on anything else: fp8
    rings stay on the plain `ring_attention` path (models/encoder.py).  It
    walks the ring's blocks in absolute slot order, split into the
    segments of `flash_encode_segments(cap)` (a function of cap alone),
    whose partial rows it combines in segment order, so its output is
    bitwise the same however the feed was chunked, at every B.
    `flash_encode_split_plain` is that split in plain PyTorch.
  * CPU tensors take `flash_encode_plain`, the same function in plain
    PyTorch.  The CPU tests hold it against the JAX kernel, and the GPU
    smoke run holds the kernel against it.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .ring import slot_logical_positions

# query rows per block of the kernel (csrc/attn_tile.cuh BQ; a 128-row
# tile measured slower, PERF.md section 6)
TILE_ROWS = 64
BLOCK = 64          # ring slots per block of the kernel's walk
MAX_SEGMENTS = 8    # blocks of one thread-block cluster (portable size)


def flash_encode_segments(cap: int) -> int:
    """The kernel's segment plan: into how many segments of consecutive
    ring blocks the walk over a ring of `cap` slots is split (segment s
    covers blocks [s n // S, (s + 1) n // S) of the n = ceil(cap / 64)).
    A function of cap alone, never of B, T or the positions, so that a
    row's rounding is the same under every chunking of the feed: about four
    blocks per segment, at most 8 segments (4 for the 1024-slot ring)."""
    n_blocks = -(-cap // BLOCK)
    return max(1, min(MAX_SEGMENTS, n_blocks // 4))


def _logical_mask(pos0, t: int, cap: int, window: int, device):
    """[B, T, cap] validity of ring slots for the chunk's query rows."""
    lpos = slot_logical_positions(pos0 + (t - 1), cap)[:, None, :]  # [B,1,cap]
    q_pos = (pos0[:, None]
             + torch.arange(t, device=device, dtype=pos0.dtype))[:, :, None]
    return (lpos >= 0) & (lpos <= q_pos) & (lpos > q_pos - window)


def flash_encode_plain(q, k_ring, v_ring, pos0, *, window: int,
                       out_dtype=None):
    """Plain PyTorch flash encode: q [B,T,H,D], rings [B,KH,cap,D], pos0
    int [B] -> [B,T,H,D] in out_dtype (default q.dtype).  Operands in q's
    dtype are widened to f32, which is exact for the products."""
    bsz, t, h, d = q.shape
    _, kh, cap, _ = k_ring.shape
    g = h // kh
    out_dtype = out_dtype or q.dtype
    pos0 = pos0.to(device=q.device).reshape(bsz)
    valid = _logical_mask(pos0, t, cap, window, q.device)[:, None, None]
    # valid: [B,1,1,T,cap]
    qg = q.reshape(bsz, t, kh, g, d).float()
    kf = k_ring.to(q.dtype).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qg, kf) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)                                  # masked -> 0
    l = p.sum(dim=-1, keepdim=True)                            # [B,KH,G,T,1]
    acc = torch.einsum("bkgts,bksd->bkgtd", p.to(q.dtype).float(),
                       v_ring.to(q.dtype).float())
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(bsz, t, h, d).to(out_dtype)


def flash_encode_split_plain(q, k_ring, v_ring, pos0, *, window: int,
                             segments: int | None = None, out_dtype=None):
    """The kernel's split walk in plain PyTorch, the same function as
    `flash_encode_plain`: the ring's slots are cut into the segments of
    `flash_encode_segments(cap)` (or `segments`); each gives every row a
    partial max m_s, sum l_s and output O_s over its own slots, with the
    probabilities rounded to q's dtype against m_s; the partials are folded
    into a running (M, L, O) in segment order: with M' = max(M, m_s),
    L = L e^(M - M') + l_s e^(m_s - M'), likewise O, and the row is O / L.
    A segment with no valid slot for a row contributes exactly 0; a row
    with no valid slot at all gets 0."""
    bsz, t, h, d = q.shape
    _, kh, cap, _ = k_ring.shape
    g = h // kh
    out_dtype = out_dtype or q.dtype
    n_seg = segments or flash_encode_segments(cap)
    n_blocks = -(-cap // BLOCK)
    pos0 = pos0.to(device=q.device).reshape(bsz)
    valid = _logical_mask(pos0, t, cap, window, q.device)[:, None, None]
    qg = q.reshape(bsz, t, kh, g, d).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qg,
                          k_ring.to(q.dtype).float()) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~valid, float("-inf"))       # [B,KH,G,T,cap]
    vf = v_ring.to(q.dtype).float()
    parts = []
    for s in range(n_seg):
        lo = min(cap, s * n_blocks // n_seg * BLOCK)
        hi = min(cap, (s + 1) * n_blocks // n_seg * BLOCK)
        sc = scores[..., lo:hi]
        m = sc.amax(dim=-1, keepdim=True)                      # -inf: empty
        p = torch.exp(sc - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m)))   # masked -> 0
        o = torch.einsum("bkgts,bksd->bkgtd", p.to(q.dtype).float(),
                         vf[:, :, lo:hi])
        parts.append((m, p.sum(dim=-1, keepdim=True), o))
    big_m = torch.full_like(parts[0][0], float("-inf"))
    tot = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, l, o in parts:               # folded one by one, in segment order
        mn = torch.maximum(big_m, m)
        live = torch.isfinite(mn)
        a = torch.where(live & torch.isfinite(big_m), torch.exp(big_m - mn),
                        torch.zeros_like(mn))
        b = torch.where(live & torch.isfinite(m), torch.exp(m - mn),
                        torch.zeros_like(mn))
        tot = tot * a + l * b
        acc = acc * a + o * b
        big_m = mn
    out = torch.where(tot > 0, acc / tot.clamp_min(1e-30),
                      torch.zeros_like(acc))
    return out.permute(0, 3, 1, 2, 4).reshape(bsz, t, h, d).to(out_dtype)


def flash_bulk_attention_batched(q, k_ring, v_ring, pos0, *, window: int,
                                 out_dtype=None, split: bool | None = None):
    """Sliding-window attention of a T-row chunk over its layer's ring.
    q [B,T,H,D]; k_ring/v_ring [B,KH,cap,D] (views of the stacked cache are
    read in place); pos0 int [B] -> [B,T,H,D].  The kernel's walk is split
    as `flash_encode_segments(cap)` says.  `split` maps the segments to
    blocks: True, one block each (a cluster per query tile); False, one
    block walks them all; None, one block each when the query tiles
    (ceil(T / 64) x H x B) would not fill two waves of the card's SMs.  It
    changes no bit of the output.  CPU and float32 queries: ignored."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return flash_encode_plain(q, k_ring, v_ring, pos0, window=window,
                                  out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_encode on {q.device}")
    bsz, t, h, d = q.shape
    _, kh, cap, _ = k_ring.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("flash-encode kernel: q must be bf16 or f32, got "
                         f"{q.dtype}")
    rdt = k_ring.dtype
    if rdt not in (torch.bfloat16, torch.float32) or v_ring.dtype != rdt:
        raise ValueError("flash-encode kernel takes bf16 or f32 rings, got "
                         f"{rdt}, {v_ring.dtype}")
    if d != 64:
        raise ValueError(f"flash-encode kernel supports head_dim 64, got {d}")
    if (k_ring.shape != (bsz, kh, cap, d) or v_ring.shape != k_ring.shape
            or h % kh):
        raise ValueError(f"flash-encode kernel: shapes q{tuple(q.shape)} "
                         f"rings {tuple(k_ring.shape)} {tuple(v_ring.shape)}")
    if k_ring.stride() != v_ring.stride() or k_ring.stride(-1) != 1:
        raise ValueError("flash-encode kernel: rings need equal strides and "
                         "a contiguous head_dim")
    # 16-byte row loads: row starts aligned for both ring dtypes
    if any(s * k_ring.element_size() % 16 for s in k_ring.stride()[:3]) or any(
            r.data_ptr() % 16 for r in (k_ring, v_ring)):
        raise ValueError("flash-encode kernel: ring rows must be 16-byte "
                         "aligned")
    for x in (k_ring, v_ring):
        if x.device != q.device:
            raise ValueError(f"flash-encode kernel: ring on {x.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash-encode kernel: out_dtype {out_dtype}")
    if split is None:
        tiles = -(-t // TILE_ROWS) * h * bsz
        split = tiles < 2 * cuda_lib.sm_count(q.device)
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("flash-encode kernel: q must be 16-byte aligned")
    pos32 = pos0.to(device=q.device, dtype=torch.int32).reshape(bsz)
    pos32 = pos32.contiguous()
    out = torch.empty((bsz, t, h, d), dtype=out_dtype, device=q.device)
    sb, sh, ss, _ = k_ring.stride()
    lib = cuda_lib.kernels()
    err = lib.vt_flash_encode(
        q.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(), pos32.data_ptr(),
        out.data_ptr(), bsz, t, h, kh, d, cap, window, sb, sh, ss,
        int(q.dtype == torch.float32), int(rdt == torch.float32), int(out_dtype == torch.float32),
        flash_encode_segments(cap), int(split),
        cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, "flash_encode")
    flash_bulk_attention_batched.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
flash_bulk_attention_batched.launches = 0
