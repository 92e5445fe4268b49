"""Flash-decode: single-token GQA attention over the stacked KV ring, with
an optional in-place write of this step's K/V row.

For stream b at query position pos[b] the live window is the last
valid = min(pos + 1, window, cap) logical positions, held at ring slots
(pos - valid + 1 .. pos) mod cap of layer `li` (the JAX package's `_info`
arithmetic).  With k_rows/v_rows given, the row is first written at slot
pos % cap of layer li, in place (cast to the ring dtype as
`ops/ring.py:to_ring_dtype` casts: fp8 saturates at +-448), and attention
sees it there.  Softmax and accumulation are float32; the result is in
out_dtype.

`flash_decode` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/flash_decode.cu`, one
    launch per call doing the row write and the attention, and nothing
    else (it replaces the Pallas kernels `_kernel`, `_kernel_flat` and
    `_kernel_flat_fused` of voxtral_tpu/ops/flash_decode.py, and the B=1
    row write before them).  It takes f32, bf16 or fp8 e4m3fn rings with
    head_dim 128, q in bf16 or f32, rows in f32 or the ring dtype, and
    writes a bf16 or f32 output; it raises on anything else.  The window
    is split into `flash_decode_splits(min(cap, window), KH)` ranges,
    whose partials the kernel folds in split order; the split does not
    depend on B and only the mapping does (`flash_decode_cluster`: a
    cluster of blocks, or one block walking the ranges), so a stream's
    output has the same bits at every batch size and on every call.
    `flash_decode_split_plain` models the split's arithmetic in plain
    PyTorch.
  * CPU tensors take `flash_decode_plain`, the same function in plain
    PyTorch: the in-place row write of `ring_rows_write_plain`, then masked
    softmax attention over the whole ring widened to f32.  It launches no
    kernel on CUDA tensors either, so it serves as the kernel's reference
    there.

The decoder's attn_impl="xla" path (ring_rows_write + ring_attention)
computes the same function; it differs only in rounding (ring_attention
takes its products in the ring dtype, or q's for fp8 rings, as the JAX one
does).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_lib
from .ring import RING_KINDS, ring_rows_write_plain, slot_logical_positions

# the kernel's split plan: ranges of about RANGE_SLOTS window slots, at
# least MIN_RANGES of them and at most a portable thread-block cluster (8
# blocks) per KV head, at least 64 window slots per range, ranges a
# multiple of 64 slots (a bf16 trip of the kernel's 32 partitions; an fp8
# trip is 128), and, for the mapping, at most one wave of blocks on an
# H100 (132 SMs; the kernel's 192-254 registers a thread hold one 256-thread
# block per SM).  RANGE_SLOTS trades a lone stream's step against a
# batch's (H100 80GB HBM3, 700 W, bf16, device ms a launch): on an
# 896-slot ring 2 ranges of 448 take 0.0125 at B=1 (7 of 128 on a cluster:
# 0.0089), 0.0195 at B=16 (0.0250) and 0.0774 at B=64 (0.0982); on 512
# slots at B=1 2 of 256 take 0.0098 (8 of 64: 0.0079, 1 of 512: 0.0132)
WAVE_BLOCKS = 132
MAX_SPLITS = 8
MIN_SPLIT_SLOTS = 64
CHUNK_ALIGN = 64
RANGE_SLOTS = 448
MIN_RANGES = 2
# csrc/flash_decode.cu: partitions of 8 lanes per block, and ring rows a
# partition takes per trip by ring dtype (128 bytes of K and V per lane)
NPART = 32
TRIP_ROWS = {torch.float32: 1, torch.bfloat16: 2, torch.float8_e4m3fn: 4}
NEG = -1e30


class FlashPlan(NamedTuple):
    splits: int     # ranges of the window, folded in this order
    chunk: int      # window indices per range: [s chunk, (s + 1) chunk)
    cluster: int    # blocks per (KV head, stream); rank r walks r, r + c..


def flash_decode_chunk(span: int, kv_heads: int) -> int:
    """Window indices per range of the split of span = min(cap, window)
    slots: span / n for n ranges of about RANGE_SLOTS, at least MIN_RANGES
    and at most MAX_SPLITS (fewer where they would not give each 64 slots,
    or their clusters of kv_heads blocks would pass one wave), rounded up
    to a multiple of CHUNK_ALIGN."""
    want = max(1, min(MAX_SPLITS, WAVE_BLOCKS // kv_heads,
                      span // MIN_SPLIT_SLOTS,
                      max(MIN_RANGES, span // RANGE_SLOTS)))
    return -(-(-(-span // want)) // CHUNK_ALIGN) * CHUNK_ALIGN


def flash_decode_splits(span: int, kv_heads: int) -> int:
    """Into how many ranges the kernel cuts the window indices 0 .. span - 1
    of every (stream, KV head) group: range s takes [s C, (s + 1) C) with C
    = flash_decode_chunk(span, kv_heads), the newest position first, and
    the ranges' partials fold in split order.  A function of the shapes
    alone, never of the batch size (so a stream's bits do not depend on
    how many streams share the step) nor of the positions (the host cannot
    read them without a sync): 8 KV heads cut 512 slots into 2 ranges of
    256, 896 into 2 of 448, 2048 into 4 of 512, 8192 into 8 of 1024."""
    return -(-span // flash_decode_chunk(span, kv_heads))


def flash_decode_cluster(splits: int, bsz: int, kv_heads: int) -> int:
    """How the ranges run (the mapping; every mapping gives the same bits):
    a cluster of c blocks per (stream, KV head), block r walking the
    ranges r, r + c, ..  c = splits (one range a block) where the clusters
    fit one wave, fewer where they would not, down to 1 (one block walking
    every range: B >= 9 at 8 KV heads)."""
    return max(1, min(splits, WAVE_BLOCKS // (bsz * kv_heads)))


def flash_decode_plan(span: int, bsz: int, kv_heads: int) -> FlashPlan:
    """The kernel's launch: the batch-free split and its mapping at bsz."""
    splits = flash_decode_splits(span, kv_heads)
    return FlashPlan(splits, flash_decode_chunk(span, kv_heads),
                     flash_decode_cluster(splits, bsz, kv_heads))


def flash_decode_plain(q, k_all, v_all, li: int, pos, k_rows=None,
                       v_rows=None, *, window: int, out_dtype=None):
    """Plain PyTorch flash-decode.  q [B,H,D]; k_all/v_all [B,L,KH,cap,D]
    (any float ring, fp8 included); pos int [B]; k_rows/v_rows [B,KH,D] or
    None.  Returns [B,H,D]."""
    bsz, h, d = q.shape
    kh, cap = k_all.shape[2], k_all.shape[3]
    g = h // kh
    out_dtype = out_dtype or q.dtype
    pos = pos.reshape(bsz)
    if k_rows is not None:
        ring_rows_write_plain(k_all, v_all, k_rows, v_rows, li, pos)
    lpos = slot_logical_positions(pos, cap)                    # [B, cap]
    p = pos[:, None]
    valid = (lpos >= 0) & (lpos > p - window) & (lpos <= p)
    # q scaled before the dot, as the kernels do
    qg = q.float().reshape(bsz, kh, g, d) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_all[:, li].float())
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_all[:, li].float())
    return out.reshape(bsz, h, d).to(out_dtype)



def _fold(m, l, o, m2, l2, o2):
    """The kernel's fold() of a partial (m2, l2, o2) into (m, l, o): the
    running max, sums and outputs rescaled by 2^(max difference)."""
    mn = torch.maximum(m, m2)
    a, c = torch.exp2(m - mn), torch.exp2(m2 - mn)
    return mn, l2 * c + l * a, o2 * c[..., None] + o * a[..., None]


def _range_partial(qs, k_l, v_l, wslot, valid, j0: int, chunk: int, u: int):
    """One range's partial as the kernel takes it: NPART partitions walk
    the range's live rows in trips of NPART * u (row jj of a trip to
    partition jj % NPART), each an online softmax in log2 units that
    raises its max only past the margin of 8; then the 4 partitions of a
    warp fold in a butterfly (1 apart, then 2) and the warps in order.
    qs [B,KH,G,D] (scaled by log2(e)/sqrt(D)); k_l/v_l [B,KH,cap,D] f32;
    wslot, valid [B].  Returns (m, l [B,KH,G], o [B,KH,G,D])."""
    bsz, kh, g, d = qs.shape
    cap = k_l.shape[2]
    n = (torch.minimum(valid, torch.full_like(valid, j0 + chunk))
         - j0)                                                  # [B]
    m = torch.full((bsz, kh, g, NPART), NEG)
    l = torch.zeros((bsz, kh, g, NPART))
    acc = torch.zeros((bsz, kh, g, NPART, d))
    part = torch.arange(NPART)
    bidx = torch.arange(bsz)[:, None, None]
    hidx = torch.arange(kh)[None, :, None]
    for base in range(0, chunk, NPART * u):
        scs, vs, acts = [], [], []
        for uu in range(u):
            jj = base + uu * NPART + part                        # [NPART]
            act = jj[None] < n[:, None]                          # [B, NPART]
            slot = torch.remainder(wslot[:, None] - (j0 + jj)[None], cap)
            kr = k_l[bidx, hidx, slot[:, None, :]]               # [B,KH,P,D]
            vr = v_l[bidx, hidx, slot[:, None, :]]
            scs.append(torch.einsum("bkgd,bkpd->bkgp", qs, kr))
            vs.append(vr)
            acts.append(act[:, None, None, :])
        mx = m
        for sc, act in zip(scs, acts):
            mx = torch.where(act, torch.maximum(mx, sc), mx)
        grow = mx > m + 8.0
        corr = torch.where(grow, torch.exp2(m - mx), torch.ones_like(m))
        l, acc, m = l * corr, acc * corr[..., None], torch.where(grow, mx, m)
        for sc, vr, act in zip(scs, vs, acts):
            p = torch.where(act, torch.exp2(sc - m), torch.zeros_like(sc))
            l = l + p
            acc = acc + p[..., None] * vr[:, :, None]
    for k in (1, 2):                         # lanes 8 and 16 apart
        other = part ^ k
        m, l, acc = _fold(m, l, acc, m[..., other], l[..., other],
                          acc[..., other, :])
    wm, wl, wo = m[..., ::4], l[..., ::4], acc[..., ::4, :]   # each warp's
    pm = torch.full((bsz, kh, g), NEG)
    pl = torch.zeros((bsz, kh, g))
    po = torch.zeros((bsz, kh, g, d))
    for w in range(NPART // 4):
        pm, pl, po = _fold(pm, pl, po, wm[..., w], wl[..., w], wo[..., w, :])
    return pm, pl, po


def flash_decode_split_plain(q, k_all, v_all, li: int, pos, k_rows=None,
                             v_rows=None, *, window: int, out_dtype=None,
                             cluster: int | None = None):
    """The kernel's split in plain PyTorch (a model of csrc/flash_decode.cu's
    arithmetic, not of its rounding): the row write, then the ranges of
    `flash_decode_splits`, each range's partial as `_range_partial` takes
    it, and the partials folded in split order.  `cluster`: the mapping,
    blocks per (stream, KV head), block r taking the ranges r, r + c, ..
    (None: the kernel's at this B).  Every mapping folds the same partials
    in the same order, so the bits do not depend on it.  Arguments as
    `flash_decode_plain`."""
    bsz, h, d = q.shape
    kh, cap = k_all.shape[2], k_all.shape[3]
    out_dtype = out_dtype or q.dtype
    pos = pos.reshape(bsz).long()
    if k_rows is not None:
        ring_rows_write_plain(k_all, v_all, k_rows, v_rows, li, pos)
    span = min(cap, window)
    plan = flash_decode_plan(span, bsz, kh)
    c = plan.cluster if cluster is None else cluster
    valid = torch.clamp(torch.minimum(pos + 1, torch.full_like(pos, window)),
                        max=cap)
    qs = (q.float().reshape(bsz, kh, h // kh, d)
          * (math.log2(math.e) / math.sqrt(d)))
    k_l, v_l = k_all[:, li].float(), v_all[:, li].float()
    u = TRIP_ROWS[k_all.dtype]
    partials = {}
    for rank in range(c):                    # each block's ranges in turn
        for s in range(rank, plan.splits, c):
            partials[s] = _range_partial(qs, k_l, v_l, pos % cap, valid,
                                         s * plan.chunk, plan.chunk, u)
    m = torch.full((bsz, kh, h // kh), NEG)
    l = torch.zeros_like(m)
    o = torch.zeros((bsz, kh, h // kh, d))
    for s in range(plan.splits):             # split order, live ranges
        live = (s * plan.chunk < valid)[:, None, None]
        m2, l2, o2 = _fold(m, l, o, *partials[s])
        m, l = torch.where(live, m2, m), torch.where(live, l2, l)
        o = torch.where(live[..., None], o2, o)
    return (o / l[..., None]).reshape(bsz, h, d).to(out_dtype)


_FLOATS = (torch.float32, torch.bfloat16)


def flash_decode(q, k_all, v_all, li: int, pos, k_rows=None, v_rows=None,
                 *, window: int, out_dtype=None):
    """Attention output [B,H,D] for the query at pos[b] over layer li of the
    stacked caches; with k_rows/v_rows, writes them at pos % cap first (in
    place).  Pass the STACKED cache and the layer index."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_all, v_all, li, pos, k_rows, v_rows,
                                  window=window, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_decode on {q.device}")
    bsz, h, d = q.shape
    _, n_layers, kh, cap, _ = k_all.shape
    kind = RING_KINDS.get(k_all.dtype)
    if kind is None or v_all.dtype != k_all.dtype:
        raise ValueError("flash-decode kernel takes f32, bf16 or fp8 e4m3fn "
                         f"rings, got {k_all.dtype}, {v_all.dtype}")
    if q.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"flash-decode kernel: q {q.dtype}, out_dtype "
                         f"{out_dtype} (needs bf16 or f32)")
    if d != 128 or h % kh or (h // kh) not in (1, 2, 4):
        raise ValueError(f"flash-decode kernel: H={h} KH={kh} D={d} "
                         "(needs D=128, H/KH in 1, 2, 4)")
    if v_all.shape != k_all.shape or k_all.shape[0] != bsz:
        raise ValueError("flash-decode kernel: cache shapes")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError("flash-decode kernel: caches must be contiguous "
                         "(they are written in place)")
    if not 0 <= li < n_layers:
        raise ValueError(f"flash-decode kernel: layer {li} of {n_layers}")
    # each a no-op on the decoder's tensors: nothing is launched but the
    # kernel
    q = q.contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).reshape(bsz).contiguous()
    write = k_rows is not None
    rows_ptr, rows_stride, rows_f32 = (None, None), (0, 0), 1
    if write:
        if (k_rows.dtype not in (torch.float32, k_all.dtype)
                or v_rows.dtype != k_rows.dtype
                or k_rows.shape != (bsz, kh, d) or v_rows.shape != k_rows.shape
                or k_rows.device != q.device or v_rows.device != q.device):
            raise ValueError("flash-decode kernel: k_rows/v_rows must be "
                             f"[{bsz}, {kh}, {d}] in f32 or the ring dtype "
                             f"on {q.device}")
        # read in place with any stride between streams (the decoder's v
        # row is a slice of the qkv product)
        k_rows, v_rows = (r if r.stride()[1:] == (d, 1) else r.contiguous()
                          for r in (k_rows, v_rows))
        rows_ptr = (k_rows.data_ptr(), v_rows.data_ptr())
        rows_stride = (k_rows.stride(0), v_rows.stride(0))
        rows_f32 = int(k_rows.dtype == torch.float32)
    out = torch.empty((bsz, h, d), dtype=out_dtype, device=q.device)
    elt = k_rows.element_size() if write else 1
    if any(t.data_ptr() % 16 for t in (q, k_all, v_all, out)) or any(
            ptr % 16 or st * elt % 16 for ptr, st in zip(rows_ptr, rows_stride)
            if ptr is not None):
        raise ValueError("flash-decode kernel: tensors must be 16-byte "
                         "aligned")
    lib = cuda_lib.kernels()
    err = lib.vt_flash_decode(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *rows_ptr,
        pos32.data_ptr(), out.data_ptr(), bsz, n_layers, h, kh, cap, d, li,
        window, int(write), kind, int(q.dtype == torch.float32), rows_f32,
        int(out_dtype == torch.float32), *rows_stride,
        *flash_decode_plan(min(cap, window), bsz, kh),
        cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
flash_decode.launches = 0
