"""Row-invariant bf16 product on the card: f32 [rows, out] = x @ w.T.

The streaming encoder side (conv stem, ring layers, adapter) must give a
row the same bits however the audio was chunked into calls (the JAX
package's promise, voxtral_tpu/runtime/offline.py).  cuBLAS picks its
algorithm and its K split by the row count, so `models/quant.py
matmul_f32` rounds a row differently at another chunking.  `bf16_mm`
computes the same function with one tile and one K split for every row
count (`models/decoder.py:_use_rowinv` holds the routing rule):

  * CUDA tensors launch `voxtral_tpu_torch/csrc/bf16_mm.cu` (the
    counterpart of the einsum XLA compiles in the JAX package; its header
    says what bounds it on the H100 and how the design meets it) on the
    plan of `bf16_mm_plan`: one instruction shape (wgmma m64n64k16) for
    every output element, and a K split whose ranges and fold order are a
    function of (out, K) and the card's SM count, never of the rows.  The
    tile's height (`bf16_mm_tile_rows`: 64 or 128 rows of x, one or two
    64-row fragments) and how the split runs (`bf16_mm_seq`: a cluster of
    blocks per tile, one range each, or single blocks walking the ranges in
    turn) follow the rows, and change no bit.  It takes bf16 x [rows, K],
    contiguous, and w [out, K] either contiguous (the weights as the JAX
    package stores them) or the transpose view of a contiguous [K, out]
    (the conv stem's im2col weights as stored, read in place: `out` a
    multiple of 8), K a multiple of 64, and raises on anything else.
  * CPU tensors take `bf16_mm_plain`, `matmul_f32`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models.quant import matmul_f32
from . import cuda_lib
from .quant_mm import (
    MAX_CLUSTER,
    RING_BLOCK_M,
    RING_BLOCK_N,
    RING_CONSUMER_REGS,
    RING_CONSUMER_THREADS,
    RING_K_CHUNK,
    RING_PRODUCER_REGS,
    RING_REG_BLOCKS,
    RING_THREADS,
    RING_TILE_ROWS,
    MmPlan,
    _check_operands,
    ring_blocks_per_sm,
    ring_smem,
    ring_split,
    ring_stages,
)

# csrc/bf16_mm.cu's tile, the ring of csrc/wgmma_ring.cuh (int8_mm.cu's
# too) with two bytes a weight: columns of K per ring stage, output columns
# of a tile (two consumer warpgroups of 64), rows of x of the wgmma (its
# n), the tile heights, threads (two consumer warpgroups and a producer
# one), blocks an SM by registers and setmaxnreg's registers a thread
K_CHUNK = RING_K_CHUNK
BLOCK_N = RING_BLOCK_N
BLOCK_M = RING_BLOCK_M
TILE_ROWS = RING_TILE_ROWS
THREADS = RING_THREADS
CONSUMER_THREADS = RING_CONSUMER_THREADS
REG_BLOCKS = RING_REG_BLOCKS
PRODUCER_REGS = RING_PRODUCER_REGS
CONSUMER_REGS = RING_CONSUMER_REGS
W_BYTES = 2
# the split's aim: the tiles of one row tile fill this many blocks an SM
SPLIT_BLOCKS_PER_SM = 2
# the rules below are read off chip_smoke.py's bf16_mm sweep (--bf16:
# every product at 1-2432 rows, each tile height and each way of running
# the split timed; PERF.md section 6): the 128-row tile where its tiles
# give at least half an SM each, and clusters only for a full cluster of
# MAX_CLUSTER blocks whose blocks fill at most CLUSTER_SM_WAVES blocks an
# SM (smaller clusters measured 1.4-2x slower than single blocks)
TALL_TILES_PER_SM = 0.5
CLUSTER_SM_WAVES = 3
# the most tiles a cluster launch takes (gridDim.y)
MAX_CLUSTER_TILES = 65535


def bf16_mm_tile_rows(rows: int, out: int, sms: int = 132) -> int:
    """Rows of x a tile of csrc/bf16_mm.cu holds for a [rows, in] x
    [out, in] product: one 64-row wgmma fragment up to 64 rows; above, two
    (the weights' stage then feeds twice the rows) where the 128-row tiles
    number at least TALL_TILES_PER_SM an SM, else still one (two blocks of
    the 64-row tile an SM keep more of the card busy).  Every output
    element is summed by the same wgmma m64n64k16 sequence at either
    height, so a row's bits do not follow it."""
    tall = TILE_ROWS[1]
    if rows <= TILE_ROWS[0] or (-(-out // BLOCK_N) * -(-rows // tall)
                                < TALL_TILES_PER_SM * sms):
        return TILE_ROWS[0]
    return tall


def bf16_mm_stages(tile_rows: int = 64, seq: bool = False) -> int:
    """The ring's depth (`ring_stages`): as deep as the tile's blocks an SM
    allow (two of the 64-row tile, one of the 128-row tile)."""
    return ring_stages(tile_rows, not seq, W_BYTES, K_CHUNK)


def bf16_mm_smem(tile_rows: int = 64, seq: bool = False) -> int:
    """Dynamic shared memory of a block (`ring_smem`): the ring (stages of
    x's and the weights' boxes), the barriers and a cluster's fold
    buffer."""
    return ring_smem(tile_rows, not seq, W_BYTES, K_CHUNK)


def bf16_mm_blocks_per_sm(tile_rows: int = 64, seq: bool = False) -> int:
    """Blocks (single, or a cluster's) of a tile height one SM holds, by
    shared memory and registers: two of the 64-row tile, one of the
    128-row tile."""
    return ring_blocks_per_sm(tile_rows, not seq, W_BYTES, K_CHUNK)


@functools.lru_cache(maxsize=None)
def bf16_mm_plan(out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/bf16_mm.cu's launch for a [rows, in] x [out, in] product at any
    row count: the K range split over cs blocks so that the tiles of one
    row tile (`tiles`: ceil(out / 128)) fill about SPLIT_BLOCKS_PER_SM
    blocks an SM; `clusters`, the clusters of cs blocks one wave holds.  A
    function of (out, in) and the card alone, so a row's bits never depend
    on how many rows share the call."""
    col_tiles = -(-out // BLOCK_N)
    chunks = -(-in_dim // K_CHUNK)
    cs = ring_split(col_tiles, chunks, SPLIT_BLOCKS_PER_SM, sms)
    per_sm = bf16_mm_blocks_per_sm()
    return MmPlan(BLOCK_M // 8, cs, sms * per_sm // cs, col_tiles, per_sm)


def bf16_mm_blocks(rows: int, out: int, in_dim: int, tile_rows: int,
                   seq: bool, sms: int = 132) -> int:
    """Blocks of a launch with this tile height and way of running the
    split: single blocks persistent over the tiles (at most what the card
    holds at once), or a cluster a tile (the clusters)."""
    plan = bf16_mm_plan(out, in_dim, sms)
    n_tiles = plan.tiles * -(-rows // tile_rows)
    return (min(n_tiles, sms * bf16_mm_blocks_per_sm(tile_rows, seq)) if seq
            else n_tiles)


def bf16_mm_seq(rows: int, out: int, in_dim: int, sms: int = 132) -> bool:
    """How the plan's split runs at `rows` rows: on single blocks, each
    walking the split's ranges in turn, persistent over the tiles (True),
    or on a cluster of cs blocks per tile, one range each, every tile at
    once (False): the cluster for a full cluster on the 64-row tile whose
    blocks number at most CLUSTER_SM_WAVES an SM (the split's few K chunks
    a block then beat one block's walk of all of K).  Both give the same
    bits (csrc/bf16_mm.cu), so only time follows the rows."""
    plan = bf16_mm_plan(out, in_dim, sms)
    tile = bf16_mm_tile_rows(rows, out, sms)
    n_tiles = plan.tiles * -(-rows // tile)
    return (tile != TILE_ROWS[0] or plan.cs < MAX_CLUSTER
            or n_tiles * plan.cs > CLUSTER_SM_WAVES * sms
            or n_tiles > MAX_CLUSTER_TILES)


class Bf16MmLaunch(NamedTuple):
    tile_rows: int       # rows of x a tile holds (bf16_mm_tile_rows)
    seq: bool            # the split on single blocks, else a cluster a tile
    blocks: int          # single blocks launched, or clusters (a tile each)
    ranges: tuple        # the K ranges, [lo, hi) in 64-column chunks, in
                         # the order their sums are folded from zero
    instruction: str     # the wgmma each 64-row fragment issues a k16 step


def bf16_mm_launch(rows: int, out: int, in_dim: int,
                   sms: int = 132) -> Bf16MmLaunch:
    """csrc/bf16_mm.cu's launch of a [rows, in] x [out, in] product as the
    wrapper sends it: what follows the rows (the tile height, how the split
    runs, the grid) and what a row's sums are (the
    plan's K ranges in fold order, each 64-column chunk of a range as four
    k16 steps of one instruction), which does not."""
    plan = bf16_mm_plan(out, in_dim, sms)
    chunks = -(-in_dim // K_CHUNK)
    tile = bf16_mm_tile_rows(rows, out, sms)
    seq = bf16_mm_seq(rows, out, in_dim, sms)
    return Bf16MmLaunch(
        tile, seq, bf16_mm_blocks(rows, out, in_dim, tile, seq, sms),
        tuple((r * chunks // plan.cs, (r + 1) * chunks // plan.cs)
              for r in range(plan.cs)),
        "wgmma.m64n64k16.f32.bf16.bf16")


def bf16_mm_plain(x, w):
    """Plain PyTorch version: x [rows, K] @ w [out, K].T with f32
    accumulation and result (`matmul_f32`)."""
    return matmul_f32(x, w.t())


def weight_layout(w) -> bool:
    """Whether the kernel reads w [out, K] as the transpose view of a
    contiguous [K, out] (True) or as a contiguous [out, K] (False); raises
    on any other layout."""
    if w.is_contiguous():
        return False
    if w.t().is_contiguous():
        return True
    raise ValueError(f"bf16_mm kernel: w{tuple(w.shape)} with strides "
                     f"{w.stride()} is neither [out, K] nor the transpose "
                     "of [K, out], contiguous")


def bf16_mm(x, w):
    """f32 [rows, out] = x @ w.T, each row's bits independent of the row
    count on the card."""
    if x.device.type == "cpu":
        return bf16_mm_plain(x, w)
    if x.device.type != "cuda":
        raise NotImplementedError(f"bf16_mm on {x.device}")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"bf16_mm kernel: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)}")
    rows, in_dim = x.shape
    out_dim, k = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"bf16_mm kernel takes bf16 x and w, got {x.dtype}, "
                         f"{w.dtype}")
    if in_dim != k or in_dim % K_CHUNK:
        raise ValueError(f"bf16_mm kernel: in {in_dim} against the weight's "
                         f"{k} (needs equal, a multiple of {K_CHUNK})")
    w_t = weight_layout(w)
    if w_t and out_dim % 8:
        raise ValueError(f"bf16_mm kernel: a [K, out] weight needs out a "
                         f"multiple of 8, got {out_dim}")
    _check_operands("bf16_mm", x, w=w.t() if w_t else w)
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    sms = cuda_lib.sm_count(x.device)
    lp = bf16_mm_launch(rows, out_dim, in_dim, sms)
    err = cuda_lib.kernels().vt_bf16_mm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, out_dim, in_dim,
        len(lp.ranges), int(lp.seq), int(w_t), lp.blocks, lp.tile_rows,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "bf16_mm")
    bf16_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
bf16_mm.launches = 0
