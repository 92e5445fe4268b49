"""Weight-only matmuls on the card: int4 (W4A16) and int8 (W8A16).

int4 packing (models/quant.py `_quantize4`): low nibbles hold input columns
[0, in/2), high nibbles [in/2, in); one f32 scale per (output row, half).
The product is

    y = (x[:, :in/2] @ lo.T) * s[:, 0] + (x[:, in/2:] @ hi.T) * s[:, 1]

with f32 accumulation and an f32 result [rows, out].  int8 (`_quantize`):
one byte a weight and one f32 scale per output row, y = (x @ w.T) * s.

`int4_mm` and `int8_mm` dispatch on the device of their inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/int4_mm.cu` (it replaces
    the Pallas kernel voxtral_tpu/ops/quant_mm.py:_kernel) or
    `csrc/int8_mm.cu` (the counterpart of the int8 -> bf16 convert XLA
    fuses into the JAX package's int8 product, voxtral_tpu/models/quant.py
    mm: the weights stay int8 in device memory); their headers say what
    bounds them on the H100 and how the design meets it.  Both take bf16 x
    and contiguous operands (int4: an input dim that is a multiple of 32,
    int8: of 128) and raise on anything else.  One launch per call, on the
    plan of `int4_mm_plan` / `int8_mm_plan` (tile, K split over a
    thread-block cluster, clusters), a function of the shapes alone; with
    `rowinv` (the streaming encoder side and the decoder,
    models/decoder.py:_use_rowinv) on `int4_mm_rowinv_plan` /
    `int8_mm_rowinv_plan`, a function of (out, K) and the card without the
    row count, so that a row's bits do not depend on how many rows share
    the call.  The int8 kernel runs one tile on both plans at every row
    count (wgmma m64n64k16 with the widened weights as register A, on the
    ring of csrc/wgmma_ring.cuh that `bf16_mm` shares; `int8_mm_launch`).
  * CPU tensors take `int4_mm_plain` (the JAX package's `_mm4`) or
    `int8_mm_plain` (the JAX expression: the weights widened to x's dtype,
    one f32-result product, the row scales).

Both take the STACKED [L, out, in/2] or [L, out, in] weight and a layer
index, the JAX int4 function's signature; for the logits table pass p[None]
with li=0.  The stream axis is folded into the rows by the caller, so one
launch reads the weights once for every stream of the batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models.quant import _mm4, _unpack4, matmul_f32
from . import cuda_lib

# csrc/int4_mm.cu's constants: packed bytes of a row per K chunk, ring
# stages, the largest cluster; and its tiles (MmaTile for nj = 2, 4: the
# decode tiles of 8 nj rows on mma.sync; WgTile for nj = 16: the 128-row
# prefill tile on wgmma), by nj (n8 tiles of x rows): output columns per
# block tile, threads per block, and the blocks an SM holds by registers
# (the kernels' __launch_bounds__ cap their registers to match;
# chip_smoke.py checks every residency against the card's occupancy query)
K_CHUNK = 64
STAGES = 4
MAX_CLUSTER = 8
_TILES = {  # nj: (block_n, threads, reg_blocks)
    2: (64, 128, 5),
    4: (64, 128, 3),
    16: (128, 256, 1),
}
_SM_SMEM = 233472          # shared memory per SM on the H100 (228 KB)
_BLOCK_RESERVED = 1024     # the runtime's per-block share

# csrc/wgmma_ring.cuh's block (bf16_mm.cu and int8_mm.cu): columns of K per
# ring stage, output columns of a tile (two consumer warpgroups of 64), rows
# of x of the wgmma (its n), the tile heights (one or two 64-row
# fragments), threads (two consumer warpgroups and a producer one)
RING_K_CHUNK = 64
RING_BLOCK_N = 128
RING_BLOCK_M = 64
RING_TILE_ROWS = (64, 128)
RING_THREADS = 384
RING_CONSUMER_THREADS = 256
# blocks an SM holds by registers (__launch_bounds__), by tile rows, and
# setmaxnreg's registers a thread: the producer warpgroup's, the consumers'
RING_REG_BLOCKS = {64: 2, 128: 1}
RING_PRODUCER_REGS = {64: 32, 128: 40}
RING_CONSUMER_REGS = {64: 104, 128: 232}
_BLOCK_SMEM = 232448       # the H100's most shared memory for one block


def ring_smem_fixed(tile_rows: int, recv: bool) -> int:
    """A ring block's shared memory besides the ring: 1 KB to start on a
    1024-byte boundary, the barriers (256 bytes) and, `recv`, a cluster's
    fold receive buffer of its own ((accumulators of a thread + 7) x 256
    floats)."""
    return 1024 + 256 + ((tile_rows // 2 + MAX_CLUSTER - 1)
                         * RING_CONSUMER_THREADS * 4 if recv else 0)


def ring_stage_bytes(tile_rows: int, w_bytes: int, k_chunk: int) -> int:
    """A ring stage of k_chunk columns of K: x's bf16 boxes of tile_rows
    rows and the weights' box of RING_BLOCK_N rows of w_bytes-byte
    weights."""
    return (tile_rows * 2 + RING_BLOCK_N * w_bytes) * k_chunk


def ring_stages(tile_rows: int, recv: bool, w_bytes: int,
                k_chunk: int) -> int:
    """The ring's depth: as deep as the tile's blocks an SM allow (two of
    the 64-row tile, one of the 128-row tile)."""
    room = (_BLOCK_SMEM if RING_REG_BLOCKS[tile_rows] == 1
            else _SM_SMEM // RING_REG_BLOCKS[tile_rows] - _BLOCK_RESERVED)
    return ((room - ring_smem_fixed(tile_rows, recv))
            // ring_stage_bytes(tile_rows, w_bytes, k_chunk))


def ring_smem(tile_rows: int, recv: bool, w_bytes: int, k_chunk: int) -> int:
    """Dynamic shared memory of a ring block: the ring and
    `ring_smem_fixed`."""
    return (ring_smem_fixed(tile_rows, recv)
            + ring_stages(tile_rows, recv, w_bytes, k_chunk)
            * ring_stage_bytes(tile_rows, w_bytes, k_chunk))


def ring_blocks_per_sm(tile_rows: int, recv: bool, w_bytes: int,
                       k_chunk: int) -> int:
    """Blocks (single, or a cluster's) of a ring tile one SM holds, by
    shared memory and registers: two of the 64-row tile, one of the
    128-row tile."""
    return min(RING_REG_BLOCKS[tile_rows], _SM_SMEM // (
        ring_smem(tile_rows, recv, w_bytes, k_chunk) + _BLOCK_RESERVED))


def ring_split(tiles: int, chunks: int, blocks_per_sm: int, sms: int) -> int:
    """A ring product's K split: the ranges that let `tiles` tiles fill
    about `blocks_per_sm` blocks an SM, 1..MAX_CLUSTER of them, each of at
    least one chunk."""
    return max(1, min(MAX_CLUSTER, chunks, blocks_per_sm * sms // tiles))


def int4_mm_smem(nj: int, cs: int) -> int:
    """Dynamic shared memory of a block: 1 KB to start on a 1024-byte
    boundary, the ring (stages of both x tiles, the packed tile and the
    tile's f32 scales), its barriers (128 bytes) and, with a K split, the
    decode tile's partial sums (2 halves x 4 nj outputs per thread, f32)."""
    bn, threads, _ = _TILES[nj]
    ring = 1024 + STAGES * (2 * 8 * nj * 2 * K_CHUNK + bn * K_CHUNK
                            + bn * 8) + 128
    return ring + (2 * 4 * nj * threads * 4 if cs > 1 and nj != 16 else 0)


class MmPlan(NamedTuple):
    nj: int          # n8 tiles of x rows per block tile (rows 8 * nj)
    cs: int          # K split: blocks per cluster, one range of chunks each
    clusters: int    # clusters launched; each walks tiles `clusters` apart
    tiles: int       # block tiles of the product
    per_sm: int      # blocks of this tile and split an SM holds


def int4_mm_blocks_per_sm(nj: int, cs: int) -> int:
    """Blocks of tile width nj (K split cs) one SM holds, by shared memory
    and registers."""
    return min(_TILES[nj][2],
               _SM_SMEM // (int4_mm_smem(nj, cs) + _BLOCK_RESERVED))


def _plan(rows: int, out: int, chunks: int, tiles_table: dict,
          blocks_per_sm, sms: int) -> MmPlan:
    """The launch of a weight-only product [rows, K] x [out, K] of `chunks`
    K chunks, for a kernel of these tiles, on a card of `sms` SMs: never
    more blocks than the card holds at once.

    Rows take the narrowest decode tile (nj < 16) of at least as many rows
    (else the widest), more than 64 the wgmma prefill tile (nj = 16) when
    its tiles give at least half a block per SM.  Where the tiles fill less
    than one wave, the K range is split over a cluster of cs blocks (the
    prefill tile never splits: its partials would not fit beside its
    stages)."""
    def tiles(nj):
        return -(-out // tiles_table[nj][0]) * -(-rows // (8 * nj))

    decode = sorted(k for k in tiles_table if k != 16)
    nj = next((k for k in decode if 8 * k >= rows), decode[-1])
    if rows > 64 and tiles(16) * 2 >= sms:
        nj = 16
    n_tiles = tiles(nj)
    cs = 1
    if nj != 16 and n_tiles < sms * blocks_per_sm(nj, 1):
        cs = max(1, min(MAX_CLUSTER, chunks,
                        sms * blocks_per_sm(nj, 2) // n_tiles))
    per_sm = blocks_per_sm(nj, cs)
    return MmPlan(nj, cs, min(n_tiles, sms * per_sm // cs), n_tiles, per_sm)


def _rowinv_plan(out: int, chunks: int, tiles_table: dict, blocks_per_sm,
                 sms: int) -> MmPlan:
    """The row-invariant launch of a weight-only product of `chunks` K
    chunks at ANY row count: one tile and one K split for every row count,
    so that a row's sums are taken in the same order however many rows
    share the call.  The tile is the widest decode tile (mma.sync; the
    wgmma prefill tile would round a k16 step otherwise), the split fills
    about one wave with the tiles of one row tile (`tiles`), and a full
    wave of clusters walks the tiles (those past the last tile exit)."""
    nj = max(k for k in tiles_table if k != 16)
    col_tiles = -(-out // tiles_table[nj][0])
    cs = max(1, min(MAX_CLUSTER, chunks,
                    sms * blocks_per_sm(nj, 2) // col_tiles))
    per_sm = blocks_per_sm(nj, cs)
    return MmPlan(nj, cs, sms * per_sm // cs, col_tiles, per_sm)


def _splits(width: int, chunk: int, cs: int) -> list[tuple[int, int]]:
    """The column ranges [lo, hi) of the cs blocks of a K split of `width`
    columns in chunks of `chunk`: contiguous runs of chunks, rank order (the
    kernels' c_lo)."""
    chunks = -(-width // chunk)
    return [(r * chunks // cs * chunk,
             min(width, (r + 1) * chunks // cs * chunk)) for r in range(cs)]


@functools.lru_cache(maxsize=None)
def int4_mm_plan(rows: int, out: int, half: int, sms: int = 132) -> MmPlan:
    """csrc/int4_mm.cu's launch for an [rows, 2 half] x [out, half] product
    (`_plan`, in K chunks of K_CHUNK packed columns)."""
    return _plan(rows, out, -(-half // K_CHUNK), _TILES,
                 int4_mm_blocks_per_sm, sms)


@functools.lru_cache(maxsize=None)
def int4_mm_rowinv_plan(out: int, half: int, sms: int = 132) -> MmPlan:
    """csrc/int4_mm.cu's row-invariant launch for an [any, 2 half] x
    [out, half] product (`_rowinv_plan`)."""
    return _rowinv_plan(out, -(-half // K_CHUNK), _TILES,
                        int4_mm_blocks_per_sm, sms)


def int4_mm_splits(half: int, cs: int) -> list[tuple[int, int]]:
    """The packed-column ranges [lo, hi) of the cs blocks of a K split:
    contiguous runs of K chunks, rank order (the kernel's c_lo)."""
    return _splits(half, K_CHUNK, cs)


def int4_mm_plain(x, p_all, s_all, li: int):
    """Plain PyTorch int4 product: x [rows, in], p_all nibble-packed int8
    [L, out, in/2], s_all f32 [L, out, 2] -> f32 [rows, out].  Unpacks to
    x's dtype, then two f32-result products and the per-half scales."""
    return _mm4(x, p_all[li], s_all[li], x.dtype)


def int4_mm_split_plain(x, p_all, s_all, li: int, cs: int):
    """Plain model of the kernel's K split: each of the cs ranges of
    `int4_mm_splits` sums its share of both products in f32, the partials
    are added in rank order, then scaled per half -- the kernel's fold."""
    half = p_all.shape[-1]
    lo_w, hi_w = _unpack4(p_all[li], x.dtype)
    lo = hi = 0.0
    for a, b in int4_mm_splits(half, cs):
        lo = lo + matmul_f32(x[:, a:b], lo_w[:, a:b].t())
        hi = hi + matmul_f32(x[:, half + a:half + b], hi_w[:, a:b].t())
    s = s_all[li]
    return lo * s[None, :, 0] + hi * s[None, :, 1]


def _check_operands(what: str, x, **tensors) -> None:
    """Raise unless x and `tensors` are contiguous, on x's device and
    16-byte aligned, as the kernels' tensor maps need."""
    for name, t in (("x", x), *tensors.items()):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{what} kernel: {name} must be contiguous "
                             f"on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} not 16-byte aligned")


def int4_mm(x, p_all, s_all, li: int, rowinv: bool = False):
    """f32 [rows, out] = x @ unpack(p_all[li]).T with per-half scales
    (`rowinv`: on the row-invariant plan)."""
    if x.device.type == "cpu":
        return int4_mm_plain(x, p_all, s_all, li)
    if x.device.type != "cuda":
        raise NotImplementedError(f"int4_mm on {x.device}")
    if x.dim() != 2 or p_all.dim() != 3 or s_all.dim() != 3:
        raise ValueError(f"int4_mm kernel: x{tuple(x.shape)} "
                         f"p{tuple(p_all.shape)} s{tuple(s_all.shape)}")
    rows, in_dim = x.shape
    n_layers, out_dim, half = p_all.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int4_mm kernel takes bf16 x, got {x.dtype}")
    if p_all.dtype != torch.int8 or s_all.dtype != torch.float32:
        raise ValueError("int4_mm kernel takes int8 packed weights and f32 "
                         f"scales, got {p_all.dtype}, {s_all.dtype}")
    if in_dim != 2 * half or in_dim % 32:
        raise ValueError(f"int4_mm kernel: in {in_dim} against packed "
                         f"{half} (needs in = 2 * packed, a multiple of 32)")
    if s_all.shape != (n_layers, out_dim, 2):
        raise ValueError(f"int4_mm kernel: scales {tuple(s_all.shape)}")
    if not 0 <= li < n_layers:
        raise ValueError(f"int4_mm kernel: layer {li} of {n_layers}")
    _check_operands("int4_mm", x, p_all=p_all, s_all=s_all)
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    sms = cuda_lib.sm_count(x.device)
    plan = (int4_mm_rowinv_plan(out_dim, half, sms) if rowinv
            else int4_mm_plan(rows, out_dim, half, sms))
    err = cuda_lib.kernels().vt_int4_mm(
        x.data_ptr(), p_all.data_ptr(), s_all.data_ptr(), out.data_ptr(),
        rows, out_dim, half, li, plan.nj, plan.cs, plan.clusters,
        cuda_lib.stream_handle(x.device),
    )
    cuda_lib.check(err, "int4_mm")
    int4_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
int4_mm.launches = 0


# ---- int8 (W8A16) ---------------------------------------------------------

# csrc/int8_mm.cu: the ring of RING_* above with one byte a weight and
# INT8_K_CHUNK columns of K a stage (a stage of 32 KB at 64 rows, 48 KB at
# 128), one wgmma m64n64k16 with the widened weights as register A at every
# row count.  The rules below are read off chip_smoke.py's int8 sweep
# (--int8: every decoder product at a decode step's rows and the
# prefills', each tile height, way to run the split and split timed;
# PERF.md section 6): the split aims at INT8_SPLIT_BLOCKS_PER_SM blocks an
# SM (a power of two), the 128-row tile where its tiles give at least
# INT8_TALL_TILES_PER_SM an SM, a split of the 64-row tile on clusters
INT8_K_CHUNK = 128
INT8_W_BYTES = 1
INT8_SPLIT_BLOCKS_PER_SM = 2
INT8_TALL_TILES_PER_SM = 0.5
INT8_INSTRUCTION = ("wgmma.m64n64k16.f32.bf16.bf16 "
                    "(A: int8 widened in registers)")


def int8_mm_stages(tile_rows: int = 64) -> int:
    """The int8 ring's depth (`ring_stages`; a cluster's fold receives in
    the idle ring, so clusters and single blocks hold the same ring): 3
    stages of 32 KB at 64 rows, 4 of 48 KB at 128."""
    return ring_stages(tile_rows, False, INT8_W_BYTES, INT8_K_CHUNK)


def int8_mm_smem(tile_rows: int = 64) -> int:
    """Dynamic shared memory of a block of csrc/int8_mm.cu (`ring_smem`)."""
    return ring_smem(tile_rows, False, INT8_W_BYTES, INT8_K_CHUNK)


def int8_mm_blocks_per_sm(tile_rows: int = 64) -> int:
    """Blocks of the int8 kernel's tile one SM holds, by shared memory and
    registers: two of the 64-row tile, one of the 128-row tile."""
    return ring_blocks_per_sm(tile_rows, False, INT8_W_BYTES, INT8_K_CHUNK)


def int8_mm_tile_rows(rows: int, out: int, sms: int = 132) -> int:
    """Rows of x a tile holds for a [rows, in] x [out, in] product: one
    64-row fragment up to 64 rows; above, two (a weights' stage then feeds
    twice the rows) where the 128-row tiles number at least
    INT8_TALL_TILES_PER_SM an SM.  Every output element is summed by the
    same instruction sequence at either height."""
    tall = RING_TILE_ROWS[1]
    if rows <= RING_TILE_ROWS[0] or (-(-out // RING_BLOCK_N) * -(-rows // tall)
                                     < INT8_TALL_TILES_PER_SM * sms):
        return RING_TILE_ROWS[0]
    return tall


def _int8_split(tiles: int, chunks: int, sms: int) -> int:
    """The int8 kernel's K split for `tiles` tiles: `ring_split`'s, down to
    a power of two (clusters of 3, 5, 6 or 7 blocks measured slower than
    the power of two below them)."""
    cs = ring_split(tiles, chunks, INT8_SPLIT_BLOCKS_PER_SM, sms)
    return 1 << (cs.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def int8_mm_rowinv_plan(out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/int8_mm.cu's row-invariant launch for a [rows, in] x [out, in]
    product at ANY row count: the K range split over cs blocks so that the
    tiles of one 64-row tile (`tiles`: ceil(out / 128)) fill about
    INT8_SPLIT_BLOCKS_PER_SM blocks an SM; `clusters`, the clusters of cs
    blocks one wave holds.  A function of (out, in) and the card alone, so
    a row's sums are taken in the same order however many rows share the
    call (the tile height and the way the split runs follow the rows and
    change no bit: int8_mm_launch)."""
    col_tiles = -(-out // RING_BLOCK_N)
    chunks = -(-in_dim // INT8_K_CHUNK)
    cs = _int8_split(col_tiles, chunks, sms)
    per_sm = int8_mm_blocks_per_sm()
    return MmPlan(RING_BLOCK_M // 8, cs, sms * per_sm // cs, col_tiles,
                  per_sm)


@functools.lru_cache(maxsize=None)
def int8_mm_plan(rows: int, out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/int8_mm.cu's launch for an [rows, in] x [out, in] product by
    its row count: the tile of `int8_mm_tile_rows` (nj = its rows / 8) and
    a K split that lets the tiles of all the rows fill about
    INT8_SPLIT_BLOCKS_PER_SM blocks an SM (none once they fill the card);
    `clusters`, the single blocks one wave holds, or the tiles.  Up to 64
    rows the tiles are the column tiles, so the split is the row-invariant
    plan's."""
    tile = int8_mm_tile_rows(rows, out, sms)
    n_tiles = -(-out // RING_BLOCK_N) * -(-rows // tile)
    chunks = -(-in_dim // INT8_K_CHUNK)
    cs = _int8_split(n_tiles, chunks, sms)
    per_sm = int8_mm_blocks_per_sm(tile)
    return MmPlan(tile // 8, cs, min(n_tiles, sms * per_sm), n_tiles, per_sm)


def int8_mm_seq(rows: int, out: int, cs: int, sms: int = 132) -> bool:
    """How a split of cs ranges runs at `rows` rows: on single blocks, each
    walking the ranges in turn, persistent over the tiles (True: the
    128-row tile, or no split), or on a cluster of cs blocks per tile, one
    range each, every tile at once (False: a split on the 64-row tile, whose
    single blocks have no registers for folded sums).  Both give the same
    bits (csrc/wgmma_ring.cuh), so only time follows the rows."""
    return int8_mm_tile_rows(rows, out, sms) != RING_TILE_ROWS[0] or cs == 1


class Int8MmLaunch(NamedTuple):
    tile_rows: int       # rows of x a tile holds (int8_mm_tile_rows)
    seq: bool            # the split on single blocks, else a cluster a tile
    blocks: int          # single blocks launched, or clusters (a tile each)
    ranges: tuple        # the K ranges, [lo, hi) in 128-column chunks, in
                         # the order their sums are folded from zero
    instruction: str     # the wgmma each 64-row fragment issues a k16 step


def int8_mm_launch(rows: int, out: int, in_dim: int, sms: int = 132,
                   rowinv: bool = False) -> Int8MmLaunch:
    """csrc/int8_mm.cu's launch of a [rows, in] x [out, in] product as the
    wrapper sends it: the split of `int8_mm_rowinv_plan` (rowinv) or of
    `int8_mm_plan`, and what follows the rows (the tile height, how the
    split runs, the grid).  On the row-invariant plan a row's sums (the K
    ranges in fold order, each 128-column chunk as eight k16 steps of one
    instruction) do not follow the rows."""
    plan = (int8_mm_rowinv_plan(out, in_dim, sms) if rowinv
            else int8_mm_plan(rows, out, in_dim, sms))
    chunks = -(-in_dim // INT8_K_CHUNK)
    tile = int8_mm_tile_rows(rows, out, sms)
    seq = int8_mm_seq(rows, out, plan.cs, sms)
    n_tiles = -(-out // RING_BLOCK_N) * -(-rows // tile)
    blocks = (min(n_tiles, sms * int8_mm_blocks_per_sm(tile)) if seq
              else n_tiles)
    return Int8MmLaunch(
        tile, seq, blocks,
        tuple((r * chunks // plan.cs, (r + 1) * chunks // plan.cs)
              for r in range(plan.cs)), INT8_INSTRUCTION)


def int8_mm_splits(in_dim: int, cs: int) -> list[tuple[int, int]]:
    """The column ranges [lo, hi) of the cs ranges of the int8 kernel's K
    split: contiguous runs of K chunks, rank order."""
    return _splits(in_dim, INT8_K_CHUNK, cs)


def int8_mm_plain(x, w_all, s_all, li: int):
    """Plain PyTorch int8 product: x [rows, in], w_all int8 [L, out, in],
    s_all f32 [L, out] -> f32 [rows, out].  Widens the whole layer to x's
    dtype (a copy in memory), one f32-result product, then the row scales:
    the JAX expression, which XLA fuses and PyTorch does not."""
    return matmul_f32(x, w_all[li].to(x.dtype).t()) * s_all[li]


def int8_mm_split_plain(x, w_all, s_all, li: int, cs: int,
                        k_step: int | None = None):
    """Plain model of the int8 kernel's fold: each of the cs ranges of
    `int8_mm_splits` sums its share in f32 from zero (with `k_step`, as
    the kernel's chain does: one f32 product a k_step columns, added in
    order), the ranges' sums are added in rank order from zero, then
    scaled per output column."""
    w = w_all[li].to(x.dtype)
    acc = 0.0
    for a, b in int8_mm_splits(w.shape[-1], cs):
        part = 0.0
        for lo in range(a, b, k_step or b - a):
            hi = min(b, lo + (k_step or b - a))
            part = part + matmul_f32(x[:, lo:hi], w[:, lo:hi].t())
        acc = acc + part
    return acc * s_all[li]


def int8_mm(x, w_all, s_all, li: int, rowinv: bool = False):
    """f32 [rows, out] = (x @ w_all[li].T) * s_all[li] (`rowinv`: on the
    row-invariant plan)."""
    if x.device.type == "cpu":
        return int8_mm_plain(x, w_all, s_all, li)
    if x.device.type != "cuda":
        raise NotImplementedError(f"int8_mm on {x.device}")
    if x.dim() != 2 or w_all.dim() != 3 or s_all.dim() != 2:
        raise ValueError(f"int8_mm kernel: x{tuple(x.shape)} "
                         f"w{tuple(w_all.shape)} s{tuple(s_all.shape)}")
    rows, in_dim = x.shape
    n_layers, out_dim, k = w_all.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8_mm kernel takes bf16 x, got {x.dtype}")
    if w_all.dtype != torch.int8 or s_all.dtype != torch.float32:
        raise ValueError("int8_mm kernel takes int8 weights and f32 scales, "
                         f"got {w_all.dtype}, {s_all.dtype}")
    if in_dim != k or in_dim % INT8_K_CHUNK:
        raise ValueError(f"int8_mm kernel: in {in_dim} against weights' {k} "
                         f"(needs equal, a multiple of {INT8_K_CHUNK})")
    if s_all.shape != (n_layers, out_dim):
        raise ValueError(f"int8_mm kernel: scales {tuple(s_all.shape)}")
    if not 0 <= li < n_layers:
        raise ValueError(f"int8_mm kernel: layer {li} of {n_layers}")
    _check_operands("int8_mm", x, w_all=w_all, s_all=s_all)
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    sms = cuda_lib.sm_count(x.device)
    lp = int8_mm_launch(rows, out_dim, in_dim, sms, rowinv)
    err = cuda_lib.kernels().vt_int8_mm(
        x.data_ptr(), w_all.data_ptr(), s_all.data_ptr(), out.data_ptr(),
        rows, out_dim, in_dim, li, len(lp.ranges), int(lp.seq), lp.blocks,
        lp.tile_rows, cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "int8_mm")
    int8_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
int8_mm.launches = 0
