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
    `rowinv` (the streaming encoder side, models/decoder.py:_use_rowinv)
    on `int4_mm_rowinv_plan` / `int8_mm_rowinv_plan`, a function of
    (out, K) and the card without the row count, so that a row's bits do
    not depend on how many rows share the call.
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
# csrc/int8_mm.cu's: columns of K per chunk (a ring stage of two 64-column
# TMA boxes), the same cluster, and its tiles as above plus a 64-row decode
# tile, with their ring stages (one accumulator set, twice the weight bytes
# a stage: the 16-row tile holds 4 blocks an SM by shared memory, not 5;
# the 64-row one 3 on 3 stages, 2 with a K split's partials)
INT8_K_CHUNK = 128
_TILES8 = {  # nj: (block_n, threads, reg_blocks, stages)
    2: (64, 128, 4, 4),
    4: (64, 128, 3, 4),
    8: (64, 128, 3, 3),
    16: (128, 256, 1, 4),
}
_SM_SMEM = 233472          # shared memory per SM on the H100 (228 KB)
_BLOCK_RESERVED = 1024     # the runtime's per-block share


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

def int8_mm_smem(nj: int, cs: int) -> int:
    """Dynamic shared memory of a block of csrc/int8_mm.cu: 1 KB to start
    on a 1024-byte boundary, the ring (stages of x's two bf16 boxes, the
    weights' two byte boxes and the tile's f32 scales), its barriers (128
    bytes) and, with a K split, the decode tile's partial sums (4 nj
    outputs per thread, f32)."""
    bn, threads, _, stages = _TILES8[nj]
    ring = 1024 + stages * (8 * nj * 2 * INT8_K_CHUNK + bn * INT8_K_CHUNK
                            + bn * 4) + 128
    return ring + (4 * nj * threads * 4 if cs > 1 and nj != 16 else 0)


def int8_mm_blocks_per_sm(nj: int, cs: int) -> int:
    """Blocks of the int8 kernel's tile width nj (K split cs) one SM holds,
    by shared memory and registers."""
    return min(_TILES8[nj][2],
               _SM_SMEM // (int8_mm_smem(nj, cs) + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)
def int8_mm_plan(rows: int, out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/int8_mm.cu's launch for an [rows, in] x [out, in] product
    (`_plan`, in K chunks of INT8_K_CHUNK columns)."""
    return _plan(rows, out, -(-in_dim // INT8_K_CHUNK), _TILES8,
                 int8_mm_blocks_per_sm, sms)


@functools.lru_cache(maxsize=None)
def int8_mm_rowinv_plan(out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/int8_mm.cu's row-invariant launch for an [any, in] x [out, in]
    product (`_rowinv_plan`)."""
    return _rowinv_plan(out, -(-in_dim // INT8_K_CHUNK), _TILES8,
                        int8_mm_blocks_per_sm, sms)


def int8_mm_splits(in_dim: int, cs: int) -> list[tuple[int, int]]:
    """The column ranges [lo, hi) of the cs blocks of the int8 kernel's K
    split: contiguous runs of K chunks, rank order (the kernel's c_lo)."""
    return _splits(in_dim, INT8_K_CHUNK, cs)


def int8_mm_plain(x, w_all, s_all, li: int):
    """Plain PyTorch int8 product: x [rows, in], w_all int8 [L, out, in],
    s_all f32 [L, out] -> f32 [rows, out].  Widens the whole layer to x's
    dtype (a copy in memory), one f32-result product, then the row scales:
    the JAX expression, which XLA fuses and PyTorch does not."""
    return matmul_f32(x, w_all[li].to(x.dtype).t()) * s_all[li]


def int8_mm_split_plain(x, w_all, s_all, li: int, cs: int):
    """Plain model of the int8 kernel's K split: each of the cs ranges of
    `int8_mm_splits` sums its share in f32, the partials are added in rank
    order, then scaled per row -- the kernel's fold."""
    w = w_all[li].to(x.dtype)
    acc = 0.0
    for a, b in int8_mm_splits(w.shape[-1], cs):
        acc = acc + matmul_f32(x[:, a:b], w[:, a:b].t())
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
    plan = (int8_mm_rowinv_plan(out_dim, in_dim, sms) if rowinv
            else int8_mm_plan(rows, out_dim, in_dim, sms))
    err = cuda_lib.kernels().vt_int8_mm(
        x.data_ptr(), w_all.data_ptr(), s_all.data_ptr(), out.data_ptr(),
        rows, out_dim, in_dim, li, plan.nj, plan.cs, plan.clusters,
        cuda_lib.stream_handle(x.device),
    )
    cuda_lib.check(err, "int8_mm")
    int8_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
int8_mm.launches = 0
