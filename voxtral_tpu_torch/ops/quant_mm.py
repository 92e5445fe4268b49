"""int4 weight-only matmul (W4A16): nibble-packed weights, unpacked on chip.

Packing (models/quant.py `_quantize4`): low nibbles hold input columns
[0, in/2), high nibbles [in/2, in); one f32 scale per (output row, half).
The product is

    y = (x[:, :in/2] @ lo.T) * s[:, 0] + (x[:, in/2:] @ hi.T) * s[:, 1]

with f32 accumulation and an f32 result [rows, out].

`int4_mm` dispatches on the device of its inputs:
  * CUDA tensors launch `voxtral_tpu_torch/csrc/int4_mm.cu` (it replaces
    the Pallas kernel voxtral_tpu/ops/quant_mm.py:_kernel; its header says
    what bounds it on the H100 and how the design meets it).  It takes bf16
    x with an input dim that is a multiple of 32, contiguous operands, and
    raises on anything else.  One launch per call, on the plan of
    `int4_mm_plan` (tile, K split over a thread-block cluster, clusters),
    a function of the shapes alone.
  * CPU tensors take `int4_mm_plain` (the JAX package's `_mm4`).

Both take the STACKED [L, out, in/2] weight and a layer index, the JAX
function's signature; for the logits table pass p[None] with li=0.  The
stream axis is folded into the rows by the caller, so one launch reads the
weights once for every stream of the batch.
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


def int4_mm_smem(nj: int, cs: int) -> int:
    """Dynamic shared memory of a block: 1 KB to start on a 1024-byte
    boundary, the ring (stages of both x tiles, the packed tile and the
    tile's f32 scales), its barriers (128 bytes) and, with a K split, the
    decode tile's partial sums (2 halves x 4 nj outputs per thread, f32)."""
    bn, threads, _ = _TILES[nj]
    ring = 1024 + STAGES * (2 * 8 * nj * 2 * K_CHUNK + bn * K_CHUNK
                            + bn * 8) + 128
    return ring + (2 * 4 * nj * threads * 4 if cs > 1 and nj != 16 else 0)


class Int4Plan(NamedTuple):
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


@functools.lru_cache(maxsize=None)
def int4_mm_plan(rows: int, out: int, half: int, sms: int = 132) -> Int4Plan:
    """The kernel's launch for an [rows, 2 half] x [out, half] product on a
    card of `sms` SMs: never more blocks than the card holds at once.

    Rows up to 16 take the 16-row tile, up to 64 the 32-row one, more the
    wgmma prefill tile when its tiles give at least half a block per SM
    (else the 32-row tile).  Where the tiles fill less than one wave, the K
    range is split over a cluster of cs blocks (the prefill tile never
    splits: its partials would not fit beside its stages)."""
    def tiles(nj):
        return -(-out // _TILES[nj][0]) * -(-rows // (8 * nj))

    nj = 2 if rows <= 16 else 4
    if rows > 64 and tiles(16) * 2 >= sms:
        nj = 16
    n_tiles = tiles(nj)
    chunks = -(-half // K_CHUNK)
    cs = 1
    if nj != 16 and n_tiles < sms * int4_mm_blocks_per_sm(nj, 1):
        cs = max(1, min(MAX_CLUSTER, chunks,
                        sms * int4_mm_blocks_per_sm(nj, 2) // n_tiles))
    per_sm = int4_mm_blocks_per_sm(nj, cs)
    return Int4Plan(nj, cs, min(n_tiles, sms * per_sm // cs), n_tiles,
                    per_sm)


def int4_mm_splits(half: int, cs: int) -> list[tuple[int, int]]:
    """The packed-column ranges [lo, hi) of the cs blocks of a K split:
    contiguous runs of K chunks, rank order (the kernel's c_lo)."""
    chunks = -(-half // K_CHUNK)
    return [(r * chunks // cs * K_CHUNK,
             min(half, (r + 1) * chunks // cs * K_CHUNK)) for r in range(cs)]


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


def int4_mm(x, p_all, s_all, li: int):
    """f32 [rows, out] = x @ unpack(p_all[li]).T with per-half scales."""
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
    for name, t in (("x", x), ("p_all", p_all), ("s_all", s_all)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"int4_mm kernel: {name} must be contiguous "
                             f"on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"int4_mm kernel: {name} not 16-byte aligned")
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    plan = int4_mm_plan(rows, out_dim, half, cuda_lib.sm_count(x.device))
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
