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
    plan of `bf16_mm_plan`: one tile, and a K split whose ranges and fold
    order are a function of (out, K) and the card's SM count, never of the
    rows.  How the split runs (a cluster of blocks, one range each, or
    single blocks walking the ranges in turn: the same bits) follows the
    tile count, `bf16_mm_seq`.  It takes bf16 x [rows, K], contiguous,
    and w [out, K] either contiguous (the weights as the JAX package stores
    them) or the transpose view of a contiguous [K, out] (the conv stem's
    im2col weights as stored, read in place: `out` a multiple of 8), K a
    multiple of 64, and raises on anything else.
  * CPU tensors take `bf16_mm_plain`, `matmul_f32`.
"""

from __future__ import annotations

import functools

import torch

from ..models.quant import matmul_f32
from . import cuda_lib
from .quant_mm import (
    _BLOCK_RESERVED,
    _SM_SMEM,
    MAX_CLUSTER,
    MmPlan,
    _check_operands,
)

# csrc/bf16_mm.cu's tile: columns of K per ring stage, output columns and
# rows of x per tile (wgmma m64n64k16 on two warpgroups), threads, ring
# stages (a cluster's blocks, the single blocks), and the blocks an SM
# holds by registers (its __launch_bounds__)
K_CHUNK = 64
BLOCK_N = 128
BLOCK_M = 64
THREADS = 256
STAGES = {False: 3, True: 4}
REG_BLOCKS = 2


def bf16_mm_smem(cs: int, seq: bool = False) -> int:
    """Dynamic shared memory of a block: 1 KB to start on a 1024-byte
    boundary, the ring (stages of x's and the weights' boxes), its barriers
    (128 bytes) and, for a cluster's split, the partial sums (32 f32 a
    thread); `seq`: a single block's."""
    ring = 1024 + STAGES[seq] * (BLOCK_M + BLOCK_N) * K_CHUNK * 2 + 128
    return ring + (BLOCK_M * 64 // 128 * THREADS * 4
                   if cs > 1 and not seq else 0)


def bf16_mm_blocks_per_sm(cs: int, seq: bool = False) -> int:
    """Blocks (a cluster's of split cs, or `seq` single ones) one SM holds,
    by shared memory and registers."""
    return min(REG_BLOCKS,
               _SM_SMEM // (bf16_mm_smem(cs, seq) + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)
def bf16_mm_plan(out: int, in_dim: int, sms: int = 132) -> MmPlan:
    """csrc/bf16_mm.cu's launch for a [rows, in] x [out, in] product at any
    row count: the K range split over a cluster of cs blocks so that the
    tiles of one row tile (`tiles`: ceil(out / 128)) fill about one wave,
    and a full wave of clusters walking the tiles (those past the last
    tile exit).  A function of (out, in) and the card alone, so a row's
    bits never depend on how many rows share the call."""
    col_tiles = -(-out // BLOCK_N)
    chunks = -(-in_dim // K_CHUNK)
    cs = max(1, min(MAX_CLUSTER, chunks,
                    sms * bf16_mm_blocks_per_sm(2) // col_tiles))
    per_sm = bf16_mm_blocks_per_sm(cs)
    return MmPlan(BLOCK_M // 8, cs, sms * per_sm // cs, col_tiles, per_sm)


def bf16_mm_seq(rows: int, plan: MmPlan, sms: int = 132) -> bool:
    """How the plan's split runs at `rows` rows: on single blocks, each
    walking the split's ranges in turn (True), once the tiles fill at
    least half a wave of them; below that on the plan's clusters of cs
    blocks, one range each, where the split keeps the card's loads in
    flight.  Both give the same bits (csrc/bf16_mm.cu), so only time
    follows the rows."""
    n_tiles = plan.tiles * -(-rows // BLOCK_M)
    return 2 * n_tiles >= sms * bf16_mm_blocks_per_sm(1, seq=True)


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
    plan = bf16_mm_plan(out_dim, in_dim, sms)
    seq = bf16_mm_seq(rows, plan, sms)
    blocks = (sms * bf16_mm_blocks_per_sm(1, seq=True) if seq
              else plan.clusters)
    err = cuda_lib.kernels().vt_bf16_mm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, out_dim, in_dim,
        plan.cs, int(seq), int(w_t), blocks, cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "bf16_mm")
    bf16_mm.launches += 1
    return out


# kernel launches since the last reset (CPU calls never count)
bf16_mm.launches = 0
