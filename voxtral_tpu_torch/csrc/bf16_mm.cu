// Row-invariant bf16 product: y[m, n] = sum_k x[m, k] w[n, k], f32 out.
//
// The counterpart of an XLA product, not of a Pallas kernel: the JAX
// package's float products (voxtral_tpu/models/quant.py:mm,
// einsum(preferred_element_type=f32)) and its conv stem's im2col products.
// The port computes them with cuBLAS elsewhere (models/quant.py
// matmul_f32); on the streaming encoder side and in the decoder of a bf16
// config it takes this kernel instead, because cuBLAS picks its algorithm
// and its K split by the row count M, so the same row rounds differently
// when the feed is chunked differently or the batch is another size.  Here
// a row's bits depend on that row and the weights alone:
//   * One instruction for every output element at every M: wgmma
//     m64n64k16, 64 output columns (the weights, the A operand) x 64 rows
//     of x (the B operand), both read from shared memory.  A tile of 128
//     output columns x 64 R rows of x issues it R times per k16 step, once
//     for each 64-row block of x (R = 1 or 2, by M: ops/bf16_mm.py
//     bf16_mm_tile_rows); each element still sees the same instruction
//     sequence.  Rows past M are zeros from TMA's out-of-bounds fill and
//     are never stored; a row never meets another row in a sum.
//   * K is walked in chunks of 64 columns in order, split into SPLIT
//     contiguous ranges, SPLIT chosen from (N, K) by the caller
//     (ops/bf16_mm.py bf16_mm_plan), never from M.  Each range is summed
//     from zero, and the ranges' sums are added in range order, from zero:
//     the same operations on every path below.
//   * Two ways to run that split, which give the same bits: a cluster of
//     SPLIT blocks per tile, one range each, whose sums are pushed to the
//     rank that folds them (few tiles: the split keeps the card's loads in
//     flight at a streaming chunk's or a decode step's few rows); or single
//     blocks that walk the ranges in turn and fold them in registers,
//     persistent over the tiles a grid apart (enough tiles to fill the
//     card).  The caller picks one from the tile count (bf16_mm_seq; the
//     clusters run the 64-row tile only, the few-row case they serve);
//     neither changes a row's bits.
// x is bf16 [M, K], y f32 [M, N].  w is bf16 [N, K], the weight as the JAX
// package stores it, or, WT, [K, N], the conv stem's im2col weight as it is
// stored: TMA then loads boxes of 64 output columns x 64 rows of K, and the
// wgmma reads them as its A operand transposed (MN-major), so no transposed
// copy of the weight is kept.  Both layouts give the same bits.
//
// What bounds it on the H100: at a streaming chunk's or a decode step's
// few rows the weights' bytes (2 a weight: an encoder layer's four
// products are 60 MB, a decode step's 105 are 7.2 GB); at hundreds of rows
// the tensor cores.  The design is the ring of csrc/wgmma_ring.cuh (shared
// with int8_mm.cu; its header says more), blocks of 384 threads:
//   * One thread of a producer warpgroup issues every TMA copy (of the 80
//     registers a thread two blocks an SM have, 32 there and 104 in the
//     consumers; of one block's 168, 40 and 232) into a ring of stages: 64
//     columns of K, the weights' box of 128 rows and x's box of 64 R rows,
//     both in TMA's 128-byte swizzle.  Every stage the ring holds is in
//     flight at once: 96-128 KB of weights an SM.
//   * Two consumer warpgroups, each owning 64 output columns of the tile,
//     run the wgmma chain on each stage as it lands, both operands from
//     shared memory, and hand the stage back once their group of the
//     stage before it is done.  R = 2 halves the weights' re-reads at many
//     rows: a 24 KB stage feeds 1 MFLOP at R = 1, a 32 KB stage 2 MFLOP at
//     R = 2.
//   * The cluster's fold and programmatic dependent launch: wgmma_ring.cuh.

#include "wgmma_ring.cuh"

namespace {

// d += a b over m64 n64 k16, both operands bf16 in shared memory by
// descriptor: a, 64 rows of the weights (K-major, or MN-major when TA);
// b, 64 rows of x, K-major; d, the warp's 16 x 64 slice, 32 floats a thread
template <int TA>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// CL false: single blocks walking the split's ranges; CL true: a cluster
// of `split` blocks per tile (wgmma_ring.cuh ring_mm).  WT: the weights
// stored [K, N].
template <int R, bool CL, bool WT>
__global__ void __launch_bounds__(THREADS, R == 1 ? 2 : 1)
bf16_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               float* __restrict__ y, int M, int N, int K, int split) {
  using C = Tile<64 * R, CL, 2>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int g = lane >> 2, tig = lane & 3;
  const int n_mt = (M + C::BM - 1) / C::BM;
  const CUtensorMap* const mw = &map_w;
  ring_mm<C, CL>(
      aligned_smem(smem_raw), &map_x, mw, M, N, K, split,
      // the weights' box (WT: a box for each warpgroup's 64 output columns)
      [&](uint32_t dst, int k0, int n0, uint32_t bar) {
        if (WT) {
          tma_2d(dst, mw, n0, k0, bar);
          tma_2d(dst + C::W_BYTES / 2, mw, n0 + BN / 2, k0, bar);
        } else {
          tma_2d(dst, mw, k0, n0, bar);
        }
      },
      // acc += this warpgroup's 64 output columns x 64 R rows over the
      // stage's 64 columns of K: 4 k16 steps in order for each 64-row
      // fragment, one group, left in flight; then the stage before's group
      // is waited for.  A k16 step starts 32 bytes on in a K-major box's
      // 128-byte rows, 16 rows (two 1024-byte swizzle atoms) on in a WT
      // box; fragment j, 64 rows (8 KB) on in x's box.
      [&](uint32_t w_slot, uint32_t xs, float (&acc)[R][32]) {
        const uint32_t ws = w_slot + wg * 64 * BK * 2;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < R; ++j)
            wgmma_m64n64k16_ss<WT ? 1 : 0>(
                acc[j], desc_sw128(ws + (WT ? 16 * 128 : 32) * ks),
                desc_sw128(xs + j * 64 * 128 + 32 * ks));
        wgmma_commit();
        wgmma_wait<1>();
      },
      [&](int t, int I, float v) {
        const int j = I >> 5, i = I & 31;
        const int q = i >> 2, e = (i >> 1) & 1, c = i & 1;
        const int n = (t / n_mt) * BN + 64 * wg + 16 * wq + g + 8 * e;
        const int m = (t % n_mt) * C::BM + 64 * j + 8 * q + 2 * tig + c;
        if (n < N && m < M) y[(size_t)m * N + n] = v;
      });
}

// the two tensor maps (see the producer): x [M][K] in boxes of 64 columns
// x bm rows, w [N][K] in boxes of 64 columns x BN rows (wt: w [K][N] in
// boxes of BN / 2 columns x 64 rows), all bf16 in the 128-byte swizzle
bool encode_maps(CUtensorMap (&m)[2], const void* x, const void* w, int M,
                 int N, int K, bool wt, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)(wt ? N : K), (cuuint64_t)(wt ? K : N)};
  const cuuint64_t stride[1] = {2 * (cuuint64_t)K};
  const cuuint64_t stride_w[1] = {2 * (cuuint64_t)(wt ? N : K)};
  const cuuint32_t bx[2] = {BK, (cuuint32_t)bm};
  const cuuint32_t bw[2] = {(cuuint32_t)(wt ? BN / 2 : BK),
                            (cuuint32_t)(wt ? BK : BN)};
  return encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dx, stride, bx, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(w), dw, stride_w, bw, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernels opted into their shared memory, by [R - 1][CL][WT], a bit a
// device
unsigned configured[2][2][2] = {};

template <int R, bool CL, bool WT>
int launch(const CUtensorMap (&maps)[2], float* y, int M, int N, int K,
           int split, int blocks, cudaStream_t st) {
  return launch_ring<Tile<64 * R, CL, 2>>(
      bf16_mm_kernel<R, CL, WT>, configured[R - 1][CL][WT], CL ? split : 1,
      blocks, st, maps[0], maps[1], y, M, N, K, split);
}

template <int R, bool CL>
int launch_wt(bool w_t, const CUtensorMap (&maps)[2], float* y, int M, int N,
              int K, int split, int blocks, cudaStream_t st) {
  return w_t ? launch<R, CL, true>(maps, y, M, N, K, split, blocks, st)
             : launch<R, CL, false>(maps, y, M, N, K, split, blocks, st);
}

template <int R, bool CL, bool WT>
int blocks_per_sm() {
  using C = Tile<64 * R, CL, 2>;
  return occupancy<C>(bf16_mm_kernel<R, CL, WT>, configured[R - 1][CL][WT],
                      C::ST);
}

template <int R, bool CL>
int blocks_per_sm_wt(bool w_t) {
  return w_t ? blocks_per_sm<R, CL, true>() : blocks_per_sm<R, CL, false>();
}

}  // namespace

// x bf16 [M, K]; w bf16 [N, K] or, w_t, [K, N]; y f32 [M, N]; all
// contiguous and 16-byte aligned, K % 64 == 0 (w_t: N % 8 == 0).  The plan
// (ops/bf16_mm.py bf16_mm_plan, a function of N, K and the card): a K split
// of `split` in 1 .. 8 ranges (at least one 64-column chunk each);
// tile_rows 64 or 128, the rows of x a tile holds (bf16_mm_tile_rows).
// `seq` 0 runs the split on a
// cluster of split blocks per tile (every tile at once; the 64-row tile
// only), 1 on `blocks` single blocks walking the tiles (the same bits).
// Returns a cudaError_t code.
extern "C" int vt_bf16_mm(const void* x, const void* w, void* y, int M, int N,
                          int K, int split, int seq, int w_t, int blocks,
                          int tile_rows, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || split < 1 ||
      split > MAX_CLUSTER || split > K / BK || blocks < 1 ||
      (w_t && N % 8 != 0) || (tile_rows != 64 && tile_rows != 128) ||
      (!seq && tile_rows != 64))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles =
      (long long)((N + BN - 1) / BN) * ((M + tile_rows - 1) / tile_rows);
  if (!seq && n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int grid = seq ? (int)(blocks < n_tiles ? blocks : n_tiles)
                       : (int)n_tiles;
  CUtensorMap maps[2];
  if (!encode_maps(maps, x, w, M, N, K, w_t != 0, tile_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(y);
  const bool wt = w_t != 0;
  if (tile_rows == 64)
    return seq ? launch_wt<1, false>(wt, maps, out, M, N, K, split, grid, st)
               : launch_wt<1, true>(wt, maps, out, M, N, K, split, grid, st);
  return launch_wt<2, false>(wt, maps, out, M, N, K, split, grid, st);
}

// Blocks of the kernel (tile_rows 64 or 128; seq: the single blocks', else
// a cluster's, 64-row tile only; w_t: on [K, N] weights) resident on
// one SM of the current device, or -cudaError_t: what the launch's
// residency assumes.
extern "C" int vt_bf16_mm_occupancy(int seq, int w_t, int tile_rows) {
  const bool wt = w_t != 0;
  if (tile_rows == 64)
    return seq ? blocks_per_sm_wt<1, false>(wt)
               : blocks_per_sm_wt<1, true>(wt);
  return seq ? blocks_per_sm_wt<2, false>(wt)
             : -(int)cudaErrorInvalidValue;
}
