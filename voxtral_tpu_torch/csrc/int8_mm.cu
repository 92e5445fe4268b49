// int8 weight-only matmul (W8A16): the weights stay int8 in device memory.
//
// The counterpart of a fusion, not of a Pallas kernel: the JAX package's
// int8 product (voxtral_tpu/models/quant.py:mm, and the int8 table of
// voxtral_tpu/models/decoder.py:final_logits) is
//     einsum(x, w.astype(bf16), preferred_element_type=f32) * s
// which XLA fuses, so the int8 -> bf16 convert runs in the product's
// operand stream and only int8 bytes leave device memory.  Same function:
//     y[m, n] = s[n] * sum_k x[m, k] * w[n, k]
// x is bf16 [M, K], w is layer li of an int8 [L, N, K] stack, s is f32
// [L, N], y is f32 [M, N].  Products are exact (an int8 weight in
// [-127, 127] is exact in bf16); the sums are f32 and the scale comes after
// the sums of all of K.
//
// What bounds it on the H100: at decode (M = streams, 1..80) device-memory
// bytes of the weights, one byte a weight (a decode step's 105 products
// are 3.43 GB); at batched prefill (M = 38 x streams) tensor-core math.
// One tile for both, on the ring of csrc/wgmma_ring.cuh (shared with
// bf16_mm.cu; its header says more): blocks of 384 threads, a producer
// warpgroup issuing every TMA copy, two consumer warpgroups of 64 output
// columns, tiles of 128 output columns x 64 R rows of x (R = 1, two blocks
// an SM, or 2, one), a ring of stages of KB = 128 columns of K as deep as
// that residency allows (3 and 4 stages), and a K split fixed by (N, K)
// that runs on a cluster or on single blocks with the same bits.
//   * The weights are wgmma's A operand, widened in registers: a thread
//     reads the bytes of its m64n64k16 A fragment (rows g and g + 8 of its
//     warp's 16, columns 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9 of a
//     k16 step) with four 4-byte loads from the weights' box of 128-byte
//     rows in TMA's 128-byte swizzle (16-byte piece q of row r at
//     q ^ (r & 7): conflict-free), and widens two bytes into a bf16x2 word
//     with prmt, two lop3 and one subtract: (u & 0x7F) | 0x4300 read as
//     bf16 is 128 + (u & 127), and (u & 0x80) | 0x4300 is 128 or 256;
//     their difference is the two's-complement value of u, exactly.
//     Nothing widened is written to memory.  A stage's 8 k16 steps are
//     loaded together (32 loads a thread), widened and issued as one group
//     once the group before is done.
//   * x is the B operand, read by descriptor from x's boxes in the 128-byte
//     swizzle: every warpgroup reads a stage's x once per instruction (2
//     bytes of x a weight byte at n = 64), not once per warp as mma.sync
//     tiles must.
//   * One instruction for every output element at every M: wgmma
//     m64n64k16, issued R times a k16 step (once for each 64-row fragment
//     of x).  Rows past M are zeros from TMA's out-of-bounds fill and are
//     never stored; a row never meets another row in a sum, so a row's
//     bits do not depend on how many rows share the call (the
//     row-invariant plan, ops/quant_mm.py int8_mm_rowinv_plan, fixes the K
//     split by (N, K) alone).
//   * The 64-row tile runs a split on clusters only (its single blocks
//     hold no registers for folded sums beside the A fragments); a
//     cluster's fold stages and receives its sums in the idle ring, which
//     gives it the single blocks' 3 stages.

#include "wgmma_ring.cuh"

namespace {

constexpr int KB = 128;   // columns of K a ring stage: 128-byte weight rows
constexpr int KS = KB / 16;   // k16 steps a stage


// Two bf16 weights from a word holding int8 bytes u at bits 0-7 and 16-23,
// the lower byte's in the lower half: (128 + (u & 127)) - (128 + (u & 128)).
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t t) {
  const uint32_t lo = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
              *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// d += a b over m64 n64 k16: a, the warp's 16 x 16 slice of A, in
// registers (the m16n8k16 A layout); b, 64 rows of x, K-major, from shared
// memory by descriptor; d, the warp's 16 x 64 slice, 32 floats a thread
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// CL false: single blocks walking the split's ranges (the 64-row tile: one
// range, its 104 registers hold no folded sums); CL true: a cluster of
// `split` blocks per tile (wgmma_ring.cuh ring_mm, the fold received in the
// idle ring).  s: layer li's scales (the stack's from li N).
template <int BM, bool CL>
__global__ void __launch_bounds__(THREADS, BM == 64 ? 2 : 1)
int8_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ s, float* __restrict__ y, int M,
               int N, int K, int split) {
  using C = Tile<BM, CL, 1, KB, true>;
  constexpr int R = C::R;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int g = lane >> 2, tig = lane & 3;
  const int n_mt = (M + C::BM - 1) / C::BM;
  // the thread's A rows r and r + 8 of the weights' box (the same
  // swizzle: 16-byte piece q of row r at q ^ sw), and the byte pair of a
  // word it takes, spread to bits 0-7 and 16-23
  const int r = 64 * wg + 16 * wq + g;
  const int sw = r & 7;
  const uint32_t pair_sel = (tig & 1) ? 0x4342 : 0x4140;
  const CUtensorMap* const mw = &map_w;
  uint32_t a[KS][4];   // the A fragments of a stage's k16 steps
  ring_mm<C, CL, !CL && BM == 128>(
      aligned_smem(smem_raw), &map_x, mw, M, N, K, split,
      [&](uint32_t dst, int k0, int n0, uint32_t bar) {
        tma_2d(dst, mw, k0, n0, bar);
      },
      // acc += this warpgroup's 64 output columns x 64 R rows over the
      // stage's KB columns of K as one group of KB / 16 k16 steps, left in
      // flight: once the group before is done, the A fragments of every
      // step are loaded (the loads issued together), widened, and fed to
      // the wgmma chain.  Step ks reads x's box ks / 4 from 32 (ks % 4)
      // bytes on, and the bytes 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9
      // of the weights' piece ks of rows r and r + 8.
      [&](uint32_t ws, uint32_t xs, float (&acc)[R][32]) {
        wgmma_wait<0>();
        uint32_t u[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t a0 = ws + r * KB + ((ks ^ sw) << 4) + 4 * (tig >> 1);
          const uint32_t a1 = a0 + 8 * KB;
          u[ks][0] = ld_shared4(a0);
          u[ks][1] = ld_shared4(a1);
          u[ks][2] = ld_shared4(a0 + 8);
          u[ks][3] = ld_shared4(a1 + 8);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[ks][e] = bytes_bf16x2(__byte_perm(u[ks][e], 0u, pair_sel));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int j = 0; j < R; ++j)
            wgmma_m64n64k16_rs(acc[j], a[ks],
                               desc_sw128(xs + (ks / 4) * C::X_BOX +
                                          j * 64 * 128 + 32 * (ks % 4)));
        wgmma_commit();
      },
      // the folded sum times the output column's scale
      [&](int t, int I, float v) {
        const int j = I >> 5, i = I & 31;
        const int q = i >> 2, e = (i >> 1) & 1, c = i & 1;
        const int n = (t / n_mt) * BN + 64 * wg + 16 * wq + g + 8 * e;
        const int m = (t % n_mt) * BM + 64 * j + 8 * q + 2 * tig + c;
        if (n < N && m < M) y[(size_t)m * N + n] = v * __ldg(s + n);
      });
}

// the two tensor maps: x [M][K] bf16 in boxes of 64 columns x bm rows,
// layer li's weights [N][K] bytes in boxes of KB columns x BN rows, both in
// the 128-byte swizzle
bool encode_maps(CUtensorMap (&m)[2], const void* x, const uint8_t* w, int M,
                 int N, int K, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sx[1] = {2 * (cuuint64_t)K};
  const cuuint32_t bx[2] = {BK, (cuuint32_t)bm};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t sw[1] = {(cuuint64_t)K};
  const cuuint32_t bw[2] = {KB, BN};
  return encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dx, sx, bx, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<uint8_t*>(w), dw, sw, bw, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernels opted into their shared memory, by [BM / 128][CL], a bit a
// device
unsigned configured[2][2] = {};

template <int BM, bool CL>
int launch(const CUtensorMap (&maps)[2], const float* s, float* y, int M,
           int N, int K, int split, int blocks, cudaStream_t st) {
  return launch_ring<Tile<BM, CL, 1, KB, true>>(
      int8_mm_kernel<BM, CL>, configured[BM / 128][CL], CL ? split : 1,
      blocks, st, maps[0], maps[1], s, y, M, N, K, split);
}

template <int BM, bool CL>
int blocks_per_sm() {
  using C = Tile<BM, CL, 1, KB, true>;
  return occupancy<C>(int8_mm_kernel<BM, CL>, configured[BM / 128][CL],
                      C::ST);
}

}  // namespace

// x bf16 [M, K]; w_all int8 [L, N, K]; s_all f32 [L, N]; y f32 [M, N]; all
// contiguous and 16-byte aligned, K % 128 == 0.  The plan (ops/quant_mm.py
// int8_mm_launch: int8_mm_rowinv_plan, a function of N, K and the card, or
// int8_mm_plan, of the rows too): a K split of `split` in 1 .. 8 ranges (at
// least one 128-column chunk each); tile_rows 64 or 128, the rows of x a
// tile holds.  `seq` 0 runs the split on a cluster of split blocks per
// tile (every tile at once; the 64-row tile only), 1 on `blocks` single
// blocks walking the tiles (the same bits; the 64-row tile: split 1).
// Returns a cudaError_t code.
extern "C" int vt_int8_mm(const void* x, const void* w_all, const void* s_all,
                          void* y, int M, int N, int K, int li, int split,
                          int seq, int blocks, int tile_rows, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % KB != 0 || li < 0 || split < 1 ||
      split > MAX_CLUSTER || split > K / KB || blocks < 1 ||
      (tile_rows != 64 && tile_rows != 128) || (!seq && tile_rows != 64) ||
      (seq && tile_rows == 64 && split != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles =
      (long long)((N + BN - 1) / BN) * ((M + tile_rows - 1) / tile_rows);
  if (!seq && n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int grid = seq ? (int)(blocks < n_tiles ? blocks : n_tiles)
                       : (int)n_tiles;
  const uint8_t* w = static_cast<const uint8_t*>(w_all) + (size_t)li * N * K;
  const float* s = static_cast<const float*>(s_all) + (size_t)li * N;
  CUtensorMap maps[2];
  if (!encode_maps(maps, x, w, M, N, K, tile_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(y);
  if (tile_rows == 64)
    return seq ? launch<64, false>(maps, s, out, M, N, K, split, grid, st)
               : launch<64, true>(maps, s, out, M, N, K, split, grid, st);
  return launch<128, false>(maps, s, out, M, N, K, split, grid, st);
}

// Blocks of the kernel (tile_rows 64 or 128; seq: the single blocks', else
// a cluster's, 64-row tile only) resident on one SM of the current device,
// or -cudaError_t: what the launch's residency assumes.
extern "C" int vt_int8_mm_occupancy(int seq, int tile_rows) {
  if (tile_rows == 64)
    return seq ? blocks_per_sm<64, false>() : blocks_per_sm<64, true>();
  return seq && tile_rows == 128 ? blocks_per_sm<128, false>()
                                 : -(int)cudaErrorInvalidValue;
}
