// int4 weight-only matmul (W4A16) with nibble-packed weights.
//
// Replaces voxtral_tpu/ops/quant_mm.py:_kernel (the Pallas kernel behind
// int4_mm).  Same function:
//     y[m, n] = s[n, 0] * sum_j x[m, j]        * lo(p[n, j])
//             + s[n, 1] * sum_j x[m, half + j] * hi(p[n, j])
// for j in [0, half), where byte p[n, j] holds the signed 4-bit weights of
// input columns j (low nibble) and half + j (high nibble): the columns of
// one byte are half the row apart, not neighbours.  x is bf16 [M, 2*half],
// p is layer li of an int8 [L, N, half] stack, s is f32 [L, N, 2], y is f32
// [M, N].  Products are exact in bf16 x int4; the sums are f32.
//
// What bounds it on the H100: at decode (M = streams, 1..64) device-memory
// bytes of the packed weights, 0.5 byte per weight, a few FLOP per byte;
// at batched prefill (M = 38 x streams) tensor-core math.  The design reads
// each packed byte from device memory once per block of rows and never
// writes the unpacked weights back: one block per (64 output columns,
// 16/32/64 rows of x) loops over the packed columns in chunks of 64 bytes,
// loads them 16 bytes per thread, sign-extends both nibbles in registers
// with explicit integer math (no shifts of negative values), stages the
// unpacked bf16 tiles of both halves and the matching x tiles in shared
// memory, and runs both products on the tensor cores through WMMA bf16
// 16x16x16 fragments into two f32 accumulators per tile, one per half.  The
// epilogue applies the per-(row, half) scales.  The ragged row and column
// edges are masked here, so the caller pads nothing.
//
// At decode the narrow matrices give few blocks (wo and w2: 48 column
// tiles for 132 SMs), each walking a long K loop with one 16-byte load per
// thread in flight.  So the K range is split over gridDim.z when the
// caller asks (k_split < half): each split writes its scaled partial sums
// to a workspace [splits, M, N], and a second kernel adds them in split
// order, so the result does not depend on scheduling.  Asynchronous copies
// (cp.async/TMA) and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 64;                // output columns per block
constexpr int BK = 64;                // packed columns (bytes) per k step
constexpr int NWARPS = BN / 16;       // one warp per 16 output columns
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDT = BK + 8;           // bf16 tiles' leading dim (elements)
constexpr int LDE = 16 + 4;           // f32 epilogue tile's leading dim
// blocks that fill an H100: 132 SMs, a few resident blocks each
constexpr int FILL_BLOCKS = 4 * 132;

// 16-row tiles of x per block for M rows
int row_tiles(int M) { return M <= 16 ? 1 : M <= 32 ? 2 : 4; }

// signed value of a 4-bit two's-complement nibble u in [0, 16)
__device__ __forceinline__ __nv_bfloat16 nibble(unsigned u) {
  return __int2bfloat16_rn((int)(u ^ 8u) - 8);
}

// two bf16 in one word, `a` at the lower address
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

template <int MT>  // 16-row tiles of x per block
__global__ void __launch_bounds__(NTHREADS)
int4_mm_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ p, const float* __restrict__ s,
               float* __restrict__ y, int M, int N, int half, int k_split) {
  constexpr int BM = 16 * MT;
  // x tiles of both halves [2][BM][LDT], unpacked weight tiles [2][BN][LDT]
  // (bf16), then the per-warp epilogue tiles [NWARPS][2][16][LDE] (f32):
  // 47 KB at MT = 4, under the 48 KB of static shared memory
  constexpr int X_ELEMS = BM * LDT, W_ELEMS = BN * LDT;
  __shared__ __align__(128) unsigned char smem[
      sizeof(__nv_bfloat16) * 2 * (X_ELEMS + W_ELEMS) +
      sizeof(float) * NWARPS * 2 * 16 * LDE];
  __nv_bfloat16* const xs_base = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const xs[2] = {xs_base, xs_base + X_ELEMS};
  __nv_bfloat16* const ws[2] = {xs_base + 2 * X_ELEMS,
                                xs_base + 2 * X_ELEMS + W_ELEMS};
  float* const es = reinterpret_cast<float*>(xs_base + 2 * (X_ELEMS + W_ELEMS));

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t K = 2 * (size_t)half;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][MT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[h][mt], 0.f);

  // this block's K range; split z writes its partial sums to y[z]
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(half, k_begin + k_split);
  y += (size_t)blockIdx.z * M * N;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tiles
    // x tiles, 8 bf16 (16 bytes) per load; rows past M and columns past
    // the half are zeros
    for (int i = tid; i < 2 * BM * (BK / 8); i += NTHREADS) {
      const int h = i / (BM * (BK / 8));
      const int r = (i / (BK / 8)) % BM;
      const int c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < k_end)
        val = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + (size_t)h * half + k0 + c);
      *reinterpret_cast<uint4*>(&xs[h][r * LDT + c]) = val;
    }
    // packed weights, 16 bytes per load -> 16 low and 16 high weights
    for (int i = tid; i < BN * (BK / 16); i += NTHREADS) {
      const int r = i / (BK / 16);
      const int c = (i % (BK / 16)) * 16;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N && k0 + c < k_end)
        raw = *reinterpret_cast<const uint4*>(p + (size_t)(n0 + r) * half +
                                              k0 + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t lo[8], hi[8];  // two bf16 weights per word, byte order kept
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t pair = words[j >> 1] >> (16 * (j & 1));
        const unsigned u0 = pair & 0xFFu, u1 = (pair >> 8) & 0xFFu;
        lo[j] = pack2(nibble(u0 & 0xFu), nibble(u1 & 0xFu));
        hi[j] = pack2(nibble(u0 >> 4), nibble(u1 >> 4));
      }
      uint4* dlo = reinterpret_cast<uint4*>(&ws[0][r * LDT + c]);
      uint4* dhi = reinterpret_cast<uint4*>(&ws[1][r * LDT + c]);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();

    // acc[h] += x_h tile @ w_h tile^T for this warp's 16 output columns
    // (the [n][k] weight tile read as a col-major B operand)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bf;
        wmma::load_matrix_sync(bf, &ws[h][warp * 16 * LDT + kk * 16], LDT);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, &xs[h][mt * 16 * LDT + kk * 16], LDT);
          wmma::mma_sync(acc[h][mt], af, bf, acc[h][mt]);
        }
      }
    }
  }

  // epilogue: y = acc_lo * s[n, 0] + acc_hi * s[n, 1], masked to [M, N]
  float* e_lo = es + warp * 2 * 16 * LDE;
  float* e_hi = e_lo + 16 * LDE;
  const int c = lane & 15;
  const int n = n0 + warp * 16 + c;
  float s0 = 0.f, s1 = 0.f;
  if (n < N) {
    s0 = s[2 * (size_t)n];
    s1 = s[2 * (size_t)n + 1];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::store_matrix_sync(e_lo, acc[0][mt], LDE, wmma::mem_row_major);
    wmma::store_matrix_sync(e_hi, acc[1][mt], LDE, wmma::mem_row_major);
    __syncwarp();
    for (int r = lane >> 4; r < 16; r += 2) {
      const int m = m0 + mt * 16 + r;
      if (m < M && n < N)
        y[(size_t)m * N + n] = e_lo[r * LDE + c] * s0 + e_hi[r * LDE + c] * s1;
    }
    __syncwarp();  // the lanes are done reading before the next store
  }
}

// y[i] = sum over z of part[z][i], z in order
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                  size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[(size_t)z * n + i];
    y[i] = acc;
  }
}

template <int MT>
int launch(const void* x, const uint8_t* p, const float* s, void* y,
           void* work, int M, int N, int half, int k_split,
           cudaStream_t stream) {
  const int splits = (half + k_split - 1) / k_split;
  dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT), splits);
  float* out = static_cast<float*>(splits > 1 ? work : y);
  int4_mm_kernel<MT><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), p, s, out, M, N, half, k_split);
  if (splits > 1) {
    const size_t n = (size_t)M * N;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    sum_splits_kernel<<<blocks, 256, 0, stream>>>(
        out, static_cast<float*>(y), n, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, 2*half]; p_all int8 [L, N, half]; s_all f32 [L, N, 2]; y f32
// [M, N]; all contiguous and 16-byte aligned, half % 16 == 0.  The K range
// is cut into splits of k_split packed columns (a multiple of 64); with
// more than one split, work is f32 [splits, M, N] scratch.  Returns a
// cudaError_t code.
extern "C" int vt_int4_mm(const void* x, const void* p_all, const void* s_all,
                          void* y, void* work, int M, int N, int half, int li,
                          int k_split, void* stream) {
  if (M <= 0 || N <= 0 || half <= 0 || half % 16 != 0 || li < 0 ||
      k_split <= 0 || k_split % BK != 0 ||
      (k_split < half && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint8_t* p =
      static_cast<const uint8_t*>(p_all) + (size_t)li * N * (size_t)half;
  const float* s = static_cast<const float*>(s_all) + (size_t)li * N * 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_tiles(M)) {
    case 1: return launch<1>(x, p, s, y, work, M, N, half, k_split, st);
    case 2: return launch<2>(x, p, s, y, work, M, N, half, k_split, st);
    default: return launch<4>(x, p, s, y, work, M, N, half, k_split, st);
  }
}

// Packed columns per K split for an [M, N] product over `half` packed
// columns: enough splits that the launch has about FILL_BLOCKS blocks (the
// decode shapes of the narrow matrices), none when the row and column
// tiles already fill the card.  The caller sizes the workspace from it.
extern "C" int vt_int4_mm_k_split(int M, int N, int half) {
  if (M <= 0 || N <= 0 || half <= 0) return BK;  // vt_int4_mm refuses these
  const long blocks =
      (long)((N + BN - 1) / BN) * ((M + 16 * row_tiles(M) - 1) /
                                   (16 * row_tiles(M)));
  const int chunks = (half + BK - 1) / BK;
  const long want = (FILL_BLOCKS + blocks - 1) / blocks;
  const int splits = (int)(want < chunks ? (want > 1 ? want : 1) : chunks);
  return (chunks + splits - 1) / splits * BK;
}
