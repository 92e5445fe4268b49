// Banded (sliding-window causal) attention for the bulk offline encoder.
//
// Replaces voxtral_tpu/ops/banded_encode.py:_kernel (the Pallas kernel
// behind banded_attention_batched).  Same function: queries and keys sit at
// positions 0..T-1 of each stream; query q sees key k iff
//     k <= q,  k > q - window,  k >= kv_lo[b]
// with the softmax and both accumulations in float32.
//
// What bounds it on the H100: tensor-core math.  At the encoder shape
// (H = KH = 32, D = 64, window 750, T = 1500 for a 30 s clip) each query
// row meets up to 750 keys, ~2*2*750*64 FLOP per row and head, against
// 3*64*2 bytes of q/k/v per row: far above the ~295 FLOP/byte ridge, so
// the kernel is compute-bound and the scores must never reach device
// memory.  The design keeps them on chip: one block per (query tile of 64
// rows, head, stream); a loop over the 64-key tiles of the band
// [max(0, q0 - window + 1, kv_lo), q_last] takes the place of the TPU
// grid's sequential band axis; Q, K, V, the score tile, the probability
// tile and the f32 output accumulator all live in shared memory.  Both
// products run on the tensor cores through WMMA 16x16x16 bf16 fragments
// with f32 accumulation.  Each of the 4 warps owns 16 query rows, so the
// online softmax of a row is private to one warp and needs only warp syncs.
// wgmma/TMA pipelining is later work.
//
// The ragged T edge is masked here (K/V rows past T load as zeros, output
// rows past T are not stored), so the caller pads nothing.  A row that sees
// no valid key (q < kv_lo) gets 0, not garbage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;            // head_dim (the encoder's)
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per band tile
constexpr int NWARPS = BQ / 16;  // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
// padded leading dimensions (elements): multiples of 8 (bf16) / 4 (f32)
// as WMMA requires, offset to spread shared-memory banks
constexpr int LDH = D + 8;   // Q/K/V tiles, bf16
constexpr int LDP = BK + 8;  // probability tile, bf16
constexpr int LDS = BK + 4;  // score tile, f32
constexpr int LDO = D + 4;   // output accumulator, f32
constexpr float NEG = -1e30f;  // finite "masked" sentinel

constexpr size_t SMEM_BYTES =
    sizeof(__nv_bfloat16) * (BQ * LDH + 2 * BK * LDH + BQ * LDP) +
    sizeof(float) * (BQ * LDS + BQ * LDO + 2 * BQ);

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS)
banded_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kv_lo,
                        OutT* __restrict__ out, int T, int H, int KH,
                        int window, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Os = Ss + BQ * LDS;
  float* Ms = Os + BQ * LDO;
  float* Ls = Ms + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lo = kv_lo[b];

  const size_t qrow = (size_t)H * D;   // elements between query rows
  const size_t krow = (size_t)KH * D;  // elements between key rows
  const __nv_bfloat16* qb = q + (size_t)b * T * qrow + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * T * krow + (size_t)kh * D;
  const __nv_bfloat16* vb = v + (size_t)b * T * krow + (size_t)kh * D;

  // Q tile (rows past T are zeros), 16-byte chunks of 8 bf16
  for (int i = tid; i < BQ * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * qrow + c);
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;
  if (tid < BQ) {
    Ms[tid] = NEG;
    Ls[tid] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);

  const int q_last = min(q0 + BQ - 1, T - 1);
  const int band_lo = max(max(0, q0 - window + 1), lo);
  // softmax lanes: two lanes per query row, each owning half the columns
  const int srow = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qp = q0 + srow;

  for (int k0 = (band_lo / BK) * BK; k0 <= q_last; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < T) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * krow + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * krow + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDH + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDH + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K^T read as a col-major B operand)
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, sf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row per lane pair
    {
      float* sr = Ss + srow * LDS + half * (BK / 2);
      __nv_bfloat16* pr = Ps + srow * LDP + half * (BK / 2);
      const float m_prev = Ms[srow];
      float mx = NEG;
      for (int c = 0; c < BK / 2; ++c) {
        const int kp = k0 + half * (BK / 2) + c;
        const bool ok = kp <= qp && kp > qp - window && kp >= lo && kp < T;
        const float s = ok ? sr[c] * scale : NEG;
        sr[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < BK / 2; ++c) {
        const float s = sr[c];
        const float p = s > 0.5f * NEG ? expf(s - m_new) : 0.f;
        pr[c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);  // 0 when m_prev is NEG
      float* orow = Os + srow * LDO + half * (D / 2);
      for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
      __syncwarp();  // both lanes of the pair have read Ms[srow]
      if (half == 0) {
        Ms[srow] = m_new;
        Ls[srow] = Ls[srow] * corr + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + warp * 16 * LDO + n * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Os + warp * 16 * LDO + n * 16, of, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  // emit this warp's rows: O / l, or 0 for a row that saw no valid key
  OutT* ob = out + (size_t)b * T * qrow + (size_t)h * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D, c = i % D;
    if (q0 + r < T) {
      const float l = Ls[r];
      const float o = l > 0.f ? Os[r * LDO + c] / l : 0.f;
      store_out(ob + (size_t)(q0 + r) * qrow + c, o);
    }
  }
}

template <typename OutT>
int launch(const void* q, const void* k, const void* v, const void* kv_lo,
           void* out, int B, int T, int H, int KH, int window,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      banded_attention_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  banded_attention_kernel<OutT><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lo),
      static_cast<OutT*>(out), T, H, KH, window, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,T,H,D], k/v [B,T,KH,D] bf16 contiguous; kv_lo [B] int32; out
// [B,T,H,D] in f32 (out_f32 != 0) or bf16.  Returns a cudaError_t code.
extern "C" int vt_banded_attention(const void* q, const void* k,
                                   const void* v, const void* kv_lo,
                                   void* out, int B, int T, int H, int KH,
                                   int head_dim, int window, int out_f32,
                                   void* stream) {
  if (head_dim != D || KH <= 0 || H % KH != 0 || T <= 0 || B <= 0 ||
      window <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<float>(q, k, v, kv_lo, out, B, T, H, KH, window, s)
                 : launch<__nv_bfloat16>(q, k, v, kv_lo, out, B, T, H, KH,
                                         window, s);
}
