// T-row sliding-window attention over the streaming encoder's KV ring.
//
// Replaces voxtral_tpu/ops/flash_encode.py:_kernel (the Pallas kernel behind
// flash_bulk_attention_batched).  Same function: for stream b, head h and
// query row i at position q = pos0[b] + i, with pos_hi = pos0[b] + T - 1
// the last position written to the ring, slot s holds the logical position
//     l(s) = pos_hi - ((pos_hi - s) mod cap)
// and is valid iff 0 <= l(s) <= q and l(s) > q - window.  Scores are
// q.k / sqrt(64) in float32 with an online softmax in float32; the
// probabilities are rounded to bf16 before the PV product, which
// accumulates in float32.  The chunk's own rows are already in the ring
// (ops/ring.py ring_chunk_write runs first).
//
// What bounds it on the H100: device-memory bytes.  At the batched streaming
// shape (B = 16, T = 64, H = KH = 32, D = 64, cap 1024, window 750) each
// query row meets up to 750 keys, ~4*64*750 FLOP per row and head against
// the live window's ~813 K/V rows of 128 bytes each read once per 64-row
// tile: ~6.3 GFLOP against ~107 MB, 59 FLOP/byte, below the ~295 FLOP/byte
// ridge.  At B = 1 and T = 100 (the 2 s streaming chunk) the 32 launches
// per chunk are bounded by launch latency.  The design reads the ring once
// per query tile and keeps the scores on chip: one block per (query tile of
// 64 rows, head, stream); a loop over the ring's 64-slot blocks takes the
// place of the TPU grid's sequential axis; Q, K, V, the score and
// probability tiles and the f32 output accumulator live in shared memory;
// both products run on the tensor cores through WMMA 16x16x16 bf16
// fragments with f32 accumulation; each of the 4 warps owns 16 query rows,
// so a row's online softmax is private to one warp.  The ring is read in
// place from the stacked [B, L, KH, cap, D] cache through the layer view's
// base pointer and strides (never copied).  wgmma/TMA pipelining is later
// work.
//
// Chunking invariance: the loop walks the ring's blocks in ABSOLUTE slot
// order 0 .. ceil(cap/64)-1, as the TPU kernel does, so a row's masked
// scores, block partition and accumulation order depend only on the ring's
// state, and its output is bitwise the same however the feed was chunked.
// A block masked for every row of the tile is skipped: for each of those
// rows the running max would stay, the rescale factor would be exactly 1
// and the block would add 0, so skipping leaves every row's arithmetic as
// it was.  The walked blocks are never reordered.
//
// The ragged T edge (query rows past T) and a ragged cap (slots past cap)
// are masked here, so the caller pads nothing.  A row that sees no valid
// key gets 0.  Rings are bf16, or f32 rounded to bf16 as they are loaded
// (the compute dtype of the query, as in the TPU kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;            // head_dim (the encoder's)
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // ring slots per block of the walk
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
    sizeof(float) * (BQ * LDS + BQ * LDO + 2 * BQ) + sizeof(int) * BK;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive ring elements of a row -> 8 bf16 in shared memory
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

template <typename RingT, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
flash_encode_kernel(const __nv_bfloat16* __restrict__ q,
                    const RingT* __restrict__ k_ring,
                    const RingT* __restrict__ v_ring,
                    const int* __restrict__ pos0, OutT* __restrict__ out,
                    int T, int H, int KH, int cap, int window,
                    long long stride_b, long long stride_h,
                    long long stride_s, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Os = Ss + BQ * LDS;
  float* Ms = Os + BQ * LDO;
  float* Ls = Ms + BQ;
  int* Lpos = reinterpret_cast<int*>(Ls + BQ);  // logical position per slot

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = pos0[b];
  const int pos_hi = p0 + T - 1;
  const int qf = p0 + q0;                         // the tile's first position
  const int ql = p0 + min(q0 + BQ - 1, T - 1);    // its last

  const size_t qrow = (size_t)H * D;  // elements between query rows
  const __nv_bfloat16* qb = q + (size_t)b * T * qrow + (size_t)h * D;
  const RingT* kb = k_ring + b * stride_b + kh * stride_h;
  const RingT* vb = v_ring + b * stride_b + kh * stride_h;

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
      qf_frag[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf_frag[kk], Qs + warp * 16 * LDH + kk * 16, LDH);

  // softmax lanes: two lanes per query row, each owning half the columns
  const int srow = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qp = qf + srow;

  const int n_blocks = (cap + BK - 1) / BK;
  for (int j = 0; j < n_blocks; ++j) {  // absolute slot order
    const int s0 = j * BK;
    __syncthreads();  // every warp is done with the previous tiles
    bool any = false;
    if (tid < BK) {
      const int s = s0 + tid;
      int l = -1;  // a slot past cap is never valid
      if (s < cap) {
        int m = (pos_hi - s) % cap;
        if (m < 0) m += cap;
        l = pos_hi - m;
      }
      Lpos[tid] = l;
      any = l >= 0 && l <= ql && l > qf - window;
    }
    // a block masked for every row of the tile leaves every row unchanged
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < BK * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s0 + r < cap) {
        kv = load8(kb + (s0 + r) * stride_s + c);
        vv = load8(vb + (s0 + r) * stride_s + c);
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
        wmma::mma_sync(sf, qf_frag[kk], kf, sf);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, sf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this block, one row per lane pair
    {
      float* sr = Ss + srow * LDS + half * (BK / 2);
      __nv_bfloat16* pr = Ps + srow * LDP + half * (BK / 2);
      const int* lr = Lpos + half * (BK / 2);
      const float m_prev = Ms[srow];
      float mx = NEG;
      for (int c = 0; c < BK / 2; ++c) {
        const int l = lr[c];
        const bool ok = l >= 0 && l <= qp && l > qp - window;
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
  __syncthreads();

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

template <typename RingT, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* pos0,
           void* out, int B, int T, int H, int KH, int cap, int window,
           long long sb, long long sh, long long ss, cudaStream_t stream) {
  auto kern = flash_encode_kernel<RingT, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const RingT*>(k),
      static_cast<const RingT*>(v), static_cast<const int*>(pos0),
      static_cast<OutT*>(out), T, H, KH, cap, window, sb, sh, ss,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,T,H,D] bf16 contiguous; k_ring/v_ring: the layer's rings [B,KH,cap,D]
// (bf16, or f32 with ring_f32 != 0) at element strides stride_b, stride_h,
// stride_s, D contiguous, 16-byte aligned rows; pos0 [B] int32; out
// [B,T,H,D] in f32 (out_f32 != 0) or bf16.  Returns a cudaError_t code.
extern "C" int vt_flash_encode(const void* q, const void* k_ring,
                               const void* v_ring, const void* pos0,
                               void* out, int B, int T, int H, int KH,
                               int head_dim, int cap, int window,
                               long long stride_b, long long stride_h,
                               long long stride_s, int ring_f32, int out_f32,
                               void* stream) {
  if (head_dim != D || KH <= 0 || H % KH != 0 || T <= 0 || B <= 0 ||
      cap <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring_f32)
    return out_f32 ? launch<float, float>(q, k_ring, v_ring, pos0, out, B, T,
                                          H, KH, cap, window, stride_b,
                                          stride_h, stride_s, s)
                   : launch<float, __nv_bfloat16>(q, k_ring, v_ring, pos0,
                                                  out, B, T, H, KH, cap,
                                                  window, stride_b, stride_h,
                                                  stride_s, s);
  return out_f32 ? launch<__nv_bfloat16, float>(q, k_ring, v_ring, pos0, out,
                                                B, T, H, KH, cap, window,
                                                stride_b, stride_h, stride_s,
                                                s)
                 : launch<__nv_bfloat16, __nv_bfloat16>(
                       q, k_ring, v_ring, pos0, out, B, T, H, KH, cap, window,
                       stride_b, stride_h, stride_s, s);
}
