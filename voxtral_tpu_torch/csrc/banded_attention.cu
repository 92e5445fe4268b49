// Banded (sliding-window causal) attention for the bulk offline encoder.
//
// Replaces voxtral_tpu/ops/banded_encode.py:_kernel (the Pallas kernel
// behind banded_attention_batched).  Same function: queries and keys sit at
// positions 0..T-1 of each stream; query q sees key k iff
//     k <= q,  k > q - window,  k >= kv_lo[b],  k < T
// with the softmax and both accumulations in float32.
//
// What bounds it on the H100: tensor-core math.  At the encoder shape
// (H = KH = 32, D = 64, window 750, T = 1500 for a 30 s clip) each query
// row meets up to 750 keys, ~2*2*750*64 FLOP per row and head, against
// 3*64*2 bytes of q/k/v per row: far above the ~295 FLOP/byte ridge, so
// the kernel is compute-bound and the scores must never reach device
// memory.  The design keeps every intermediate in registers: one block per
// (query tile of BQ rows, head, stream) runs the shared Hopper attention
// tile (attn_tile.cuh: mma.sync m16n8k16 bf16 with ldmatrix operands, the
// softmax in registers with base-2 exponentials, K/V streamed through a
// 3-stage cp.async ring of swizzled tiles) over the 64-key tiles of the band
// [max(0, q0 - window + 1, kv_lo), q_last], which take the place of the TPU
// grid's sequential band axis.  Tiles wholly inside the band skip the
// per-element mask.  BQ is 64 rows (4 warps; 128 rows measured slower);
// wgmma and warp specialisation are the next step.
//
// The ragged T edge is masked here (K/V rows past T load as zeros, output
// rows past T are not stored), so the caller pads nothing.  A row that sees
// no valid key (q < kv_lo) gets 0, not garbage.  GQA (H % KH == 0) is
// accepted.

#include "attn_tile.cuh"

namespace {

using attn::Acc;
using attn::BK;
using attn::BQ;
using attn::D;
using attn::LDO;
using attn::NT;

// which keys a row sees: the static band of positions 0..T-1
struct BandPolicy {
  const __nv_bfloat16* q;
  int q_stride, q_rows;
  const __nv_bfloat16* k;  // key row 0 of this (stream, kv head)
  const __nv_bfloat16* v;
  int kv_stride;
  int T, window, lo, q0, q_last, j_first, j_last;

  __device__ int first() const { return j_first <= j_last ? j_first : -1; }
  __device__ int next(int j) const { return j < j_last ? j + 1 : -1; }
  __device__ const __nv_bfloat16* k_tile(int j) const {
    return k + (long long)j * BK * kv_stride;
  }
  __device__ const __nv_bfloat16* v_tile(int j) const {
    return v + (long long)j * BK * kv_stride;
  }
  __device__ int kv_rows(int j) const { return min(BK, T - j * BK); }
  __device__ bool interior(int j) const {
    const int k0 = j * BK;
    return k0 >= lo && k0 + BK <= T && k0 + BK - 1 <= q0 &&
           k0 > q_last - window;
  }
  __device__ int kpos(int j, int c) const {
    const int kp = j * BK + c;
    return kp < T ? kp : attn::NO_KEY;
  }
  __device__ int row_lo(int r) const {
    return max(lo, q0 + r - window + 1);  // lo >= 0
  }
  __device__ int row_hi(int r) const { return q0 + r; }
};

template <typename OutT>
__global__ void __launch_bounds__(NT, 4)
banded_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kv_lo,
                        OutT* __restrict__ out, int T, int H, int KH,
                        int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int qrow = H * D;   // elements between query rows
  const int krow = KH * D;  // elements between key rows

  BandPolicy pol;
  pol.q = q + ((long long)b * T + q0) * qrow + h * D;
  pol.q_stride = qrow;
  pol.q_rows = min(BQ, T - q0);
  pol.k = k + (long long)b * T * krow + kh * D;
  pol.v = v + (long long)b * T * krow + kh * D;
  pol.kv_stride = krow;
  pol.T = T;
  pol.window = window;
  pol.lo = max(0, kv_lo[b]);
  pol.q0 = q0;
  pol.q_last = min(q0 + BQ, T) - 1;
  pol.j_first = max(max(0, q0 - window + 1), pol.lo) / BK;
  pol.j_last = pol.q_last / BK;
  if (pol.lo > pol.q_last) pol.j_first = pol.j_last + 1;  // no key at all

  Acc acc;
  attn::attend(pol, smem, acc);

  // O / l (0 for a row that saw no key) through the f32 staging rows, then
  // 16-byte stores of whole rows
  float* st = reinterpret_cast<float*>(smem + attn::Q_BYTES);
  attn::stage_rows(st, acc, acc.l[0] > 0.f ? 1.f / acc.l[0] : 0.f,
                   acc.l[1] > 0.f ? 1.f / acc.l[1] : 0.f);
  __syncthreads();
  OutT* ob = out + ((long long)b * T + q0) * qrow + h * D;
  for (int i = threadIdx.x; i < pol.q_rows * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(st + r * LDO + c);
    attn::store8(ob + r * qrow + c, src[0], src[1]);
  }
}

template <typename OutT>
int launch(const void* q, const void* k, const void* v, const void* kv_lo,
           void* out, int B, int T, int H, int KH, int window,
           cudaStream_t stream) {
  auto kern = banded_attention_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, attn::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lo),
      static_cast<OutT*>(out), T, H, KH, window);
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
