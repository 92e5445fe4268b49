// In-place write of one K/V row per stream into the stacked decoder rings.
//
// Replaces voxtral_tpu/ops/ring.py:_rows_write_kernel (the Pallas kernel
// behind the batched ring_rows_write).  Same function: for every stream b,
//     k_all[b, li, :, pos[b] mod cap, :] = cast(k_rows[b])
//     v_all[b, li, :, pos[b] mod cap, :] = cast(v_rows[b])
// of rings [B, L, KH, cap, D] in float32, bf16 or fp8 e4m3fn, from float32
// rows [B, KH, D].  The cast goes straight from f32 to the ring type (never
// through bf16, which would round twice): round to nearest even, and for
// fp8 saturation to +-448 (__NV_SATFINITE), bit for bit as ops/ring.py
// to_ring_dtype.
//
// What bounds it on the H100: the fixed cost of a launch.  It moves 2 x KH
// x D elements per stream (4 KB of fp8 at the decoder's KH=8, D=128), so
// its byte bound is tens of nanoseconds.  The TPU kernel read, patched and
// wrote back an aligned 16- or 32-slot window because a single slot is
// below the TPU's sublane tiling; here a row is contiguous in D and is
// stored directly.  The design keeps the work per thread one short chain:
// one block per stream, one thread per 8 consecutive values of one head's
// K or V row (threadIdx = (d / 8, head, K or V): the block shape does the
// index arithmetic, no division); each thread issues its two 16-byte row
// loads and the load of pos[b] together, converts its 8 values and writes
// them with one vector store (32, 16 or 8 bytes).  Nothing is read back
// from the ring.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 8 values -> 8 ring elements at dst, one vector store
__device__ __forceinline__ void store8(float* dst, float4 a, float4 b) {
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);  // lo first
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, float4 a,
                                       float4 b) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
}
__device__ __forceinline__ uint32_t fp8x4(float4 v) {
  // round to nearest even, saturating at +-448; .x lands in the low byte
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(v.x, v.y),
                                               __NV_SATFINITE, __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(v.z, v.w),
                                               __NV_SATFINITE, __NV_E4M3);
  return lo | (hi << 16);
}
__device__ __forceinline__ void store8(__nv_fp8_e4m3* dst, float4 a,
                                       float4 b) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(fp8x4(a), fp8x4(b));
}

// block b = stream b; threadIdx (d / 8, head, 0 for K or 1 for V)
template <typename T>
__global__ void ring_rows_write_kernel(T* __restrict__ k_all,
                                       T* __restrict__ v_all,
                                       const float* __restrict__ k_rows,
                                       const float* __restrict__ v_rows,
                                       const int* __restrict__ pos, int L,
                                       int cap, int li) {
  const int b = blockIdx.x;
  const int D = 8 * blockDim.x, KH = blockDim.y;
  const int d = 8 * threadIdx.x, kh = threadIdx.y;
  const bool is_v = threadIdx.z != 0;
  const float4* src = reinterpret_cast<const float4*>(
      (is_v ? v_rows : k_rows) + ((size_t)b * KH + kh) * D + d);
  const float4 lo = __ldg(src), hi = __ldg(src + 1);
  int slot = __ldg(pos + b) % cap;
  if (slot < 0) slot += cap;  // torch.remainder's sign convention
  T* dst = (is_v ? v_all : k_all) +
           (((size_t)b * L + li) * KH + kh) * (size_t)cap * D +
           (size_t)slot * D + d;
  store8(dst, lo, hi);
}

template <typename T>
int launch(void* k_all, void* v_all, const void* k_rows, const void* v_rows,
           const void* pos, int B, int L, int KH, int cap, int D, int li,
           cudaStream_t stream) {
  ring_rows_write_kernel<T><<<B, dim3(D / 8, KH, 2), 0, stream>>>(
      static_cast<T*>(k_all), static_cast<T*>(v_all),
      static_cast<const float*>(k_rows), static_cast<const float*>(v_rows),
      static_cast<const int*>(pos), L, cap, li);
  return (int)cudaGetLastError();
}

}  // namespace

// k_all/v_all [B, L, KH, cap, D] contiguous, ring_kind 0 = f32, 1 = bf16,
// 2 = fp8 e4m3fn; k_rows/v_rows f32 [B, KH, D] contiguous; pos int32 [B];
// every pointer 16-byte aligned, D % 8 == 0 and KH * D <= 4096 (one thread
// per 8 values of K and of V: at most 1024 a block).  Returns a cudaError_t
// code.
extern "C" int vt_ring_rows_write(void* k_all, void* v_all,
                                  const void* k_rows, const void* v_rows,
                                  const void* pos, int B, int L, int KH,
                                  int cap, int D, int li, int ring_kind,
                                  void* stream) {
  if (B <= 0 || L <= 0 || KH <= 0 || cap <= 0 || D <= 0 || D % 8 != 0 ||
      KH * D > 4096 || li < 0 || li >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ring_kind) {
    case 0:
      return launch<float>(k_all, v_all, k_rows, v_rows, pos, B, L, KH, cap,
                           D, li, s);
    case 1:
      return launch<__nv_bfloat16>(k_all, v_all, k_rows, v_rows, pos, B, L,
                                   KH, cap, D, li, s);
    case 2:
      return launch<__nv_fp8_e4m3>(k_all, v_all, k_rows, v_rows, pos, B, L,
                                   KH, cap, D, li, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
