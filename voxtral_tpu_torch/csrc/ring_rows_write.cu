// In-place write of one K/V row per stream into the stacked decoder rings.
//
// Replaces voxtral_tpu/ops/ring.py:_rows_write_kernel (the Pallas kernel
// behind the batched ring_rows_write).  Same function: for every stream b,
//     k_all[b, li, :, pos[b] mod cap, :] = cast(k_rows[b])
//     v_all[b, li, :, pos[b] mod cap, :] = cast(v_rows[b])
// of rings [B, L, KH, cap, D] in float32, bf16 or fp8 e4m3fn, from float32
// rows [B, KH, D].  The cast goes straight from f32 to the ring type (never
// through bf16, which would round twice): round to nearest even, and for
// fp8 saturation to +-448 (__NV_SATFINITE), as torch's .to() does.
//
// What bounds it on the H100: launch latency.  It moves 2 x KH x D elements
// per stream (4 KB of fp8 at the decoder's KH=8, D=128).  The TPU kernel
// read, patched and wrote back an aligned 16- or 32-slot window because a
// single slot is below the TPU's sublane tiling; on the GPU a row is
// contiguous in D, so one block per stream stores it directly: consecutive
// threads write consecutive elements of a row, coalesced, nothing is read
// back from the ring.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__nv_fp8_e4m3* p, float x) {
  *p = __nv_fp8_e4m3(x);  // round to nearest even, __NV_SATFINITE
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ring_rows_write_kernel(T* __restrict__ k_all, T* __restrict__ v_all,
                       const float* __restrict__ k_rows,
                       const float* __restrict__ v_rows,
                       const int* __restrict__ pos, int L, int KH, int cap,
                       int D, int li) {
  const int b = blockIdx.x;
  int slot = pos[b] % cap;
  if (slot < 0) slot += cap;  // torch.remainder's sign convention
  const int n = KH * D;
  const size_t src = (size_t)b * n;
  const size_t base = ((size_t)b * L + li) * KH * (size_t)cap * D +
                      (size_t)slot * D;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const int kh = i / D, d = i - kh * D;
    const size_t dst = base + (size_t)kh * cap * D + d;
    store(k_all + dst, k_rows[src + i]);
    store(v_all + dst, v_rows[src + i]);
  }
}

template <typename T>
int launch(void* k_all, void* v_all, const void* k_rows, const void* v_rows,
           const void* pos, int B, int L, int KH, int cap, int D, int li,
           cudaStream_t stream) {
  ring_rows_write_kernel<T><<<B, NTHREADS, 0, stream>>>(
      static_cast<T*>(k_all), static_cast<T*>(v_all),
      static_cast<const float*>(k_rows), static_cast<const float*>(v_rows),
      static_cast<const int*>(pos), L, KH, cap, D, li);
  return (int)cudaGetLastError();
}

}  // namespace

// k_all/v_all [B, L, KH, cap, D] contiguous, ring_kind 0 = f32, 1 = bf16,
// 2 = fp8 e4m3fn; k_rows/v_rows f32 [B, KH, D] contiguous; pos int32 [B].
// Returns a cudaError_t code.
extern "C" int vt_ring_rows_write(void* k_all, void* v_all,
                                  const void* k_rows, const void* v_rows,
                                  const void* pos, int B, int L, int KH,
                                  int cap, int D, int li, int ring_kind,
                                  void* stream) {
  if (B <= 0 || L <= 0 || KH <= 0 || cap <= 0 || D <= 0 || li < 0 ||
      li >= L)
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
