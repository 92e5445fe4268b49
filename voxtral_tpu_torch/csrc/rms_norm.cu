// Row-invariant RMSNorm: out[r] = (x[r] * rsqrt(mean(x[r]^2) + eps)) * w,
// in float32, written in x's type (bf16 or f32).
//
// The counterpart of the norm XLA fuses into the JAX package's encoder
// and decoder layers (voxtral_tpu/ops/norms.py rms_norm); every norm of
// the port's model takes it on the card.  PyTorch's own reduction picks
// its layout by the number of rows (a 1280- or 3072-wide row at 2-15 rows
// sums in another order than at more), so a row's bits there would follow
// the batch size or the chunking.  Here each row's sum of squares is taken in
// one order fixed by the width alone: one block of 256 threads a row;
// thread t sums elements t, t + 256, ... in order, the 32 lanes of a warp
// fold in a butterfly, and thread 0 adds the 8 warps' sums in warp order.
// Then each element is (x * r) * w with f32 roundings as the plain version
// takes them.
//
// What bounds it on the H100: a launch's fixed cost.  A decode step's
// norm reads and writes B rows of 3072 bf16 values (12 KB a row), far
// below a microsecond of bandwidth; one launch replaces the plain
// version's eight elementwise and reduction kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// block r = row r
template <typename T>
__global__ void __launch_bounds__(NT)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ out, int dim, float eps) {
  __shared__ float warp_sum[NWARPS];
  __shared__ float row_scale;
  const size_t row = (size_t)blockIdx.x * dim;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s = 0.f;
  for (int i = tid; i < dim; i += NT) {
    const float v = load(x, row + i);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) t += warp_sum[i];
    row_scale = rsqrtf(t / dim + eps);
  }
  __syncthreads();
  const float r = row_scale;
  for (int i = tid; i < dim; i += NT)
    store(out, row + i, __fmul_rn(__fmul_rn(load(x, row + i), r), w[i]));
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int dim,
           float eps, cudaStream_t stream) {
  rms_norm_kernel<T><<<rows, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), dim, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [rows, dim] contiguous in f32 (x_bf16 == 0) or bf16; w [dim] f32.
// Returns a cudaError_t code.
extern "C" int vt_rms_norm(const void* x, const void* w, void* out, int rows,
                           int dim, int x_bf16, float eps, void* stream) {
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, w, out, rows, dim, eps, s)
                : launch<float>(x, w, out, rows, dim, eps, s);
}
