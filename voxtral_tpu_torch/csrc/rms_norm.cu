// Row-invariant residual add + RMSNorm (+ ada scale), one launch:
//
//   x_new[r]  = x[r] + T(y[r] [+ bias])            (when y is given)
//   n[r]      = T((x_new[r] * rsqrt(mean(x_new[r]^2) + eps)) * w)
//   normed[r] = T(n[r] * (1 + ada))  or  n[r]
//
// x, x_new and normed in T (bf16 or f32), y f32 (a product's output), w,
// bias, ada f32 [dim].  Every step rounds where the torch sequence it
// replaces rounds: a bf16 add is float(a) + float(b) rounded to bf16, the
// bias is added in f32 before the cast, the ada product is
// __fmul_rn(n, __fadd_rn(1, ada)); nothing is contracted into an FMA but
// the sum of squares, which was one in the norm-only kernel.
//
// The counterpart of the residual add, norm and ada scale that XLA fuses
// into one pass in the JAX package's layers (voxtral_tpu/models/
// decoder.py:170-177, voxtral_tpu/models/encoder.py:149-155; the norm is
// voxtral_tpu/ops/norms.py rms_norm); every norm of the port's model takes
// it on the card.  PyTorch's own reduction picks its layout by the number
// of rows (a 1280- or 3072-wide row at 2-15 rows sums in another order
// than at more), so a row's bits there would follow the batch size or the
// chunking.  Here each row's sum of squares is taken in one order fixed by
// the width alone: one block of 256 threads a row; thread t sums elements
// t, t + 256, ... in order, the 32 lanes of a warp fold in a butterfly,
// and thread 0 adds the 8 warps' sums in warp order.  Without y, bias and
// ada the kernel computes the norm alone, bit for bit as before the fused
// form existed.
//
// What bounds it on the H100: a launch's fixed cost and the wait for the
// product before it.  A decode step's norm reads B rows of 3072 values
// (12 KB in bf16) and a product's f32 output, far below a microsecond of
// bandwidth.  So the design removes launches and gaps: one launch does the
// add, the norm, the ada scale and the casts that ran as seven torch
// kernels around the norm; each thread keeps its elements of the row in
// registers between the sum and the writes, so every input byte is read
// once; and the launch is a programmatic dependent one on both sides.  It
// may start while the product before it runs: griddepcontrol.wait holds
// every read (x and y, and the weight, bias and ada too, which a caller
// may have computed in the kernel before) until that kernel's writes are
// visible.  After the wait every read is issued at once, so the norm pays
// one trip to memory: the weight and ada go to shared memory by cp.async
// (no registers held while x and y load and the row's sum is taken), x, y
// and the bias to registers.  It lets the product after it launch at once
// (griddepcontrol.launch_dependents on entry): that product streams its
// first weight stages while the norm runs, and its own
// griddepcontrol.wait keeps it from reading the norm's output early.

#include "quant_mm.cuh"  // griddep_wait, griddep_launch

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
// 4 bytes global -> shared, asynchronously: the copies issued, then
// committed as one group, which cp_async_wait waits for
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// v rounded to T, as a float
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// block r = row r; E >= ceil(dim / NT): the elements a thread holds
template <typename T, int E>
__global__ void __launch_bounds__(NT)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ bias, const float* __restrict__ ada,
                const float* __restrict__ w, T* __restrict__ x_out,
                T* __restrict__ out, int dim, float eps) {
  __shared__ float warp_sum[NWARPS];
  __shared__ float row_scale;
  __shared__ float w_sm[E * NT], a_sm[E * NT];
  const size_t row = (size_t)blockIdx.x * dim;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  griddep_launch();  // the next product may start streaming its weights
  griddep_wait();    // every input is written once the grids before are done

  // the weight and ada copied to shared memory asynchronously (each
  // thread reads back only its own copies, so no barrier), x, y and the
  // bias into registers
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = tid + k * NT;
    if (i < dim) {
      cp_async4(&w_sm[i], w + i);
      if (ada != nullptr) cp_async4(&a_sm[i], ada + i);
    }
  }
  cp_async_commit();
  float v[E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = tid + k * NT;
    float xi = 0.f;
    if (i < dim) {
      xi = load(x, row + i);
      if (y != nullptr) {
        float yi = y[row + i];
        if (bias != nullptr) yi = __fadd_rn(yi, bias[i]);
        xi = round_to(x, __fadd_rn(xi, round_to(x, yi)));
      }
      s = fmaf(xi, xi, s);
    }
    v[k] = xi;
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
  cp_async_wait();
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = tid + k * NT;
    if (i < dim) {
      if (y != nullptr) store(x_out, row + i, v[k]);
      float n = __fmul_rn(__fmul_rn(v[k], r), w_sm[i]);
      if (ada != nullptr)
        n = __fmul_rn(round_to(x, n), __fadd_rn(1.f, a_sm[i]));
      store(out, row + i, n);
    }
  }
}

// the launch may start before the stream's previous kernel ends
// (programmatic dependent launch)
template <typename T, int E>
int launch(const void* x, const void* y, const void* bias, const void* ada,
           const void* w, void* x_out, void* out, int rows, int dim,
           float eps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rms_norm_kernel<T, E>, static_cast<const T*>(x),
      static_cast<const float*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(ada), static_cast<const float*>(w),
      static_cast<T*>(x_out), static_cast<T*>(out), dim, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* x, const void* y, const void* bias,
                 const void* ada, const void* w, void* x_out, void* out,
                 int rows, int dim, float eps, cudaStream_t s) {
  const int e = (dim + NT - 1) / NT;
  if (e <= 4)
    return launch<T, 4>(x, y, bias, ada, w, x_out, out, rows, dim, eps, s);
  if (e <= 8)
    return launch<T, 8>(x, y, bias, ada, w, x_out, out, rows, dim, eps, s);
  if (e <= 12)
    return launch<T, 12>(x, y, bias, ada, w, x_out, out, rows, dim, eps, s);
  return launch<T, 16>(x, y, bias, ada, w, x_out, out, rows, dim, eps, s);
}

}  // namespace

// x [rows, dim] contiguous in f32 (x_bf16 == 0) or bf16; y [rows, dim] f32
// or null (no add: x_out unused); bias, ada [dim] f32 or null; w [dim] f32;
// x_out and out [rows, dim] in x's type; dim at most 4096 (16 elements a
// thread).  Returns a cudaError_t code.
extern "C" int vt_rms_norm(const void* x, const void* y, const void* bias,
                           const void* ada, const void* w, void* x_out,
                           void* out, int rows, int dim, int x_bf16,
                           float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim > 16 * NT || (y != nullptr && !x_out) ||
      (bias != nullptr && y == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_width<__nv_bfloat16>(x, y, bias, ada, w, x_out, out, rows,
                                       dim, eps, s);
  return launch_width<float>(x, y, bias, ada, w, x_out, out, rows, dim, eps,
                             s);
}
