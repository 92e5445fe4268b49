// The epilogue of the attention layers' qkv product, one launch:
//
//   x        = qkv[r] (+ bias)                      f32, __fadd_rn
//   q[r], k[r] = T(rotate(x's q and k columns))     interleaved RoPE
//   v[r]     = T(x's v columns)                     (when v is written)
//
//   rotate:  o1 = RN(RN(x1 * c) - RN(x2 * s)),  o2 = RN(RN(x2 * c) + RN(x1 * s))
//
// on each pair (x1, x2) = (x[2i], x[2i + 1]) of a head, with c, s = cos,
// sin[row's position][i].  qkv is the product's f32 output [rows, q_dim +
// 2 kv_dim]; cos and sin are f32 [rows, D/2] (a row's own position: the
// decoder, the ring encoder) or [T, D/2] shared by every batch row (the
// bulk encoder: row r reads table row r % T).  q in Tq, k and v in Tkv:
// all bf16 (the bulk encoder), bf16 q with f32 k and v (the decoder and
// the ring encoder, whose row writes round to the ring's dtype) or all f32
// (the f32 configurations).  Every step rounds where the torch sequence it
// replaces rounds (the bias add, each product, the difference and the sum
// in f32, then one cast): ops/rope.py qkv_rope_plain, bit for bit.  No FMA
// is contracted.  v is skipped (null) where the caller keeps a view of
// qkv's v columns: no bias and an f32 v.
//
// It replaces no TPU kernel: XLA fused the bias add, the rotation and the
// casts into the product's neighbours in the JAX package
// (voxtral_tpu/models/decoder.py, encoder.py, bulk_encode.py around
// voxtral_tpu/ops/rope.py apply_rope_interleaved).  In the port they ran as
// torch kernels, 17 a decoder layer (the split, six strided or broadcast
// mul/add/sub and a stack per rope call, the casts) and 50 a bulk encoder
// layer, each reading and writing f32 intermediates.
//
// What bounds it on the H100: in a decode step (64 rows) a launch's fixed
// cost and the wait for the product before it; in the bulk encoder
// (64 x 3196 rows) the bytes, qkv read once (5.0 GB) and bf16 q, k, v
// written once (2.5 GB), 2.25 ms at 3.35 TB/s.  So one design does both:
// a thread owns 8 consecutive columns of one row (four rotation pairs of
// one head; head dims 64 and 128 hold whole chunks), read as two 16-byte
// loads, with the pairs' cos and sin as one 16-byte load each and the
// output written as 16 bytes (bf16) or 32 (f32); the grid covers the rows
// x columns once where it fits the card and strides over them where it
// does not, so a decode step's launch is one trip to memory for each
// thread.  The launch is a programmatic dependent one: it may start while
// the product before it runs, griddepcontrol.wait holding every read until
// that product's writes are visible, and it lets the next kernel launch at
// once (griddepcontrol.launch_dependents on entry).

#include <cstdint>

#include "quant_mm.cuh"  // griddep_wait, griddep_launch

namespace {

constexpr int NT = 256;
constexpr int V = 8;  // columns a thread owns: four rotation pairs

__device__ __forceinline__ void load8(const float* p, float (&x)[V]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&o)[V]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&o)[V]) {
  uint4 u;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(o[0], o[1]);
  u.x = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(o[2], o[3]);
  u.y = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(o[4], o[5]);
  u.z = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(o[6], o[7]);
  u.w = *reinterpret_cast<uint32_t*>(&h);
  *reinterpret_cast<uint4*>(p) = u;
}

// chunk g = row * chunks + c owns columns [8c, 8c + 8) of that row; the
// q, k (and, with v, v) columns are the chunks of a row
template <int D, typename Tq, typename Tkv>
__global__ void __launch_bounds__(NT)
qkv_rope_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, Tq* __restrict__ q,
                Tkv* __restrict__ k, Tkv* __restrict__ v, unsigned rows,
                unsigned t_len, int shared_table, int q_dim, int kv_dim) {
  griddep_launch();  // the next kernel may launch: it waits for our writes
  griddep_wait();    // qkv is written once the grids before are done

  const int width = q_dim + 2 * kv_dim;
  const unsigned chunks = (v != nullptr ? width : q_dim + kv_dim) / V;
  const unsigned total = rows * chunks;
  for (unsigned g = blockIdx.x * NT + threadIdx.x; g < total;
       g += gridDim.x * NT) {
    const unsigned row = g / chunks;
    const int col = (int)(g - row * chunks) * V;
    float x[V];
    load8(qkv + (size_t)row * width + col, x);
    if (bias != nullptr) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(bias + col));
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col) + 1);
      x[0] = __fadd_rn(x[0], a.x); x[1] = __fadd_rn(x[1], a.y);
      x[2] = __fadd_rn(x[2], a.z); x[3] = __fadd_rn(x[3], a.w);
      x[4] = __fadd_rn(x[4], b.x); x[5] = __fadd_rn(x[5], b.y);
      x[6] = __fadd_rn(x[6], b.z); x[7] = __fadd_rn(x[7], b.w);
    }
    if (col >= q_dim + kv_dim) {
      store8(v + (size_t)row * kv_dim + (col - q_dim - kv_dim), x);
      continue;
    }
    const unsigned trow = shared_table ? row % t_len : row;
    const size_t at = (size_t)trow * (D / 2) + ((col & (D - 1)) >> 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(cos_t + at));
    const float4 s = __ldg(reinterpret_cast<const float4*>(sin_t + at));
    const float cs[4] = {c.x, c.y, c.z, c.w}, sn[4] = {s.x, s.y, s.z, s.w};
    float o[V];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x1 = x[2 * j], x2 = x[2 * j + 1];
      o[2 * j] = __fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j]));
      o[2 * j + 1] = __fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j]));
    }
    if (col < q_dim)
      store8(q + (size_t)row * q_dim + col, o);
    else
      store8(k + (size_t)row * kv_dim + (col - q_dim), o);
  }
}

template <int D, typename Tq, typename Tkv>
int launch(const void* qkv, const void* bias, const void* cos_t,
           const void* sin_t, void* q, void* k, void* v, unsigned rows,
           unsigned t_len, int shared_table, int q_dim, int kv_dim,
           unsigned blocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qkv_rope_kernel<D, Tq, Tkv>, static_cast<const float*>(qkv),
      static_cast<const float*>(bias), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<Tq*>(q),
      static_cast<Tkv*>(k), static_cast<Tkv*>(v), rows, t_len, shared_table,
      q_dim, kv_dim);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the (q, k/v) types the callers take: bf16 / bf16, bf16 / f32, f32 / f32
// (vt_qkv_rope refuses an f32 q beside bf16 k, v)
template <int D>
int launch_types(int q_bf16, int kv_bf16, const void* qkv, const void* bias,
                 const void* cos_t, const void* sin_t, void* q, void* k,
                 void* v, unsigned rows, unsigned t_len, int shared_table,
                 int q_dim, int kv_dim, unsigned blocks, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<D, B, B>(qkv, bias, cos_t, sin_t, q, k, v, rows, t_len,
                           shared_table, q_dim, kv_dim, blocks, s);
  if (q_bf16)
    return launch<D, B, float>(qkv, bias, cos_t, sin_t, q, k, v, rows, t_len,
                               shared_table, q_dim, kv_dim, blocks, s);
  return launch<D, float, float>(qkv, bias, cos_t, sin_t, q, k, v, rows,
                                 t_len, shared_table, q_dim, kv_dim, blocks,
                                 s);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// qkv [rows, n_heads * D + 2 * n_kv_heads * D] f32, contiguous; bias that
// width in f32 or null; cos_t, sin_t f32 [rows, D/2], or [t_len, D/2] with
// shared_table (row r reads row r % t_len); q [rows, n_heads * D] in bf16
// (q_bf16) or f32, k and v [rows, n_kv_heads * D] in bf16 (kv_bf16) or
// f32, not bf16 beside an f32 q; v null to leave it unwritten; every
// pointer 16-byte aligned, head_dim 64 or 128; at most max_blocks blocks
// (the grid strides over the rest).
// Returns a cudaError_t code.
extern "C" int vt_qkv_rope(const void* qkv, const void* bias,
                           const void* cos_t, const void* sin_t, void* q,
                           void* k, void* v, int rows, int t_len,
                           int shared_table, int n_heads, int n_kv_heads,
                           int head_dim, int q_bf16, int kv_bf16,
                           int max_blocks, void* stream) {
  if (rows <= 0 || t_len <= 0 || n_heads <= 0 || n_kv_heads <= 0 ||
      max_blocks <= 0 || (head_dim != 64 && head_dim != 128) ||
      (kv_bf16 && !q_bf16) || !qkv ||
      !cos_t || !sin_t || !q || !k)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {qkv, bias, cos_t, sin_t, q, k, v};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int q_dim = n_heads * head_dim, kv_dim = n_kv_heads * head_dim;
  const unsigned long long chunks =
      (unsigned long long)rows * ((v ? q_dim + 2 * kv_dim : q_dim + kv_dim) / V);
  // g + the grid's threads stays below 2^32 (a qkv of over 128 GB: none)
  if (chunks + (unsigned long long)max_blocks * NT >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  const unsigned need = (unsigned)((chunks + NT - 1) / NT);
  const unsigned blocks = need < (unsigned)max_blocks ? need : max_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_types<64>(q_bf16, kv_bf16, qkv, bias, cos_t, sin_t, q, k, v,
                            rows, t_len, shared_table, q_dim, kv_dim, blocks,
                            s);
  return launch_types<128>(q_bf16, kv_bf16, qkv, bias, cos_t, sin_t, q, k, v,
                           rows, t_len, shared_table, q_dim, kv_dim, blocks,
                           s);
}
