// Single-query GQA attention over the decoder's KV ring, with an optional
// in-place write of this step's K/V row, on f32, bf16 or fp8 e4m3 rings.
//
// Replaces three Pallas kernels of voxtral_tpu/ops/flash_decode.py:
//   _kernel (:44)             per-stream grid (the B=1 decode path),
//   _kernel_flat (:124)       the same attention as one program, and
//   _kernel_flat_fused (:232) row write + attention in one launch,
// and the row write the B=1 path did before it (ops/ring.py
// ring_rows_write).  With write=0 it is the first two; with write=1 it is
// the third.  Like them it takes fp8 rings and widens them on chip.
//
// Function: for stream b with query position pos the live window holds
//     valid = min(pos + 1, window, cap)
// slots: window index j = 0 .. valid-1 is logical position pos - j, at ring
// slot (pos - j) mod cap of layer li (the _info arithmetic,
// flash_decode.py:412-421).  Each of the G = H/KH query heads of a KV group
// attends over them with an online softmax in float32.  q (bf16 or f32) is
// scaled by log2(e)/sqrt(D), so the softmax runs on exp2.  With write=1
// the row at j = 0 (slot pos % cap, which still holds the stale position
// pos - cap) comes from k_rows/v_rows (f32 or the ring type) cast to the
// ring type -- bf16 and fp8 round to nearest even, fp8 saturates at +-448
// (__NV_SATFINITE), bit for bit as ops/ring.py to_ring_dtype -- is stored
// into the ring in place, and attention sees the stored value.  The output
// is written in bf16 or f32.
//
// What bounds it on the H100: the live window's bytes.  Every live K/V
// element is read once and meets G = 4 multiply-adds per product, ~1-4
// FLOP/byte, far below the ridge, so tensor cores do not help.  At the
// slice's B=1 the bytes are ~1 MB and a launch of the old one-block-per-
// (stream, KV head) design walked them in series on 8 of 132 SMs (10
// dependent trips at pos 300).  The design:
//   * Split: the window indices 0 .. W-1, W = min(cap, window), are cut into
//     S ranges of C = ceil(W / S) by the caller's plan (ops/flash_decode.py
//     flash_decode_splits: a function of W and B alone, never of pos, and
//     never more blocks than one wave: at 192-254 registers a thread one
//     block fits an SM).  One block per (split, KV head, stream); the S
//     blocks of a (KV head, stream) form a thread-block cluster.  Each block
//     starts a fresh online softmax over its live indices (j < valid; a
//     split with none contributes nothing), folds its partitions in a fixed
//     order, and the cluster folds the S partials in split order through
//     distributed shared memory: one launch per layer, no workspace, the
//     same bits on every call.  With S = 1 (B >= 2 at 8 KV heads) the block
//     writes the output itself.
//   * Loads: 8 lanes per row, 16 bytes per load, consecutive rows on
//     consecutive lane groups, and 128 bytes of K and V in flight per lane
//     and trip from independent loads (4 fp8 rows, 2 bf16, 1 f32); the
//     rows are widened in registers (e4m3 -> half2 -> float2 and bf16 ->
//     float are exact).  q is loaded before anything waits on pos.
//   * Few instructions per row: exp2 on the SFU, and the running max is
//     raised only when a score exceeds it by more than 8 (log2 units), so
//     most trips skip the rescale of the accumulators (the same function;
//     probabilities stay at most 256).
//   * Casts in the kernel: q, the new rows and the output are read and
//     written in the caller's types, so the wrapper launches nothing else.
//   * Race-free write: the new row is window index j = 0 of split 0; the 8
//     lanes that attend it load it from k_rows/v_rows, cast it, store it
//     into slot pos % cap and attend it from registers.  No block reads that
//     slot from the ring in this launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;                  // head_dim (the decoder's)
constexpr int LANES = 8;                // lanes per ring row
constexpr int E = D / LANES;            // elements of a row per lane: 16
constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int NPART = NT / LANES;       // softmax partitions per block: 32
constexpr int MAX_SPLITS = 8;           // the portable cluster size
constexpr float NEG = -1e30f;           // finite "no score yet" sentinel
// log2(e) / sqrt(128): scores in log2 units, the softmax on exp2
constexpr float Q_SCALE = 0.12752041570284943f;

// 16-byte words per lane and row (NV), and rows per lane and trip (U): each
// lane has 128 bytes of K and V in flight per trip whatever the ring type
template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int NV = 4, U = 1;
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int NV = 2, U = 2;
};
template <>
struct Ring<__nv_fp8_e4m3> {
  static constexpr int NV = 1, U = 4;
};

// the floats of one 16-byte word of a row: 4 f32, 8 bf16 or 16 fp8 values
__device__ __forceinline__ void widen(const uint4& w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void widen(const uint4& w, float* x,
                                      __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(const uint4& w, float* x,
                                      __nv_fp8_e4m3) {
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // the low byte is the first element
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3)));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 2^x on the SFU (ex2.approx.ftz); 2^0 is exactly 1, 2^-1e30 is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// floats in the ring type, packed as they lie in memory: round to nearest
// even, fp8 saturating at +-448 (the first element in the low bits)
__device__ __forceinline__ void pack(const float* x, uint4* w, float) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = make_uint4(__float_as_uint(x[4 * i]), __float_as_uint(x[4 * i + 1]),
                      __float_as_uint(x[4 * i + 2]),
                      __float_as_uint(x[4 * i + 3]));
}

__device__ __forceinline__ void pack(const float* x, uint4* w,
                                     __nv_bfloat16) {
  uint32_t* u = reinterpret_cast<uint32_t*>(w);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

__device__ __forceinline__ void pack(const float* x, uint4* w,
                                     __nv_fp8_e4m3) {
  uint16_t* u = reinterpret_cast<uint16_t*>(w);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u[i] = __nv_cvt_float2_to_fp8x2(make_float2(x[2 * i], x[2 * i + 1]),
                                    __NV_SATFINITE, __NV_E4M3);
}

// folds a partial (max m, sum l, unnormalised output o) into the running
// (M, L, O); every merge of partials goes through it, in a fixed order
__device__ __forceinline__ void fold(float& M, float& L, float& O, float m,
                                     float l, float o) {
  const float mn = fmaxf(M, m);
  const float a = ex2(M - mn), c = ex2(m - mn);
  L = fmaf(l, c, __fmul_rn(L, a));
  O = fmaf(o, c, __fmul_rn(O, a));
  M = mn;
}

// the running max is raised only when a score exceeds it by more than this
// (log2 units): probabilities stay at most 2^8
constexpr float RESCALE_MARGIN = 8.f;

template <int G, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_decode_kernel(const void* __restrict__ q, T* __restrict__ k_all,
                    T* __restrict__ v_all, const void* __restrict__ k_rows,
                    const void* __restrict__ v_rows,
                    const int* __restrict__ pos_b, void* __restrict__ out,
                    int L, int KH, int cap, int li, int window, int write,
                    int q_f32, int rows_f32, int out_f32, long long k_rs,
                    long long v_rs, int chunk) {
  constexpr int NV = Ring<T>::NV, U = Ring<T>::U, PW = 16 / sizeof(T);
  __shared__ float w_m[NWARPS][G], w_l[NWARPS][G];
  __shared__ float w_o[NWARPS][G * D];           // each warp's partial
  __shared__ float p_m[G], p_l[G];
  __shared__ float p_o[G * D];                   // this split's partial

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = tid / LANES, sub = tid % LANES;
  const int H = KH * G;

  // q first: it does not wait for pos
  float qv[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t qo = ((size_t)b * H + (size_t)kh * G + g) * D + sub * E;
    if (q_f32) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const float*>(q) + qo);
#pragma unroll
      for (int w = 0; w < E / 4; ++w) widen(p[w], qv[g] + 4 * w, 0.f);
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(q) + qo);
#pragma unroll
      for (int w = 0; w < E / 8; ++w)
        widen(p[w], qv[g] + 8 * w, __nv_bfloat16());
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qv[g][e] *= Q_SCALE;
  }

  const int pos = pos_b[b];
  const int valid = min(min(pos + 1, window), cap);
  const int wslot = pos % cap;
  const int j0 = split * chunk;                   // this split's indices
  const int n = min(j0 + chunk, valid) - j0;      // live ones (<= 0: none)

  const size_t ring_off = (((size_t)b * L + li) * KH + kh) * (size_t)cap * D;
  T* kr = k_all + ring_off;
  T* vr = v_all + ring_off;
  // this lane's slice of the new rows (k_rs, v_rs: elements between
  // streams)
  const size_t k_off = b * k_rs + (size_t)kh * D + sub * E;
  const size_t v_off = b * v_rs + (size_t)kh * D + sub * E;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // every lane of the block runs the same trip count, so the row-group
  // shuffles stay uniform
  for (int base = 0; base < n; base += NPART * U) {
    uint4 kw[U][NV], vw[U][NV];
    bool act[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = base + u * NPART + part;
      act[u] = jj < n;
      const int j = j0 + jj;
      int slot = wslot - j;
      if (slot < 0) slot += cap;
      T* kd = kr + (size_t)slot * D + sub * E;
      T* vd = vr + (size_t)slot * D + sub * E;
      if (act[u] && write && j == 0) {
        // the new row: cast to the ring type here, stored into slot
        // pos % cap by these 8 lanes, attended from registers (no block
        // reads that slot from the ring in this launch)
        if (rows_f32) {
          float x[E];
#pragma unroll
          for (int w = 0; w < E / 4; ++w)
            widen(reinterpret_cast<const uint4*>(
                      static_cast<const float*>(k_rows) + k_off)[w],
                  x + 4 * w, 0.f);
          pack(x, kw[u], T());
#pragma unroll
          for (int w = 0; w < E / 4; ++w)
            widen(reinterpret_cast<const uint4*>(
                      static_cast<const float*>(v_rows) + v_off)[w],
                  x + 4 * w, 0.f);
          pack(x, vw[u], T());
        } else {
#pragma unroll
          for (int w = 0; w < NV; ++w) {
            kw[u][w] = reinterpret_cast<const uint4*>(
                static_cast<const T*>(k_rows) + k_off)[w];
            vw[u][w] = reinterpret_cast<const uint4*>(
                static_cast<const T*>(v_rows) + v_off)[w];
          }
        }
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          reinterpret_cast<uint4*>(kd)[w] = kw[u][w];
          reinterpret_cast<uint4*>(vd)[w] = vw[u][w];
        }
      } else if (act[u]) {
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          kw[u][w] = reinterpret_cast<const uint4*>(kd)[w];
          vw[u][w] = reinterpret_cast<const uint4*>(vd)[w];
        }
      } else {
#pragma unroll
        for (int w = 0; w < NV; ++w)
          kw[u][w] = vw[u][w] = make_uint4(0, 0, 0, 0);
      }
    }

    // scores: this lane's 16 elements, then summed over the row's 8 lanes
    // (a butterfly: every lane of the group gets the same bits)
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        float x[PW];
        widen(kw[u][w], x, T());
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < PW; ++e)
            s[u][g] = fmaf(qv[g][w * PW + e], x[e], s[u][g]);
      }
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

    // online softmax over the trip's rows (s becomes the probabilities);
    // the rescale runs when some lane of the warp needs it
    bool grow = false;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        grow |= act[u] && s[u][g] > m[g] + RESCALE_MARGIN;
    if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (act[u]) mx = fmaxf(mx, s[u][g]);
        if (mx > m[g] + RESCALE_MARGIN) {
          const float corr = ex2(m[g] - mx);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= corr;
          m[g] = mx;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = act[u] ? ex2(s[u][g] - m[g]) : 0.f;
        l[g] += s[u][g];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        float x[PW];
        widen(vw[u][w], x, T());
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < PW; ++e)
            acc[g][w * PW + e] = fmaf(s[u][g], x[e], acc[g][w * PW + e]);
      }
    }
  }

  // the warp's 4 partitions (lanes 8 and 16 apart), then its partial to
  // shared memory
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {  // fold()'s arithmetic, one max per head
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = ex2(m[g] - mn), c = ex2(mo - mn);
      l[g] = fmaf(lo, c, __fmul_rn(l[g], a));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float oo = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = fmaf(oo, c, __fmul_rn(acc[g][e], a));
      }
      m[g] = mn;
    }
  }
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        w_m[warp][g] = m[g];
        w_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) w_o[warp][g * D + sub * E + e] = acc[g][e];
    }
  }
  __syncthreads();

  // the block's partial: the warps folded in order; with one split it is
  // the output (split 0 holds j = 0, so the sum is > 0)
  const size_t o0 = ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float M = NEG, Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      fold(M, Lsum, O, w_m[w][g], w_l[w][g], w_o[w][i]);
    if (n_splits == 1) {
      if (out_f32)
        static_cast<float*>(out)[o0 + i] = O / Lsum;
      else
        static_cast<__nv_bfloat16*>(out)[o0 + i] =
            __float2bfloat16_rn(O / Lsum);
      continue;
    }
    p_o[i] = O;
    if (i % D == 0) {
      p_m[g] = M;
      p_l[g] = Lsum;
    }
  }
  if (n_splits == 1) return;
  cg::cluster_group cluster = cg::this_cluster();  // rank == split
  cluster.sync();

  // block `split` of the cluster folds its share of the G x D outputs over
  // the splits, in split order; splits past the live window hold nothing
  const int per = (G * D + n_splits - 1) / n_splits;
  const int i_hi = min(G * D, (split + 1) * per);
  for (int i = split * per + tid; i < i_hi; i += NT) {
    const int g = i / D;
    float M = NEG, Lsum = 0.f, O = 0.f;
    for (int s = 0; s < n_splits && s * chunk < valid; ++s) {
      const float* rm = cluster.map_shared_rank(p_m, s);
      const float* rl = cluster.map_shared_rank(p_l, s);
      const float* ro = cluster.map_shared_rank(p_o, s);
      fold(M, Lsum, O, rm[g], rl[g], ro[i]);
    }
    const float v = O / Lsum;  // split 0 holds j = 0, so Lsum > 0
    if (out_f32)
      static_cast<float*>(out)[o0 + i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[o0 + i] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int G, typename T>
int launch(const void* q, void* k_all, void* v_all, const void* k_rows,
           const void* v_rows, const void* pos, void* out, int B, int L,
           int KH, int cap, int li, int window, int write, int q_f32,
           int rows_f32, int out_f32, long long k_rs, long long v_rs,
           int splits, cudaStream_t stream) {
  const int span = cap < window ? cap : window;
  const int chunk = (span + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH, B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<G, T>, q, static_cast<T*>(k_all),
      static_cast<T*>(v_all), k_rows, v_rows, static_cast<const int*>(pos),
      out, L, KH, cap, li, window, write, q_f32, rows_f32, out_f32, k_rs,
      v_rs, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g(int G, const void* q, void* k_all, void* v_all,
             const void* k_rows, const void* v_rows, const void* pos,
             void* out, int B, int L, int KH, int cap, int li, int window,
             int write, int q_f32, int rows_f32, int out_f32, long long k_rs,
             long long v_rs, int splits, cudaStream_t s) {
#define VT_G(N)                                                             \
  launch<N, T>(q, k_all, v_all, k_rows, v_rows, pos, out, B, L, KH, cap, li, \
               window, write, q_f32, rows_f32, out_f32, k_rs, v_rs, splits, s)
  switch (G) {
    case 1:
      return VT_G(1);
    case 2:
      return VT_G(2);
    case 4:
      return VT_G(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_G
}

}  // namespace

// q [B,H,D] in f32 (q_f32 != 0) or bf16; k_all/v_all [B,L,KH,cap,D],
// ring_kind 0 = f32, 1 = bf16, 2 = fp8 e4m3fn; k_rows/v_rows [B,KH,D] in
// f32 (rows_f32 != 0) or the ring type, read only when write != 0, each
// [KH,D] contiguous with k_rs/v_rs elements between streams; pos int32
// [B], >= 0; out [B,H,D] in f32 (out_f32 != 0) or bf16; the others
// contiguous, every pointer 16-byte aligned.  splits 1 .. 8: the caller's
// plan, a function of min(cap, window) and B alone.  Returns a
// cudaError_t code.
extern "C" int vt_flash_decode(const void* q, void* k_all, void* v_all,
                               const void* k_rows, const void* v_rows,
                               const void* pos, void* out, int B, int L,
                               int H, int KH, int cap, int head_dim, int li,
                               int window, int write, int ring_kind,
                               int q_f32, int rows_f32, int out_f32,
                               long long k_rs, long long v_rs, int splits,
                               void* stream) {
  if (head_dim != D || KH <= 0 || H % KH != 0 || B <= 0 || cap <= 0 ||
      li < 0 || li >= L || window <= 0 || splits < 1 ||
      splits > MAX_SPLITS || (write && (!k_rows || !v_rows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
#define VT_RING(R)                                                          \
  launch_g<R>(G, q, k_all, v_all, k_rows, v_rows, pos, out, B, L, KH, cap,  \
              li, window, write, q_f32, rows_f32, out_f32, k_rs, v_rs,      \
              splits, s)
  switch (ring_kind) {
    case 0:
      return VT_RING(float);
    case 1:
      return VT_RING(__nv_bfloat16);
    case 2:
      return VT_RING(__nv_fp8_e4m3);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_RING
}
