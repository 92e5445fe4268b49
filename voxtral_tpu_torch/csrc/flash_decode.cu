// Single-query GQA attention over the decoder's KV ring, with an optional
// in-place write of this step's K/V row.
//
// Replaces three Pallas kernels of voxtral_tpu/ops/flash_decode.py:
//   _kernel            (per-stream grid; the B=1 decode path),
//   _kernel_flat       (the same attention as one program), and
//   _kernel_flat_fused (row write + attention in one launch, B >= 2),
// and the row write the B=1 path did before it (ops/ring.py
// ring_rows_write).  With write=0 it is the first two; with write=1 it is
// the third.
//
// Function: for stream b with query position pos the live window holds
//     valid = min(pos + 1, window, cap)
// slots, the logical positions pos-valid+1 .. pos at ring slots
// (pos-valid+1 .. pos) mod cap of layer li (the _info arithmetic,
// flash_decode.py:412-421).  Each of the G = H/KH query heads of a KV group
// attends over them with an online softmax in float32; out is f32 [B,H,D].
// With write=1 the slot pos % cap is read from k_rows/v_rows (the ring
// still holds the stale row pos-cap there) and the block stores the new row
// into the ring.  No other block reads that (b, li, kh) slice, and this
// block never reads the slot from the ring, so the in-place store cannot
// race with a read.
//
// What bounds it on the H100: device-memory bytes.  Every live K/V element
// is read once and used for G=4 multiply-adds per product, ~1 FLOP/byte,
// far below the ridge; at B=1 the 26 launches per decode step are also
// bounded by launch latency.  The design reads only the live window (never
// the dead slots of the ring), packs the G query heads of a KV group into
// one block so each K/V row is fetched once for all of them, and spreads
// the window over 32 independent softmax partitions per block (8 lanes per
// slot, 16-byte loads, consecutive slots on consecutive lane groups) so
// many loads are in flight; partitions merge through warp shuffles and
// shared memory at the end.  Split-K across blocks, for B=1 occupancy, is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;               // head_dim (the decoder's)
constexpr int LANES_PER_SLOT = 8;
constexpr int E = D / LANES_PER_SLOT;  // elements of a row per lane: 16
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NPART = NTHREADS / LANES_PER_SLOT;  // 32 partitions

__device__ __forceinline__ void load_row(const float* p, float* x) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    x[i] = f.x;
    x[i + 1] = f.y;
    x[i + 2] = f.z;
    x[i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* x) {
#pragma unroll
  for (int i = 0; i < E; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[i + 2 * j] = f.x;
      x[i + 2 * j + 1] = f.y;
    }
  }
}

template <int G, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const float* __restrict__ q, T* __restrict__ k_all,
                    T* __restrict__ v_all, const T* __restrict__ k_rows,
                    const T* __restrict__ v_rows, const int* __restrict__ pos_b,
                    float* __restrict__ out, int L, int KH, int cap, int li,
                    int window, int write, float scale) {
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int part = tid / LANES_PER_SLOT;  // softmax partition
  const int sub = tid % LANES_PER_SLOT;   // this lane's slice of the row
  const int H = KH * G;

  const int pos = pos_b[b];
  const int valid = min(min(pos + 1, window), cap);
  const int lo_slot = ((pos - valid + 1) % cap + cap) % cap;
  const int wslot = pos % cap;

  const size_t ring_off = (((size_t)b * L + li) * KH + kh) * (size_t)cap * D;
  T* kr = k_all + ring_off;
  T* vr = v_all + ring_off;
  const size_t row_off = ((size_t)b * KH + kh) * D;

  if (write) {
    // the new row goes into slot pos % cap; no thread of any block reads
    // that slot from the ring in this launch
    for (int i = tid; i < D; i += NTHREADS) {
      kr[(size_t)wslot * D + i] = k_rows[row_off + i];
      vr[(size_t)wslot * D + i] = v_rows[row_off + i];
    }
  }

  float qv[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* qp = q + ((size_t)b * H + (size_t)kh * G + g) * D + sub * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qv[g][e] = qp[e] * scale;
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // every lane runs the same trip count so the group shuffles stay uniform
  for (int base = 0; base < valid; base += NPART) {
    const int j = base + part;
    const bool active = j < valid;
    float kx[E], vx[E];
    if (active) {
      int slot = lo_slot + j;
      if (slot >= cap) slot -= cap;
      const bool fresh = write && slot == wslot;
      load_row(fresh ? k_rows + row_off + sub * E
                     : kr + (size_t)slot * D + sub * E, kx);
      load_row(fresh ? v_rows + row_off + sub * E
                     : vr + (size_t)slot * D + sub * E, vx);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kx[e] = vx[e] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qv[g][e], kx[e], d);
      s[g] = d;
    }
#pragma unroll
    for (int off = 1; off < LANES_PER_SLOT; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    if (active) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - m_new);  // 0 on the first slot
        const float p = expf(s[g] - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], corr, p * vx[e]);
        m[g] = m_new;
      }
    }
  }

  // merge the 4 partitions of each warp (lanes 8 and 16 apart)
#pragma unroll
  for (int off = LANES_PER_SLOT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - mm);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mm);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mm;
    }
  }
  if (lane < LANES_PER_SLOT) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][sub * E + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps; valid >= 1, so some partition saw a slot
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = sm_m[w][g];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mm);
      ls += sm_l[w][g] * f;
      as += sm_acc[w][g][d] * f;
    }
    out[((size_t)b * H + (size_t)kh * G + g) * D + d] = as / fmaxf(ls, 1e-30f);
  }
}

template <int G, typename T>
int launch(const void* q, void* k_all, void* v_all, const void* k_rows,
           const void* v_rows, const void* pos, void* out, int B, int L,
           int KH, int cap, int li, int window, int write,
           cudaStream_t stream) {
  dim3 grid(KH, B);
  flash_decode_kernel<G, T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<T*>(k_all),
      static_cast<T*>(v_all), static_cast<const T*>(k_rows),
      static_cast<const T*>(v_rows), static_cast<const int*>(pos),
      static_cast<float*>(out), L, KH, cap, li, window, write,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g(int G, const void* q, void* k_all, void* v_all,
             const void* k_rows, const void* v_rows, const void* pos,
             void* out, int B, int L, int KH, int cap, int li, int window,
             int write, cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<1, T>(q, k_all, v_all, k_rows, v_rows, pos, out, B, L,
                          KH, cap, li, window, write, s);
    case 2:
      return launch<2, T>(q, k_all, v_all, k_rows, v_rows, pos, out, B, L,
                          KH, cap, li, window, write, s);
    case 4:
      return launch<4, T>(q, k_all, v_all, k_rows, v_rows, pos, out, B, L,
                          KH, cap, li, window, write, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q f32 [B,H,D]; k_all/v_all [B,L,KH,cap,D] in f32 (ring_f32 != 0) or bf16;
// k_rows/v_rows [B,KH,D] in the ring dtype (read only when write != 0);
// pos int32 [B]; out f32 [B,H,D].  Returns a cudaError_t code.
extern "C" int vt_flash_decode(const void* q, void* k_all, void* v_all,
                               const void* k_rows, const void* v_rows,
                               const void* pos, void* out, int B, int L,
                               int H, int KH, int cap, int head_dim, int li,
                               int window, int write, int ring_f32,
                               void* stream) {
  if (head_dim != D || KH <= 0 || H % KH != 0 || B <= 0 || cap <= 0 ||
      li < 0 || li >= L || window <= 0 || (write && (!k_rows || !v_rows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
  return ring_f32
             ? launch_g<float>(G, q, k_all, v_all, k_rows, v_rows, pos, out,
                               B, L, KH, cap, li, window, write, s)
             : launch_g<__nv_bfloat16>(G, q, k_all, v_all, k_rows, v_rows,
                                       pos, out, B, L, KH, cap, li, window,
                                       write, s);
}
