// The float32-query attention row walk, shared by the banded encoder kernel
// (banded_attention.cu) and the ring flash-encode kernel (flash_encode.cu).
//
// The TPU kernels take the compute dtype of the config: for a float32
// config their products, softmax and accumulations are all float32 (the
// probabilities are rounded to the query's dtype, which is a no-op).  The
// bf16 tile (attn_tile.cuh) runs on bf16 tensor-core products and cannot
// hold that; this walk is its float32 counterpart: every product and sum
// in f32 FMA on the CUDA cores, with accurate expf.  Float32 configs are
// the small witness configs (tests, the dry run, the f32 mesh check), so
// the walk is kept simple rather than fast:
//   * one warp per query row (NW rows per block of one head and stream);
//     the row's 64 query values sit in registers in every lane;
//   * keys stream through shared memory in tiles of BK = 32 (one per lane;
//     K rows padded to 68 floats, so the lanes' float4 reads of 32 rows
//     are free of bank conflicts); lane c scores key c of the tile;
//   * an online softmax in f32 per row: the tile's max by xor shuffles;
//     then lane i accumulates output dims i and i + 32 over the tile's
//     keys, each probability broadcast by a shuffle.
//
// Row independence, as in attn_tile.cuh: a tile with no valid key for a row
// leaves that row's max, sum and output exactly unchanged (it is skipped
// for the row), so a row's result depends only on the tiles in which it
// has keys, walked in the policy's order.  A policy that walks tiles in a
// fixed order of absolute key index (banded: positions; flash-encode: ring
// slots) makes a row's output independent of which block, chunk or batch
// it was computed in.
//
// A row that sees no key is written as 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn32 {

constexpr int D = 64;            // head_dim
constexpr int BK = 32;           // keys per tile: one per lane
constexpr int NW = 8;            // warps per block: one query row each
constexpr int BQ = NW;           // query rows per block
constexpr int NT = 32 * NW;      // threads per block
constexpr int LDK = D + 4;       // K tile row stride (floats)
constexpr float SCALE = 0.125f;  // 1/sqrt(64)
constexpr int NO_KEY = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// 4 consecutive elements of a K/V row as f32 (16- resp. 8-byte loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The walk of one block.  The policy says which keys exist and which a row
// sees (every member is block-uniform):
//   first(), next(j)   the key tiles to walk, in order (-1 ends); tile j
//                      holds keys j*BK .. j*BK + BK - 1
//   n_keys             keys at or past it load as zeros and are never valid
//   k_row(key), v_row  the key's K and V rows (16-byte aligned for f32)
//   kpos(key)          its position (NO_KEY: never valid)
//   row_lo(r), row_hi  the positions row r sees: [row_lo, row_hi]
// `q` is this warp's query row and `out` its output row (nullptr for a row
// past the ragged edge: it joins the loads and writes nothing).
template <typename KvT, typename OutT, class Policy>
__device__ void attend(const Policy& pol, const float* __restrict__ q,
                       OutT* __restrict__ out) {
  __shared__ __align__(16) float ks[BK * LDK];
  __shared__ __align__(16) float vs[BK * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = q != nullptr;
  float4 qr[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i)
    qr[i] = live ? reinterpret_cast<const float4*>(q)[i]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const int lo = pol.row_lo(warp), hi = pol.row_hi(warp);
  float m = -INFINITY, l = 0.f, o0 = 0.f, o1 = 0.f;

  for (int j = pol.first(); j >= 0; j = pol.next(j)) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * (D / 4); i += NT) {
      const int c = i / (D / 4), d = (i % (D / 4)) * 4;
      const int key = j * BK + c;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < pol.n_keys) {
        kv = load4(pol.k_row(key) + d);
        vv = load4(pol.v_row(key) + d);
      }
      *reinterpret_cast<float4*>(ks + c * LDK + d) = kv;
      *reinterpret_cast<float4*>(vs + c * D + d) = vv;
    }
    __syncthreads();

    const int kp = pol.kpos(j * BK + lane);
    const bool ok = live && kp != NO_KEY && kp >= lo && kp <= hi;
    float s = -INFINITY;
    if (ok) {
      const float4* kr = reinterpret_cast<const float4*>(ks + lane * LDK);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 k4 = kr[i];
        acc = fmaf(qr[i].x, k4.x, acc);
        acc = fmaf(qr[i].y, k4.y, acc);
        acc = fmaf(qr[i].z, k4.z, acc);
        acc = fmaf(qr[i].w, k4.w, acc);
      }
      s = acc * SCALE;
    }
    const float tmax = warp_max(s);
    if (tmax == -INFINITY) continue;  // no key of the tile for this row
    const float mn = fmaxf(m, tmax);
    const float corr = expf(m - mn);  // 0 before the row's first key
    const float p = ok ? expf(s - mn) : 0.f;
    l = fmaf(l, corr, warp_sum(p));
    o0 *= corr;
    o1 *= corr;
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float pc = __shfl_sync(FULL, p, c);
      o0 = fmaf(pc, vs[c * D + lane], o0);
      o1 = fmaf(pc, vs[c * D + lane + 32], o1);
    }
    m = mn;
  }
  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    put(out + lane, o0 * inv);
    put(out + lane + 32, o1 * inv);
  }
}

}  // namespace attn32
