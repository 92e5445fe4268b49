// One Hopper attention tile, shared by the banded encoder kernel
// (banded_attention.cu) and the ring flash-encode kernel (flash_encode.cu).
//
// Both compute the same online-softmax attention with head_dim 64 over
// 64-key tiles; they differ only in which keys a query row may see and in
// the order and limits of the key loop.  That difference is a mask policy
// (see `attend` below); everything else lives here once.
//
// The design, per block of NW = 4 warps (16 query rows each, BQ = 64; a
// 128-row tile of 8 warps measured slower for both kernels, PERF.md):
//   * Both products run on mma.sync.aligned.m16n8k16 bf16 -> f32 through
//     inline PTX.  Operands come from shared memory by ldmatrix (V by
//     ldmatrix.trans).  Q is loaded into shared memory once and its A
//     operands are read from there for each tile: held in registers for
//     the whole walk they would push the tile past 128 registers, the
//     budget of 4 blocks per SM, into spills.
//   * The S = Q K^T accumulator stays in registers.  Its m16n8 C layout is
//     the m16n8k16 A layout, so P, rounded to bf16, feeds the PV product
//     straight from registers: no score, probability or output tile goes
//     through shared memory.  O accumulates in f32 registers.
//   * The softmax runs in registers: a row's 64 scores sit in the 4 lanes
//     of a quad, whose max is reduced with two xor shuffles; the scale
//     1/sqrt(64) * log2(e) and the max are folded into one FFMA per score
//     and the exponentials run on the SFU (ex2.approx.ftz); the rescale of
//     O is one multiply per accumulator register.
//     Each lane keeps its own partial row sum, reduced over the quad once,
//     after the loop.
//   * K/V tiles stream through a ring of NSTAGE stages in shared memory with
//     16-byte cp.async.cg copies (commit_group / wait_group): the next
//     tile's copies are issued before the current tile's math.  A 128-byte
//     XOR swizzle (one bf16 row of D = 64 is exactly 128 bytes: chunk c of
//     row r sits at chunk c ^ (r & 7)) keeps ldmatrix free of bank
//     conflicts without padding.  f32 tiles (flash-encode's f32 rings) are
//     rounded to bf16 through registers, since cp.async cannot convert.
//   * Tiles that lie wholly inside every row's valid band skip the
//     per-element mask; only edge tiles evaluate it.
//
// Numerics (unchanged from the WMMA kernels these replaced): scores in f32;
// an online softmax in f32 with the finite sentinel NEG for masked scores;
// probabilities rounded to bf16 before the PV product; f32 accumulation; a
// row that sees no key ends with l = 0 and is written as 0 by the caller.
// Only the order of f32 operations and the base-2 exponentials differ (a
// probability below 2^-126 becomes 0).
//
// Row independence: a row's arithmetic depends only on its own scores and
// on the sequence of tiles walked.  A tile masked for every key of a row
// leaves that row's max, sum and output bitwise unchanged (rescale exactly
// 1, probabilities exactly 0), so a policy may skip a tile that is masked
// for every row of the block without changing any row's result.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int D = 64;                  // head_dim
constexpr int BK = 64;                 // keys per tile
constexpr int ROW_BYTES = D * 2;       // one bf16 row: 8 chunks of 16 bytes
constexpr int TILE_BYTES = BK * ROW_BYTES;
constexpr int NSTAGE = 3;              // K/V pipeline depth
constexpr float NEG = -1e30f;          // finite "masked" sentinel
// 1/sqrt(64) * log2(e): scores go to the log2 domain in one multiply
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;
// a running max below this is a sentinel: the row has seen no key yet
constexpr float MASKED = 0.5f * NEG * SCALE_LOG2;
constexpr int NO_KEY = 0x7fffffff;     // a key position no row may see
constexpr int LDO = D + 4;             // f32 staging stride (floats)

constexpr int NW = 4;                  // warps per block
constexpr int BQ = 16 * NW;            // query rows per block
constexpr int NT = 32 * NW;            // threads per block
constexpr int Q_BYTES = BQ * ROW_BYTES;
constexpr int KV_BYTES = NSTAGE * 2 * TILE_BYTES;
constexpr int SMEM_BYTES = Q_BYTES + KV_BYTES;
// the f32 staging of BQ output rows (plus a max and a sum per row) reuses
// the K/V stages once the loop is done
static_assert(BQ * LDO * 4 + 2 * BQ * 4 <= KV_BYTES, "staging fits");

// the per-thread state of a warp's 16 rows: lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8; o[n] covers head dims 8n + 2t, 8n + 2t + 1
struct Acc {
  float o[8][4];
  float m[2];
  float l[2];
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled 128-byte-row tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU, flushing a denormal result to 0 (exp2f's denormal
// handling costs extra instructions per score); 2^0 is exactly 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- tile loads (ROWS rows of 64 elements; rows >= `valid` are zeros) -----

template <int NT, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t s, const __nv_bfloat16* g,
                                          int stride, int valid,
                                          int tid) {
  static_assert(ROWS * 8 % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int k = 0; k < ROWS * 8 / NT; ++k) {
    const int i = tid + k * NT, r = i >> 3, c = i & 7;
    const bool ok = r < valid;
    cp_async16(s + swz(r, c), ok ? g + r * stride + c * 8 : g, ok);
  }
}

// f32 rows are rounded to bf16 on the way in (the compute dtype)
template <int NT, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t s, const float* g,
                                          int stride, int valid,
                                          int tid) {
#pragma unroll
  for (int k = 0; k < ROWS * 8 / NT; ++k) {
    const int i = tid + k * NT, r = i >> 3, c = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      const float4* p = reinterpret_cast<const float4*>(g + r * stride + c * 8);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                     pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    st_shared16(s + swz(r, c), v);
  }
}

// ---- the key loop ---------------------------------------------------------
//
// A mask policy `Pol` gives, all as uniform functions of the block:
//   first(), next(j)     the key tiles to walk, in order (-1 ends the walk)
//   k_tile(j), v_tile(j) the first K / V row of tile j, kv_stride (int)
//                        elements between rows, kv_rows(j) rows that exist
//   interior(j)          every key of tile j is valid for every row
//   kpos(j, c)           key c of tile j as a position (NO_KEY: never valid)
//   q, q_stride, q_rows  the block's query rows (q_rows of them exist,
//                        q_stride elements apart)
//   row_lo(r), row_hi(r) row r of the block sees keys lo <= kpos <= hi
// `Seg` cuts the walk into segments: after tile jc, with jn the next tile
// (-1 at the end), seg.ends(jc, jn) says whether jc closes a segment; if
// so the segment's state (acc.l reduced over the quad) goes to
// seg.fold(acc) and the walk goes on from a fresh state.  On return the
// K/V stages are free for the caller's epilogue and acc.l is the full row
// sum of the last segment (reduced over the quad).
struct NoSegments {
  __device__ bool ends(int, int) const { return false; }
  __device__ void fold(const Acc&) {}
};

__device__ __forceinline__ void reduce_sums(Acc& acc) {
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    acc.l[0] += __shfl_xor_sync(0xffffffffu, acc.l[0], x);
    acc.l[1] += __shfl_xor_sync(0xffffffffu, acc.l[1], x);
  }
}

__device__ __forceinline__ void reset(Acc& acc) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[n][e] = 0.f;
  acc.m[0] = acc.m[1] = NEG;
  acc.l[0] = acc.l[1] = 0.f;
}

template <class Pol, class Seg = NoSegments>
__device__ __forceinline__ void attend(const Pol& pol, unsigned char* smem,
                                       Acc& acc, Seg&& seg = Seg()) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + Q_BYTES;

  reset(acc);
  int jl = pol.first();  // the next tile to load
  if (jl < 0) return;    // no key for any row: l stays 0

  load_tile<NT, BQ>(s_q, pol.q, pol.q_stride, pol.q_rows, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (jl >= 0) {
      const uint32_t sk = s_kv + st * 2 * TILE_BYTES;
      load_tile<NT, BK>(sk, pol.k_tile(jl), pol.kv_stride, pol.kv_rows(jl),
                        tid);
      load_tile<NT, BK>(sk + TILE_BYTES, pol.v_tile(jl), pol.kv_stride,
                        pol.kv_rows(jl), tid);
      jl = pol.next(jl);
    }
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;
  const int lo0 = pol.row_lo(r0), hi0 = pol.row_hi(r0);
  const int lo1 = pol.row_lo(r0 + 8), hi1 = pol.row_hi(r0 + 8);

  int it = 0;
  for (int jc = pol.first(); jc >= 0; ++it) {
    cp_async_wait<NSTAGE - 2>();  // Q and tile `it` have landed (this
    __syncthreads();              // thread's part; then everyone's), and
                                  // stage it-1 is free
    if (jl >= 0) {
      const uint32_t sk = s_kv + ((it + NSTAGE - 1) % NSTAGE) * 2 * TILE_BYTES;
      load_tile<NT, BK>(sk, pol.k_tile(jl), pol.kv_stride, pol.kv_rows(jl),
                        tid);
      load_tile<NT, BK>(sk + TILE_BYTES, pol.v_tile(jl), pol.kv_stride,
                        pol.kv_rows(jl), tid);
      jl = pol.next(jl);
    }
    cp_async_commit();
    const uint32_t sk = s_kv + (it % NSTAGE) * 2 * TILE_BYTES;
    const uint32_t sv = sk + TILE_BYTES;

    // S = Q K^T: s[n] holds keys 8n + 2t (+1) of rows g and g + 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t qa[4];  // A operand of Q, dims 16kk .. 16kk + 15
      ldsm_x4(qa, s_q + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // keys 16np..16np+15, dims 16kk..16kk+15
        ldsm_x4(b, sk + swz(16 * np + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
        mma16816(s[2 * np], qa, b[0], b[1]);
        mma16816(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    if (!pol.interior(jc)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = pol.kpos(jc, 8 * n + 2 * t + e);
          if (kp < lo0 || kp > hi0) s[n][e] = NEG;
          if (kp < lo1 || kp > hi1) s[n][e + 2] = NEG;
        }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), in the
    // log2 domain: the max of the raw scores times SCALE_LOG2 is the max of
    // the scaled ones, bit for bit (the scale is positive)
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(acc.m[0], mx0 * SCALE_LOG2);
    const float mn1 = fmaxf(acc.m[1], mx1 * SCALE_LOG2);
    // 0 when the old max is a sentinel and the new one is not, exactly 1
    // when the max stays
    const float c0 = exp2f(acc.m[0] - mn0), c1 = exp2f(acc.m[1] - mn1);
    acc.m[0] = mn0;
    acc.m[1] = mn1;
    // a row that has seen no key yet subtracts 0, so that its masked
    // scores (NEG * SCALE_LOG2) still give exactly 0
    const float z0 = mn0 > MASKED ? mn0 : 0.f, z1 = mn1 > MASKED ? mn1 : 0.f;

    // probabilities in f32 for the sums, rounded to bf16 pairs as the A
    // operands of the PV product (keys 16kk .. 16kk + 15)
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2_ftz(fmaf(s[n][0], SCALE_LOG2, -z0));
      const float p1 = exp2_ftz(fmaf(s[n][1], SCALE_LOG2, -z0));
      const float p2 = exp2_ftz(fmaf(s[n][2], SCALE_LOG2, -z1));
      const float p3 = exp2_ftz(fmaf(s[n][3], SCALE_LOG2, -z1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);      // row g
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
      acc.o[n][0] *= c0;
      acc.o[n][1] *= c0;
      acc.o[n][2] *= c1;
      acc.o[n][3] *= c1;
    }
    acc.l[0] = acc.l[0] * c0 + sum0;
    acc.l[1] = acc.l[1] * c1 + sum1;

    // O += P V, P straight from registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // dims 16dp .. 16dp + 15
        uint32_t b[4];
        ldsm_x4_t(b, sv + swz(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                              2 * dp + (lane >> 4)));
        mma16816(acc.o[2 * dp], pa[kk], b[0], b[1]);
        mma16816(acc.o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
    const int jn = pol.next(jc);
    if (seg.ends(jc, jn)) {
      reduce_sums(acc);
      seg.fold(acc);
      reset(acc);
    }
    jc = jn;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  reduce_sums(acc);
}

// ---- epilogue helpers -----------------------------------------------------

// this warp's rows of acc.o, each scaled by `f` (one factor per row half),
// into the f32 staging rows `st` (stride LDO)
__device__ __forceinline__ void stage_rows(float* st, const Acc& acc,
                                           float f0, float f1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(st + r * LDO + 8 * n + c) =
        make_float2(acc.o[n][0] * f0, acc.o[n][1] * f0);
    *reinterpret_cast<float2*>(st + (r + 8) * LDO + 8 * n + c) =
        make_float2(acc.o[n][2] * f1, acc.o[n][3] * f1);
  }
}

// 4 consecutive outputs
__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// 8 consecutive outputs in 16-byte stores
__device__ __forceinline__ void store8(float* p, float4 a, float4 b) {
  reinterpret_cast<float4*>(p)[0] = a;
  reinterpret_cast<float4*>(p)[1] = b;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, float4 a, float4 b) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                 pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

}  // namespace attn
