// int4 weight-only matmul (W4A16) with nibble-packed weights.
//
// Replaces voxtral_tpu/ops/quant_mm.py:_kernel (the Pallas kernel behind
// int4_mm).  Same function:
//     y[m, n] = s[n, 0] * sum_j x[m, j]        * lo(p[n, j])
//             + s[n, 1] * sum_j x[m, half + j] * hi(p[n, j])
// for j in [0, half), where byte p[n, j] holds the signed 4-bit weights of
// input columns j (low nibble) and half + j (high nibble): the columns of
// one byte are half the row apart, not neighbours.  x is bf16 [M, 2*half],
// p is layer li of an int8 [L, N, half] stack, s is f32 [L, N, 2], y is f32
// [M, N].  Products are exact in bf16 x int4; the sums are f32.
//
// What bounds it on the H100: at decode (M = streams, 1..64) device-memory
// bytes of the packed weights, 0.5 byte per weight; at batched prefill
// (M = 38 x streams) tensor-core math.  Both tiles compute the transposed
// product, y^T = W x^T: the weights, unpacked in registers, are the tensor
// cores' A operand, and x is the B operand.
//   * Unpack in registers.  Byte j of a weight row holds column j of the
//     low product and column half + j of the high one, so one load of
//     packed bytes feeds the same A fragment position of both products,
//     paired with the x of columns j and half + j; two f32 accumulators, one
//     per half.  Two nibbles go to bf16 in two operations: prmt spreads two
//     bytes to the halves of a word, and (u & 0xF) ^ 0x4308 read as bf16 is
//     128 + (u ^ 8); a bf16x2 subtract of 136 leaves the signed nibble
//     (u ^ 8) - 8, exact.  Nothing unpacked is written to memory.
//   * A ring of 4 shared-memory stages of 64 packed columns (both halves'
//     x tiles, the packed tile, and with a tile's last stage its scales),
//     filled by TMA: one thread issues a stage's tensor copies onto the
//     stage's barrier, boxes past the tensors' edges fill with zeros, and
//     no other thread spends an instruction on loads.  x comes in TMA's
//     128-byte swizzle (16-byte piece q of row r at q ^ (r & 7)):
//     conflict-free fragment loads, and the layout a wgmma descriptor
//     reads.  The epilogue applies the per-(column, half) scales in f32 and
//     writes f32 y, masked to [M, N]: the caller pads nothing.
//   * Each launch may begin while the stream's previous kernel finishes
//     (programmatic dependent launch): it issues its first stages' weights,
//     which no kernel writes, and waits for that kernel (griddepcontrol)
//     only before it reads x or writes y.
//   * Decode tile (int4_mm_kernel, 16 or 32 rows of x): mma.sync m16n8k16,
//     four warps of 16 output columns each.  A thread's 16 packed bytes of
//     a row (one 16-byte load) feed 4 k16 steps: fragment columns (2t,
//     2t+1, 2t+8, 2t+9) of quad thread t map to packed bytes 16t + 4s +
//     (0..3) -- any bijection of k is the same sum, and this one makes a
//     weight word and an x word line up.  The tiles of a decode product
//     are too few to fill the card, so the K range is split over the CS
//     blocks of a thread-block cluster, which fold their partial sums
//     through distributed shared memory in rank order: one launch, no
//     workspace, the same bits on every call.  At 16 rows wgmma does not
//     pay: the work per weight byte is the unpack and the latency, and
//     mma.sync keeps more, smaller blocks in flight.
//   * Prefill tile (int4_mm_wgmma_kernel, 128 rows of x, 128 columns): two
//     warpgroups of 64 columns run wgmma m64n128k16 with the unpacked
//     weights as the register A operand and the x tile read from shared
//     memory by descriptor, asynchronously, so the tensor cores run while
//     the next k16 step unpacks (A in four register buffers, at most three
//     groups in flight).  Here the fragment keeps k in order (the
//     descriptor reads x in order): thread t takes bytes 2t, 2t+1 and 2t+8,
//     2t+9 of each 16-byte piece with two 4-byte loads; the packed rows come
//     in TMA's 64-byte swizzle (piece q of row r at q ^ ((r >> 1) & 3)), so
//     those loads are conflict-free.
//   * One launch per call, persistent: the caller's plan (ops/quant_mm.py
//     int4_mm_plan, a function of the shapes alone) gives the tile, the K
//     split and the number of clusters, never more blocks than fit the card
//     at once; a cluster walks the tiles clusters apart.

#include <cooperative_groups.h>

#include "quant_mm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BKB = 64;          // packed columns (bytes) per K chunk
constexpr int STAGES = 4;        // ring stages
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// The decode tile: NJ n8 tiles of x rows (16 or 32 at the plan's row
// counts), four warps of 16 output columns.  The prefill tile: 128 output
// columns (a warpgroup's m64 tile each, two warpgroups) x 128 rows of x
// (the wgmma's n): per unpacked A fragment 128 x rows, half the unpack per
// product of a 256 x 64 tile at the same 64 accumulators a thread.  A
// stage is the x tiles of both halves, the packed tile, and the tile's f32
// scales [BN][2]; the ring keeps each kind in its own array (the x tiles
// first, each on a 1024-byte boundary for TMA's 128-byte swizzle, with no
// padding), then a barrier per stage and, for a K split, the partial sums.
// ops/quant_mm.py _TILES mirrors these.
template <int BN, int BM>
struct Ring {
  static constexpr int X_BYTES = 2 * BM * 2 * BKB, W_BYTES = BN * BKB;
  static constexpr int S_BYTES = BN * 8;
  static constexpr int BAR_OFF = STAGES * (X_BYTES + W_BYTES + S_BYTES);
  static_assert(X_BYTES % 1024 == 0, "x tiles must stay 1024-byte aligned");
  __host__ __device__ static constexpr int x_at(int slot) {
    return slot * X_BYTES;
  }
  __host__ __device__ static constexpr int w_at(int slot) {
    return STAGES * X_BYTES + slot * W_BYTES;
  }
  __host__ __device__ static constexpr int s_at(int slot) {
    return STAGES * (X_BYTES + W_BYTES) + slot * S_BYTES;
  }
};
template <int NJ_>
struct MmaTile : Ring<64, 8 * NJ_> {
  static constexpr int NJ = NJ_, NT = 128, BN = 64, BM = 8 * NJ;
  static constexpr int PART_OFF = MmaTile::BAR_OFF + 128;
  static constexpr int E = NJ * 4;  // outputs per thread and half
  // blocks an SM must hold by registers (caps them at 102 and 168)
  static constexpr int MIN_BLOCKS = NJ == 2 ? 5 : 3;
  // the ring from a 1024-byte boundary (1 KB more), barriers, partials
  static constexpr int MAX_SMEM = 1024 + PART_OFF + 2 * E * NT * 4;
  static constexpr int smem(int cs) {
    return cs > 1 ? MAX_SMEM : 1024 + PART_OFF;
  }
  // the packed rows land as they are: 64-byte rows read 16 bytes a lane
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_NONE;
};
struct WgTile : Ring<128, 128> {
  static constexpr int NT = 256, BN = 128, BM = 128;
  static constexpr int MAX_SMEM = 1024 + BAR_OFF + 128;
  static constexpr int smem(int) { return MAX_SMEM; }
  // the packed rows in TMA's 64-byte swizzle: piece q of row r at
  // q ^ ((r >> 1) & 3), so the 4-byte fragment loads are conflict-free
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;
  __device__ static int w_piece(int r, int q) { return q ^ ((r >> 1) & 3); }
};

// Two bf16 weights from a word holding packed bytes at bits 0-7 and 16-23:
// the low nibbles (h = 0) or the high ones (h = 1), the lower byte's in the
// lower half.  (u ^ 8) | 0x4300 is the bf16 128 + (u ^ 8), so subtracting
// 136 (0x4308) gives (u ^ 8) - 8, the two's-complement value of u, exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t t, int h) {
  const uint32_t v = ((h ? t >> 4 : t) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t magic = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---- the walk over tiles and K chunks, and the ring ------------------------

// A block's share: the tiles blockIdx.y, + gridDim.y, ..., each over the K
// chunks [c_lo, c_lo + nch) of its rank (blockIdx.x of gridDim.x = cs).
template <class C>
struct Walk {
  int n_mt, c_lo, nch, steps;
  __device__ Walk(int M, int N, int half) {
    n_mt = (M + C::BM - 1) / C::BM;
    const int n_tiles = ((N + C::BN - 1) / C::BN) * n_mt;
    const int chunks = (half + BKB - 1) / BKB;
    const int cs = gridDim.x, rank = blockIdx.x;
    c_lo = (int)((long long)rank * chunks / cs);
    nch = (int)((long long)(rank + 1) * chunks / cs) - c_lo;
    const int tiles = (int)blockIdx.y < n_tiles
                          ? (n_tiles - 1 - blockIdx.y) / gridDim.y + 1
                          : 0;
    steps = tiles * nch;
  }
};

// Stage k of the block's walk into ring slot k % STAGES, by TMA onto the
// slot's barrier (one thread): its weights (the packed tile, and with the
// tile's last chunk its scales; the barrier expects the whole stage's
// bytes), its x, or both.  x is a [M][2][half] bf16 tensor (box 64 columns
// x 1 half x BM rows), the packed layer [N][half] bytes (box 64 x BN), the
// scales the stack's f32 [(li + 1) N 2] from layer li's offset s_off (box
// 2 BN; past column N it reads the next layer's, which no output uses);
// boxes past a tensor's edge fill with zeros.
template <class C>
__device__ __forceinline__ void issue_stage(
    const Walk<C>& w, int k, bool weights, bool acts, uint32_t sbase,
    const CUtensorMap* mx, const CUtensorMap* mp, const CUtensorMap* ms,
    int s_off) {
  constexpr uint32_t X_TILE = C::BM * 128, W_TILE = C::BN * BKB;
  constexpr uint32_t S_TILE = C::BN * 8;
  const int slot = k % STAGES, c = k % w.nch;
  const int t = blockIdx.y + (k / w.nch) * gridDim.y;
  const int n0 = (t / w.n_mt) * C::BN, m0 = (t % w.n_mt) * C::BM;
  const int k0 = (w.c_lo + c) * BKB;
  const bool last = c == w.nch - 1;
  const uint32_t bar = sbase + C::BAR_OFF + 8 * slot;
  if (weights) {
    mbar_expect(bar, 2 * X_TILE + W_TILE + (last ? S_TILE : 0));
    tma_2d(sbase + C::w_at(slot), mp, k0, n0, bar);
    if (last) tma_1d(sbase + C::s_at(slot), ms, s_off + 2 * n0, bar);
  }
  if (acts) {
    tma_3d(sbase + C::x_at(slot), mx, k0, 0, m0, bar);
    tma_3d(sbase + C::x_at(slot) + X_TILE, mx, k0, 1, m0, bar);
  }
}

// The ring's start: the tensor maps prefetched and the barriers
// initialised, then the first `ahead`
// stages issued -- their weights before the grids this one depends on are
// done (weights are no kernel's output), their x, and so every later
// read of x and write of y, after; then dependents may launch.
template <class C>
__device__ __forceinline__ void start_ring(
    const Walk<C>& w, int ahead, uint32_t sbase, const CUtensorMap* mx,
    const CUtensorMap* mp, const CUtensorMap* ms, int s_off) {
  if (threadIdx.x == 0) {
    prefetch_map(mx);
    prefetch_map(mp);
    prefetch_map(ms);
    for (int i = 0; i < STAGES; ++i) mbar_init(sbase + C::BAR_OFF + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < ahead && k < w.steps; ++k)
      issue_stage(w, k, true, false, sbase, mx, mp, ms, s_off);
  griddep_wait();
  if (threadIdx.x == 0)
    for (int k = 0; k < ahead && k < w.steps; ++k)
      issue_stage(w, k, false, true, sbase, mx, mp, ms, s_off);
  griddep_launch();
}

// ---- the decode tile: mma.sync, K split over a cluster --------------------

template <int NJ>
__global__ void __launch_bounds__(128, MmaTile<NJ>::MIN_BLOCKS)
int4_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_p,
               const __grid_constant__ CUtensorMap map_s,
               float* __restrict__ y, int M, int N, int half, int s_off) {
  using C = MmaTile<NJ>;
  constexpr int NT = C::NT, BN = C::BN, BM = C::BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Walk<C> walk(M, N, half);
  const int cs = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  float acc[NJ][2][4];
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][h][c] = 0.f;
  };

  // acc += this warp's 16 columns x BM rows over the 64 packed columns of
  // ring slot `slot` (4 k16 steps of each product)
  auto compute = [&](int slot) {
    const uint32_t ws = sbase + C::w_at(slot), xs = sbase + C::x_at(slot);
    uint4 wa[2];  // packed bytes 16 tig .. 16 tig + 15 of rows g, g + 8
#pragma unroll
    for (int e = 0; e < 2; ++e)
      wa[e] = ld_shared16(ws + (warp * 16 + 8 * e + g) * BKB + 16 * tig);
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // x row 8j + g, columns 16 tig + 8 sp .. + 7 of half h: the B
        // fragments of k16 steps 2 sp and 2 sp + 1
        uint4 xb[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          xb[j] = ld_shared16(xs + (h * BM + 8 * j + g) * 128 +
                              (((2 * tig + sp) ^ g) << 4));
#pragma unroll
        for (int ss = 0; ss < 2; ++ss) {
          const int ks = 2 * sp + ss;  // k16 step: word ks of wa
          const uint32_t w0 = ks == 0 ? wa[0].x : ks == 1 ? wa[0].y
                            : ks == 2 ? wa[0].z : wa[0].w;
          const uint32_t w1 = ks == 0 ? wa[1].x : ks == 1 ? wa[1].y
                            : ks == 2 ? wa[1].z : wa[1].w;
          // bytes 0, 1 -> fragment columns 2 tig, 2 tig + 1; bytes 2, 3 ->
          // 2 tig + 8, 2 tig + 9; rows g (w0) and g + 8 (w1)
          const uint32_t a[4] = {
              nibbles_bf16x2(__byte_perm(w0, 0u, 0x4140), h),
              nibbles_bf16x2(__byte_perm(w1, 0u, 0x4140), h),
              nibbles_bf16x2(__byte_perm(w0, 0u, 0x4342), h),
              nibbles_bf16x2(__byte_perm(w1, 0u, 0x4342), h)};
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma16816(acc[j][h], a, ss ? xb[j].z : xb[j].x,
                     ss ? xb[j].w : xb[j].y);
        }
      }
    }
  };

  // y for tile t, whose last stage sits in ring slot `slot`: the scaled
  // sums, folded over the cluster's K ranges in rank order when the K range
  // is split.  Output (j, c) of a thread is column 16 warp + g + 8 (c >> 1)
  // of the tile, row 8 j + 2 tig + (c & 1).
  auto epilogue = [&](int t, int slot) {
    const int n0 = (t / walk.n_mt) * BN + warp * 16;
    const int m0 = (t % walk.n_mt) * BM;
    const float2* sc =
        reinterpret_cast<const float2*>(smem + C::s_at(slot)) + warp * 16;
    if (cs == 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + g + 8 * e;
        if (n >= N) continue;
        const float2 sn = sc[g + 8 * e];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = m0 + 8 * j + 2 * tig + c;
            if (m < M)
              y[(size_t)m * N + n] =
                  acc[j][0][2 * e + c] * sn.x + acc[j][1][2 * e + c] * sn.y;
          }
      }
      return;
    }
    // partials [2][E][NT]
    float* part = reinterpret_cast<float*>(smem + C::PART_OFF);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        part[(j * 4 + c) * NT + tid] = acc[j][0][c];
        part[(C::E + j * 4 + c) * NT + tid] = acc[j][1][c];
      }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // rank r folds outputs e = r, r + cs, ... over the ranks, in order;
    // every rank's pair is loaded before the adds, so the distributed
    // shared memory's latency is paid once, not cs times
    for (int e = rank; e < C::E; e += cs) {
      const int j = e / 4, c = e % 4;
      float lo_r[MAX_CLUSTER], hi_r[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) {
          const float* rp = cluster.map_shared_rank(part, r);
          lo_r[r] = rp[e * NT + tid];
          hi_r[r] = rp[(C::E + e) * NT + tid];
        }
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) {
          lo += lo_r[r];
          hi += hi_r[r];
        }
      const int n = n0 + g + 8 * (c >> 1);
      const int m = m0 + 8 * j + 2 * tig + (c & 1);
      if (n < N && m < M) {
        const float2 sn = sc[g + 8 * (c >> 1)];
        y[(size_t)m * N + n] = lo * sn.x + hi * sn.y;
      }
    }
    cluster.sync();  // no block overwrites its partials while one reads them
  };

  // three stages in flight while one is computed
  zero();
  start_ring(walk, STAGES - 1, sbase, &map_x, &map_p, &map_s, s_off);
  int slot = 0, cm_c = 0, cm_t = blockIdx.y;  // the stage computed next
  for (int step = 0; step < walk.steps; ++step) {
    // the stage's copies have landed (its barrier's phase: its use count)
    mbar_wait(sbase + C::BAR_OFF + 8 * slot, (step / STAGES) & 1);
    __syncthreads();  // every thread is done with step - 1's slot
    if (tid == 0 && step + STAGES - 1 < walk.steps)
      issue_stage(walk, step + STAGES - 1, true, true, sbase, &map_x, &map_p,
                  &map_s, s_off);
    compute(slot);
    if (++cm_c == walk.nch) {
      epilogue(cm_t, slot);
      zero();
      cm_c = 0;
      cm_t += gridDim.y;
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
}

// ---- the prefill tile: wgmma with register A ------------------------------

__global__ void __launch_bounds__(256, 1)
int4_mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_p,
                     const __grid_constant__ CUtensorMap map_s,
                     float* __restrict__ y, int M, int N, int half,
                     int s_off) {
  using C = WgTile;
  constexpr int BN = C::BN, BM = C::BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Walk<C> walk(M, N, half);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in the group
  const int g = lane >> 2, tig = lane & 3;
  // the byte pair of a word a thread takes, spread to bits 0-7 and 16-23
  const uint32_t pair_sel = (tig & 1) ? 0x4342 : 0x4140;

  float acc[2][64];        // [half][the m64 x n128 fragment]
  uint32_t abuf[4][2][4];  // A of each k16 step: [step][half]
  auto zero = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[h][c] = 0.f;
  };

  // acc += this warpgroup's 64 columns x 128 rows over the stage's 64
  // packed columns: per k16 step, one wgmma per half as one group; a step's
  // A buffer is rewritten only after the group that read it (4 groups
  // back) is done
  auto compute = [&](int slot) {
    const uint32_t ws = sbase + C::w_at(slot), xs = sbase + C::x_at(slot);
    // rows r and r + 8 (same swizzle)
    const int r = 64 * wg + 16 * wq + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_wait<3>();
      // the words holding bytes 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9
      // of piece ks
      const uint32_t a0 =
          ws + r * BKB + (C::w_piece(r, ks) << 4) + 4 * (tig >> 1);
      const uint32_t a1 = a0 + 8 * BKB;
      const uint32_t u[4] = {__byte_perm(ld_shared4(a0), 0u, pair_sel),
                             __byte_perm(ld_shared4(a1), 0u, pair_sel),
                             __byte_perm(ld_shared4(a0 + 8), 0u, pair_sel),
                             __byte_perm(ld_shared4(a1 + 8), 0u, pair_sel)};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) abuf[ks][h][e] = nibbles_bf16x2(u[e], h);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n128k16(acc[h], abuf[ks][h],
                         desc_sw128(xs + h * BM * 128 + 32 * ks));
      wgmma_commit();
    }
  };

  // y for tile t, whose last stage sits in ring slot `slot`.  Output (j, c)
  // of a thread is column 64 wg + 16 wq + g + 8 (c >> 1) of the tile, row
  // 8 j + 2 tig + (c & 1).
  auto epilogue = [&](int t, int slot) {
    wgmma_wait<0>();
    const int n0 = (t / walk.n_mt) * BN + 64 * wg + 16 * wq;
    const int m0 = (t % walk.n_mt) * BM;
    const float2* sc = reinterpret_cast<const float2*>(smem + C::s_at(slot)) +
                       64 * wg + 16 * wq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + g + 8 * e;
      if (n >= N) continue;
      const float2 sn = sc[g + 8 * e];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + 8 * j + 2 * tig + c;
          if (m < M)
            y[(size_t)m * N + n] = acc[0][4 * j + 2 * e + c] * sn.x +
                                   acc[1][4 * j + 2 * e + c] * sn.y;
        }
    }
  };

  // two stages in flight while one is computed; the fourth is the stage
  // before, whose wgmma groups may still read it
  zero();
  start_ring(walk, STAGES - 2, sbase, &map_x, &map_p, &map_s, s_off);
  int slot = 0, cm_c = 0, cm_t = blockIdx.y;
  for (int step = 0; step < walk.steps; ++step) {
    // the stage's copies have landed (its barrier's phase: its use count)
    mbar_wait(sbase + C::BAR_OFF + 8 * slot, (step / STAGES) & 1);
    // every warpgroup has waited for the groups of step - 2, whose slot
    // is filled next
    __syncthreads();
    if (tid == 0 && step + STAGES - 2 < walk.steps)
      issue_stage(walk, step + STAGES - 2, true, true, sbase, &map_x, &map_p,
                  &map_s, s_off);
    compute(slot);
    if (++cm_c == walk.nch) {
      epilogue(cm_t, slot);
      zero();
      cm_c = 0;
      cm_t += gridDim.y;
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  wgmma_wait<0>();
}

// ---- launches ---------------------------------------------------------------

// the tile's three tensor maps (see issue_stage): x, layer li's packed
// weights, and the scales of layers 0 .. li
template <class C>
bool encode_maps(CUtensorMap (&m)[3], const void* x, const uint8_t* p_all,
                 const float* s_all, int M, int N, int half, int li) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t dx[3] = {(cuuint64_t)half, 2, (cuuint64_t)M};
  const cuuint64_t sx[2] = {2 * (cuuint64_t)half, 4 * (cuuint64_t)half};
  const cuuint32_t bx[3] = {BKB, 1, C::BM};
  const cuuint64_t dp[2] = {(cuuint64_t)half, (cuuint64_t)N};
  const cuuint64_t sp[1] = {(cuuint64_t)half};
  const cuuint32_t bp[2] = {BKB, C::BN};
  const cuuint64_t ds[1] = {((cuuint64_t)li + 1) * N * 2};
  const cuuint64_t ss[1] = {16};  // unused at rank 1
  const cuuint32_t bs[1] = {2 * C::BN};
  return encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dx, sx, bx, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<uint8_t*>(p_all + (size_t)li * N * half), dp, sp,
                bp, one, CU_TENSOR_MAP_INTERLEAVE_NONE, C::W_SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(s_all), ds, ss, bs, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cs blocks per cluster (the K split), `clusters` clusters; the launch may
// start before the stream's previous kernel ends (see start_ring)
template <class C, class K>
int launch(K kernel, unsigned& configured, const void* x, const uint8_t* p,
           const float* s, void* y, int M, int N, int half, int li, int cs,
           int clusters, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode_maps<C>(maps, x, p, s, M, N, half, li))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in<C>(kernel, configured);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters<C>(kernel, cs, clusters, stream, maps[0], maps[1],
                            maps[2], static_cast<float*>(y), M, N, half,
                            li * N * 2);
}

unsigned configured_mma2 = 0, configured_mma4 = 0, configured_wg = 0;

}  // namespace

// x bf16 [M, 2*half]; p_all int8 [L, N, half]; s_all f32 [L, N, 2]; y f32
// [M, N]; all contiguous and 16-byte aligned, half % 16 == 0.  The plan
// (ops/quant_mm.py int4_mm_plan): nj = 2 or 4 takes the decode tile of
// 8 nj rows with a K split of cs in 1 .. 8 blocks per cluster (at most one
// 64-byte chunk per split); nj = 16 the 128-row prefill tile, cs = 1;
// `clusters` clusters walk the tiles.  Returns a cudaError_t code.
extern "C" int vt_int4_mm(const void* x, const void* p_all, const void* s_all,
                          void* y, int M, int N, int half, int li, int nj,
                          int cs, int clusters, void* stream) {
  if (M <= 0 || N <= 0 || half <= 0 || half % 16 != 0 || li < 0 || cs < 1 ||
      cs > MAX_CLUSTER || cs > (half + BKB - 1) / BKB || clusters < 1 ||
      (nj == 16 && cs > 1))
    return (int)cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(p_all);
  const float* s = static_cast<const float*>(s_all);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nj) {
    case 2:
      return launch<MmaTile<2>>(int4_mm_kernel<2>, configured_mma2, x, p, s,
                                y, M, N, half, li, cs, clusters, st);
    case 4:
      return launch<MmaTile<4>>(int4_mm_kernel<4>, configured_mma4, x, p, s,
                                y, M, N, half, li, cs, clusters, st);
    case 16:
      return launch<WgTile>(int4_mm_wgmma_kernel, configured_wg, x, p, s, y,
                            M, N, half, li, 1, clusters, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the nj tile (with a K split of cs) resident on one SM of the
// current device, or -cudaError_t: what the plan's residency table assumes.
extern "C" int vt_int4_mm_occupancy(int nj, int cs) {
  switch (nj) {
    case 2:
      return occupancy<MmaTile<2>>(int4_mm_kernel<2>, configured_mma2, cs);
    case 4:
      return occupancy<MmaTile<4>>(int4_mm_kernel<4>, configured_mma4, cs);
    case 16:
      return occupancy<WgTile>(int4_mm_wgmma_kernel, configured_wg, 1);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}
