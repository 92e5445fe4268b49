// int8 weight-only matmul (W8A16): the weights stay int8 in device memory.
//
// The counterpart of a fusion, not of a Pallas kernel: the JAX package's
// int8 product (voxtral_tpu/models/quant.py:mm, and the int8 table of
// voxtral_tpu/models/decoder.py:final_logits) is
//     einsum(x, w.astype(bf16), preferred_element_type=f32) * s
// which XLA fuses, so the int8 -> bf16 convert runs in the product's
// operand stream and only int8 bytes leave device memory.  Same function:
//     y[m, n] = s[n] * sum_k x[m, k] * w[n, k]
// x is bf16 [M, K], w is layer li of an int8 [L, N, K] stack, s is f32
// [L, N], y is f32 [M, N].  Products are exact (an int8 weight in
// [-127, 127] is exact in bf16); the sums are f32, the scale comes after.
//
// What bounds it on the H100: at decode (M = streams, 1..80) device-memory
// bytes of the weights, one byte a weight; at batched prefill (M = 38 x
// streams) tensor-core math.  The design is int4_mm.cu's (its header says
// more), with one weight a byte instead of two:
//   * Widen in registers.  prmt spreads two bytes u to the halves of a
//     word; (u & 0x7F) | 0x4300 read as bf16 is 128 + (u & 127), and
//     (u & 0x80) | 0x4300 is 128 or 256; their bf16x2 difference is the
//     two's-complement value of u, exactly: four operations for two
//     weights (prmt, two lop3, one subtract).  Nothing widened is written
//     to memory.
//   * A ring of shared-memory stages (4; 3 for the 64-row tile) of 128
//     columns of K, filled by TMA from one thread: x as two 64-column boxes in TMA's 128-byte swizzle
//     (16-byte piece q of row r at q ^ (r & 7)), the weights as two
//     64-byte boxes, and with a tile's last stage its f32 scales.  Boxes
//     past the tensors' edges fill with zeros; y is masked to [M, N], so
//     the caller pads nothing.
//   * Programmatic dependent launch: the first stages' weights are issued
//     before the previous kernel on the stream ends; x is read and y
//     written only after it (griddepcontrol).
//   * Decode tile (int8_mm_kernel, 16, 32 or 64 rows of x): mma.sync
//     m16n8k16, four warps of 16 output columns; 64 rows read a weight
//     byte once for up to 64 streams (a ring of 3 stages, so that two
//     blocks fit an SM with a K split's partials, three without).  Per box, a thread's 16 bytes of a
//     weight row (one 16-byte load, plain 64-byte rows: conflict-free) feed
//     4 k16 steps: fragment columns (2t, 2t+1, 2t+8, 2t+9) of quad thread t
//     map to bytes 16t + 4s + (0..3), which lines a weight word up with an
//     x word (any bijection of k is the same sum).  The K range is split
//     over the CS blocks of a thread-block cluster, whose partial sums fold
//     through distributed shared memory in rank order: one launch, no
//     workspace, the same bits on every call.
//   * Prefill tile (int8_mm_wgmma_kernel, 128 rows of x, 128 columns): two
//     warpgroups of 64 columns run wgmma m64n128k16 with the widened
//     weights as the register A operand and x read from shared memory by
//     descriptor, asynchronously (A in four register buffers, at most three
//     groups in flight).  The fragment keeps k in order: thread t takes
//     bytes 2t, 2t+1 and 2t+8, 2t+9 of each 16-byte piece with two 4-byte
//     loads from rows in TMA's 64-byte swizzle (piece q of row r at
//     q ^ ((r >> 1) & 3)), conflict-free.
//   * One launch per call, persistent: the caller's plan (ops/quant_mm.py
//     int8_mm_plan, a function of the shapes alone) gives the tile, the K
//     split and the number of clusters, never more blocks than fit the card
//     at once; a cluster walks the tiles clusters apart.

#include <cooperative_groups.h>

#include "quant_mm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;          // columns of K per chunk (a ring stage)
constexpr int BOX = 64;          // columns of one TMA box: two per stage
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// A ring of ST stages.  A stage: x's two boxes [2][BM][64] bf16 (each on a
// 1024-byte boundary for the 128-byte swizzle), the weights' two boxes
// [2][BN][64] bytes, the tile's scales [BN] f32; each kind in its own
// array, then a barrier per stage and, for a K split, the partial sums.
// ops/quant_mm.py _TILES8 mirrors the tiles.
template <int BN, int BM, int ST>
struct Ring {
  static constexpr int STAGES = ST;
  static constexpr int X_BOX = BM * 2 * BOX, X_BYTES = 2 * X_BOX;
  static constexpr int W_BOX = BN * BOX, W_BYTES = 2 * W_BOX;
  static constexpr int S_BYTES = BN * 4;
  static constexpr int BAR_OFF = STAGES * (X_BYTES + W_BYTES + S_BYTES);
  static_assert(X_BOX % 1024 == 0, "x boxes must stay 1024-byte aligned");
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
// The decode tile: NJ n8 tiles of x rows (16, 32 or 64), four warps of 16
// output columns; the 64-row tile on 3 stages.
template <int NJ_>
struct MmaTile : Ring<64, 8 * NJ_, NJ_ == 8 ? 3 : 4> {
  static constexpr int NJ = NJ_, NT = 128, BN = 64, BM = 8 * NJ;
  static constexpr int PART_OFF = MmaTile::BAR_OFF + 128;
  static constexpr int E = NJ * 4;  // outputs per thread
  // blocks an SM must hold by registers (caps them at 128 and 168); shared
  // memory holds no more (the 64-row tile: 2 with a K split)
  static constexpr int MIN_BLOCKS = NJ == 2 ? 4 : 3;
  // the ring from a 1024-byte boundary (1 KB more), barriers, partials
  static constexpr int MAX_SMEM = 1024 + PART_OFF + E * NT * 4;
  static constexpr int smem(int cs) {
    return cs > 1 ? MAX_SMEM : 1024 + PART_OFF;
  }
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_NONE;
};
// The prefill tile: 128 output columns (a warpgroup's m64 tile each) x 128
// rows of x (the wgmma's n).
struct WgTile : Ring<128, 128, 4> {
  static constexpr int NT = 256, BN = 128, BM = 128;
  static constexpr int MAX_SMEM = 1024 + BAR_OFF + 128;
  static constexpr int smem(int) { return MAX_SMEM; }
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;
  __device__ static int w_piece(int r, int q) { return q ^ ((r >> 1) & 3); }
};

// Two bf16 weights from a word holding int8 bytes u at bits 0-7 and 16-23,
// the lower byte's in the lower half: (128 + (u & 127)) - (128 + (u & 128)).
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t t) {
  const uint32_t lo = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
              *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---- the walk over tiles and K chunks, and the ring ------------------------

// A block's share: the tiles blockIdx.y, + gridDim.y, ..., each over the K
// chunks [c_lo, c_lo + nch) of its rank (blockIdx.x of gridDim.x = cs).
template <class C>
struct Walk {
  int n_mt, c_lo, nch, steps;
  __device__ Walk(int M, int N, int K) {
    n_mt = (M + C::BM - 1) / C::BM;
    const int n_tiles = ((N + C::BN - 1) / C::BN) * n_mt;
    const int chunks = K / BK;
    const int cs = gridDim.x, rank = blockIdx.x;
    c_lo = (int)((long long)rank * chunks / cs);
    nch = (int)((long long)(rank + 1) * chunks / cs) - c_lo;
    const int tiles = (int)blockIdx.y < n_tiles
                          ? (n_tiles - 1 - blockIdx.y) / gridDim.y + 1
                          : 0;
    steps = tiles * nch;
  }
};

// Stage k of the block's walk into ring slot k % C::STAGES, by TMA onto the
// slot's barrier (one thread): its weights (two boxes, and with the tile's
// last chunk its scales; the barrier expects the whole stage's bytes), its
// x, or both.  x is [M][K] bf16 (boxes 64 columns x BM rows), the weight
// layer [N][K] bytes (boxes 64 x BN), the scales the stack's f32
// [(li + 1) N] from layer li's offset s_off (box BN; past column N it reads
// the next layer's, which no output uses).
template <class C>
__device__ __forceinline__ void issue_stage(
    const Walk<C>& w, int k, bool weights, bool acts, uint32_t sbase,
    const CUtensorMap* mx, const CUtensorMap* mw, const CUtensorMap* ms,
    int s_off) {
  const int slot = k % C::STAGES, c = k % w.nch;
  const int t = blockIdx.y + (k / w.nch) * gridDim.y;
  const int n0 = (t / w.n_mt) * C::BN, m0 = (t % w.n_mt) * C::BM;
  const int k0 = (w.c_lo + c) * BK;
  const bool last = c == w.nch - 1;
  const uint32_t bar = sbase + C::BAR_OFF + 8 * slot;
  if (weights) {
    mbar_expect(bar, C::X_BYTES + C::W_BYTES + (last ? C::S_BYTES : 0));
    tma_2d(sbase + C::w_at(slot), mw, k0, n0, bar);
    tma_2d(sbase + C::w_at(slot) + C::W_BOX, mw, k0 + BOX, n0, bar);
    if (last) tma_1d(sbase + C::s_at(slot), ms, s_off + n0, bar);
  }
  if (acts) {
    tma_2d(sbase + C::x_at(slot), mx, k0, m0, bar);
    tma_2d(sbase + C::x_at(slot) + C::X_BOX, mx, k0 + BOX, m0, bar);
  }
}

// The ring's start: the tensor maps prefetched and the barriers
// initialised, then the first `ahead` stages issued -- their weights before
// the grids this one depends on are done (weights are no kernel's output),
// their x, and so every later read of x and write of y, after; then
// dependents may launch.
template <class C>
__device__ __forceinline__ void start_ring(
    const Walk<C>& w, int ahead, uint32_t sbase, const CUtensorMap* mx,
    const CUtensorMap* mw, const CUtensorMap* ms, int s_off) {
  if (threadIdx.x == 0) {
    prefetch_map(mx);
    prefetch_map(mw);
    prefetch_map(ms);
    for (int i = 0; i < C::STAGES; ++i)
      mbar_init(sbase + C::BAR_OFF + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < ahead && k < w.steps; ++k)
      issue_stage(w, k, true, false, sbase, mx, mw, ms, s_off);
  griddep_wait();
  if (threadIdx.x == 0)
    for (int k = 0; k < ahead && k < w.steps; ++k)
      issue_stage(w, k, false, true, sbase, mx, mw, ms, s_off);
  griddep_launch();
}

// ---- the decode tile: mma.sync, K split over a cluster --------------------

template <int NJ>
__global__ void __launch_bounds__(128, MmaTile<NJ>::MIN_BLOCKS)
int8_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_s,
               float* __restrict__ y, int M, int N, int K, int s_off) {
  using C = MmaTile<NJ>;
  constexpr int NT = C::NT, BN = C::BN, BM = C::BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Walk<C> walk(M, N, K);
  const int cs = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  float acc[NJ][4];
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  };

  // acc += this warp's 16 columns x BM rows over the 128 columns of ring
  // slot `slot`: 4 k16 steps per box
  auto compute = [&](int slot) {
    const uint32_t ws = sbase + C::w_at(slot), xs = sbase + C::x_at(slot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 wa[2];  // bytes 16 tig .. 16 tig + 15 of box h's rows g, g + 8
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wa[e] = ld_shared16(ws + h * C::W_BOX +
                            (warp * 16 + 8 * e + g) * BOX + 16 * tig);
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
        // x row 8j + g, columns 16 tig + 8 sp .. + 7 of box h: the B
        // fragments of k16 steps 2 sp and 2 sp + 1
        uint4 xb[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          xb[j] = ld_shared16(xs + h * C::X_BOX + (8 * j + g) * 128 +
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
          const uint32_t a[4] = {bytes_bf16x2(__byte_perm(w0, 0u, 0x4140)),
                                 bytes_bf16x2(__byte_perm(w1, 0u, 0x4140)),
                                 bytes_bf16x2(__byte_perm(w0, 0u, 0x4342)),
                                 bytes_bf16x2(__byte_perm(w1, 0u, 0x4342))};
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma16816(acc[j], a, ss ? xb[j].z : xb[j].x,
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
    const float* sc =
        reinterpret_cast<const float*>(smem + C::s_at(slot)) + warp * 16;
    if (cs == 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + g + 8 * e;
        if (n >= N) continue;
        const float sn = sc[g + 8 * e];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = m0 + 8 * j + 2 * tig + c;
            if (m < M) y[(size_t)m * N + n] = acc[j][2 * e + c] * sn;
          }
      }
      return;
    }
    // partials [E][NT]
    float* part = reinterpret_cast<float*>(smem + C::PART_OFF);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[(j * 4 + c) * NT + tid] = acc[j][c];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // rank r folds outputs e = r, r + cs, ... over the ranks, in order;
    // every rank's partial is loaded before the adds, so the distributed
    // shared memory's latency is paid once, not cs times
    for (int e = rank; e < C::E; e += cs) {
      const int j = e / 4, c = e % 4;
      float v_r[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) v_r[r] = cluster.map_shared_rank(part, r)[e * NT + tid];
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) v += v_r[r];
      const int n = n0 + g + 8 * (c >> 1);
      const int m = m0 + 8 * j + 2 * tig + (c & 1);
      if (n < N && m < M) y[(size_t)m * N + n] = v * sc[g + 8 * (c >> 1)];
    }
    cluster.sync();  // no block overwrites its partials while one reads them
  };

  // every other stage in flight while one is computed
  constexpr int ST = C::STAGES;
  zero();
  start_ring(walk, ST - 1, sbase, &map_x, &map_w, &map_s, s_off);
  int slot = 0, cm_c = 0, cm_t = blockIdx.y;  // the stage computed next
  for (int step = 0; step < walk.steps; ++step) {
    // the stage's copies have landed (its barrier's phase: its use count)
    mbar_wait(sbase + C::BAR_OFF + 8 * slot, (step / ST) & 1);
    __syncthreads();  // every thread is done with step - 1's slot
    if (tid == 0 && step + ST - 1 < walk.steps)
      issue_stage(walk, step + ST - 1, true, true, sbase, &map_x, &map_w,
                  &map_s, s_off);
    compute(slot);
    if (++cm_c == walk.nch) {
      epilogue(cm_t, slot);
      zero();
      cm_c = 0;
      cm_t += gridDim.y;
    }
    slot = slot == ST - 1 ? 0 : slot + 1;
  }
}

// ---- the prefill tile: wgmma with register A ------------------------------

__global__ void __launch_bounds__(256, 1)
int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_s,
                     float* __restrict__ y, int M, int N, int K, int s_off) {
  using C = WgTile;
  constexpr int BN = C::BN, BM = C::BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Walk<C> walk(M, N, K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in the group
  const int g = lane >> 2, tig = lane & 3;
  // the byte pair of a word a thread takes, spread to bits 0-7 and 16-23
  const uint32_t pair_sel = (tig & 1) ? 0x4342 : 0x4140;

  float acc[64];           // the m64 x n128 fragment
  uint32_t abuf[4][2][4];  // A of each k16 step of both boxes: [step][box]
  auto zero = [&]() {
#pragma unroll
    for (int c = 0; c < 64; ++c) acc[c] = 0.f;
  };

  // acc += this warpgroup's 64 columns x 128 rows over the stage's 128
  // columns: per k16 step ks, one wgmma per box (columns 16 ks .. and
  // 64 + 16 ks ..) as one group; a step's A buffer is rewritten only after
  // the group that read it (4 groups back) is done
  auto compute = [&](int slot) {
    const uint32_t ws = sbase + C::w_at(slot), xs = sbase + C::x_at(slot);
    // rows r and r + 8 (same swizzle)
    const int r = 64 * wg + 16 * wq + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_wait<3>();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the words holding bytes 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9
        // of piece ks of box h
        const uint32_t a0 = ws + h * C::W_BOX + r * BOX +
                            (C::w_piece(r, ks) << 4) + 4 * (tig >> 1);
        const uint32_t a1 = a0 + 8 * BOX;
        const uint32_t u[4] = {ld_shared4(a0), ld_shared4(a1),
                               ld_shared4(a0 + 8), ld_shared4(a1 + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          abuf[ks][h][e] = bytes_bf16x2(__byte_perm(u[e], 0u, pair_sel));
      }
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n128k16(acc, abuf[ks][h],
                         desc_sw128(xs + h * C::X_BOX + 32 * ks));
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
    const float* sc = reinterpret_cast<const float*>(smem + C::s_at(slot)) +
                      64 * wg + 16 * wq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + g + 8 * e;
      if (n >= N) continue;
      const float sn = sc[g + 8 * e];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + 8 * j + 2 * tig + c;
          if (m < M) y[(size_t)m * N + n] = acc[4 * j + 2 * e + c] * sn;
        }
    }
  };

  // two stages in flight while one is computed; the fourth is the stage
  // before, whose wgmma groups may still read it
  constexpr int ST = C::STAGES;
  zero();
  start_ring(walk, ST - 2, sbase, &map_x, &map_w, &map_s, s_off);
  int slot = 0, cm_c = 0, cm_t = blockIdx.y;
  for (int step = 0; step < walk.steps; ++step) {
    // the stage's copies have landed (its barrier's phase: its use count)
    mbar_wait(sbase + C::BAR_OFF + 8 * slot, (step / ST) & 1);
    // every warpgroup has waited for the groups of step - 2, whose slot
    // is filled next
    __syncthreads();
    if (tid == 0 && step + ST - 2 < walk.steps)
      issue_stage(walk, step + ST - 2, true, true, sbase, &map_x, &map_w,
                  &map_s, s_off);
    compute(slot);
    if (++cm_c == walk.nch) {
      epilogue(cm_t, slot);
      zero();
      cm_c = 0;
      cm_t += gridDim.y;
    }
    slot = slot == ST - 1 ? 0 : slot + 1;
  }
  wgmma_wait<0>();
}

// ---- launches ---------------------------------------------------------------

// the tile's three tensor maps (see issue_stage): x, layer li's weights, and
// the scales of layers 0 .. li
template <class C>
bool encode_maps(CUtensorMap (&m)[3], const void* x, const uint8_t* w_all,
                 const float* s_all, int M, int N, int K, int li) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sx[1] = {2 * (cuuint64_t)K};
  const cuuint32_t bx[2] = {BOX, C::BM};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t sw[1] = {(cuuint64_t)K};
  const cuuint32_t bw[2] = {BOX, C::BN};
  const cuuint64_t ds[1] = {((cuuint64_t)li + 1) * N};
  const cuuint64_t ss[1] = {16};  // unused at rank 1
  const cuuint32_t bs[1] = {C::BN};
  return encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dx, sx, bx, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<uint8_t*>(w_all + (size_t)li * N * K), dw, sw, bw,
                one, CU_TENSOR_MAP_INTERLEAVE_NONE, C::W_SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(s_all), ds, ss, bs, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C, class Kern>
int launch(Kern kernel, unsigned& configured, const void* x, const uint8_t* w,
           const float* s, void* y, int M, int N, int K, int li, int cs,
           int clusters, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode_maps<C>(maps, x, w, s, M, N, K, li))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in<C>(kernel, configured);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters<C>(kernel, cs, clusters, stream, maps[0], maps[1],
                            maps[2], static_cast<float*>(y), M, N, K, li * N);
}

unsigned configured_mma2 = 0, configured_mma4 = 0, configured_mma8 = 0,
         configured_wg = 0;

}  // namespace

// x bf16 [M, K]; w_all int8 [L, N, K]; s_all f32 [L, N]; y f32 [M, N]; all
// contiguous and 16-byte aligned, K % 128 == 0.  The plan (ops/quant_mm.py
// int8_mm_plan): nj = 2, 4 or 8 takes the decode tile of 8 nj rows with a K
// split of cs in 1 .. 8 blocks per cluster (at least one 128-column chunk
// each); nj = 16 the 128-row prefill tile, cs = 1; `clusters` clusters walk
// the tiles.  Returns a cudaError_t code.
extern "C" int vt_int8_mm(const void* x, const void* w_all, const void* s_all,
                          void* y, int M, int N, int K, int li, int nj,
                          int cs, int clusters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || li < 0 || cs < 1 ||
      cs > MAX_CLUSTER || cs > K / BK || clusters < 1 ||
      (nj == 16 && cs > 1))
    return (int)cudaErrorInvalidValue;
  const uint8_t* w = static_cast<const uint8_t*>(w_all);
  const float* s = static_cast<const float*>(s_all);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nj) {
    case 2:
      return launch<MmaTile<2>>(int8_mm_kernel<2>, configured_mma2, x, w, s,
                                y, M, N, K, li, cs, clusters, st);
    case 4:
      return launch<MmaTile<4>>(int8_mm_kernel<4>, configured_mma4, x, w, s,
                                y, M, N, K, li, cs, clusters, st);
    case 8:
      return launch<MmaTile<8>>(int8_mm_kernel<8>, configured_mma8, x, w, s,
                                y, M, N, K, li, cs, clusters, st);
    case 16:
      return launch<WgTile>(int8_mm_wgmma_kernel, configured_wg, x, w, s, y,
                            M, N, K, li, 1, clusters, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the nj tile (with a K split of cs) resident on one SM of the
// current device, or -cudaError_t: what the plan's residency table assumes.
extern "C" int vt_int8_mm_occupancy(int nj, int cs) {
  switch (nj) {
    case 2:
      return occupancy<MmaTile<2>>(int8_mm_kernel<2>, configured_mma2, cs);
    case 4:
      return occupancy<MmaTile<4>>(int8_mm_kernel<4>, configured_mma4, cs);
    case 8:
      return occupancy<MmaTile<8>>(int8_mm_kernel<8>, configured_mma8, cs);
    case 16:
      return occupancy<WgTile>(int8_mm_wgmma_kernel, configured_wg, 1);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}
