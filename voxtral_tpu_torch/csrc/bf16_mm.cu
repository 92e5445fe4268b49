// Row-invariant bf16 product: y[m, n] = sum_k x[m, k] w[n, k], f32 out.
//
// The counterpart of an XLA product, not of a Pallas kernel: the JAX
// package's float products (voxtral_tpu/models/quant.py:mm,
// einsum(preferred_element_type=f32)) and its conv stem's im2col products.
// The port computes them with cuBLAS elsewhere (models/quant.py
// matmul_f32); on the streaming encoder side it takes this kernel instead,
// because cuBLAS picks its algorithm and its K split by the row count M, so
// the same row rounds differently when the feed is chunked differently.
// Here a row's bits depend on that row and the weights alone:
//   * One tile family at every M: wgmma m64n64k16 (64 output columns of a
//     warpgroup x 64 rows of x), both operands read from shared memory.
//     Rows past M are zeros from TMA's out-of-bounds fill and are never
//     stored; a row never meets another row in a sum.
//   * K is walked in chunks of 64 columns in order, split into SPLIT
//     contiguous ranges, SPLIT chosen from (N, K) by the caller
//     (ops/bf16_mm.py bf16_mm_plan), never from M.  Each range is summed
//     from zero, and the ranges' sums are added in range order, from zero:
//     the same operations on every path below.
//   * Two ways to run that split, which give the same bits: a cluster of
//     SPLIT blocks, one range each, whose sums fold through distributed
//     shared memory (few tiles: the split keeps the card's loads in flight
//     at a streaming chunk's few rows); or single blocks that walk the
//     ranges in turn and fold them in registers (enough tiles to fill the
//     card: no fold traffic, no cluster barriers, a deeper ring).  The
//     caller picks one from the tile count; neither changes a row's bits.
//   * The launch is persistent: the blocks (or clusters) walk the tiles a
//     grid apart.  Which block takes a tile changes nothing in it.
// x is bf16 [M, K], y f32 [M, N].  w is bf16 [N, K], the weight as the JAX
// package stores it, or, WT, [K, N], the conv stem's im2col weight as it is
// stored: TMA then loads boxes of 64 output columns x 64 rows of K, and the
// wgmma reads them as its A operand transposed (MN-major), so no transposed
// copy of the weight is kept.  Both layouts give the same bits.
//
// What bounds it on the H100: at a streaming chunk's few rows the weights'
// bytes (2 a weight: a layer's four products are 60 MB); at hundreds of
// rows the tensor cores.  The design: a ring of stages of 64 columns of K
// (x's box of 64 rows and the weights' box of 128 rows, both in TMA's
// 128-byte swizzle, read by the wgmma descriptors as they land), filled by
// TMA from one thread two stages ahead, so that every block keeps 48 KB of
// loads in flight and two blocks share an SM (3 stages beside a cluster's
// partial sums; 4 for the single blocks, whose one extra stage lets a
// stage's wgmma group run on while the next is issued); programmatic
// dependent launch issues the first stages' weights before the previous
// kernel ends.

#include <cooperative_groups.h>

#include "quant_mm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;           // columns of K per chunk (a ring stage)
constexpr int BN = 128;          // output columns of a tile: two m64 halves
constexpr int BM = 64;           // rows of x of a tile: the wgmma's n
constexpr int THREADS = 256;     // two warpgroups
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int E = BM * 64 / 128; // accumulators a thread holds (32)

// A ring of ST stages.  A stage: x's box [BM][64] bf16 and the weights' box
// [BN][64] bf16, each on a 1024-byte boundary for the 128-byte swizzle;
// each kind in its own array, then a barrier per stage and, for a
// cluster's split, the partial sums.  SEQ: the single blocks' ring.
// ops/bf16_mm.py mirrors these sizes.
template <bool SEQ>
struct Tile {
  static constexpr int NT = THREADS;
  static constexpr int ST = SEQ ? 4 : 3;
  static constexpr int X_BYTES = BM * BK * 2, W_BYTES = BN * BK * 2;
  static constexpr int BAR_OFF = ST * (X_BYTES + W_BYTES);
  static constexpr int PART_OFF = BAR_OFF + 128;
  static constexpr int MAX_SMEM = 1024 + PART_OFF + (SEQ ? 0 : E * NT * 4);
  static constexpr int smem(int cs) {
    return cs > 1 ? MAX_SMEM : 1024 + PART_OFF;
  }
  __host__ __device__ static constexpr int x_at(int slot) {
    return slot * X_BYTES;
  }
  __host__ __device__ static constexpr int w_at(int slot) {
    return ST * X_BYTES + slot * W_BYTES;
  }
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "boxes must stay 1024-byte aligned");
};

// d += a b over m64 n64 k16, both operands bf16 in shared memory by
// descriptor: a, 64 rows of the weights (K-major, or MN-major when TA);
// b, 64 rows of x, K-major; d, the warp's 16 x 64 slice, 32 floats a thread
template <int TA>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// A block's share: the tiles blockIdx.y, + gridDim.y, ..., each over the K
// chunks [c_lo, c_lo + nch) of its rank (blockIdx.x of gridDim.x: the
// cluster's split; the whole K for a single block).  Tile t covers output
// columns (t / n_mt) BN and rows (t % n_mt) BM.
struct Walk {
  int n_mt, c_lo, nch, steps;
  __device__ Walk(int M, int N, int K) {
    n_mt = (M + BM - 1) / BM;
    const int n_tiles = ((N + BN - 1) / BN) * n_mt;
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

// Stage k of the block's walk into ring slot k % ST, by TMA onto the slot's
// barrier (one thread): its weights (the barrier expects the whole stage's
// bytes; WT: a box for each warpgroup's 64 output columns), its x, or both.
template <class C, bool WT>
__device__ __forceinline__ void issue_stage(const Walk& w, int k, bool weights,
                                            bool acts, uint32_t sbase,
                                            const CUtensorMap* mx,
                                            const CUtensorMap* mw) {
  const int slot = k % C::ST, c = k % w.nch;
  const int t = blockIdx.y + (k / w.nch) * gridDim.y;
  const int n0 = (t / w.n_mt) * BN, m0 = (t % w.n_mt) * BM;
  const int k0 = (w.c_lo + c) * BK;
  const uint32_t bar = sbase + C::BAR_OFF + 8 * slot;
  if (weights) {
    mbar_expect(bar, C::X_BYTES + C::W_BYTES);
    if (WT) {
      tma_2d(sbase + C::w_at(slot), mw, n0, k0, bar);
      tma_2d(sbase + C::w_at(slot) + C::W_BYTES / 2, mw, n0 + BN / 2, k0,
             bar);
    } else {
      tma_2d(sbase + C::w_at(slot), mw, k0, n0, bar);
    }
  }
  if (acts) tma_2d(sbase + C::x_at(slot), mx, k0, m0, bar);
}

// SEQ false: a cluster of gridDim.x = split blocks, one K range each.  SEQ
// true: single blocks, each folding the `split` ranges of the whole K.  WT:
// the weights stored [K, N].
template <bool SEQ, bool WT>
__global__ void __launch_bounds__(THREADS, 2)
bf16_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               float* __restrict__ y, int M, int N, int K, int split) {
  using C = Tile<SEQ>;
  constexpr int ST = C::ST;
  // stages issued ahead of the one computed: the single blocks keep one
  // stage back for the wgmma group still in flight
  constexpr int AHEAD = SEQ ? ST - 2 : ST - 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Walk walk(M, N, K);
  const int cs = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in the group
  const int g = lane >> 2, tig = lane & 3;

  float acc[E];   // the warpgroup's m64 x n64 fragment: one range's sums
  float fold[E];  // SEQ: the sum of the ranges done so far
  auto zero = [&](float (&a)[E]) {
#pragma unroll
    for (int c = 0; c < E; ++c) a[c] = 0.f;
  };

  // acc += this warpgroup's 64 output columns x 64 rows over the stage's 64
  // columns of K: 4 k16 steps in order, one group; the single blocks leave
  // it in flight (the previous group is done), a cluster waits for it.  A
  // k16 step starts 32 bytes on in a K-major box's 128-byte rows, 16 rows
  // (two 1024-byte swizzle atoms) on in a WT box.
  auto compute = [&](int slot) {
    const uint32_t ws = sbase + C::w_at(slot) + wg * 64 * BK * 2;
    const uint32_t xs = sbase + C::x_at(slot);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_ss<WT ? 1 : 0>(
          acc, desc_sw128(ws + (WT ? 16 * 128 : 32) * ks),
          desc_sw128(xs + 32 * ks));
    wgmma_commit();
    if (SEQ)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
  };

  // Accumulator 4 j + 2 e + c of a thread is output column
  // 64 wg + 16 wq + g + 8 e of tile t, row 8 j + 2 tig + c.
  auto store = [&](int t, int i, float v) {
    const int j = i >> 2, e = (i >> 1) & 1, c = i & 1;
    const int n = (t / walk.n_mt) * BN + 64 * wg + 16 * wq + g + 8 * e;
    const int m = (t % walk.n_mt) * BM + 8 * j + 2 * tig + c;
    if (n < N && m < M) y[(size_t)m * N + n] = v;
  };
  // y for tile t of a cluster: the sums, folded over the cluster's ranges
  // in rank order when the K range is split
  auto epilogue = [&](int t) {
    if (cs == 1) {
#pragma unroll
      for (int i = 0; i < E; ++i) store(t, i, acc[i]);
      return;
    }
    // partials [E][NT]
    float* part = reinterpret_cast<float*>(smem + C::PART_OFF);
#pragma unroll
    for (int i = 0; i < E; ++i) part[i * THREADS + tid] = acc[i];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // rank r folds accumulators i = r, r + cs, ... over the ranks, in
    // order, from zero; every rank's partial is loaded before the adds
    for (int i = rank; i < E; i += cs) {
      float v_r[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) v_r[r] = cluster.map_shared_rank(part, r)[i * THREADS + tid];
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) v += v_r[r];
      store(t, i, v);
    }
    cluster.sync();  // no block overwrites its partials while one reads them
  };

  // the ring's start: the maps prefetched, the barriers initialised, the
  // first stages' weights issued before the grids this one depends on are
  // done (weights are no kernel's output), their x after; then dependents
  // may launch
  if (tid == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    for (int i = 0; i < ST; ++i) mbar_init(sbase + C::BAR_OFF + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < AHEAD && k < walk.steps; ++k)
      issue_stage<C, WT>(walk, k, true, false, sbase, &map_x, &map_w);
  griddep_wait();
  if (tid == 0)
    for (int k = 0; k < AHEAD && k < walk.steps; ++k)
      issue_stage<C, WT>(walk, k, false, true, sbase, &map_x, &map_w);
  griddep_launch();

  zero(acc);
  zero(fold);
  int slot = 0, cm_c = 0, cm_t = blockIdx.y;  // the stage computed next
  int range = 1;  // SEQ: the range whose end comes next
  const int chunks = K / BK;
  for (int step = 0; step < walk.steps; ++step) {
    // the stage's copies have landed (its barrier's phase: its use count)
    mbar_wait(sbase + C::BAR_OFF + 8 * slot, (step / ST) & 1);
    // every thread is done with the slot refilled next (SEQ: its group,
    // two back, is done)
    __syncthreads();
    if (tid == 0 && step + AHEAD < walk.steps)
      issue_stage<C, WT>(walk, step + AHEAD, true, true, sbase, &map_x,
                         &map_w);
    compute(slot);
    ++cm_c;
    if (SEQ && cm_c == (int)((long long)range * chunks / split)) {
      // a range ends: its sums onto the ranges' before it, in order
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < E; ++i) fold[i] += acc[i];
      zero(acc);
      ++range;
    }
    if (cm_c == walk.nch) {
      if (SEQ) {
#pragma unroll
        for (int i = 0; i < E; ++i) store(cm_t, i, fold[i]);
        zero(fold);
        range = 1;
      } else {
        epilogue(cm_t);
        zero(acc);
      }
      cm_c = 0;
      cm_t += gridDim.y;
    }
    slot = slot == ST - 1 ? 0 : slot + 1;
  }
  wgmma_wait<0>();
}

// the two tensor maps (see issue_stage): x [M][K] in boxes of 64 columns x
// BM rows, w [N][K] in boxes of 64 columns x BN rows (wt: w [K][N] in boxes
// of BN / 2 columns x 64 rows), all bf16 in the 128-byte swizzle
bool encode_maps(CUtensorMap (&m)[2], const void* x, const void* w, int M,
                 int N, int K, bool wt) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)(wt ? N : K), (cuuint64_t)(wt ? K : N)};
  const cuuint64_t stride[1] = {2 * (cuuint64_t)K};
  const cuuint64_t stride_w[1] = {2 * (cuuint64_t)(wt ? N : K)};
  const cuuint32_t bx[2] = {BK, BM};
  const cuuint32_t bw[2] = {wt ? BN / 2 : BK, wt ? BK : BN};
  return encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dx, stride, bx, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(w), dw, stride_w, bw, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernels opted into their shared memory, by [SEQ][WT], a bit a device
unsigned configured[2][2] = {};

template <bool SEQ, bool WT>
int launch(const CUtensorMap (&maps)[2], float* y, int M, int N, int K,
           int split, int blocks, cudaStream_t st) {
  const cudaError_t err = opt_in<Tile<SEQ>>(bf16_mm_kernel<SEQ, WT>,
                                            configured[SEQ][WT]);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters<Tile<SEQ>>(bf16_mm_kernel<SEQ, WT>, SEQ ? 1 : split,
                                    blocks, st, maps[0], maps[1], y, M, N, K,
                                    split);
}

template <bool SEQ, bool WT>
int blocks_per_sm(int cs) {
  return occupancy<Tile<SEQ>>(bf16_mm_kernel<SEQ, WT>, configured[SEQ][WT],
                              SEQ ? 1 : cs);
}

}  // namespace

// x bf16 [M, K]; w bf16 [N, K] or, w_t, [K, N]; y f32 [M, N]; all
// contiguous and 16-byte aligned, K % 64 == 0 (w_t: N % 8 == 0).  The plan
// (ops/bf16_mm.py bf16_mm_plan, a function of N, K and the card): a K split
// of `split` in 1 .. 8 ranges (at least one 64-column chunk each); `seq` 0
// runs it on `blocks` clusters of split blocks, 1 on `blocks` single blocks
// (the same bits).  Returns a cudaError_t code.
extern "C" int vt_bf16_mm(const void* x, const void* w, void* y, int M, int N,
                          int K, int split, int seq, int w_t, int blocks,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || split < 1 ||
      split > MAX_CLUSTER || split > K / BK || blocks < 1 ||
      (w_t && N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (!encode_maps(maps, x, w, M, N, K, w_t != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(y);
  if (seq)
    return w_t ? launch<true, true>(maps, out, M, N, K, split, blocks, st)
               : launch<true, false>(maps, out, M, N, K, split, blocks, st);
  return w_t ? launch<false, true>(maps, out, M, N, K, split, blocks, st)
             : launch<false, false>(maps, out, M, N, K, split, blocks, st);
}

// Blocks of the kernel (with a cluster split of cs; seq: the single
// blocks'; w_t: on [K, N] weights) resident on one SM of the current
// device, or -cudaError_t: what the plan's residency assumes.
extern "C" int vt_bf16_mm_occupancy(int cs, int seq, int w_t) {
  if (seq) return w_t ? blocks_per_sm<true, true>(cs)
                      : blocks_per_sm<true, false>(cs);
  return w_t ? blocks_per_sm<false, true>(cs) : blocks_per_sm<false, false>(cs);
}
