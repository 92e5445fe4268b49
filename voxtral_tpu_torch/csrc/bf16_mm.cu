// Row-invariant bf16 product: y[m, n] = sum_k x[m, k] w[n, k], f32 out.
//
// The counterpart of an XLA product, not of a Pallas kernel: the JAX
// package's float products (voxtral_tpu/models/quant.py:mm,
// einsum(preferred_element_type=f32)) and its conv stem's im2col products.
// The port computes them with cuBLAS elsewhere (models/quant.py
// matmul_f32); on the streaming encoder side and in the decoder of a bf16
// config it takes this kernel instead, because cuBLAS picks its algorithm
// and its K split by the row count M, so the same row rounds differently
// when the feed is chunked differently or the batch is another size.  Here
// a row's bits depend on that row and the weights alone:
//   * One instruction for every output element at every M: wgmma
//     m64n64k16, 64 output columns (the weights, the A operand) x 64 rows
//     of x (the B operand), both read from shared memory.  A tile of 128
//     output columns x 64 R rows of x issues it R times per k16 step, once
//     for each 64-row block of x (R = 1 or 2, by M: ops/bf16_mm.py
//     bf16_mm_tile_rows); each element still sees the same instruction
//     sequence.  Rows past M are zeros from TMA's out-of-bounds fill and
//     are never stored; a row never meets another row in a sum.
//   * K is walked in chunks of 64 columns in order, split into SPLIT
//     contiguous ranges, SPLIT chosen from (N, K) by the caller
//     (ops/bf16_mm.py bf16_mm_plan), never from M.  Each range is summed
//     from zero, and the ranges' sums are added in range order, from zero:
//     the same operations on every path below.
//   * Two ways to run that split, which give the same bits: a cluster of
//     SPLIT blocks per tile, one range each, whose sums are pushed to the
//     rank that folds them (few tiles: the split keeps the card's loads in
//     flight at a streaming chunk's or a decode step's few rows); or single
//     blocks that walk the ranges in turn and fold them in registers,
//     persistent over the tiles a grid apart (enough tiles to fill the
//     card).  The caller picks one from the tile count (bf16_mm_seq; the
//     clusters run the 64-row tile only, the few-row case they serve);
//     neither changes a row's bits.
// x is bf16 [M, K], y f32 [M, N].  w is bf16 [N, K], the weight as the JAX
// package stores it, or, WT, [K, N], the conv stem's im2col weight as it is
// stored: TMA then loads boxes of 64 output columns x 64 rows of K, and the
// wgmma reads them as its A operand transposed (MN-major), so no transposed
// copy of the weight is kept.  Both layouts give the same bits.
//
// What bounds it on the H100: at a streaming chunk's or a decode step's
// few rows the weights' bytes (2 a weight: an encoder layer's four
// products are 60 MB, a decode step's 105 are 7.2 GB); at hundreds of rows
// the tensor cores.  The design, blocks of 384 threads:
//   * One thread of a producer warpgroup issues every TMA copy (the
//     warpgroup's registers given to the consumers with setmaxnreg: of the
//     80 a thread two blocks an SM have, 32 there and 104 in the
//     consumers; of one block's 168, 40 and 232), into a ring of ST stages
//     in shared memory: a stage is 64 columns of K, the weights' box of
//     128 rows and x's box of 64 R rows, in TMA's 128-byte swizzle, with a
//     full and an empty mbarrier.  Every stage the ring holds is in flight
//     at once: 96-128 KB of weights an SM.
//   * Two consumer warpgroups, each owning 64 output columns of the tile,
//     run the wgmma chain on each stage as it lands and hand the stage back
//     once their group of the stage before it is done.  R = 2 halves the
//     weights' re-reads at many rows: a 24 KB stage feeds 1 MFLOP at R = 1,
//     a 32 KB stage 2 MFLOP at R = 2.
//   * The cluster's fold: each block pushes its partial sums into the
//     shared memory of the ranks that fold them (rank r folds the
//     accumulators r, r + SPLIT, ...), one bulk copy a rank from a staging
//     area in its idle ring, each completing on that rank's one mbarrier;
//     a rank waits once, for the bytes it expects, and folds its share in
//     rank order from zero.  No remote loads; one cluster barrier, split
//     around the fold, keeps each block until the copies out of it are
//     read.
//   * Programmatic dependent launch: the producer issues the first stages'
//     weights before the previous kernel ends, x only after.

#include "quant_mm.cuh"

namespace {

constexpr int BK = 64;            // columns of K per chunk (a ring stage)
constexpr int BN = 128;           // output columns of a tile: two m64 halves
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

// A ring of stages.  A stage: x's box [64 R][64] bf16 and the weights'
// box [BN][64] bf16, each on a 1024-byte boundary for the 128-byte
// swizzle, each kind in its own array; then the barriers (full and empty
// per stage, the fold's) and, for a cluster's split, the fold's receive
// buffer: from each of the SPLIT ranks, ceil(E / SPLIT) accumulators of
// every consumer thread, at most (E + 7) x 256 floats.  CL: the cluster's
// tile.  The 64-row tile's ring is as deep as two blocks an SM allow (its
// registers allow two: setmaxnreg splits each block's between the
// producer warpgroup and the consumers), the 128-row tile's as deep as one
// block allows.  ops/bf16_mm.py mirrors these sizes.
template <int R, bool CL>
struct Tile {
  static constexpr int NT = THREADS;
  static constexpr int BM = 64 * R;   // rows of x of a tile
  static constexpr int E = 32 * R;    // accumulators of a consumer thread
  static constexpr int BLOCKS = R == 1 ? 2 : 1;   // blocks an SM, at most
  static constexpr int PRODUCER_REGS = R == 1 ? 32 : 40;
  static constexpr int CONSUMER_REGS = R == 1 ? 104 : 232;
  static constexpr int X_BYTES = BM * BK * 2, W_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int RECV_BYTES =
      CL ? (E + MAX_CLUSTER - 1) * CONSUMERS * 4 : 0;
  static constexpr int smem(int st) {
    return 1024 + st * STAGE_BYTES + 256 + RECV_BYTES;
  }
  static constexpr int ST =
      ((BLOCKS == 1 ? 232448 : 233472 / BLOCKS - 1024) - smem(0)) /
      STAGE_BYTES;
  static constexpr int MAX_SMEM = smem(ST);
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "boxes must stay 1024-byte aligned");
  static_assert(16 * ST + 8 <= 256, "the barriers fit their 256 bytes");
  static_assert(BLOCKS * (MAX_SMEM + 1024) <= 233472,
                "the blocks' shared memory on an H100 SM");
  static_assert(!CL || RECV_BYTES <= ST * STAGE_BYTES,
                "the fold stages in the ring");
  static_assert(CONSUMERS * CONSUMER_REGS + (NT - CONSUMERS) * PRODUCER_REGS
                    <= 65536 / (BLOCKS * NT) / 8 * 8 * NT,
                "setmaxnreg moves registers within the block's allocation");
};

// The addresses of a ring of `st` stages at shared address `base`.
template <class C>
struct Ring {
  int st;
  uint32_t base;
  __device__ uint32_t x_at(int slot) const { return base + slot * C::X_BYTES; }
  __device__ uint32_t w_at(int slot) const {
    return base + st * C::X_BYTES + slot * C::W_BYTES;
  }
  __device__ uint32_t full_at(int slot) const {
    return base + st * C::STAGE_BYTES + 8 * slot;
  }
  __device__ uint32_t empty_at(int slot) const {
    return base + st * C::STAGE_BYTES + 8 * (st + slot);
  }
  __device__ uint32_t recv_bar() const {
    return base + st * C::STAGE_BYTES + 16 * st;
  }
  __device__ uint32_t recv() const { return base + st * C::STAGE_BYTES + 256; }
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of `parity` to complete.  A phase that never
// completes (a fault in the byte counts) traps after ~2^33 cycles, so it
// shows as a failed launch, not as a hung card.  `CLUSTER`: the bytes came
// from other blocks of the cluster (st.async), acquired at cluster scope.
template <bool CLUSTER = false>
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
          " %2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      const long long now = clock64();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > (1ll << 33))
        __trap();
    }
  }
}
// the shared::cluster address of `addr` (this block's) in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// `bytes` of this block's shared memory at src into another block's at
// dst (both 16-byte aligned, bytes a multiple of 16), completing on that
// block's barrier: one copy engine transaction
__device__ __forceinline__ void bulk_copy_to(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the two consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// CL false: single blocks, each folding the `split` ranges of the whole K
// over the tiles blockIdx.y, + gridDim.y, ...; CL true: a cluster of
// gridDim.x = split blocks per tile (tile blockIdx.y, one a cluster), one
// K range each.  Tile t covers output columns (t / n_mt) BN and rows
// (t % n_mt) 64 R.  WT: the weights stored [K, N].
template <int R, bool CL, bool WT>
__global__ void __launch_bounds__(THREADS, R == 1 ? 2 : 1)
bf16_mm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               float* __restrict__ y, int M, int N, int K, int split) {
  using C = Tile<R, CL>;
  constexpr int ST = C::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const Ring<C> ring{ST, sbase};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = K / BK;
  const int n_mt = (M + C::BM - 1) / C::BM;
  const int n_tiles = ((N + BN - 1) / BN) * n_mt;
  const int cs = CL ? (int)gridDim.x : 1, rank = CL ? (int)blockIdx.x : 0;
  // the block's K chunks: its rank's range, or the whole K
  const int c_lo = (int)((long long)rank * chunks / cs);
  const int nch = (int)((long long)(rank + 1) * chunks / cs) - c_lo;
  const int tiles = (int)blockIdx.y < n_tiles
                        ? (n_tiles - 1 - (int)blockIdx.y) / (int)gridDim.y + 1
                        : 0;
  const int steps = tiles * nch;
  const bool push = CL && cs > 1;

  if (tid == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    for (int i = 0; i < ST; ++i) {
      mbar_init(ring.full_at(i), 1);
      mbar_init(ring.empty_at(i), CONSUMERS / 32);
    }
    if (push) {
      // this rank's share of the fold: accumulators rank, rank + cs, ...
      // of every consumer thread, from each of the cs ranks
      mbar_init(ring.recv_bar(), 1);
      mbar_expect(ring.recv_bar(),
                  cs * ((C::E - rank + cs - 1) / cs) * CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every rank's barriers exist before any push (waited at the push)
  if (push) cluster_arrive();

  if (warp >= CONSUMERS / 32) {
    // ---- the producer warpgroup: every TMA copy, from one thread ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      const CUtensorMap* const mx = &map_x;
      const CUtensorMap* const mw = &map_w;
      // stage k of the walk into slot k % ST: its weights (the barrier
      // expects the whole stage's bytes; WT: a box for each warpgroup's
      // 64 output columns), its x, or both
      auto issue = [&](int k, bool weights, bool acts) {
        const int slot = k % ST, c = k % nch;
        const int t = (int)blockIdx.y + (k / nch) * (int)gridDim.y;
        const int n0 = (t / n_mt) * BN, m0 = (t % n_mt) * C::BM;
        const int k0 = (c_lo + c) * BK;
        const uint32_t bar = ring.full_at(slot);
        if (weights) {
          mbar_expect(bar, C::STAGE_BYTES);
          if (WT) {
            tma_2d(ring.w_at(slot), mw, n0, k0, bar);
            tma_2d(ring.w_at(slot) + C::W_BYTES / 2, mw, n0 + BN / 2, k0,
                   bar);
          } else {
            tma_2d(ring.w_at(slot), mw, k0, n0, bar);
          }
        }
        if (acts) tma_2d(ring.x_at(slot), mx, k0, m0, bar);
      };
      // the first stages' weights before the grids this one depends on
      // are done (weights are no kernel's output), their x after
      const int pre = steps < ST ? steps : ST;
      for (int k = 0; k < pre; ++k) issue(k, true, false);
      griddep_wait();
      for (int k = 0; k < pre; ++k) issue(k, false, true);
      griddep_launch();   // dependents may launch: this block has started
      for (int k = pre; k < steps; ++k) {
        // the slot's previous use is done with
        wait_phase(ring.empty_at(k % ST), ((k / ST) - 1) & 1);
        issue(k, true, true);
      }
    } else {
      griddep_launch();
    }
  } else {
    // ---- two consumer warpgroups: 64 output columns each ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    griddep_wait();  // y is written only once the grids before are done
    griddep_launch();
    const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
    const int g = lane >> 2, tig = lane & 3;

    float acc[R][32];   // one range's sums: R m64 x n64 fragments
    float fold[R][32];  // single blocks: the ranges done so far
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = fold[j][i] = 0.f;

    // Accumulator i of fragment j of a thread is output column
    // 64 wg + 16 wq + g + 8 e of tile t, row 64 j + 8 q + 2 tig + c, with
    // i = 4 q + 2 e + c.  I = 32 j + i.
    auto store = [&](int t, int I, float v) {
      const int j = I >> 5, i = I & 31;
      const int q = i >> 2, e = (i >> 1) & 1, c = i & 1;
      const int n = (t / n_mt) * BN + 64 * wg + 16 * wq + g + 8 * e;
      const int m = (t % n_mt) * C::BM + 64 * j + 8 * q + 2 * tig + c;
      if (n < N && m < M) y[(size_t)m * N + n] = v;
    };

    int slot = 0, prev = -1, c = 0, range = 1, t = blockIdx.y;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      wait_phase(ring.full_at(slot), phase);
      // acc += this warpgroup's 64 output columns x 64 R rows over the
      // stage's 64 columns of K: 4 k16 steps in order for each 64-row
      // fragment, one group, left in flight.  A k16 step starts 32 bytes
      // on in a K-major box's 128-byte rows, 16 rows (two 1024-byte
      // swizzle atoms) on in a WT box; fragment j, 64 rows (8 KB) on in
      // x's box.
      {
        const uint32_t ws = ring.w_at(slot) + wg * 64 * BK * 2;
        const uint32_t xs = ring.x_at(slot);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < R; ++j)
            wgmma_m64n64k16_ss<WT ? 1 : 0>(
                acc[j], desc_sw128(ws + (WT ? 16 * 128 : 32) * ks),
                desc_sw128(xs + j * 64 * 128 + 32 * ks));
        wgmma_commit();
      }
      // the stage before is done with: its slot goes back to the producer
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(ring.empty_at(prev));
      prev = slot;
      ++c;
      const bool tile_end = c == nch;
      const bool range_end =
          !CL && c == (int)((long long)range * chunks / split);
      if (tile_end || range_end) {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(ring.empty_at(slot));
        prev = -1;
        if (!CL) {
          // a range ends: its sums onto the ranges' before it, in order
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              fold[j][i] += acc[j][i];
              acc[j][i] = 0.f;
            }
          ++range;
        }
        if (tile_end) {
          if (!CL) {
#pragma unroll
            for (int I = 0; I < C::E; ++I) store(t, I, fold[I >> 5][I & 31]);
#pragma unroll
            for (int j = 0; j < R; ++j)
#pragma unroll
              for (int i = 0; i < 32; ++i) fold[j][i] = 0.f;
          } else if (!push) {
#pragma unroll
            for (int I = 0; I < C::E; ++I) store(t, I, acc[I >> 5][I & 31]);
          } else {
            // accumulator I goes to rank I % cs, slot I / cs of this
            // rank's rows there: staged in the ring (every stage is done
            // with), one bulk copy a rank, each completing on that rank's
            // barrier; rank r then folds its accumulators over the ranks
            // in order, from zero
            const int nj = (C::E + cs - 1) / cs;
            float* stage = reinterpret_cast<float*>(smem);
            consumers_sync();  // both warpgroups' wgmma are done with x
            int r = 0, jr = 0;
#pragma unroll
            for (int I = 0; I < C::E; ++I) {
              stage[(r * nj + jr) * CONSUMERS + tid] = acc[I >> 5][I & 31];
              if (++r == cs) {
                r = 0;
                ++jr;
              }
            }
            // the staged sums are visible to the copies, and every rank's
            // barrier exists
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            consumers_sync();
            cluster_wait();
            const uint32_t recv = ring.recv();
            const uint32_t rbar = ring.recv_bar();
            if (tid == 0)
              for (int d = 0; d < cs; ++d)
                bulk_copy_to(mapa(recv + rank * nj * CONSUMERS * 4, d),
                             sbase + d * nj * CONSUMERS * 4,
                             (C::E - d + cs - 1) / cs * CONSUMERS * 4,
                             mapa(rbar, d));
            wait_phase<true>(rbar, 0);
            // every copy into this block has landed (the wait below: every
            // copy out of it has been read, before the block may exit)
            cluster_arrive();
            const float* rv =
                reinterpret_cast<const float*>(smem + (recv - sbase));
            const int mine = (C::E - rank + cs - 1) / cs;
            for (int j = 0; j < mine; ++j) {
              float v = 0.f;
              for (int s = 0; s < cs; ++s)
                v += rv[(s * nj + j) * CONSUMERS + tid];
              store(t, rank + j * cs, v);
            }
            cluster_wait();
          }
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
          c = 0;
          range = 1;
          t += gridDim.y;
        }
      }
      if (++slot == ST) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

// the two tensor maps (see the producer): x [M][K] in boxes of 64 columns
// x bm rows, w [N][K] in boxes of 64 columns x BN rows (wt: w [K][N] in
// boxes of BN / 2 columns x 64 rows), all bf16 in the 128-byte swizzle
bool encode_maps(CUtensorMap (&m)[2], const void* x, const void* w, int M,
                 int N, int K, bool wt, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)(wt ? N : K), (cuuint64_t)(wt ? K : N)};
  const cuuint64_t stride[1] = {2 * (cuuint64_t)K};
  const cuuint64_t stride_w[1] = {2 * (cuuint64_t)(wt ? N : K)};
  const cuuint32_t bx[2] = {BK, (cuuint32_t)bm};
  const cuuint32_t bw[2] = {(cuuint32_t)(wt ? BN / 2 : BK),
                            (cuuint32_t)(wt ? BK : BN)};
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

// the kernels opted into their shared memory, by [R - 1][CL][WT], a bit a
// device
unsigned configured[2][2][2] = {};

// grid (cs, clusters) of clusters of cs blocks; the launch may start before the stream's previous kernel ends
// (programmatic dependent launch)
template <int R, bool CL, bool WT>
int launch(const CUtensorMap (&maps)[2], float* y, int M, int N, int K,
           int split, int blocks, cudaStream_t st) {
  using C = Tile<R, CL>;
  auto kernel = bf16_mm_kernel<R, CL, WT>;
  cudaError_t err = opt_in<C>(kernel, configured[R - 1][CL][WT]);
  if (err != cudaSuccess) return (int)err;
  const int cs = CL ? split : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, blocks, 1);
  cfg.blockDim = dim3(C::NT, 1, 1);
  cfg.dynamicSmemBytes = C::MAX_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], y, M, N, K, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int R, bool CL>
int launch_wt(bool w_t, const CUtensorMap (&maps)[2], float* y, int M, int N,
              int K, int split, int blocks, cudaStream_t st) {
  return w_t ? launch<R, CL, true>(maps, y, M, N, K, split, blocks, st)
             : launch<R, CL, false>(maps, y, M, N, K, split, blocks, st);
}

template <int R, bool CL, bool WT>
int blocks_per_sm() {
  using C = Tile<R, CL>;
  return occupancy<C>(bf16_mm_kernel<R, CL, WT>, configured[R - 1][CL][WT],
                      C::ST);
}

template <int R, bool CL>
int blocks_per_sm_wt(bool w_t) {
  return w_t ? blocks_per_sm<R, CL, true>() : blocks_per_sm<R, CL, false>();
}

}  // namespace

// x bf16 [M, K]; w bf16 [N, K] or, w_t, [K, N]; y f32 [M, N]; all
// contiguous and 16-byte aligned, K % 64 == 0 (w_t: N % 8 == 0).  The plan
// (ops/bf16_mm.py bf16_mm_plan, a function of N, K and the card): a K split
// of `split` in 1 .. 8 ranges (at least one 64-column chunk each);
// tile_rows 64 or 128, the rows of x a tile holds (bf16_mm_tile_rows).
// `seq` 0 runs the split on a
// cluster of split blocks per tile (every tile at once; the 64-row tile
// only), 1 on `blocks` single blocks walking the tiles (the same bits).
// Returns a cudaError_t code.
extern "C" int vt_bf16_mm(const void* x, const void* w, void* y, int M, int N,
                          int K, int split, int seq, int w_t, int blocks,
                          int tile_rows, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || split < 1 ||
      split > MAX_CLUSTER || split > K / BK || blocks < 1 ||
      (w_t && N % 8 != 0) || (tile_rows != 64 && tile_rows != 128) ||
      (!seq && tile_rows != 64))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles =
      (long long)((N + BN - 1) / BN) * ((M + tile_rows - 1) / tile_rows);
  if (!seq && n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int grid = seq ? (int)(blocks < n_tiles ? blocks : n_tiles)
                       : (int)n_tiles;
  CUtensorMap maps[2];
  if (!encode_maps(maps, x, w, M, N, K, w_t != 0, tile_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(y);
  const bool wt = w_t != 0;
  if (tile_rows == 64)
    return seq ? launch_wt<1, false>(wt, maps, out, M, N, K, split, grid, st)
               : launch_wt<1, true>(wt, maps, out, M, N, K, split, grid, st);
  return launch_wt<2, false>(wt, maps, out, M, N, K, split, grid, st);
}

// Blocks of the kernel (tile_rows 64 or 128; seq: the single blocks', else
// a cluster's, 64-row tile only; w_t: on [K, N] weights) resident on
// one SM of the current device, or -cudaError_t: what the launch's
// residency assumes.
extern "C" int vt_bf16_mm_occupancy(int seq, int w_t, int tile_rows) {
  const bool wt = w_t != 0;
  if (tile_rows == 64)
    return seq ? blocks_per_sm_wt<1, false>(wt)
               : blocks_per_sm_wt<1, true>(wt);
  return seq ? blocks_per_sm_wt<2, false>(wt)
             : -(int)cudaErrorInvalidValue;
}
