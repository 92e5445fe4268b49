// The block of the row-invariant wgmma products: bf16_mm.cu (bf16 weights,
// both operands from shared memory) and int8_mm.cu (int8 weights widened
// to bf16 in registers, the A operand).  Included after quant_mm.cuh, not
// compiled on its own: everything here has internal linkage in each file
// that includes it.
//
// A block of 384 threads computes tiles of BN = 128 output columns (the
// weights' rows, wgmma's M: two consumer warpgroups of 64) by BM = 64 R
// rows of x (wgmma's N: R = 1 or 2 fragments of 64 rows, by descriptor):
//   * One thread of a producer warpgroup issues every TMA copy into a ring
//     of ST stages in shared memory (the warpgroup's registers given to
//     the consumers with setmaxnreg); a stage is KB columns of K (64 or
//     128), the weights' box of 128 rows and x's boxes of BM rows x 64
//     columns (128-byte swizzle; rows past M filled with zeros by TMA),
//     with a full and an empty mbarrier.  The first stages' weights are
//     issued before the previous kernel on the stream ends (programmatic
//     dependent launch), x only after.
//   * K is walked in chunks of KB in order, split into `split` contiguous
//     ranges (the caller's plan, a function of (N, K) and the card, never
//     of M).  Each range is summed from zero and the ranges' sums are added
//     in range order, from zero, whichever way the split runs: on a
//     cluster of `split` blocks per tile, one range each, whose sums are
//     pushed to the rank that folds them (CL), or on single blocks that
//     walk the ranges in turn and fold them in registers, persistent over
//     the tiles a grid apart.  Both give the same bits.
//   * The cluster's fold: each block pushes its partial sums into the
//     shared memory of the ranks that fold them (rank r folds the
//     accumulators r, r + split, ...), one bulk copy a rank from a staging
//     area in its idle ring, each completing on that rank's one mbarrier;
//     a rank waits once, for the bytes it expects, and folds its share in
//     rank order from zero.  No remote loads; one cluster barrier, split
//     around the fold, keeps each block until the copies out of it are
//     read.
// The including file gives the weights' TMA copy, the chain of wgmma on a
// stage and the store of an output (ring_mm).
#pragma once

#include "quant_mm.cuh"

namespace {

constexpr int BK = 64;            // columns of K of an x box (128 bytes)
constexpr int BN = 128;           // output columns of a tile: two m64 halves
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

// A ring of stages.  A stage: KB columns of K, x's KB / 64 boxes [BM][64]
// bf16 and the weights' box [BN][KB] of WB-byte weights, each on a
// 1024-byte boundary for the TMA swizzles, each kind in its own array; then
// the barriers (full and empty per stage, the fold's) and, for a cluster's
// split, the fold's receive buffer: from each of the `split` ranks,
// ceil(E / split) accumulators of every consumer thread, at most (E + 7) x
// 256 floats, FOLD_BYTES (RIR:
// in the ring, past the staging area the sums are pushed from, which the
// idle ring holds at the fold).  CL: the cluster's tile.  The 64-row
// tile's ring is as deep as two blocks an SM allow (its registers allow
// two: setmaxnreg splits each block's between the producer warpgroup and
// the consumers), the 128-row tile's as deep as one block allows.
// ops/bf16_mm.py and ops/quant_mm.py mirror these sizes.
template <int BM_, bool CL, int WB, int KB_ = BK, bool RIR_ = false>
struct Tile {
  static constexpr int BM = BM_;      // rows of x of a tile: 64 or 128
  static constexpr int R = BM / 64;   // 64-row fragments of x a tile
  static constexpr int KB = KB_;      // columns of K a stage
  static constexpr bool RIR = CL && RIR_;  // the fold receives in the ring
  static constexpr int NT = THREADS;
  static constexpr int E = BM / 2;    // accumulators of a consumer thread
  static constexpr int BLOCKS = BM == 64 ? 2 : 1;   // blocks an SM, at most
  static constexpr int PRODUCER_REGS = BM == 64 ? 32 : 40;
  static constexpr int CONSUMER_REGS = BM == 64 ? 104 : 232;
  static constexpr int X_BOX = BM * BK * 2;
  static constexpr int X_BYTES = X_BOX * (KB / BK), W_BYTES = BN * KB * WB;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int FOLD_BYTES = (E + MAX_CLUSTER - 1) * CONSUMERS * 4;
  static constexpr int RECV_BYTES = CL && !RIR ? FOLD_BYTES : 0;
  static constexpr int smem(int st) {
    return 1024 + st * STAGE_BYTES + 256 + RECV_BYTES;
  }
  static constexpr int ST =
      ((BLOCKS == 1 ? 232448 : 233472 / BLOCKS - 1024) - smem(0)) /
      STAGE_BYTES;
  static constexpr int MAX_SMEM = smem(ST);
  static_assert(X_BOX % 1024 == 0 && W_BYTES % 1024 == 0 && KB % BK == 0,
                "boxes must stay 1024-byte aligned");
  static_assert(16 * ST + 8 <= 256, "the barriers fit their 256 bytes");
  static_assert(BLOCKS * (MAX_SMEM + 1024) <= 233472,
                "the blocks' shared memory on an H100 SM");
  static_assert(!CL || (RIR ? 2 : 1) * FOLD_BYTES <= ST * STAGE_BYTES,
                "the fold stages (RIR: and receives) in the ring");
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
  __device__ uint32_t recv() const {
    return C::RIR ? base + C::FOLD_BYTES : base + st * C::STAGE_BYTES + 256;
  }
};

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

// One block of a ring product y [M, N] = x [M, K] w^T over the shared
// memory `smem` (1024-byte aligned).  CL false: single blocks, each
// folding the `split` ranges of the whole K (FOLD false: one range, split
// 1) over the tiles blockIdx.y, + gridDim.y, ...; CL true: a cluster of
// gridDim.x = split blocks per tile (tile blockIdx.y, one a cluster), one
// K range each.  Tile t covers
// output columns (t / n_mt) BN and rows (t % n_mt) BM.  The including
// kernel gives:
//   load_w(dst, k0, n0, bar)   the TMA copy of the weights' box of output
//                              columns n0 .. n0 + BN, K columns k0 .. k0 +
//                              KB into ring address dst, onto `bar`
//   compute(ws, xs, acc)       acc += the stage's product (weights at ws, x
//                              at xs), its wgmma groups left in flight; on
//                              return every group of the stage before is
//                              done and the stage's weights are read
//   store(t, I, v)             output accumulator I of tile t, the folded
//                              sum v
// Accumulator i of fragment j (I = 32 j + i) of a consumer thread is output
// column 64 wg + 16 wq + g + 8 e of the tile, row 64 j + 8 q + 2 tig + c,
// with i = 4 q + 2 e + c (the wgmma m64n64k16 accumulator layout).
template <class C, bool CL, bool FOLD = !CL, class LoadW, class Compute,
          class Store>
__device__ __forceinline__ void ring_mm(unsigned char* smem,
                                        const CUtensorMap* mx,
                                        const CUtensorMap* mw, int M, int N,
                                        int K, int split, LoadW load_w,
                                        Compute compute, Store store) {
  constexpr int ST = C::ST, R = C::R;
  const uint32_t sbase = smem_u32(smem);
  const Ring<C> ring{ST, sbase};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = K / C::KB;
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
    prefetch_map(mx);
    prefetch_map(mw);
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
      // stage k of the walk into slot k % ST: its weights (the barrier
      // expects the whole stage's bytes), its x, or both
      auto issue = [&](int k, bool weights, bool acts) {
        const int slot = k % ST, c = k % nch;
        const int t = (int)blockIdx.y + (k / nch) * (int)gridDim.y;
        const int n0 = (t / n_mt) * BN, m0 = (t % n_mt) * C::BM;
        const int k0 = (c_lo + c) * C::KB;
        const uint32_t bar = ring.full_at(slot);
        if (weights) {
          mbar_expect(bar, C::STAGE_BYTES);
          load_w(ring.w_at(slot), k0, n0, bar);
        }
        if (acts)
          for (int b = 0; b < C::KB / BK; ++b)
            tma_2d(ring.x_at(slot) + b * C::X_BOX, mx, k0 + BK * b, m0, bar);
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

    float acc[R][32];   // one range's sums: R m64 x n64 fragments
    float fold[R][32];  // FOLD: the ranges done so far
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = fold[j][i] = 0.f;

    int slot = 0, prev = -1, c = 0, range = 1, t = blockIdx.y;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      wait_phase(ring.full_at(slot), phase);
      compute(ring.w_at(slot), ring.x_at(slot), acc);
      // the stage before is done with: its slot goes back to the producer
      if (prev >= 0 && lane == 0) mbar_arrive(ring.empty_at(prev));
      prev = slot;
      ++c;
      const bool tile_end = c == nch;
      const bool range_end =
          FOLD && c == (int)((long long)range * chunks / split);
      if (tile_end || range_end) {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(ring.empty_at(slot));
        prev = -1;
        if (FOLD) {
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
          if (FOLD) {
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
            if (C::RIR) {
              // RIR: every rank's sums are staged, so no push lands in a
              // ring still in use (a phase of the consumers alone: the
              // producers' threads have arrived at the first and exited)
              cluster_wait();
              cluster_arrive();
            }
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

// the dynamic shared memory opted into and the launch: a grid of
// (cs, blocks) of clusters of cs blocks, cs = split for CL, else 1; the
// launch may start before the stream's previous kernel ends (programmatic
// dependent launch)
template <class C, class Kern, class... Args>
int launch_ring(Kern kernel, unsigned& configured, int cs, int blocks,
                cudaStream_t st, Args... args) {
  cudaError_t err = opt_in<C>(kernel, configured);
  if (err != cudaSuccess) return (int)err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
