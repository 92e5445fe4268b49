// T-row sliding-window attention over the streaming encoder's KV ring.
//
// Replaces voxtral_tpu/ops/flash_encode.py:_kernel (the Pallas kernel behind
// flash_bulk_attention_batched).  Same function: for stream b, head h and
// query row i at position q = pos0[b] + i, with pos_hi = pos0[b] + T - 1
// the last position written to the ring, slot s holds the logical position
//     l(s) = pos_hi - ((pos_hi - s) mod cap)
// and is valid iff 0 <= l(s) <= q and l(s) > q - window.  Scores are
// q.k / sqrt(64) in float32 with an online softmax in float32; the
// probabilities are rounded to bf16 before the PV product, which
// accumulates in float32.  The chunk's own rows are already in the ring
// (ops/ring.py ring_chunk_write runs first).
//
// What bounds it on the H100: device-memory bytes.  At the batched streaming
// shape (B = 16, T = 64, H = KH = 32, D = 64, cap 1024, window 750) each
// query row meets up to 750 keys, ~4*64*750 FLOP per row and head against
// the live window's ~813 K/V rows of 128 bytes each read once per query
// tile: ~6.3 GFLOP against ~107 MB, 59 FLOP/byte, below the ~295 FLOP/byte
// ridge.  At B = 1 and T = 100 (the 2 s streaming chunk) only 64 (query
// tile, head) pairs exist, each walking ~13 ring blocks, so a walk that is
// not split is bounded by its own latency.
//
// The design: the shared Hopper attention tile (attn_tile.cuh: mma.sync
// m16n8k16 with every intermediate in registers, K/V through a 3-stage
// cp.async ring of swizzled tiles) walks the ring's 64-slot blocks; the
// walk of each (query tile, head, stream) is split into S segments of
// consecutive ring blocks, one block of S (a thread-block cluster) each, and
// the segments' partial (max, sum, output) rows are combined in segment
// order through distributed shared memory: one launch, no partials in
// device memory.  The ring is read in place from the stacked
// [B, L, KH, cap, D] cache through the layer view's base pointer and
// strides (never copied).
//
// Chunking invariance: the walk visits the ring's blocks in ABSOLUTE slot
// order 0 .. ceil(cap/64)-1, as the TPU kernel does, and S and the segment
// boundaries are functions of cap alone (the caller's segment plan,
// ops/flash_encode.py flash_encode_segments), never of B, T or the
// positions; so a row's masked scores, block partition, segment partition
// and accumulation order depend only on the ring's state, and its output is
// bitwise the same however the feed was chunked.  A block masked for every
// row of the tile is skipped: for each of those rows the running max would
// stay, the rescale factor would be exactly 1 and the block would add 0.  A
// segment with no valid key for a row contributes exactly 0 to the combine
// (its max is the sentinel, its sum and output 0); a row whose segments are
// all empty gets 0.  Blocks wholly valid for every row skip the per-element
// mask, which changes no value.
//
// The ragged T edge (query rows past T) and a ragged cap (slots past cap)
// are masked here, so the caller pads nothing.  Rings are bf16, or f32
// rounded to bf16 as they are loaded (the compute dtype of the query, as in
// the TPU kernel); f32 tiles go through registers, since cp.async cannot
// convert.
//
// Float32 queries (a float32 config, whose TPU kernel computes in f32) take
// the f32 row walk of attn_f32.cuh: the ring's live 32-slot tiles in
// ascending slot order, bf16 or f32 rings read as f32, CUDA-core FMA, no
// split; a row's output is again bitwise the same however the feed was
// chunked (attn_f32.cuh, row independence).

#include <cooperative_groups.h>

#include "attn_f32.cuh"
#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using attn::Acc;
using attn::BK;
using attn::BQ;
using attn::D;
using attn::LDO;
using attn::NT;

constexpr int MAX_SEGMENTS = 8;  // the portable cluster size

// which slots a row sees: the ring's logical positions, one segment of the
// walk.  Slots 0..rr hold positions base .. pos_hi and slots rr+1..cap-1
// positions base - cap + rr + 1 .. base - 1 (base = pos_hi - rr): two runs
// in which the position grows with the slot, so the slots some row sees,
// and those every row sees, are each at most one interval per run.
template <typename RingT>
struct RingPolicy {
  const __nv_bfloat16* q;
  int q_stride, q_rows;
  const RingT* k;  // slot 0 of this (stream, kv head)
  const RingT* v;
  int kv_stride;
  int cap, base, rr;
  int qf, window;   // the tile's first row's position; the window
  int a0, a1, b0, b1;          // live blocks of the segment: [a0,a1], [b0,b1]
  int ia0, ia1, ib0, ib1;      // slots valid for every row, one run each

  // the slots of run A (slots <= rr) and of run B whose positions lie in
  // [lo, hi], as [x0, x1] and [y0, y1] (empty when x0 > x1)
  __device__ void runs(int lo, int hi, int& x0, int& x1, int& y0,
                       int& y1) const {
    x0 = max(0, lo - base);
    x1 = min(rr, hi - base);
    y0 = max(rr + 1, lo - base + cap);
    y1 = min(cap - 1, hi - base + cap);
  }
  // set up the walk of blocks [j_lo, j_hi) for rows at positions qf..ql
  __device__ void plan(int ql, int j_lo, int j_hi) {
    int x0, x1, y0, y1;
    runs(max(0, qf - window + 1), ql, x0, x1, y0, y1);  // some row sees
    a0 = max(x0 / BK, j_lo);
    a1 = x0 <= x1 ? min(x1 / BK, j_hi - 1) : -1;
    b0 = max(y0 / BK, j_lo);
    b1 = y0 <= y1 ? min(y1 / BK, j_hi - 1) : -1;
    if (a0 > a1) a1 = -1;  // nothing of the run in this segment
    if (b0 > b1) b1 = -1;
    runs(max(0, ql - window + 1), qf, ia0, ia1, ib0, ib1);  // every row sees
  }
  // the next live block after j (a block masked for every row is skipped)
  __device__ int next(int j) const {
    const int c = j + 1;
    if (c <= a1) return max(c, a0);
    if (c <= b1) return max(c, b0);
    return -1;
  }
  __device__ int first() const { return next(-1); }
  __device__ const RingT* k_tile(int j) const {
    return k + (long long)j * BK * kv_stride;
  }
  __device__ const RingT* v_tile(int j) const {
    return v + (long long)j * BK * kv_stride;
  }
  __device__ int kv_rows(int j) const { return min(BK, cap - j * BK); }
  // every slot of block j is valid for every row of the tile
  __device__ bool interior(int j) const {
    const int s0 = j * BK, s1 = s0 + BK - 1;
    const int lo = ia0 <= ia1 ? ia0 : ib0;                  // the two runs
    const int hi = ib0 <= ib1 && (ia0 > ia1 || (ia1 == rr && ib0 == rr + 1))
                       ? ib1 : ia1;                         // joined if they
    return (lo <= s0 && s1 <= hi) || (ib0 <= s0 && s1 <= ib1);  // touch
  }
  __device__ int kpos(int j, int c) const {
    const int s = j * BK + c;
    return s >= cap ? attn::NO_KEY : s <= rr ? base + s : base - cap + s;
  }
  __device__ int row_lo(int r) const { return max(0, qf + r - window + 1); }
  __device__ int row_hi(int r) const { return qf + r; }
};

// the segment of the walk that ring block j falls in: segment s covers
// blocks [s n / S, (s + 1) n / S) of the n blocks
__device__ __forceinline__ int segment_of(int j, int n_blocks, int segments) {
  return ((j + 1) * segments - 1) / n_blocks;
}

// folds one segment's partial row (max m, sum l, unnormalised outputs o)
// into the running row (M, L, O), in segment order.  Both mappings of the
// walk (below) combine with this one function, so their outputs are the
// same bit for bit.
template <int N>
__device__ __forceinline__ void fold_row(float& M, float& L, float* O,
                                         float m, float l, const float* o) {
  const float mn = fmaxf(M, m);
  const float a = exp2f(M - mn), b = exp2f(m - mn);
  L = fmaf(l, b, __fmul_rn(L, a));
#pragma unroll
  for (int i = 0; i < N; ++i) O[i] = fmaf(o[i], b, __fmul_rn(O[i], a));
  M = mn;
}

// one block walks every segment of its (query tile, head, stream) and
// folds each into running rows: the maxima and sums in registers, the
// outputs in shared memory, each thread's 32 at stride NT (no bank
// conflicts; in registers they would push the tile into spills)
struct FoldInShared {
  int n_blocks, segments;
  float* O;  // [32][NT]: O[k * NT + tid]
  float M[2], L[2];

  __device__ bool ends(int jc, int jn) const {
    return jn < 0 || segment_of(jc, n_blocks, segments) !=
                         segment_of(jn, n_blocks, segments);
  }
  __device__ void fold(const Acc& acc) {
    float* mine = O + threadIdx.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      float o[16], run[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[2 * n] = acc.o[n][2 * h];
        o[2 * n + 1] = acc.o[n][2 * h + 1];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) run[i] = mine[(16 * h + i) * NT];
      fold_row<16>(M[h], L[h], run, acc.m[h], acc.l[h], o);
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[(16 * h + i) * NT] = run[i];
    }
  }
};

// dynamic shared memory: the tile's, and the walk's running outputs
template <bool SPLIT>
constexpr int smem_bytes() {
  return attn::SMEM_BYTES + (SPLIT ? 0 : 32 * 4 * NT);
}

// SPLIT: one block per segment, the blocks of a (query tile, head, stream)
// forming a cluster that folds the partial rows through distributed shared
// memory (few query tiles: the split fills the card); otherwise one block
// walks all segments (enough tiles to fill the card without it).  The
// ring's state and the fold need more than the 128 registers of 4 blocks
// per SM, so the tile runs 3 blocks per SM (170 registers; the split runs
// only on small grids) and does not spill.
template <bool SPLIT, typename RingT, typename OutT>
__global__ void __launch_bounds__(NT, 3)
flash_encode_kernel(const __nv_bfloat16* __restrict__ q,
                    const RingT* __restrict__ k_ring,
                    const RingT* __restrict__ v_ring,
                    const int* __restrict__ pos0, OutT* __restrict__ out,
                    int T, int H, int KH, int cap, int window,
                    long long stride_b, long long stride_h,
                    long long stride_s, int segments) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int seg = SPLIT ? (int)(blockIdx.x % segments) : 0;
  const int q0 = (SPLIT ? blockIdx.x / segments : blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int qrow = H * D;  // elements between query rows
  const int p0 = pos0[b];
  const int pos_hi = p0 + T - 1;
  const int n_blocks = (cap + BK - 1) / BK;

  RingPolicy<RingT> pol;
  pol.q = q + ((long long)b * T + q0) * qrow + h * D;
  pol.q_stride = qrow;
  pol.q_rows = min(BQ, T - q0);
  pol.k = k_ring + b * stride_b + kh * stride_h;
  pol.v = v_ring + b * stride_b + kh * stride_h;
  pol.kv_stride = (int)stride_s;
  pol.cap = cap;
  pol.rr = (pos_hi % cap + cap) % cap;
  pol.base = pos_hi - pol.rr;
  pol.qf = p0 + q0;
  pol.window = window;
  OutT* ob = out + ((long long)b * T + q0) * qrow + h * D;
  Acc acc;

  if constexpr (!SPLIT) {
    pol.plan(p0 + q0 + pol.q_rows - 1, 0, n_blocks);
    FoldInShared run;
    run.n_blocks = n_blocks;
    run.segments = segments;
    run.O = reinterpret_cast<float*>(smem + attn::SMEM_BYTES);
    for (int i = 0; i < 32; ++i) run.O[i * NT + threadIdx.x] = 0.f;
    run.M[0] = run.M[1] = attn::NEG;
    run.L[0] = run.L[1] = 0.f;
    attn::attend(pol, smem, acc, run);
    // O / L (0 for a row that saw no key), staged for 16-byte stores
    float* st = reinterpret_cast<float*>(smem + attn::Q_BYTES);
    const int lane = threadIdx.x & 31;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float l = run.L[h2];
      const float* o = run.O + (16 * h2) * NT + threadIdx.x;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float2 v = make_float2(0.f, 0.f);
        if (l > 0.f)
          v = make_float2(o[(2 * n) * NT] / l, o[(2 * n + 1) * NT] / l);
        *reinterpret_cast<float2*>(st + (r + 8 * h2) * LDO + 8 * n + c) = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pol.q_rows * (D / 8); i += NT) {
      const int rr = i / (D / 8), cc = (i % (D / 8)) * 8;
      const float4* src = reinterpret_cast<const float4*>(st + rr * LDO + cc);
      attn::store8(ob + rr * qrow + cc, src[0], src[1]);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();  // rank == seg
    pol.plan(p0 + q0 + pol.q_rows - 1, seg * n_blocks / segments,
             (seg + 1) * n_blocks / segments);
    attn::attend(pol, smem, acc);

    // this segment's partial rows: unnormalised O, max and sum per row
    float* part = reinterpret_cast<float*>(smem + attn::Q_BYTES);
    float* pm = part + BQ * LDO;
    float* pl = pm + BQ;
    attn::stage_rows(part, acc, 1.f, 1.f);
    if ((threadIdx.x & 3) == 0) {
      const int r = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
      pm[r] = acc.m[0];
      pl[r] = acc.l[0];
      pm[r + 8] = acc.m[1];
      pl[r + 8] = acc.l[1];
    }
    cluster.sync();

    // block `seg` of the cluster folds its share of the rows over all
    // segments, four outputs a thread, four segments at a time so that
    // their remote loads are issued together
    const int per = (BQ + segments - 1) / segments;
    const int r_lo = seg * per, r_hi = min(BQ, r_lo + per);
    for (int i = threadIdx.x; i < (r_hi - r_lo) * (D / 4); i += NT) {
      const int r = r_lo + i / (D / 4), c = (i % (D / 4)) * 4;
      if (r >= pol.q_rows) continue;
      float M = attn::NEG, L = 0.f, O[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s0 = 0; s0 < segments; s0 += 4) {
        float ms[4], ls[4];
        float4 xs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (s0 + k < segments) {  // rank s0 + k's partial rows
            const float* rp = cluster.map_shared_rank(part, s0 + k);
            ms[k] = rp[BQ * LDO + r];
            ls[k] = rp[BQ * LDO + BQ + r];
            xs[k] = *reinterpret_cast<const float4*>(rp + r * LDO + c);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (s0 + k < segments) {
            const float o[4] = {xs[k].x, xs[k].y, xs[k].z, xs[k].w};
            fold_row<4>(M, L, O, ms[k], ls[k], o);
          }
        }
      }
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (L > 0.f) v = make_float4(O[0] / L, O[1] / L, O[2] / L, O[3] / L);
      attn::store4(ob + r * qrow + c, v);
    }
    cluster.sync();  // no block leaves while another reads its partials
  }
}

// the f32 walk's view of the ring (attn_f32.cuh): the 32-slot tiles that
// hold a position some row of the block sees, in slot order.  Slots
// 0..rr hold positions base .. pos_hi and slots rr+1..cap-1 positions
// base - cap + rr + 1 .. base - 1 (RingPolicy above): one interval of
// slots per run, [a0, a1] and [b0, b1] as tiles.
template <typename RingT>
struct RingPolicyF32 {
  const RingT* k;  // slot 0 of this (stream, kv head)
  const RingT* v;
  long long kv_stride;
  int n_keys, base, rr, qf, window, a0, a1, b0, b1;

  __device__ void plan(int ql) {
    constexpr int BK32 = attn32::BK;
    const int lo = max(0, qf - window + 1);
    const int x0 = max(0, lo - base), x1 = min(rr, ql - base);
    const int y0 = max(rr + 1, lo - base + n_keys);
    const int y1 = min(n_keys - 1, ql - base + n_keys);
    a0 = x0 / BK32;
    a1 = x0 <= x1 ? x1 / BK32 : -1;
    b0 = y0 / BK32;
    b1 = y0 <= y1 ? y1 / BK32 : -1;
  }
  __device__ int next(int j) const {
    const int c = j + 1;
    if (c <= a1) return max(c, a0);
    if (c <= b1) return max(c, b0);
    return -1;
  }
  __device__ int first() const { return next(-1); }
  __device__ const RingT* k_row(int s) const { return k + s * kv_stride; }
  __device__ const RingT* v_row(int s) const { return v + s * kv_stride; }
  __device__ int kpos(int s) const {
    return s >= n_keys ? attn32::NO_KEY : s <= rr ? base + s
                                                  : base - n_keys + s;
  }
  __device__ int row_lo(int r) const { return max(0, qf + r - window + 1); }
  __device__ int row_hi(int r) const { return qf + r; }
};

template <typename RingT, typename OutT>
__global__ void __launch_bounds__(attn32::NT)
flash_encode_f32_kernel(const float* __restrict__ q,
                        const RingT* __restrict__ k_ring,
                        const RingT* __restrict__ v_ring,
                        const int* __restrict__ pos0, OutT* __restrict__ out,
                        int T, int H, int KH, int cap, int window,
                        long long stride_b, long long stride_h,
                        long long stride_s) {
  const int q0 = blockIdx.x * attn32::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int p0 = pos0[b];
  const int pos_hi = p0 + T - 1;

  RingPolicyF32<RingT> pol;
  pol.k = k_ring + b * stride_b + kh * stride_h;
  pol.v = v_ring + b * stride_b + kh * stride_h;
  pol.kv_stride = stride_s;
  pol.n_keys = cap;
  pol.rr = (pos_hi % cap + cap) % cap;
  pol.base = pos_hi - pol.rr;
  pol.qf = p0 + q0;
  pol.window = window;
  pol.plan(p0 + min(q0 + attn32::BQ, T) - 1);

  const int row = q0 + (threadIdx.x >> 5);
  const long long off = ((long long)b * T + row) * (H * D) + h * D;
  const bool live = row < T;
  attn32::attend<RingT>(pol, live ? q + off : nullptr,
                        live ? out + off : nullptr);
}

template <typename RingT, typename OutT>
int launch_f32(const void* q, const void* k, const void* v, const void* pos0,
               void* out, int B, int T, int H, int KH, int cap, int window,
               long long sb, long long sh, long long ss,
               cudaStream_t stream) {
  dim3 grid((T + attn32::BQ - 1) / attn32::BQ, H, B);
  flash_encode_f32_kernel<RingT, OutT><<<grid, attn32::NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const RingT*>(k),
      static_cast<const RingT*>(v), static_cast<const int*>(pos0),
      static_cast<OutT*>(out), T, H, KH, cap, window, sb, sh, ss);
  return (int)cudaGetLastError();
}

template <bool SPLIT, typename RingT, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* pos0,
           void* out, int B, int T, int H, int KH, int cap, int window,
           long long sb, long long sh, long long ss, int segments,
           cudaStream_t stream) {
  auto kern = flash_encode_kernel<SPLIT, RingT, OutT>;
  constexpr int SMEM = smem_bytes<SPLIT>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (T + BQ - 1) / BQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT ? n_qt * segments : n_qt, H, B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT ? segments : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q),
      static_cast<const RingT*>(k), static_cast<const RingT*>(v),
      static_cast<const int*>(pos0), static_cast<OutT*>(out), T, H, KH, cap,
      window, sb, sh, ss, segments);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename RingT, typename OutT>
int launch_split(int split, const void* q, const void* k, const void* v,
                 const void* pos0, void* out, int B, int T, int H, int KH,
                 int cap, int window, long long sb, long long sh,
                 long long ss, int segments, cudaStream_t s) {
  return split ? launch<true, RingT, OutT>(q, k, v, pos0, out, B, T, H, KH,
                                           cap, window, sb, sh, ss, segments,
                                           s)
               : launch<false, RingT, OutT>(q, k, v, pos0, out, B, T, H, KH,
                                            cap, window, sb, sh, ss, segments,
                                            s);
}

}  // namespace

// q [B,T,H,D] contiguous, bf16 or (q_f32 != 0) f32 with a 16-byte aligned
// base; k_ring/v_ring: the layer's rings [B,KH,cap,D]
// (bf16, or f32 with ring_f32 != 0) at element strides stride_b, stride_h,
// stride_s (stride_s < 2^31 / 64), D contiguous, 16-byte aligned rows; pos0
// [B] int32, >= 0; out [B,T,H,D] in f32 (out_f32 != 0) or bf16; segments
// 1 .. min(8, ceil(cap/64)), the caller's plan, a function of cap alone
// (the bitwise chunking invariance rests on it); split 1: one block per
// segment (a cluster per query tile), 0: one block per query tile walking
// every segment (the output is the same bit for bit).  f32 queries take
// the f32 walk, which ignores segments and split.  Returns a cudaError_t
// code.
extern "C" int vt_flash_encode(const void* q, const void* k_ring,
                               const void* v_ring, const void* pos0,
                               void* out, int B, int T, int H, int KH,
                               int head_dim, int cap, int window,
                               long long stride_b, long long stride_h,
                               long long stride_s, int q_f32, int ring_f32,
                               int out_f32, int segments, int split,
                               void* stream) {
  if (head_dim != D || KH <= 0 || H % KH != 0 || T <= 0 || B <= 0 ||
      cap <= 0 || window <= 0 || segments < 1 || segments > MAX_SEGMENTS ||
      segments > (cap + BK - 1) / BK || split < 0 || split > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VT_F32(R, O)                                                          \
  launch_f32<R, O>(q, k_ring, v_ring, pos0, out, B, T, H, KH, cap, window,    \
                   stride_b, stride_h, stride_s, s)
  if (q_f32) {
    if (ring_f32)
      return out_f32 ? VT_F32(float, float) : VT_F32(float, __nv_bfloat16);
    return out_f32 ? VT_F32(__nv_bfloat16, float)
                   : VT_F32(__nv_bfloat16, __nv_bfloat16);
  }
#undef VT_F32
#define VT_SPLIT(R, O)                                                        \
  launch_split<R, O>(split, q, k_ring, v_ring, pos0, out, B, T, H, KH, cap,  \
                     window, stride_b, stride_h, stride_s, segments, s)
  if (ring_f32)
    return out_f32 ? VT_SPLIT(float, float) : VT_SPLIT(float, __nv_bfloat16);
  return out_f32 ? VT_SPLIT(__nv_bfloat16, float)
                 : VT_SPLIT(__nv_bfloat16, __nv_bfloat16);
#undef VT_SPLIT
}
