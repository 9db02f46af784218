// B6: per-slot running top-k lists over the scheduled pair tiles, the
// k-NN graph's batched step (replaces the Pallas kernel
// repro/kernels/pairwise_topk.py:pairwise_topk_pallas, body
// _pairwise_topk_kernel with _merge_rows).
//
// For every simulated device p and scheduled slot pair (lo, hi) whose
// meta row (active, is_self, ga, gb, nv_lo, nv_hi) is active, the rows of
// slot lo take the hi block's rows c < nv_hi as neighbour candidates
// (c != r on a self tile) and, on a non-self tile, the rows of slot hi
// take the lo block's rows r < nv_lo; each row keeps its topk best
// candidates under the (-score, index) order, with (NEG_INF,
// IDX_SENTINEL) padding.  Scores are the dot or the l2 score
// (2 dot - |cand|^2) - |row|^2.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores, 2*d
// operations per candidate pair of an active tile (67 TFLOP/s).  The f32
// scores decide the ranking, so no TF32.
//
// Design.  The TPU kernel walks the pairs in order on its sequential grid
// and merges each tile into a VMEM accumulator with topk rounds of
// extract-max.  Here B8's ownership (pairwise_topk_q.cu): one block of 8
// warps owns 128 rows of one (device, slot), walks the pairs in order and
// scores every tile that touches its slot from its own side, so it is the
// only writer of its rows' lists (no atomics on them, deterministic) and a
// non-self tile is formed twice, once per side.
//
//   * Scoring is B2's fp32 tile as B4 (query_topk.cu) runs it: 128 own
//     rows x 256 candidates a tile, 8 x 16 scores a thread, 32-deep d
//     slices of both through a 3-stage 16-byte cp.async ring in dynamic
//     shared memory (zero fill past the rows and d; plain loads where d or
//     the base is not 16-byte aligned), one block an SM.  The ring runs on
//     across tiles and segments, so the next tile loads while this one is
//     selected.  Every score is one fmaf chain over d in ascending order,
//     so (u, v) and (v, u) have the same dot and identical rows tie
//     exactly; the squared norms are chains of the same kind, computed
//     once per slot row (row_norms.cuh), and the l2 score keeps the order
//     (2 dot - |cand|^2) - |row|^2.
//   * Selection is B4's (topk_select.cuh): each score is compared in
//     registers with its row's admission bound, only the few that beat it
//     are queued, and the queues drain into the running lists once one is
//     half full: shared memory for lists of up to 32 entries, else global
//     scratch, held in a warp's registers while it drains a list of up to
//     512 (a separate kernel instance for each); order_kernel
//     (pair_tile.cuh) sorts the lists.
//
// No float atomics (the queues claim slots with integer shared atomics);
// the lists do not depend on the order in which candidates reach them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "pair_tile.cuh"
#include "row_norms.cuh"
#include "topk_select.cuh"

namespace {

using namespace hopper;
using namespace topk_select;
using pair_tile::load_meta;
using pair_tile::Meta;

constexpr int kRows = 128;        // own rows per block
constexpr int kCols = 256;        // candidates per score tile
constexpr int kDepth = 32;        // d per ring stage
constexpr int kLd = kDepth + 4;   // row stride in shared memory (floats)
constexpr int kStages = 3;
constexpr int kThreads = 256;     // 16 x 16, each 8 rows x 16 candidates
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 16;        // queued candidates per row
constexpr int kSmemTp = 32;       // lists up to this long live in shared memory
constexpr int kStageFloats = (kRows + kCols) * kLd;
constexpr int kRingBytes = kStages * kStageFloats * (int)sizeof(float);
static_assert(kThreads == kCols, "one thread per candidate of a tile");

struct Sel {
  Queues<kRows, kQueue> q;
  float rn[kRows];   // |row|^2 (l2)
  float cn[kCols];   // |candidate|^2 of the tile (l2)
  int G[kCols];      // the tile's global candidate ids, kSentinel past nv
};

// One (pair, side) that feeds this block's slot: the other slot, the
// candidates' global block, their valid count, the self-tile diagonal.
struct Seg {
  int other, g, nv, excl;
};

// The block's walk over (pair, side, 256-row tile c0, d slice ks).
struct Walk {
  int pair, side, c0, ks;
  bool done;
  Seg seg;
};

struct Sched {
  const int *lo, *hi, *meta;  // meta of this device
  int slot, n_pairs, nks;

  __device__ __forceinline__ bool seg_of(int pair, int side, Seg& s) const {
    const Meta m = load_meta(meta + (size_t)pair * 6);
    if (m.active != 1) return false;
    const int l = lo[pair], h = hi[pair];
    if (side == 0) {
      if (l != slot) return false;
      s = Seg{h, m.gb, m.nv_hi, m.is_self == 1};
    } else {
      if (h != slot || m.is_self == 1) return false;
      s = Seg{l, m.ga, m.nv_lo, 0};
    }
    return s.nv > 0;
  }
  // from (w.pair, w.side) on, the first segment that feeds the slot
  __device__ __forceinline__ void seek(Walk& w) const {
    while (w.pair < n_pairs && !seg_of(w.pair, w.side, w.seg)) {
      if (++w.side == 2) {
        w.side = 0;
        ++w.pair;
      }
    }
    w.done = w.pair >= n_pairs;
  }
  __device__ __forceinline__ void start(Walk& w) const {
    w.pair = w.side = w.c0 = w.ks = 0;
    seek(w);
  }
  __device__ __forceinline__ void step(Walk& w) const {
    if (++w.ks < nks) return;
    w.ks = 0;
    w.c0 += kCols;
    if (w.c0 < w.seg.nv) return;
    w.c0 = 0;
    if (++w.side == 2) {
      w.side = 0;
      ++w.pair;
    }
    seek(w);
  }
};

// d slice [k0, k0 + 32) of own rows A[0, a_rows) (ring rows 0..127) and
// of candidates B[0, b_rows) (ring rows 128..383) into the stage at dst,
// zeros past the rows and d (query_topk.cu's load_stage, kept apart:
// one shared copy slowed B4, PERF.md §6)
template <bool kVec>
__device__ __forceinline__ void load_stage(uint32_t dst,
                                           const float* __restrict__ A,
                                           int a_rows,
                                           const float* __restrict__ B,
                                           int b_rows, int k0, int d,
                                           int tid) {
#pragma unroll
  for (int e = 0; e < (kRows + kCols) * (kDepth / 4) / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / (kDepth / 4), c = idx % (kDepth / 4);
    const bool isa = r < kRows;   // uniform in e
    const float* g = isa ? A : B;
    const int gr = isa ? r : r - kRows;
    const bool row_ok = gr < (isa ? a_rows : b_rows);
    const int gk = k0 + 4 * c;
    const float* src = g + (size_t)(row_ok ? gr : 0) * d + gk;
    const uint32_t dd = dst + (uint32_t)(r * kLd + 4 * c) * 4u;
    if constexpr (kVec) {
      const bool ok = row_ok && gk < d;
      cp_async16(dd, ok ? src : g, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        w[x] = __float_as_uint(row_ok && gk + x < d ? src[x] : 0.f);
      st_shared_v4(dd, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// kVec: 16-byte copies (d % 4 == 0, 16-byte-aligned base), else plain
// loads.  kLong: lists longer than kSmemTp, in global memory.  kScoreOnly
// (measurement): no selection; each row's best score goes to entry 0 of
// its list, so the scoring alone can be timed.
template <bool kVec, bool kLong, bool kScoreOnly>
__global__ void __launch_bounds__(kThreads, 1)
topk_kernel(const float* __restrict__ quorum,  // [P, k, block, d]
            const float* __restrict__ norms,   // [P, k, block] (l2)
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ meta,      // [P, n_pairs, 6]
            float* __restrict__ list_v,        // [P, k, block, tp]
            int* __restrict__ list_i, int k, int block, int d, int n_pairs,
            int block_rows, int topk, int tp, int l2) {
  extern __shared__ __align__(16) float smem[];
  Sel& sel = *reinterpret_cast<Sel*>(smem + kStages * kStageFloats);
  const int p = blockIdx.z, slot = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, block - r0);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32;
  const size_t dev_off = (size_t)p * k * block;
  const size_t slot_off = dev_off + (size_t)slot * block;
  const Sched sch{lo, hi, meta + (size_t)p * n_pairs * 6, slot, n_pairs,
                  max(1, (d + kDepth - 1) / kDepth)};

  // the running lists: shared memory for short ones (entry t of row r's
  // list at t * kRows + r), else the global scratch; topk sentinels first
  constexpr bool in_smem = !kLong && !kScoreOnly;
  float* lv = reinterpret_cast<float*>(&sel + 1);
  int* li = reinterpret_cast<int*>(lv + kRows * tp);
  if (!in_smem) {
    lv = list_v + (slot_off + r0) * tp;
    li = list_i + (slot_off + r0) * tp;
  }
  if constexpr (!kScoreOnly) {
    for (int e = tid; e < (in_smem ? kRows : rows) * tp; e += kThreads) {
      lv[e] = kNegInf;
      li[e] = kSentinel;
    }
    sel.q.init(tid, kThreads);
  }
  if (tid < kRows)
    sel.rn[tid] = l2 && tid < rows ? norms[slot_off + r0 + tid] : 0.f;

  auto drain_lists = [&]() {
    if constexpr (kLong)
      sel.q.drain_warps(warp, kWarps, lv, li, tp, topk);
    else
      sel.q.drain_threads(lv, li, topk);
  };

  const float* __restrict__ A = quorum + (slot_off + r0) * d;
  const uint32_t s0 = smem_u32(smem);
  auto load = [&](const Walk& w, int stage) {
    load_stage<kVec>(s0 + (uint32_t)(stage * kStageFloats) * 4u, A, rows,
                     quorum + (dev_off + (size_t)w.seg.other * block + w.c0) *
                                  d,
                     min(kCols, w.seg.nv - w.c0), w.ks * kDepth, d, tid);
  };
  Walk lw, cw;   // the loader runs kStages - 1 slices ahead
  sch.start(lw);
  sch.start(cw);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!lw.done) {
      load(lw, s);
      sch.step(lw);
    }
    cp_async_commit();
  }

  float acc[8][16];
  float best[8];   // kScoreOnly
#pragma unroll
  for (int i = 0; i < 8; ++i) best[i] = -INFINITY;
  for (int it = 0; !cw.done; ++it) {
    if (cw.ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
      // the tile's ids and norms (the last tile's readers are past a
      // barrier)
      const int c = cw.c0 + tid;
      const bool ok = c < cw.seg.nv;
      sel.G[tid] = ok ? cw.seg.g * block_rows + c : kSentinel;
      sel.cn[tid] =
          l2 && ok ? norms[dev_off + (size_t)cw.seg.other * block + c] : 0.f;
    }
    cp_async_wait<kStages - 2>();   // slice it landed
    __syncthreads();                // ... for every thread; slice it-1 done
    if (!lw.done) {
      load(lw, (it + kStages - 1) % kStages);
      sch.step(lw);
    }
    cp_async_commit();
    const float* As = smem + (it % kStages) * kStageFloats;   // own rows
    const float* Bs = As + kRows * kLd;                        // candidates
#pragma unroll
    for (int k4 = 0; k4 < kDepth / 4; ++k4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[(ty + 16 * i) * kLd +
                                                     4 * k4]);
      // the candidates in two halves of 8 (registers for the selection)
#pragma unroll
      for (int jh = 0; jh < 16; jh += 8) {
        float4 bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * (jh + j)) * kLd + 4 * k4]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // d in order
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][jh + j] = fmaf(lane_of(a[i], kk), lane_of(bv[j], kk),
                                    acc[i][jh + j]);
      }
    }
    if (cw.ks != sch.nks - 1) {
      sch.step(cw);
      continue;
    }

    // ---- the tile is scored: l2 scores, masks ----
    const int c0 = cw.c0;
    const bool excl = cw.seg.excl;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cl = tx + 16 * j;
      const bool live = sel.G[cl] != kSentinel;
      const float cn = sel.cn[cl];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rl = ty + 16 * i;
        float s = acc[i][j];
        if (l2) s = (2.f * s - cn) - sel.rn[rl];
        // absent rows, candidates past nv and a self tile's diagonal never
        // enter a list
        const bool ok = live && rl < rows && !(excl && r0 + rl == c0 + cl);
        acc[i][j] = ok ? s : -INFINITY;
      }
    }
    if constexpr (kScoreOnly) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) best[i] = fmaxf(best[i], acc[i][j]);
      __syncthreads();   // sel.G / sel.cn are rewritten by the next tile
      sch.step(cw);
      continue;
    }
    // ---- selection: queue what beats each row's bound, then drain ----
    for (;;) {
      int pending = 0, drain = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;   // shared by 16 aligned lanes
        float bv = sel.q.bound_v[r];
        int bi = sel.q.bound_i[r];
        float top = acc[i][0];
#pragma unroll
        for (int j = 1; j < 16; ++j) top = fmaxf(top, acc[i][j]);
        if (topk <= 16 && __any_sync(0xffffffffu, bi == kSentinel)) {
          // while a list fills: at least 16 candidates reach the minimum
          // of the 16 lanes' best scores, so nothing below it can make
          // the row's top-k
          float floor_v = top;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            floor_v = fminf(floor_v,
                            __shfl_xor_sync(0xffffffffu, floor_v, off));
          if (floor_v > bv) {
            bv = floor_v;
            bi = kSentinel;
          }
        }
        if (!__any_sync(0xffffffffu, top >= bv)) continue;   // none passes
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float a = acc[i][j];
          if (a > bv || (a == bv && sel.G[tx + 16 * j] < bi)) m |= 1u << j;
        }
        int pos = sel.q.template claim<16>(r, __popc(m));
        drain |= m != 0 && pos + __popc(m) > kQueue / 2;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (!(m >> j & 1)) continue;
          if (pos < kQueue) {
            sel.q.put(pos, r, acc[i][j], sel.G[tx + 16 * j]);
            acc[i][j] = -INFINITY;   // queued: never again
          } else {
            pending = 1;             // full: pending for the next round
          }
          ++pos;
        }
      }
      // a queue half full or a candidate pending: drain, then retry
      if (!__syncthreads_or(drain | pending)) break;
      drain_lists();
      if (!__syncthreads_or(pending)) break;
    }
    sch.step(cw);
  }

  cp_async_wait<0>();   // no copy outlives the block (no tiles at all)
  if constexpr (kScoreOnly) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = best[i];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (tx == 0 && ty + 16 * i < rows)
        list_v[(slot_off + r0 + ty + 16 * i) * tp] = v;
    }
    return;
  }
  __syncthreads();      // what the last tiles queued
  drain_lists();
  if constexpr (in_smem) {
    __syncthreads();
    for (int e = tid; e < rows * tp; e += kThreads) {
      const int r = e / tp, t = e % tp;
      list_v[(slot_off + r0) * tp + e] = lv[t * kRows + r];
      list_i[(slot_off + r0) * tp + e] = li[t * kRows + r];
    }
  }
}

template <bool kVec, bool kLong, bool kScoreOnly>
int launch_select(const float* quorum, const float* norms, const int* lo,
                  const int* hi, const int* meta, float* list_v, int* list_i,
                  int P, int k, int block, int d, int n_pairs, int block_rows,
                  int topk, int tp, int l2, cudaStream_t s) {
  const size_t smem =
      kRingBytes + sizeof(Sel) +
      (kLong || kScoreOnly ? 0 : (size_t)kRows * tp * 8);
  const auto kernel = topk_kernel<kVec, kLong, kScoreOnly>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((block + kRows - 1) / kRows, k, P);
  kernel<<<grid, kThreads, smem, s>>>(quorum, norms, lo, hi, meta, list_v,
                                      list_i, k, block, d, n_pairs,
                                      block_rows, topk, tp, l2);
  return (int)cudaGetLastError();
}

template <bool kVec>
int run(const float* quorum, const float* norms, const int* lo,
        const int* hi, const int* meta, float* list_v, int* list_i,
        float* out_v, int* out_i, int P, int k, int block, int d,
        int n_pairs, int block_rows, int topk, int tp, int l2,
        int score_only, cudaStream_t s) {
  if (score_only)
    return launch_select<kVec, true, true>(quorum, norms, lo, hi, meta,
                                           list_v, list_i, P, k, block, d,
                                           n_pairs, block_rows, topk, tp, l2,
                                           s);
  const int rc =
      (tp <= kSmemTp ? launch_select<kVec, false, false>
                     : launch_select<kVec, true, false>)(
          quorum, norms, lo, hi, meta, list_v, list_i, P, k, block, d,
          n_pairs, block_rows, topk, tp, l2, s);
  if (rc != 0) return rc;
  return pair_tile::launch_order(list_v, list_i, out_v, out_i,
                                 (long long)P * k * block, topk, tp, s);
}

}  // namespace

// norms: [P, k, block] float32 scratch (l2); score_only (measurement): the
// scoring pass alone, each row's best score at entry 0 of its list, no
// selection and no ordering
extern "C" int repro_pairwise_topk(const void* quorum, const void* lo,
                                   const void* hi, const void* meta,
                                   void* norms, void* list_v, void* list_i,
                                   void* out_v, void* out_i, int P, int k,
                                   int block, int d, int n_pairs,
                                   int block_rows, int topk, int tp, int l2,
                                   int score_only, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (l2)
    row_norms::launch((const float*)quorum, (float*)norms,
                      (long long)P * k * block, d, s);
  const bool vec = d % 4 == 0 && (uintptr_t)quorum % 16 == 0;
  return (vec ? run<true> : run<false>)(
      (const float*)quorum, (const float*)norms, (const int*)lo,
      (const int*)hi, (const int*)meta, (float*)list_v, (int*)list_i,
      (float*)out_v, (int*)out_i, P, k, block, d, n_pairs, block_rows, topk,
      tp, l2, score_only, s);
}
