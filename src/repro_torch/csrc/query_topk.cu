// B4: fused query scoring + dedup mask + top-k selection (replaces the
// Pallas kernel repro/kernels/query_score.py:query_topk_pallas, body
// _query_topk_kernel).
//
// For every simulated device p, Q queries are scored against the k
// resident slots of its [k, block, d] stack (dot, or the l2 score
// (2 q.x - |x|^2) - |q|^2); rows whose mask is 0 become (NEG_INF,
// IDX_SENTINEL); the result is the top-k under the (-score, index) total
// order: among equal scores the smaller global row id wins.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores, 2*Q*d
// operations per unmasked (query, row) (67 TFLOP/s).  The f32 scores
// decide the ranking, so no TF32: every score is one fmaf chain over d in
// ascending order wherever it sits in the tile, and |x|^2, |q|^2 are
// chains of the same kind, so identical rows tie exactly and ties break
// by index as in the plain version.
//
// Design.  The TPU kernel walks the k slots in order on its sequential
// grid and merges each slot into one running [Q, topk] list.  Hopper's
// blocks run in no order, so the selection takes two passes:
//
//   1. score_kernel: one block of 256 threads per (device, slot, 16,384-row
//      chunk, 128-query tile).  A chunk whose mask is all zero (a slot the
//      cover leaves to another device) exits at once and flags its list
//      empty.  Otherwise the block scores 128 x 256 tiles (128 queries,
//      256 corpus rows) as B2's GEMM (pairwise_corr.cu) does: 8 x 16
//      outputs per thread, 32-deep d slices of both operands through a
//      3-stage 16-byte cp.async ring in dynamic shared memory (zero fill
//      past Q, the chunk and d; plain loads where d or a base is not
//      16-byte aligned), conflict-free float4 reads; the queries' slices
//      ride the ring beside the rows' (they stay in L2), so any d fits.
//      The ring runs on across tiles, so the next tile's slices load while
//      this one is selected.  Selection stays in registers: each score is
//      compared with its query's admission bound, and only the few that
//      beat it go through the candidate queues of topk_select.cuh to the
//      query's running list (shared memory for topk <= 16, global scratch
//      above that); the queues drain once one is half full.
//   2. merge_kernel: one warp per (device, query) runs the same list over
//      the non-empty chunk lists into shared memory, then orders it by
//      rank (the number of entries before each one under the total order,
//      ties of identical sentinels broken by position).
//
// No float atomics; the output does not depend on the order in which
// candidates reach a list.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topk_select.cuh"

namespace {

using namespace hopper;
using namespace topk_select;

constexpr int kQT = 128;        // queries per block
constexpr int kRT = 256;        // corpus rows per score tile
constexpr int kDepth = 32;      // d per ring stage
constexpr int kLd = kDepth + 4;  // row stride in shared memory (floats)
constexpr int kStages = 3;
constexpr int kThreads = 256;   // 16 x 16, each 8 queries x 16 rows
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16384;   // rows per chunk list
constexpr int kQueue = 32;      // queued candidates per query
constexpr int kSmemTopk = 16;   // lists up to this long live in shared memory
constexpr int kStageFloats = (kQT + kRT) * kLd;
constexpr int kRingBytes = kStages * kStageFloats * (int)sizeof(float);
constexpr int kMergeWarps = 4;

struct Sel {
  Queues<kQT, kQueue> q;
  float qn[kQT];   // |q|^2 (l2)
  float xn[kRT];   // |x|^2 of the tile's rows (l2)
  int G[kRT];      // the tile's global row ids, kSentinel where masked
};

// d slice [k0, k0 + 32) of queries [q0, q0 + 128) (ring rows 0..127) and
// of chunk rows [r0, r0 + 256) (ring rows 128..383) into the stage at dst
template <bool kVec>
__device__ __forceinline__ void load_stage(uint32_t dst,
                                           const float* __restrict__ queries,
                                           int q0, int Q,
                                           const float* __restrict__ rows,
                                           int r0, int r_end, int k0, int d,
                                           int tid) {
#pragma unroll
  for (int e = 0; e < (kQT + kRT) * (kDepth / 4) / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / (kDepth / 4), c = idx % (kDepth / 4);
    const bool isq = r < kQT;   // uniform in e
    const float* g = isq ? queries : rows;
    const int gr = isq ? q0 + r : r0 + r - kQT;
    const bool row_ok = gr < (isq ? Q : r_end);
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

// squared norm of one 32-float ring row, continuing the chain s
__device__ __forceinline__ float norm_slice(const float* row, float s) {
#pragma unroll
  for (int k4 = 0; k4 < kDepth / 4; ++k4) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * k4);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
score_kernel(const float* __restrict__ stack,   // [P, k, block, d]
             const float* __restrict__ queries,  // [Q, d]
             const float* __restrict__ mask,     // [P, k, block]
             const int* __restrict__ gidx,       // [P, k, block]
             float* __restrict__ list_v,         // [P, Q, n_lists, topk]
             int* __restrict__ list_i,           // [P, Q, n_lists, topk]
             int* __restrict__ list_full,        // [P, n_lists]
             int k, int block, int d, int Q, int topk, int n_chunks,
             int l2) {
  extern __shared__ __align__(16) float smem[];
  Sel& sel = *reinterpret_cast<Sel*>(smem + kStages * kStageFloats);
  const int p = blockIdx.z;
  const int list = blockIdx.x;  // slot * n_chunks + chunk
  const int slot = list / n_chunks;
  const int r_begin = (list % n_chunks) * kChunk;
  const int r_end = min(block, r_begin + kChunk);
  const int q0 = blockIdx.y * kQT;
  const int n_lists = k * n_chunks;
  const size_t slot_off = ((size_t)p * k + slot) * block;
  const float* __restrict__ rows = stack + slot_off * d;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32;

  bool any = false;
  for (int r = r_begin + tid; r < r_end; r += kThreads)
    any |= mask[slot_off + r] > 0.f;
  any = __syncthreads_or(any);
  if (tid == 0 && blockIdx.y == 0)
    list_full[(size_t)p * n_lists + list] = any ? 1 : 0;
  if (!any) return;  // a slot this device does not score: no work

  // the running lists: shared memory for short ones (entry t of query q's
  // list at t * kQT + q), else the output scratch itself; both start as
  // topk sentinels (a chunk with fewer real rows than topk leaves them)
  const bool in_smem = topk <= kSmemTopk;
  float* lv = reinterpret_cast<float*>(&sel + 1);
  int* li = reinterpret_cast<int*>(lv + kQT * topk);
  const size_t lstride = (size_t)n_lists * topk;
  if (in_smem) {
    for (int e = tid; e < kQT * topk; e += kThreads) {
      lv[e] = kNegInf;
      li[e] = kSentinel;
    }
  } else {
    lv = list_v + (((size_t)p * Q + q0) * n_lists + list) * topk;
    li = list_i + (((size_t)p * Q + q0) * n_lists + list) * topk;
    for (int e = tid; e < kQT * topk; e += kThreads) {
      const int q = e / topk;
      if (q0 + q >= Q) continue;
      lv[q * lstride + e % topk] = kNegInf;
      li[q * lstride + e % topk] = kSentinel;
    }
  }
  sel.q.init(tid, kThreads);

  auto drain_lists = [&]() {
    if (in_smem)
      sel.q.drain_threads(lv, li, topk);
    else
      sel.q.drain_warps(warp, kWarps, lv, li, lstride, topk);
  };

  const uint32_t s0 = smem_u32(smem);
  const int nk = max(1, (d + kDepth - 1) / kDepth);
  const int n_tiles = (r_end - r_begin + kRT - 1) / kRT;
  const int total = n_tiles * nk;
  auto load = [&](int t) {
    load_stage<kVec>(s0 + (uint32_t)((t % kStages) * kStageFloats) * 4u,
                     queries, q0, Q, rows, r_begin + (t / nk) * kRT, r_end,
                     (t % nk) * kDepth, d, tid);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) load(t);
    cp_async_commit();
  }

  float acc[8][16];
  float xnorm = 0.f, qnorm = 0.f;
  for (int t = 0; t < total; ++t) {
    const int tile = t / nk, ks = t % nk;
    const int r0 = r_begin + tile * kRT;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
      xnorm = 0.f;
      // the tile's global ids (the last tile's readers are past a barrier)
      const int r = r0 + tid;
      sel.G[tid] = r < r_end && mask[slot_off + r] > 0.f ? gidx[slot_off + r]
                                                         : kSentinel;
    }
    cp_async_wait<kStages - 2>();   // slice t landed
    __syncthreads();                // ... for every thread; slice t-1 done
    if (t + kStages - 1 < total) load(t + kStages - 1);
    cp_async_commit();
    const float* As = smem + (t % kStages) * kStageFloats;  // queries
    const float* Bs = As + kQT * kLd;                        // rows
#pragma unroll
    for (int k4 = 0; k4 < kDepth / 4; ++k4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[(ty + 16 * i) * kLd +
                                                     4 * k4]);
      // the rows in two halves of 8 (registers for the selection state)
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
    if (l2) {
      xnorm = norm_slice(Bs + tid * kLd, xnorm);
      if (tile == 0 && tid < kQT) qnorm = norm_slice(As + tid * kLd, qnorm);
    }
    if (ks != nk - 1) continue;

    // ---- the tile is scored: publish its rows' norms ----
    sel.xn[tid] = xnorm;
    if (tile == 0 && tid < kQT) sel.qn[tid] = qnorm;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = tx + 16 * j;
      const bool live = sel.G[r] != kSentinel;
      const float xn = sel.xn[r];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = acc[i][j];
        if (l2) s = (2.f * s - xn) - sel.qn[ty + 16 * i];
        // masked rows and absent queries never enter a list
        acc[i][j] = live && q0 + ty + 16 * i < Q ? s : -INFINITY;
      }
    }
    // ---- selection: queue what beats each query's bound, then drain ----
    for (;;) {
      int pending = 0, drain = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;   // shared by 16 aligned lanes
        float bv = sel.q.bound_v[q];
        int bi = sel.q.bound_i[q];
        float top = acc[i][0];
#pragma unroll
        for (int j = 1; j < 16; ++j) top = fmaxf(top, acc[i][j]);
        if (topk <= 16 && __any_sync(0xffffffffu, bi == kSentinel)) {
          // while a list fills: at least 16 candidates reach the minimum
          // of the 16 lanes' best scores, so nothing below it can make
          // the query's top-k
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
        int pos = sel.q.template claim<16>(q, __popc(m));
        drain |= m != 0 && pos + __popc(m) > kQueue / 2;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (!(m >> j & 1)) continue;
          if (pos < kQueue) {
            sel.q.put(pos, q, acc[i][j], sel.G[tx + 16 * j]);
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
  }
  __syncthreads();   // what the last tiles queued
  drain_lists();

  if (in_smem) {
    __syncthreads();
    for (int e = tid; e < kQT * topk; e += kThreads) {
      const int q = e % kQT, t = e / kQT;
      if (q0 + q >= Q) continue;
      const size_t o = (((size_t)p * Q + q0 + q) * n_lists + list) * topk + t;
      list_v[o] = lv[e];
      list_i[o] = li[e];
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ list_v,  // [P, Q, n_lists, topk]
             const int* __restrict__ list_i,
             const int* __restrict__ list_full,  // [P, n_lists]
             float* __restrict__ out_v,          // [P, Q, topk]
             int* __restrict__ out_i, int Q, int topk, int n_lists) {
  extern __shared__ unsigned char smem_m[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.y;
  const int q = blockIdx.x * kMergeWarps + warp;
  float* v = reinterpret_cast<float*>(smem_m) + (size_t)warp * topk;
  int* ix = reinterpret_cast<int*>(smem_m) + (size_t)kMergeWarps * topk +
            (size_t)warp * topk;
  if (q >= Q) return;  // whole warps only: no block-wide barrier below
  for (int t = lane; t < topk; t += 32) {
    v[t] = kNegInf;
    ix[t] = kSentinel;
  }
  __syncwarp();
  int f = 0, wp = 0, wi = kSentinel;
  float wv = kNegInf;
  const size_t base = ((size_t)p * Q + q) * n_lists * topk;
  for (int l = 0; l < n_lists; ++l) {
    if (!list_full[(size_t)p * n_lists + l]) continue;
    const size_t o = base + (size_t)l * topk;
    for (int t0 = 0; t0 < topk; t0 += 32) {
      const int t = t0 + lane;
      const float cv = t < topk ? list_v[o + t] : kNegInf;
      const int ci = t < topk ? list_i[o + t] : kSentinel;
      warp_offer(cv, ci, v, ix, topk, f, wv, wi, wp);
    }
  }
  __syncwarp();
  // rank of each entry under the total order (position breaks exact ties)
  for (int t = lane; t < topk; t += 32) {
    const float a = v[t];
    const int b = ix[t];
    int rank = 0;
    for (int u = 0; u < topk; ++u) {
      const float c = v[u];
      const int e = ix[u];
      rank += before(c, e, a, b) || (c == a && e == b && u < t);
    }
    const size_t o = ((size_t)p * Q + q) * topk + rank;
    out_v[o] = a;
    out_i[o] = b;
  }
}

template <bool kVec>
int launch_score(const dim3& grid, cudaStream_t s, const float* stack,
                 const float* queries, const float* mask, const int* gidx,
                 float* list_v, int* list_i, int* list_full, int k, int block,
                 int d, int Q, int topk, int n_chunks, int l2) {
  const size_t smem = kRingBytes + sizeof(Sel) +
                      (topk <= kSmemTopk ? (size_t)kQT * topk * 8 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  score_kernel<kVec><<<grid, kThreads, smem, s>>>(
      stack, queries, mask, gidx, list_v, list_i, list_full, k, block, d, Q,
      topk, n_chunks, l2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_query_topk(const void* stack, const void* queries,
                                const void* mask, const void* gidx,
                                void* list_v, void* list_i, void* list_full,
                                void* out_v, void* out_i, int P, int k,
                                int block, int d, int Q, int topk, int l2,
                                void* stream) {
  const int n_chunks = (block + kChunk - 1) / kChunk;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid1(k * n_chunks, (Q + kQT - 1) / kQT, P);
  const bool vec = d % 4 == 0 &&
                   ((uintptr_t)stack | (uintptr_t)queries) % 16 == 0;
  const int rc =
      (vec ? launch_score<true> : launch_score<false>)(
          grid1, s, (const float*)stack, (const float*)queries,
          (const float*)mask, (const int*)gidx, (float*)list_v,
          (int*)list_i, (int*)list_full, k, block, d, Q, topk, n_chunks, l2);
  if (rc != 0) return rc;
  const size_t smem2 =
      (size_t)kMergeWarps * topk * (sizeof(float) + sizeof(int));
  const dim3 grid2((Q + kMergeWarps - 1) / kMergeWarps, P);
  merge_kernel<<<grid2, kMergeWarps * 32, smem2, s>>>(
      (const float*)list_v, (const int*)list_i, (const int*)list_full,
      (float*)out_v, (int*)out_i, Q, topk, k * n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int repro_query_topk_chunk_rows() { return kChunk; }
