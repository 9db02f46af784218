// B4: fused query scoring + dedup mask + top-k selection (replaces the
// Pallas kernel repro/kernels/query_score.py:query_topk_pallas, body
// _query_topk_kernel).
//
// For every simulated device p, Q queries are scored against the k
// resident slots of its [k, block, d] stack (dot, or the l2 score
// 2 q.x - |x|^2 - |q|^2); rows whose mask is 0 become (NEG_INF,
// IDX_SENTINEL); the result is the top-k under the (-score, index) total
// order: among equal scores the smaller global row id wins.
//
// Design.  The TPU kernel walks the k slots in order on its sequential
// grid and merges each slot into one running [Q, topk] list.  Hopper's
// blocks run in no order, so the selection is split into two passes:
//
//   1. score_kernel: one block per (device, slot, 4096-row chunk, 64-query
//      tile).  A chunk whose mask is all zero (a slot this device does not
//      score under the cover) exits at once and flags its list empty.
//      Otherwise 64-row sub-tiles are scored by a SIMT fp32 GEMM (4 x 4
//      outputs per thread, TF32 off: the scores decide the ranking) into
//      shared memory, and one warp per query keeps the chunk's top-k in a
//      list in global scratch: a candidate enters only if it beats the
//      list's current worst entry, which then is recomputed.  After the
//      list has filled, few candidates beat the running k-th value.
//   2. merge_kernel: one warp per (device, query) runs the same selection
//      over the non-empty chunk lists into a shared-memory list, then
//      orders it by rank (the number of entries before each one under the
//      total order, ties of identical sentinels broken by position).
//
// Bound on the H100: fp32 arithmetic outside the tensor cores, 2*Q*d
// operations per unmasked (query, row); the unmasked rows are read from
// device memory once per 64-query tile.
//
// Every score goes through the same fmaf sequence over d whatever its
// position in the tile, so identical rows score identically and ties
// break by index exactly as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSentinel = 0x7fffffff;
constexpr int kQT = 64;        // queries per block
constexpr int kRT = 64;        // rows per scored sub-tile
constexpr int kDepth = 16;     // d per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;   // rows per chunk list
constexpr int kMergeWarps = 4;

// true iff (va, ia) comes before (vb, ib) in the (-score, index) order
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The warp's current worst entry of a list of n (value, index) pairs:
// the last one in the total order (and, of equal ones, the highest
// position).  Every lane returns the same (value, index, position).
__device__ __forceinline__ void warp_worst(const float* v, const int* ix,
                                           int n, float& wv, int& wi,
                                           int& wp) {
  const int lane = threadIdx.x & 31;
  wv = 3.0e38f;
  wi = -1;
  wp = -1;
  for (int t = lane; t < n; t += 32) {
    const float a = v[t];
    const int b = ix[t];
    if (wp < 0 || before(wv, wi, a, b) || (a == wv && b == wi)) {
      wv = a;
      wi = b;
      wp = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
    const int op = __shfl_xor_sync(0xffffffffu, wp, off);
    const bool take = op >= 0 && (wp < 0 || before(wv, wi, ov, oi) ||
                                  (ov == wv && oi == wi && op > wp));
    if (take) {
      wv = ov;
      wi = oi;
      wp = op;
    }
  }
}

// Offer one candidate per lane to a warp-owned list (v, ix) of n entries
// of which `filled` are set; the list keeps the n best offers.  (wv, wi,
// wp) is its worst entry once it is full.  Only this warp touches the
// list; __syncwarp orders lane 0's writes before the other lanes' reads.
__device__ __forceinline__ void warp_offer(float cv, int ci, float* v,
                                           int* ix, int n, int& filled,
                                           float& wv, int& wi, int& wp) {
  const int lane = threadIdx.x & 31;
  // while the list has room every real candidate enters; after that only
  // those ahead of the current worst
  const bool real = before(cv, ci, kNegInf, kSentinel);
  const bool want = filled < n ? real : before(cv, ci, wv, wi);
  unsigned bits = __ballot_sync(0xffffffffu, want);
  while (bits) {
    const int src = __ffs(bits) - 1;
    bits &= bits - 1;
    const float sv = __shfl_sync(0xffffffffu, cv, src);
    const int si = __shfl_sync(0xffffffffu, ci, src);
    if (filled < n) {
      if (lane == 0) {
        v[filled] = sv;
        ix[filled] = si;
      }
      ++filled;
      __syncwarp();
      if (filled == n) warp_worst(v, ix, n, wv, wi, wp);
    } else if (before(sv, si, wv, wi)) {
      if (lane == 0) {
        v[wp] = sv;
        ix[wp] = si;
      }
      __syncwarp();
      warp_worst(v, ix, n, wv, wi, wp);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ stack,  // [P, k, block, d]
             const float* __restrict__ queries,  // [Q, d]
             const float* __restrict__ mask,     // [P, k, block]
             const int* __restrict__ gidx,       // [P, k, block]
             float* __restrict__ list_v,         // [P, Q, n_lists, topk]
             int* __restrict__ list_i,           // [P, Q, n_lists, topk]
             int* __restrict__ list_full,        // [P, n_lists]
             int k, int block, int d, int Q, int topk, int n_chunks,
             int l2) {
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
  const int warp = tid / 32, lane = tid % 32;

  bool any = false;
  for (int r = r_begin + tid; r < r_end; r += kThreads)
    any |= mask[slot_off + r] > 0.f;
  any = __syncthreads_or(any);
  if (tid == 0 && blockIdx.y == 0)
    list_full[(size_t)p * n_lists + list] = any ? 1 : 0;
  if (!any) return;  // a slot this device does not score: no work

  __shared__ float As[kDepth][kQT + 1];    // query slice, transposed
  __shared__ float Bs[kDepth][kRT + 1];    // row slice, transposed
  __shared__ float S[kQT][kRT + 1];        // masked scores of a sub-tile
  __shared__ int G[kRT];                   // masked global ids
  __shared__ float qn[kQT], xn[kRT];       // squared norms (l2)
  // per-query list state, owned by the warp that serves the query
  __shared__ float worst_v[kQT];
  __shared__ int worst_i[kQT], worst_p[kQT], filled[kQT];

  for (int q = tid; q < kQT; q += kThreads) {
    float s = 0.f;
    if (l2 && q0 + q < Q)
      for (int c = 0; c < d; ++c) {
        const float x = queries[(size_t)(q0 + q) * d + c];
        s = fmaf(x, x, s);
      }
    qn[q] = s;
    worst_v[q] = kNegInf;
    worst_i[q] = kSentinel;
    worst_p[q] = 0;
    filled[q] = 0;
  }
  // every list starts as topk sentinels: a chunk with fewer real rows
  // than topk leaves them in place
  for (int e = tid; e < kQT * topk; e += kThreads) {
    const int q = e / topk;
    if (q0 + q >= Q) continue;
    const size_t o = (((size_t)p * Q + q0 + q) * n_lists + list) * topk +
                     e % topk;
    list_v[o] = kNegInf;
    list_i[o] = kSentinel;
  }
  __syncthreads();

  for (int r0 = r_begin; r0 < r_end; r0 += kRT) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    float norm = 0.f;  // |x|^2 of row r0 + tid, threads 0..63
    for (int c0 = 0; c0 < d; c0 += kDepth) {
#pragma unroll
      for (int e = 0; e < kQT * kDepth / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int rr = idx / kDepth, cc = idx % kDepth;
        const bool okc = c0 + cc < d;
        As[cc][rr] = (okc && q0 + rr < Q)
                         ? queries[(size_t)(q0 + rr) * d + c0 + cc] : 0.f;
        Bs[cc][rr] = (okc && r0 + rr < r_end)
                         ? rows[(size_t)(r0 + rr) * d + c0 + cc] : 0.f;
      }
      __syncthreads();
      if (tid < kRT) {
#pragma unroll
        for (int cc = 0; cc < kDepth; ++cc)
          norm = fmaf(Bs[cc][tid], Bs[cc][tid], norm);
      }
#pragma unroll
      for (int cc = 0; cc < kDepth; ++cc) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[cc][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[cc][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kRT) {
      const int r = r0 + tid;
      const bool ok = r < r_end && mask[slot_off + r] > 0.f;
      xn[tid] = norm;
      G[tid] = ok ? gidx[slot_off + r] : kSentinel;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float s = acc[i][j];
        if (l2) s = (2.f * s - xn[r]) - qn[q];
        S[q][r] = G[r] == kSentinel ? kNegInf : s;
      }
    }
    __syncthreads();
    // selection: warp w serves queries w, w + 8, ...
    for (int q = warp; q < kQT; q += kWarps) {
      if (q0 + q >= Q) break;
      const size_t o = (((size_t)p * Q + q0 + q) * n_lists + list) * topk;
      int f = filled[q];
      float wv = worst_v[q];
      int wi = worst_i[q], wp = worst_p[q];
#pragma unroll
      for (int half = 0; half < kRT / 32; ++half) {
        const int r = half * 32 + lane;
        warp_offer(S[q][r], G[r], list_v + o, list_i + o, topk, f, wv, wi,
                   wp);
      }
      if (lane == 0) {
        filled[q] = f;
        worst_v[q] = wv;
        worst_i[q] = wi;
        worst_p[q] = wp;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ list_v,  // [P, Q, n_lists, topk]
             const int* __restrict__ list_i,
             const int* __restrict__ list_full,  // [P, n_lists]
             float* __restrict__ out_v,          // [P, Q, topk]
             int* __restrict__ out_i, int Q, int topk, int n_lists) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.y;
  const int q = blockIdx.x * kMergeWarps + warp;
  float* v = reinterpret_cast<float*>(smem) + (size_t)warp * topk;
  int* ix = reinterpret_cast<int*>(smem) + (size_t)kMergeWarps * topk +
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
  score_kernel<<<grid1, kThreads, 0, s>>>(
      (const float*)stack, (const float*)queries, (const float*)mask,
      (const int*)gidx, (float*)list_v, (int*)list_i, (int*)list_full, k,
      block, d, Q, topk, n_chunks, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kMergeWarps * topk * (sizeof(float) + sizeof(int));
  const dim3 grid2((Q + kMergeWarps - 1) / kMergeWarps, P);
  merge_kernel<<<grid2, kMergeWarps * 32, smem, s>>>(
      (const float*)list_v, (const int*)list_i, (const int*)list_full,
      (float*)out_v, (int*)out_i, Q, topk, k * n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int repro_query_topk_chunk_rows() { return kChunk; }
