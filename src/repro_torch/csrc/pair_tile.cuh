// Shared pieces of the pair-tile kernels B7 pairwise_threshold_q and B8
// pairwise_topk_q (their SIMT routes): the 64 x 64 SIMT score tile over
// operands of any storage type, and B8's running top-k lists; and the
// final ordering of the lists (order_kernel), which B6 pairwise_topk and
// both B8 routes use.
//
// Score tile.  Every entry is one fmaf chain over d in ascending order,
// so the dot of rows (u, v) is the same bit pattern whichever of them is
// the tile's row (fmaf(a, b, c) == fmaf(b, a, c)) and wherever it sits in
// the tile.  Codes are widened to float32 as they land in shared memory
// (exact for int8 and bf16).
//
// Running lists.  One warp owns a row's list of n entries in global
// memory (topk_select.cuh's warp_offer); order_kernel sorts each list at
// the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "topk_select.cuh"

namespace pair_tile {

using compact::load_meta;
using compact::Meta;
using topk_select::before;
using topk_select::kNegInf;
using topk_select::kSentinel;
using topk_select::warp_offer;

constexpr int kTile = 64;      // rows and columns of a score tile
constexpr int kDepth = 16;     // d per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kWarps = kThreads / 32;
constexpr int kOrderWarps = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct TileSmem {
  float As[kDepth][kTile + 1];  // row slice, transposed
  float Bs[kDepth][kTile + 1];  // column slice, transposed
};

// acc[i][j] = sum over c of A[ty + 16 i][c] * B[tx + 16 j][c] for the
// a_rows rows of A and b_rows rows of B given (the rest read as 0), one
// fmaf per c in ascending order.  With bnorm, threads 0..63 also leave
// |B row tid|^2 there, accumulated in the same order.  Every thread of
// the block must call it (it synchronizes).
template <typename T>
__device__ __forceinline__ void tile_dots(const T* __restrict__ A, int a_rows,
                                          const T* __restrict__ B, int b_rows,
                                          int d, TileSmem& sm,
                                          float (&acc)[4][4], float* bnorm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;
  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int e = 0; e < kTile * kDepth / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int rr = idx / kDepth, kk = idx % kDepth;
      const bool okk = k0 + kk < d;
      sm.As[kk][rr] =
          (okk && rr < a_rows) ? to_f32(A[(size_t)rr * d + k0 + kk]) : 0.f;
      sm.Bs[kk][rr] =
          (okk && rr < b_rows) ? to_f32(B[(size_t)rr * d + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (bnorm != nullptr && tid < kTile) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk)
        norm = fmaf(sm.Bs[kk][tid], sm.Bs[kk][tid], norm);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (bnorm != nullptr && tid < kTile) bnorm[tid] = norm;
}

// |row|^2 of one row, the same fmaf chain tile_dots uses for bnorm
template <typename T>
__device__ __forceinline__ float row_norm(const T* __restrict__ x, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) {
    const float v = to_f32(x[c]);
    s = fmaf(v, v, s);
  }
  return s;
}

// B8's SIMT selection pass.  One block per (device p, slot, 64-row tile)
// walks the pairs in order and folds every active tile that touches its
// slot into its rows' lists: as the lo slot it scores the hi block's
// valid rows (minus the diagonal on a self tile), as the hi slot of a
// non-self tile the lo block's valid rows.  Scores are
// (2 dot - |cand|^2) - |row|^2 for l2, dot times s_lo * s_hi when kQuant
// (codes with per-slot scales sd[.., 0] and stored norms sq), else the
// plain dot with norms from the same fmaf chain as the dots.  Lists are
// [P, k, block, tp], the first topk entries of each in use.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const T* __restrict__ quorum,   // [P, k, block, d]
                   const float* __restrict__ sd,   // [P, k, 2] (kQuant)
                   const float* __restrict__ sq,   // [P, k, block] (kQuant)
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   const int* __restrict__ meta,   // [P, n_pairs, 6]
                   float* __restrict__ list_v,     // [P, k, block, tp]
                   int* __restrict__ list_i, int k, int block, int d,
                   int n_pairs, int block_rows, int topk, int tp, int l2) {
  const int p = blockIdx.z;
  const int slot = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int rows = min(kTile, block - r0);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t slot_off = ((size_t)p * k + slot) * block;
  const T* __restrict__ R = quorum + (slot_off + r0) * d;

  __shared__ TileSmem sm;
  __shared__ float S[kTile][kTile + 1];  // scores of the current tile
  __shared__ int G[kTile];               // candidate ids (sentinel: none)
  __shared__ float rn[kTile], cn[kTile];
  __shared__ float worst_v[kTile];
  __shared__ int worst_i[kTile], worst_p[kTile], filled[kTile];

  for (int e = tid; e < rows * tp; e += kThreads) {
    const size_t o = (slot_off + r0 + e / tp) * tp + e % tp;
    list_v[o] = kNegInf;
    list_i[o] = kSentinel;
  }
  if (tid < kTile) {
    float s = 0.f;
    if (l2 && tid < rows)
      s = kQuant ? sq[slot_off + r0 + tid] : row_norm(R + (size_t)tid * d, d);
    rn[tid] = s;
    worst_v[tid] = kNegInf;
    worst_i[tid] = kSentinel;
    worst_p[tid] = 0;
    filled[tid] = 0;
  }
  __syncthreads();

  for (int pair = 0; pair < n_pairs; ++pair) {
    const Meta m = load_meta(meta + ((size_t)p * n_pairs + pair) * 6);
    if (m.active != 1) continue;
    const int l = lo[pair], h = hi[pair];
    for (int side = 0; side < 2; ++side) {
      int other, g, nv_o;
      bool excl;
      if (side == 0) {
        if (l != slot) continue;
        other = h, g = m.gb, nv_o = m.nv_hi, excl = m.is_self == 1;
      } else {
        if (h != slot || m.is_self == 1) continue;
        other = l, g = m.ga, nv_o = m.nv_lo, excl = false;
      }
      const float sprod =
          kQuant ? sd[((size_t)p * k + l) * 2] * sd[((size_t)p * k + h) * 2]
                 : 1.f;
      const size_t o_off = ((size_t)p * k + other) * block;
      for (int c0 = 0; c0 < nv_o; c0 += kTile) {
        float acc[4][4];
        const int cols = min(kTile, nv_o - c0);
        tile_dots<T>(R, rows, quorum + (o_off + c0) * d, cols, d, sm, acc,
                     (kQuant || !l2) ? nullptr : cn);
        if (tid < kTile) {
          if (kQuant && l2) cn[tid] = tid < cols ? sq[o_off + c0 + tid] : 0.f;
          G[tid] = tid < cols ? g * block_rows + c0 + tid : kSentinel;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cl = tx + 16 * j;
            float s = acc[i][j];
            if (kQuant) s = s * sprod;
            if (l2) s = (2.f * s - cn[cl]) - rn[rl];
            S[rl][cl] = s;
          }
        }
        __syncthreads();
        // selection: warp w serves rows w, w + 8, ...
        for (int rl = warp; rl < rows; rl += kWarps) {
          const size_t o = (slot_off + r0 + rl) * tp;
          int f = filled[rl];
          float wv = worst_v[rl];
          int wi = worst_i[rl], wp = worst_p[rl];
#pragma unroll
          for (int half = 0; half < kTile / 32; ++half) {
            const int cl = half * 32 + lane;
            int ci = G[cl];
            if (excl && r0 + rl == c0 + cl) ci = kSentinel;
            const float cv = ci == kSentinel ? kNegInf : S[rl][cl];
            warp_offer(cv, ci, list_v + o, list_i + o, topk, f, wv, wi, wp);
          }
          if (lane == 0) {
            filled[rl] = f;
            worst_v[rl] = wv;
            worst_i[rl] = wi;
            worst_p[rl] = wp;
          }
        }
        __syncthreads();
      }
    }
  }
}

// One warp per list: a bitonic sort of the tp (a power of two) entries
// under the (-score, index) order, in shared memory when a list fits
// (smem_tp >= tp) and in place in global memory otherwise; then the first
// topk entries are written out.
static __global__ void __launch_bounds__(kOrderWarps * 32)
order_kernel(float* __restrict__ list_v, int* __restrict__ list_i,
             float* __restrict__ out_v, int* __restrict__ out_i,
             long long n_lists, int topk, int tp, int smem_tp) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kOrderWarps + warp;
  if (row >= n_lists) return;  // whole warps only: no block barrier below
  float* gv = list_v + (size_t)row * tp;
  int* gi = list_i + (size_t)row * tp;
  float* v = gv;
  int* ix = gi;
  if (smem_tp >= tp) {
    v = reinterpret_cast<float*>(smem) + (size_t)warp * smem_tp;
    ix = reinterpret_cast<int*>(smem) + (size_t)kOrderWarps * smem_tp +
         (size_t)warp * smem_tp;
    for (int t = lane; t < tp; t += 32) {
      v[t] = gv[t];
      ix[t] = gi[t];
    }
  }
  __syncwarp();
  for (int size = 2; size <= tp; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = lane; t < tp / 2; t += 32) {
        const int a = 2 * stride * (t / stride) + t % stride;
        const int b = a + stride;
        const float va = v[a], vb = v[b];
        const int ia = ix[a], ib = ix[b];
        const bool up = (a & size) == 0;
        if (up ? before(vb, ib, va, ia) : before(va, ia, vb, ib)) {
          v[a] = vb;
          ix[a] = ib;
          v[b] = va;
          ix[b] = ia;
        }
      }
      __threadfence_block();
      __syncwarp();
    }
  }
  for (int t = lane; t < topk; t += 32) {
    out_v[(size_t)row * topk + t] = v[t];
    out_i[(size_t)row * topk + t] = ix[t];
  }
}

// Sort the n_lists lists of tp entries and write their first topk.
inline int launch_order(float* list_v, int* list_i, float* out_v, int* out_i,
                        long long n_lists, int topk, int tp, cudaStream_t s) {
  // lists of up to 1024 entries are sorted in shared memory (32 KB)
  const int smem_tp = tp <= 1024 ? tp : 0;
  const size_t smem = (size_t)kOrderWarps * smem_tp * (sizeof(float) + sizeof(int));
  const long long blocks = (n_lists + kOrderWarps - 1) / kOrderWarps;
  order_kernel<<<(unsigned)blocks, kOrderWarps * 32, smem, s>>>(
      list_v, list_i, out_v, out_i, n_lists, topk, tp, smem_tp);
  return (int)cudaGetLastError();
}

// Launch both passes of B8 (SIMT); returns the first CUDA error.
template <typename T, bool kQuant>
inline int launch_topk(const T* quorum, const float* sd, const float* sq,
                       const int* lo, const int* hi, const int* meta,
                       float* list_v, int* list_i, float* out_v, int* out_i,
                       int P, int k, int block, int d, int n_pairs,
                       int block_rows, int topk, int tp, int l2,
                       cudaStream_t s) {
  const dim3 grid((block + kTile - 1) / kTile, k, P);
  topk_select_kernel<T, kQuant><<<grid, kThreads, 0, s>>>(
      quorum, sd, sq, lo, hi, meta, list_v, list_i, k, block, d, n_pairs,
      block_rows, topk, tp, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_order(list_v, list_i, out_v, out_i, (long long)P * k * block,
                      topk, tp, s);
}

}  // namespace pair_tile
