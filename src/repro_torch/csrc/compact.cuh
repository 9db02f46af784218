// The ordered compaction of the thresholded pair kernels B5
// pairwise_threshold and B7 pairwise_threshold_q (both routes).
//
// The TPU kernels walk the pairs in order on their sequential grid with a
// running count in SMEM.  Hopper's blocks run in no order, and an atomic
// cursor would scramble which entries survive an overflow, so the order is
// made explicit: one block per (device, pair, strip of rows) and three
// launches.
//
//   1. count: the block scores its strip's column tiles (on a self tile,
//      only those from its diagonal on) and writes each row's survivor
//      count, and one bit per column tile that held a survivor in any row
//      (the hot tiles, HotWriter);
//   2. scan_kernel: one block per device turns the counts into exclusive
//      offsets in (pair, row) order, writes the true count, and fills the
//      unused tail of the buffers with (NEG_INF, IDX_SENTINEL);
//   3. write: the block scores again only its strip's hot tiles, in column
//      order (HotWalk), and puts a survivor at its row's offset plus the
//      survivors left of it.  A skipped tile held no survivor in any row,
//      so every rank is unchanged and the overflow prefix stays exact.  A
//      strip whose first offset is past capacity writes nothing and exits.
//
// No atomic cursor, no float atomics: a survivor's position depends only
// on the inputs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace compact {

constexpr float kNegInf = -1e30f;  // ref.NEG_INF
constexpr int kSentinel = 0x7fffffff;  // ref.IDX_SENTINEL
constexpr int kScanThreads = 1024;

// a scheduled slot pair's meta row (also pair_tile.cuh's, for B6 / B8)
struct Meta {
  int active, is_self, ga, gb, nv_lo, nv_hi;
};

__device__ __forceinline__ Meta load_meta(const int* m) {
  return Meta{m[0], m[1], m[2], m[3], m[4], m[5]};
}

// 32-bit words of hot bits per strip: one bit per column tile of `tile`
// rows of a block of `block` rows
__host__ __device__ __forceinline__ int hot_words(int block, int tile) {
  return ((block + tile - 1) / tile + 31) / 32;
}

// Count pass: one thread of the block records, in increasing column-tile
// order, whether each visited tile held a survivor; finish() writes the
// strip's remaining words (tiles never visited are cold).
struct HotWriter {
  uint32_t* out;
  int n_words, wi;
  uint32_t word;
  __device__ __forceinline__ HotWriter(uint32_t* o, int n)
      : out(o), n_words(n), wi(0), word(0u) {}
  __device__ __forceinline__ void mark(int ct, bool hot) {
    while (wi < ct / 32) {
      out[wi++] = word;
      word = 0u;
    }
    if (hot) word |= 1u << (ct % 32);
  }
  __device__ __forceinline__ void finish() {
    while (wi < n_words) {
      out[wi++] = word;
      word = 0u;
    }
  }
};

// The column tiles a strip visits, in order: every tile in [ct, end) in
// the count pass (hot == false), the strip's hot tiles in the write pass.
// ct is -1 once the walk is done.  Every thread of the block walks the
// same sequence (the loads are uniform).
struct Tiles {
  int ct, end;
  const uint32_t* bits;
  int n_words, wi;
  uint32_t cur;
  bool hot;

  __device__ __forceinline__ static Tiles count(int first, int end) {
    Tiles t{first, end, nullptr, 0, 0, 0u, false};
    if (first >= end) t.ct = -1;
    return t;
  }
  __device__ __forceinline__ static Tiles written(const uint32_t* bits,
                                                  int n_words) {
    Tiles t{-1, 0, bits, n_words, -1, 0u, true};
    t.advance();
    return t;
  }
  __device__ __forceinline__ void advance() {
    if (!hot) {
      ct = ct + 1 < end ? ct + 1 : -1;
      return;
    }
    while (cur == 0u) {
      if (++wi >= n_words) {
        ct = -1;
        return;
      }
      cur = bits[wi];
    }
    ct = wi * 32 + __ffs(cur) - 1;
    cur &= cur - 1u;
  }
};

// A position in the walk over (column tile, d slice); the loader of a
// cp.async ring runs one ahead of the consumer with its own cursor.
struct Cursor {
  Tiles t;
  int ks, nks;
  __device__ __forceinline__ bool done() const { return t.ct < 0; }
  __device__ __forceinline__ void step() {
    if (++ks < nks) return;
    ks = 0;
    t.advance();
  }
};

// exclusive offsets of the per-row counts [P, n] in (pair, row) order, the
// true count (clamped to int32), and sentinels in the unused tail
static __global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ row_count,  // [P, n]
            long long* __restrict__ row_off,    // [P, n]
            int* __restrict__ count,            // [P]
            float* __restrict__ out_v, int* __restrict__ out_i,
            int* __restrict__ out_j, int n, long long capacity) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int seg = (n + kScanThreads - 1) / kScanThreads;
  const int b = min(n, tid * seg), e = min(n, b + seg);
  const int* c = row_count + (size_t)p * n;
  long long sum = 0;
  for (int t = b; t < e; ++t) sum += c[t];
  // exclusive scan of the 1024 segment sums: warp scans, then the warps'
  __shared__ long long warp_tot[kScanThreads / 32];
  __shared__ long long total;
  const int lane = tid % 32, warp = tid / 32;
  long long incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = warp_tot[lane];
    long long wincl = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, wincl, off);
      if (lane >= off) wincl += o;
    }
    warp_tot[lane] = wincl - w;  // exclusive
    if (lane == 31) total = wincl;
  }
  __syncthreads();
  long long run = warp_tot[warp] + incl - sum;
  long long* o = row_off + (size_t)p * n;
  for (int t = b; t < e; ++t) {
    o[t] = run;
    run += c[t];
  }
  const long long tot = total;
  if (tid == 0) count[p] = (int)min(tot, (long long)0x7fffffff);
  for (long long t = min(tot, capacity) + tid; t < capacity;
       t += kScanThreads) {
    out_v[(size_t)p * capacity + t] = kNegInf;
    out_i[(size_t)p * capacity + t] = kSentinel;
    out_j[(size_t)p * capacity + t] = kSentinel;
  }
}

inline cudaError_t launch_scan(const int* row_count, long long* row_off,
                               int* count, float* out_v, int* out_i,
                               int* out_j, int P, int n, long long capacity,
                               cudaStream_t s) {
  scan_kernel<<<P, kScanThreads, 0, s>>>(row_count, row_off, count, out_v,
                                         out_i, out_j, n, capacity);
  return cudaGetLastError();
}

}  // namespace compact
