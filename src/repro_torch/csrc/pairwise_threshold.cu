// B5: fused thresholded scoring + sparse compaction (replaces the Pallas
// kernel repro/kernels/pairwise_threshold.py:pairwise_threshold_pallas,
// body _threshold_kernel).
//
// For every simulated device p and scheduled slot pair (lo, hi) whose
// meta row (active, is_self, ga, gb, nv_lo, nv_hi) is active, the
// [block, block] tile of scores between slots lo (rows) and hi (columns)
// is formed (dot, or the l2 score 2 x.y - |y|^2 - |x|^2), and every entry
// with score >= threshold, row < nv_lo, col < nv_hi and, on a self tile,
// row < col is emitted as (score, min(gi, gj), max(gi, gj)) with
// g = ga * block_rows + row and gb * block_rows + col.  Entries land in
// (pair, row, col) order in [capacity] buffers; those past capacity are
// dropped while the count keeps the true total.
//
// Design.  The TPU kernel walks the pairs in order on its sequential grid
// with a running count in SMEM.  Hopper's blocks run in no order, and an
// atomic cursor would scramble which entries survive an overflow, so the
// order is made explicit in three passes:
//
//   1. tile_kernel<false>: one block per (device, pair, 64-row strip)
//      walks the strip's 64-column tiles (on a self tile, only those
//      right of the diagonal) with a SIMT fp32 GEMM (4 x 4 outputs per
//      thread, TF32 off: the scores are threshold decisions) and counts
//      the survivors of each row;
//   2. scan_kernel: one block per device turns the counts into exclusive
//      offsets in (pair, row) order, writes the true count, and fills the
//      unused tail of the buffers with (NEG_INF, IDX_SENTINEL);
//   3. tile_kernel<true>: the same tiles again; within a row, a survivor's
//      position is the row's offset plus the survivors left of it (warp
//      ballots over the 16 threads that share the row).
//
// An inactive tile, or a strip past nv_lo, exits at once in both tile
// passes.  Bound on the H100: fp32 arithmetic outside the tensor cores,
// 2*d operations per candidate of an active tile; this first version
// scores every active tile twice (count, then write).

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSentinel = 0x7fffffff;
constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;  // 16 x 16, each 4 rows x 4 columns
constexpr int kScanThreads = 1024;

struct Meta {
  int active, is_self, ga, gb, nv_lo, nv_hi;
};

template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ quorum,  // [P, k, block, d]
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ meta,       // [P, n_pairs, 6]
            int* __restrict__ row_count,        // [P, n_pairs, block]
            const long long* __restrict__ row_off,  // [P, n_pairs, block]
            float* __restrict__ out_v,          // [P, capacity]
            int* __restrict__ out_i, int* __restrict__ out_j, int k,
            int block, int d, int n_pairs, int block_rows, float thr,
            long long capacity, int l2) {
  const int p = blockIdx.z;
  const int pair = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32;
  const int* mrow = meta + ((size_t)p * n_pairs + pair) * 6;
  const Meta m{mrow[0], mrow[1], mrow[2], mrow[3], mrow[4], mrow[5]};
  const size_t strip = ((size_t)p * n_pairs + pair) * block + r0;

  if (m.active != 1 || r0 >= m.nv_lo) {
    if (!kWrite)
      for (int r = tid; r < kTile && r0 + r < block; r += kThreads)
        row_count[strip + r] = 0;
    return;
  }
  const float* __restrict__ A = quorum + ((size_t)p * k + lo[pair]) * block * d;
  const float* __restrict__ B = quorum + ((size_t)p * k + hi[pair]) * block * d;

  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Bs[kDepth][kTile + 1];
  __shared__ float rn[kTile], cn[kTile];  // squared norms (l2)

  // squared norms of the strip's rows (sequential fmaf over d)
  if (tid < kTile) {
    float s = 0.f;
    if (l2 && r0 + tid < block)
      for (int c = 0; c < d; ++c) {
        const float x = A[(size_t)(r0 + tid) * d + c];
        s = fmaf(x, x, s);
      }
    rn[tid] = s;
  }
  long long base[4];
  int n_row[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    base[i] = (kWrite && r < block) ? row_off[strip + ty + 16 * i] : 0;
  }
  const unsigned half_shift = lane & 16;  // this half-warp's ballot bits
  const unsigned below = (1u << (lane & 15)) - 1u;
  // a self tile keeps only row < col: start at the strip's diagonal tile
  const int c_begin = m.is_self == 1 ? r0 : 0;

  for (int c0 = c_begin; c0 < m.nv_hi; c0 += kTile) {
    float acc[4][4];
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
        As[kk][rr] = (okk && r0 + rr < block)
                         ? A[(size_t)(r0 + rr) * d + k0 + kk] : 0.f;
        Bs[kk][rr] = (okk && c0 + rr < block)
                         ? B[(size_t)(c0 + rr) * d + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (tid < kTile) {
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk)
          norm = fmaf(Bs[kk][tid], Bs[kk][tid], norm);
      }
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kTile) cn[tid] = norm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int r = r0 + rl;
      int left = 0;  // survivors of this row in the tile's earlier columns
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int c = c0 + cl;
        float s = acc[i][j];
        if (l2) s = (2.f * s - cn[cl]) - rn[rl];
        const bool keep = s >= thr && r < m.nv_lo && c < m.nv_hi &&
                          (m.is_self != 1 || r < c);
        const unsigned bits =
            (__ballot_sync(0xffffffffu, keep) >> half_shift) & 0xffffu;
        if (kWrite && keep) {
          const long long pos = base[i] + left + __popc(bits & below);
          if (pos < capacity) {
            const int gi = m.ga * block_rows + r;
            const int gj = m.gb * block_rows + c;
            out_v[(size_t)p * capacity + pos] = s;
            out_i[(size_t)p * capacity + pos] = min(gi, gj);
            out_j[(size_t)p * capacity + pos] = max(gi, gj);
          }
        }
        left += __popc(bits);
      }
      base[i] += left;
      n_row[i] += left;
    }
    __syncthreads();  // cn is rewritten by the next tile
  }
  if (!kWrite) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (tx == 0 && r0 + ty + 16 * i < block)
        row_count[strip + ty + 16 * i] = n_row[i];
  }
}

__global__ void __launch_bounds__(kScanThreads)
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
    long long w = warp_tot[lane];
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
  for (long long t = min(tot, capacity) + tid; t < capacity; t += kScanThreads) {
    out_v[(size_t)p * capacity + t] = kNegInf;
    out_i[(size_t)p * capacity + t] = kSentinel;
    out_j[(size_t)p * capacity + t] = kSentinel;
  }
}

}  // namespace

extern "C" int repro_pairwise_threshold(
    const void* quorum, const void* lo, const void* hi, const void* meta,
    void* row_count, void* row_off, void* out_v, void* out_i, void* out_j,
    void* count, int P, int k, int block, int d, int n_pairs,
    int block_rows, float threshold, long long capacity, int l2,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((block + kTile - 1) / kTile, n_pairs, P);
  tile_kernel<false><<<grid, kThreads, 0, s>>>(
      (const float*)quorum, (const int*)lo, (const int*)hi, (const int*)meta,
      (int*)row_count, nullptr, nullptr, nullptr, nullptr, k, block, d,
      n_pairs, block_rows, threshold, capacity, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<P, kScanThreads, 0, s>>>(
      (const int*)row_count, (long long*)row_off, (int*)count, (float*)out_v,
      (int*)out_i, (int*)out_j, n_pairs * block, capacity);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_kernel<true><<<grid, kThreads, 0, s>>>(
      (const float*)quorum, (const int*)lo, (const int*)hi, (const int*)meta,
      nullptr, (const long long*)row_off, (float*)out_v, (int*)out_i,
      (int*)out_j, k, block, d, n_pairs, block_rows, threshold, capacity, l2);
  return (int)cudaGetLastError();
}
