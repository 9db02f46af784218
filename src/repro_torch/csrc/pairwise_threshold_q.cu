// B7: quantized thresholded scoring + sparse compaction with the widened
// keep band (replaces the Pallas kernel
// repro/kernels/pairwise_batch_q.py:pairwise_threshold_q_pallas, body
// _threshold_q_kernel).
//
// B5 (pairwise_threshold.cu) over int8 or bf16 codes.  For every device p
// and active slot pair (lo, hi) the tile entry is the code dot widened to
// float32 times s_lo * s_hi (sd[.., 0]); l2 subtracts the exact stored
// squared norms: (2 s - sq_hi) - sq_lo.  An entry is kept when
// s >= thr - eps, row < nv_lo, col < nv_hi and (self tile) row < col, with
// the certified bound of ref.quant_eps_tile in its expression order:
//   eps = d_lo*l1_hi + d_hi*l1_lo + 3*d*d_lo*d_hi + FP_REL*(l1_lo*l1_hi+1)
// (doubled for l2; deltas sd[.., 1], l1 the rows' L1 norms).  Survivors
// land as (score, min gid, max gid) in (pair, row, col) order in
// [capacity] buffers; past capacity they are dropped and the count keeps
// the true total.
//
// Design: B5's three passes (count per row, exclusive scan per device,
// write at the row offset plus the rank within the row), never an atomic
// cursor, so an overflowing buffer keeps exactly the plain version's
// prefix.  The file is compiled with -fmad=false: the epilogue and eps
// round op for op as the plain version's, and int8 dots are exact (every
// partial sum < 2^24 at d = 128), so the int8 band and its overflow
// prefix equal the plain version's.
//
// Bound on the H100: 2*d operations per candidate of an active tile at
// the int8 (bf16) tensor-core rate; this SIMT kernel runs the float32
// pipe and scores every active tile twice (count, then write).

#include "pair_tile.cuh"

namespace {

using namespace pair_tile;

constexpr int kScanThreads = 1024;
constexpr float kFpRel = 1e-6f;  // ref.FP_REL

template <typename T, bool kWrite>
__global__ void __launch_bounds__(kThreads)
band_kernel(const T* __restrict__ q,          // [P, k, block, d]
            const float* __restrict__ sd,     // [P, k, 2] (scale, delta)
            const float* __restrict__ l1,     // [P, k, block]
            const float* __restrict__ sq,     // [P, k, block]
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ meta,     // [P, n_pairs, 6]
            int* __restrict__ row_count,      // [P, n_pairs, block]
            const long long* __restrict__ row_off,  // [P, n_pairs, block]
            float* __restrict__ out_v,        // [P, capacity]
            int* __restrict__ out_i, int* __restrict__ out_j, int k,
            int block, int d, int n_pairs, int block_rows, float thr,
            long long capacity, int l2) {
  const int p = blockIdx.z;
  const int pair = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32;
  const Meta m = load_meta(meta + ((size_t)p * n_pairs + pair) * 6);
  const size_t strip = ((size_t)p * n_pairs + pair) * block + r0;

  if (m.active != 1 || r0 >= m.nv_lo) {
    if (!kWrite)
      for (int r = tid; r < kTile && r0 + r < block; r += kThreads)
        row_count[strip + r] = 0;
    return;
  }
  const int l = lo[pair], h = hi[pair];
  const size_t lo_off = ((size_t)p * k + l) * block;
  const size_t hi_off = ((size_t)p * k + h) * block;
  const float s_lo = sd[((size_t)p * k + l) * 2];
  const float d_lo = sd[((size_t)p * k + l) * 2 + 1];
  const float s_hi = sd[((size_t)p * k + h) * 2];
  const float d_hi = sd[((size_t)p * k + h) * 2 + 1];
  const float sprod = s_lo * s_hi;
  const float c3 = 3.0f * (float)d;
  const int rows = min(kTile, block - r0);

  __shared__ TileSmem sm;
  __shared__ float rn[kTile], cn[kTile], rl1[kTile], cl1[kTile];
  if (tid < kTile) {
    rn[tid] = tid < rows ? sq[lo_off + r0 + tid] : 0.f;
    rl1[tid] = tid < rows ? l1[lo_off + r0 + tid] : 0.f;
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
    const int cols = min(kTile, m.nv_hi - c0);
    float acc[4][4];
    tile_dots<T>(q + (lo_off + r0) * d, rows, q + (hi_off + c0) * d, cols, d,
                 sm, acc, nullptr);
    if (tid < kTile) {
      cn[tid] = tid < cols ? sq[hi_off + c0 + tid] : 0.f;
      cl1[tid] = tid < cols ? l1[hi_off + c0 + tid] : 0.f;
    }
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
        float s = acc[i][j] * sprod;
        if (l2) s = (2.f * s - cn[cl]) - rn[rl];
        float eps = d_lo * cl1[cl] + d_hi * rl1[rl] + c3 * d_lo * d_hi +
                    kFpRel * (rl1[rl] * cl1[cl] + 1.f);
        if (l2) eps = 2.f * eps;
        const bool keep = s >= thr - eps && r < m.nv_lo && c < m.nv_hi &&
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
    __syncthreads();  // cn / cl1 are rewritten by the next tile
  }
  if (!kWrite) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (tx == 0 && r0 + ty + 16 * i < block)
        row_count[strip + ty + 16 * i] = n_row[i];
  }
}

// exclusive offsets of the per-row counts in (pair, row) order, the true
// count, and sentinels in the unused tail (B5's scan)
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
  for (long long t = min(tot, capacity) + tid; t < capacity; t += kScanThreads) {
    out_v[(size_t)p * capacity + t] = kNegInf;
    out_i[(size_t)p * capacity + t] = kSentinel;
    out_j[(size_t)p * capacity + t] = kSentinel;
  }
}

template <typename T>
int launch(const void* q, const void* sd, const void* l1, const void* sq,
           const void* lo, const void* hi, const void* meta, void* row_count,
           void* row_off, void* out_v, void* out_i, void* out_j, void* count,
           int P, int k, int block, int d, int n_pairs, int block_rows,
           float threshold, long long capacity, int l2, cudaStream_t s) {
  const dim3 grid((block + kTile - 1) / kTile, n_pairs, P);
  band_kernel<T, false><<<grid, kThreads, 0, s>>>(
      (const T*)q, (const float*)sd, (const float*)l1, (const float*)sq,
      (const int*)lo, (const int*)hi, (const int*)meta, (int*)row_count,
      nullptr, nullptr, nullptr, nullptr, k, block, d, n_pairs, block_rows,
      threshold, capacity, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<P, kScanThreads, 0, s>>>(
      (const int*)row_count, (long long*)row_off, (int*)count, (float*)out_v,
      (int*)out_i, (int*)out_j, n_pairs * block, capacity);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  band_kernel<T, true><<<grid, kThreads, 0, s>>>(
      (const T*)q, (const float*)sd, (const float*)l1, (const float*)sq,
      (const int*)lo, (const int*)hi, (const int*)meta, nullptr,
      (const long long*)row_off, (float*)out_v, (int*)out_i, (int*)out_j, k,
      block, d, n_pairs, block_rows, threshold, capacity, l2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_pairwise_threshold_q(
    const void* q, const void* sd, const void* l1, const void* sq,
    const void* lo, const void* hi, const void* meta, void* row_count,
    void* row_off, void* out_v, void* out_i, void* out_j, void* count, int P,
    int k, int block, int d, int n_pairs, int block_rows, float threshold,
    long long capacity, int l2, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, sd, l1, sq, lo, hi, meta, row_count,
                                 row_off, out_v, out_i, out_j, count, P, k,
                                 block, d, n_pairs, block_rows, threshold,
                                 capacity, l2, s);
  return launch<int8_t>(q, sd, l1, sq, lo, hi, meta, row_count, row_off,
                        out_v, out_i, out_j, count, P, k, block, d, n_pairs,
                        block_rows, threshold, capacity, l2, s);
}
