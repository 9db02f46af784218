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
// Bound on the H100: fp32 arithmetic outside the tensor cores, 2*d
// operations per candidate of an active tile (67 TFLOP/s).  The f32
// scores decide the threshold, so no TF32: every score is one fmaf chain
// over d in ascending order, and so is every squared norm (row_norms.cuh,
// once per slot row, not per strip and per tile).
//
// Design.  compact.cuh's count -> scan -> write, one block of 128 threads
// per (device, pair, 128-row strip): an inactive pair, or a strip past
// nv_lo, exits at once.  The block scores 128 x 128 tiles as B2's GEMM
// (pairwise_corr.cu) does: 8 x 16 scores a thread (rows ty + 16 i,
// columns tx + 8 j), 32-deep d slices of the strip's rows and the tile's
// columns through a 3-stage 16-byte cp.async ring in dynamic shared memory
// (zero fill past the rows and d; plain loads where d or the base is not
// 16-byte aligned), two blocks an SM.  The ring runs on across tiles, so
// the next tile loads while this one's epilogue runs.  The count pass
// walks every tile from the strip's diagonal (self tile) or from column 0,
// adds each row's survivors (8 lanes share a row: three shuffles) and
// marks the hot tiles; the write pass walks the hot tiles only and ranks
// a survivor within its row by a ballot over the row's 8 lanes, column
// tile by column tile (columns tx + 8 j: j-major, then tx).  Interior
// tiles skip the row / column / diagonal masks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "hopper.cuh"
#include "row_norms.cuh"

namespace {

using namespace hopper;
using compact::Cursor;
using compact::Meta;
using compact::Tiles;

constexpr int kTile = 128;        // strip rows, tile columns
constexpr int kDepth = 32;        // d per ring stage
constexpr int kLd = kDepth + 4;   // row stride in shared memory (floats)
constexpr int kStages = 3;
constexpr int kThreads = 128;     // 16 x 8, each 8 rows x 16 columns
constexpr int kStageFloats = 2 * kTile * kLd;
constexpr int kRingBytes = kStages * kStageFloats * (int)sizeof(float);
static_assert(kThreads == kTile, "one thread per strip row and tile column");

struct Epi {
  long long pos[kTile];  // write pass: each row's next position
  int cnt[kTile];        // count pass: each row's survivors so far
  float rn[kTile];       // |row|^2 of the strip (l2)
  float cn[kTile];       // |column|^2 of the tile (l2)
};
constexpr int kSmemBytes = kRingBytes + (int)sizeof(Epi);

// the d slice [k0, k0 + 32) of strip rows A[0, a_rows) (ring rows
// 0..127) and tile rows B[0, b_rows) (ring rows 128..255) into the stage
// at dst, zeros past the rows and d
template <bool kVec>
__device__ __forceinline__ void load_stage(uint32_t dst,
                                           const float* __restrict__ A,
                                           int a_rows,
                                           const float* __restrict__ B,
                                           int b_rows, int k0, int d,
                                           int tid) {
#pragma unroll
  for (int e = 0; e < kTile * kDepth / 4 / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / (kDepth / 4), c = idx % (kDepth / 4);
    const int gk = k0 + 4 * c;
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      const float* g = op ? B : A;
      const bool row_ok = r < (op ? b_rows : a_rows);
      const float* src = g + (size_t)(row_ok ? r : 0) * d + gk;
      const uint32_t dd =
          dst + (uint32_t)((op * kTile + r) * kLd + 4 * c) * 4u;
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
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// kVec: 16-byte copies (d % 4 == 0, 16-byte-aligned base), else plain
// loads.  kWrite: the write pass (hot tiles only), else the count pass.
template <bool kVec, bool kWrite>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const float* __restrict__ quorum,  // [P, k, block, d]
            const float* __restrict__ norms,   // [P, k, block] (l2)
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ meta,      // [P, n_pairs, 6]
            int* __restrict__ row_count,       // [P, n_pairs, block]
            uint32_t* __restrict__ hot,        // [P, n_pairs, strips, words]
            const long long* __restrict__ row_off,  // [P, n_pairs, block]
            float* __restrict__ out_v,         // [P, capacity]
            int* __restrict__ out_i, int* __restrict__ out_j, int k,
            int block, int d, int n_pairs, int block_rows, float thr,
            long long capacity, int l2) {
  extern __shared__ __align__(16) float smem[];
  Epi& ep = *reinterpret_cast<Epi*>(smem + kStages * kStageFloats);
  const int p = blockIdx.z, pair = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int lane = tid % 32;
  const size_t pp = (size_t)p * n_pairs + pair;
  const size_t strip = pp * block + r0;
  const int n_words = compact::hot_words(block, kTile);
  uint32_t* bits = hot + (pp * gridDim.x + blockIdx.x) * n_words;
  const Meta m = compact::load_meta(meta + pp * 6);
  const int rows = min(kTile, block - r0);

  if (m.active != 1 || r0 >= m.nv_lo) {
    if (!kWrite) {
      if (tid < rows) row_count[strip + tid] = 0;
      for (int w = tid; w < n_words; w += kThreads) bits[w] = 0u;
    }
    return;
  }
  if (kWrite && row_off[strip] >= capacity) return;  // nothing to keep
  const size_t lo_off = ((size_t)p * k + lo[pair]) * block;
  const size_t hi_off = ((size_t)p * k + hi[pair]) * block;
  const float* __restrict__ A = quorum + (lo_off + r0) * d;
  const float* __restrict__ Bslot = quorum + hi_off * d;
  const int vr = min(kTile, m.nv_lo - r0);  // the strip's valid rows
  const bool self = m.is_self == 1;
  ep.rn[tid] = l2 && tid < rows ? norms[lo_off + r0 + tid] : 0.f;
  if (kWrite)
    ep.pos[tid] = tid < rows ? row_off[strip + tid] : 0;
  else
    ep.cnt[tid] = 0;

  // a self tile keeps only row < col: the count walk starts at the
  // strip's diagonal tile (the write walk's hot bits start there too)
  const int nks = max(1, (d + kDepth - 1) / kDepth);
  const Tiles seq =
      kWrite ? Tiles::written(bits, n_words)
             : Tiles::count(self ? (int)blockIdx.x : 0,
                            (m.nv_hi + kTile - 1) / kTile);
  Cursor lw{seq, 0, nks}, cw{seq, 0, nks};
  compact::HotWriter hw(bits, n_words);

  const uint32_t s0 = smem_u32(smem);
  auto load = [&](const Cursor& c, int stage) {
    const int c0 = c.t.ct * kTile;
    load_stage<kVec>(s0 + (uint32_t)(stage * kStageFloats) * 4u, A, rows,
                     Bslot + (size_t)c0 * d, min(kTile, block - c0),
                     c.ks * kDepth, d, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!lw.done()) {
      load(lw, s);
      lw.step();
    }
    cp_async_commit();
  }

  float acc[8][16];
  for (int it = 0; !cw.done(); ++it) {
    const int c0 = cw.t.ct * kTile;
    if (cw.ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
      // the last tile's readers are past the barrier that ends its epilogue
      ep.cn[tid] = l2 && c0 + tid < block ? norms[hi_off + c0 + tid] : 0.f;
    }
    cp_async_wait<kStages - 2>();   // slice it landed
    __syncthreads();                // ... for every thread; slice it-1 done
    if (!lw.done()) {
      load(lw, (it + kStages - 1) % kStages);
      lw.step();
    }
    cp_async_commit();
    const float* As = smem + (it % kStages) * kStageFloats;
    const float* Bs = As + kTile * kLd;
#pragma unroll
    for (int k4 = 0; k4 < kDepth / 4; ++k4) {
      float4 a[8], bv[16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[(ty + 16 * i) * kLd +
                                                     4 * k4]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 8 * j) * kLd +
                                                      4 * k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // d in order
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[i][j] = fmaf(lane_of(a[i], kk), lane_of(bv[j], kk),
                             acc[i][j]);
    }
    if (cw.ks != nks - 1) {
      cw.step();
      continue;
    }

    // ---- the tile is scored: threshold, masks, count or write ----
    const bool edge = vr < kTile || c0 + kTile > m.nv_hi || (self && c0 == r0);
    float cn[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cn[j] = ep.cn[tx + 8 * j];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = ty + 16 * i;
      const float rn = ep.rn[rl];
      unsigned keep = 0u;   // bit j: column tx + 8 j survives
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float s = acc[i][j];
        if (l2) s = (2.f * s - cn[j]) - rn;
        acc[i][j] = s;
        bool k_ = s >= thr;
        if (edge) {
          const int c = c0 + tx + 8 * j;
          k_ = k_ && rl < vr && c < m.nv_hi && (!self || r0 + rl < c);
        }
        keep |= (unsigned)k_ << j;
      }
      if (!kWrite) {
        int n = __popc(keep);   // the row's survivors over its 8 lanes
        n += __shfl_xor_sync(0xffffffffu, n, 1);
        n += __shfl_xor_sync(0xffffffffu, n, 2);
        n += __shfl_xor_sync(0xffffffffu, n, 4);
        if (tx == 0) ep.cnt[rl] += n;
        any |= keep != 0u;
      } else {
        const long long base = ep.pos[rl];
        int left = 0;   // the row's survivors in the tile's earlier columns
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const bool k_ = keep >> j & 1u;
          const unsigned b = (__ballot_sync(0xffffffffu, k_) >> (lane & 24)) &
                             0xffu;
          if (k_) {
            const long long q = base + left + __popc(b & ((1u << tx) - 1u));
            if (q < capacity) {
              const int gi = m.ga * block_rows + r0 + rl;
              const int gj = m.gb * block_rows + c0 + tx + 8 * j;
              out_v[(size_t)p * capacity + q] = acc[i][j];
              out_i[(size_t)p * capacity + q] = min(gi, gj);
              out_j[(size_t)p * capacity + q] = max(gi, gj);
            }
          }
          left += __popc(b);
        }
        __syncwarp();
        if (tx == 0) ep.pos[rl] = base + left;
      }
    }
    // ends the epilogue: ep.cn and ep.pos are rewritten by the next tile
    if (!kWrite) {
      any = __syncthreads_or(any);
      if (tid == 0) hw.mark(cw.t.ct, any);
    } else {
      __syncthreads();
    }
    cw.step();
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (!kWrite) {
    __syncthreads();    // what the last epilogue counted (no tile: own row)
    if (tid < rows) row_count[strip + tid] = ep.cnt[tid];
    if (tid == 0) hw.finish();
  }
}

template <bool kVec>
int launch(const float* quorum, const int* lo, const int* hi,
           const int* meta, float* norms, uint32_t* hot, int* row_count,
           long long* row_off, float* out_v, int* out_i, int* out_j,
           int* count, int P, int k, int block, int d, int n_pairs,
           int block_rows, float thr, long long capacity, int l2,
           cudaStream_t s) {
  const auto count_k = tile_kernel<kVec, false>;
  const auto write_k = tile_kernel<kVec, true>;
  for (const auto kern : {count_k, write_k}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (l2) row_norms::launch(quorum, norms, (long long)P * k * block, d, s);
  const dim3 grid((block + kTile - 1) / kTile, n_pairs, P);
  count_k<<<grid, kThreads, kSmemBytes, s>>>(
      quorum, norms, lo, hi, meta, row_count, hot, nullptr, nullptr, nullptr,
      nullptr, k, block, d, n_pairs, block_rows, thr, capacity, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = compact::launch_scan(row_count, row_off, count, out_v, out_i, out_j,
                             P, n_pairs * block, capacity, s);
  if (err != cudaSuccess) return (int)err;
  write_k<<<grid, kThreads, kSmemBytes, s>>>(
      quorum, norms, lo, hi, meta, nullptr, hot, row_off, out_v, out_i,
      out_j, k, block, d, n_pairs, block_rows, thr, capacity, l2);
  return (int)cudaGetLastError();
}

}  // namespace

// norms [P, k, block] float32 scratch (l2); hot [P, n_pairs, strips,
// words] of kernels.pairwise_threshold.hot_words(block, 128)
extern "C" int repro_pairwise_threshold(
    const void* quorum, const void* lo, const void* hi, const void* meta,
    void* norms, void* hot, void* row_count, void* row_off, void* out_v,
    void* out_i, void* out_j, void* count, int P, int k, int block, int d,
    int n_pairs, int block_rows, float threshold, long long capacity, int l2,
    void* stream) {
  const bool vec = d % 4 == 0 && (uintptr_t)quorum % 16 == 0;
  return (vec ? launch<true> : launch<false>)(
      (const float*)quorum, (const int*)lo, (const int*)hi, (const int*)meta,
      (float*)norms, (uint32_t*)hot, (int*)row_count, (long long*)row_off,
      (float*)out_v, (int*)out_i, (int*)out_j, (int*)count, P, k, block, d,
      n_pairs, block_rows, threshold, capacity, l2, (cudaStream_t)stream);
}
