// B7: quantized thresholded scoring + sparse compaction with the widened
// keep band (replaces the Pallas kernel
// repro/kernels/pairwise_batch_q.py:pairwise_threshold_q_pallas, body
// _threshold_q_kernel).
//
// B5 (pairwise_threshold.cu) over int8 or bf16 codes.  For every device p
// and active slot pair (lo, hi) the tile entry is the code dot times
// s_lo * s_hi (sd[.., 0]); l2 subtracts the exact stored squared norms:
// (2 s - sq_hi) - sq_lo.  An entry is kept when s >= thr - eps,
// row < nv_lo, col < nv_hi and (self tile) row < col, with the certified
// bound of ref.quant_eps_tile in its expression order:
//   eps = d_lo*l1_hi + d_hi*l1_lo + 3*d*d_lo*d_hi + FP_REL*(l1_lo*l1_hi+1)
// (doubled for l2; deltas sd[.., 1], l1 the rows' L1 norms).  Survivors
// land as (score, min gid, max gid) in (pair, row, col) order in
// [capacity] buffers; past capacity they are dropped and the count keeps
// the true total.
//
// Bound on the H100: 2*d operations per candidate of an active tile at
// the int8 (1,979 TOP/s) or bf16 (989 TFLOP/s) tensor-core rate.
//
// Compaction: compact.cuh's count -> scan -> write, never an atomic
// cursor; the write pass scores again only the tiles that held a
// survivor, so an overflowing buffer keeps exactly the plain version's
// prefix.  This file is compiled with -fmad=false: the dequant epilogue
// and eps round op for op as the plain version's.
//
// Route "tensor_cores" (int8 with d <= 1,040, bf16 with d <= 128;
// kernels/pairwise_batch_q.py:route_of).  One block of 8 warps per
// (device, pair, 128-row strip) walks the strip's 128-column tiles of the
// hi slot (on a self tile from its diagonal on), each formed once, lo
// rows x hi columns.  The codes stay in their storage type: the strip's
// rows stay resident in shared memory when they fit (up to 256 bytes a
// row), the column rows (and strip rows, when too long) stream through a
// 2-stage 16-byte cp.async ring, 128 bytes of d a stage, rows padded by
// 16 bytes so ldmatrix reads without bank conflicts; each stage also
// brings its tile's column norms (4-byte cp.async).  Each warp forms a
// 32 x 64 sub-tile with mma.sync: int8 m16n8k32 into s32, bf16 m16n8k16
// into f32 (B8's pieces, pairwise_topk_q.cu, copied here so B8's code is
// left as it is).
//
// The epilogue, not the products, sets the pace: the exact score and eps
// cost about twenty CUDA-core operations an entry, and at chip_smoke.py's
// join about one entry in 9,000 is in the band.  So an entry first meets
// a prefilter of one fused add-and-max: with x the code dot (the
// accumulator), every entry that could be kept has x - B_c >= A_r,
// B_c = |col|^2 f and A_r = (reject + |row|^2) f - margin, with
// f = 1 / (2 s_lo s_hi) (l2; dot: 1 / (s_lo s_hi) and no norms) and
// reject = thr - eps_max.  eps_max is eps (the expression
// above, in its order) at the warp sub-tile's largest l1 on each side:
// every term of eps is non-decreasing in each l1 and rounding is
// monotone, so eps <= eps_max.  The score is a non-decreasing function of
// x made of at most four rounded operations, so below the real boundary
// x* = (reject + |row|^2 + |col|^2) / (2 s_lo s_hi) it stays below reject
// once x is a few float32 ulps of (|reject| + 2 (|row|^2 + |col|^2)) under
// it; the margin is 2^-18 of that, with B_c and A_r rounded down, 14
// times what all the roundings need.  All of it needs the deltas and
// norms >= 0 (they are rounding steps and norms): a warp sub-tile that
// sees a negative one, or an infinite or undefined bound, runs the exact
// test on every entry.  A row whose best x - B_c reaches A_r then builds
// its candidate bits, and the exact test (the plain version's operations
// under -fmad=false) runs once per set bit, the accumulator picked by a
// chain of selects so the fragment stays in registers.  The count pass
// adds each row's survivors (popc of a thread's 16 keep bits, then the
// quad's and the two column halves'), marks the hot tiles, and keeps one
// flag per warp sub-tile of a hot tile; the write pass forms only the
// flagged sub-tiles and ranks a survivor by a popcount over its row's
// 64-column keep mask, gathered from the quad by two shuffles, one set
// bit at a time.  Per-row state (norms, positions) lives in shared
// memory: the tile loop sits at the 128-register limit of two blocks an
// SM.
//
// Exactness.  int8 products are at most 127^2, so the s32 sums are exact
// and convert to float32 exactly while d * 127^2 < 2^24 (d <= 1,040): the
// dot equals the plain version's float32 matmul of the widened codes, and
// with the op-for-op epilogue the int8 band, its order and its overflow
// prefix equal the plain version's.  bf16 products are exact, and their
// sums run in the tensor cores' order and accumulation, which does not
// round to nearest.  The band still holds every pair the f32 join keeps:
// eps exceeds the worst quantization error by 2*d*d_lo*d_hi +
// FP_REL*(l1_lo*l1_hi + 1), and with bf16's delta = maxabs * 2^-8 the
// first term alone, 2*d * 2^-16 * maxabs_lo * maxabs_hi, is twice the
// error of d = 128 additions that each miss by a whole ulp (at most
// 2^-23 of sum |products| <= d * maxabs_lo * maxabs_hi each).  Wider bf16
// rows take route "simt" (the float32 tile, rounding to nearest), as B8's
// do.  A bf16 band may then differ from the plain version's only at its
// edge.
//
// Route "simt": pair_tile.cuh's 64 x 64 float32 tile over widened codes
// (exact for int8 while every partial sum is), with the same compaction.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "hopper.cuh"
#include "pair_tile.cuh"

namespace {

using namespace hopper;
using compact::Cursor;
using compact::load_meta;
using compact::Meta;
using compact::Tiles;

constexpr float kFpRel = 1e-6f;  // ref.FP_REL
// the prefilter's margin, in units of the score's magnitudes: 2^-18 is 64
// float32 ulps, 14 times what its rounding needs (see the file header)
constexpr float kBoundRel = 3.814697265625e-06f;  // 2^-18
constexpr float kBoundAbs = 7.888609052210118e-31f;  // 2^-100

// ---- route "tensor_cores" -------------------------------------------------

constexpr int kRows = 128;        // strip rows per block
constexpr int kCols = 128;        // hi-slot rows per score tile
constexpr int kSlice = 128;       // bytes of d per ring stage
constexpr int kLd = kSlice + 16;  // ring row stride (bytes)
constexpr int kStages = 2;
constexpr int kResBytes = 256;    // strip rows up to this long stay resident
constexpr int kThreads = 256;     // 8 warps: 4 (32 rows) x 2 (64 columns)
constexpr int kSmallD = 260;      // int8 dots below 2^22 in magnitude

// bytes of a ring stage: the codes (column rows, and strip rows unless
// resident), then the tile's column norms sq and l1, then (write pass)
// the tile's eight warp flags
__host__ __device__ constexpr int stage_bytes(bool res_a) {
  return (res_a ? kCols : kRows + kCols) * kLd + 2 * kCols * 4 + 16;
}

// per-row state lives here, not in registers (the tile loop is at the
// 128-register limit of two blocks an SM)
struct Epi {
  long long pos[2][kRows];          // write pass: each row's next position
  float rn[kRows], rl1[kRows];      // the strip rows' |row|^2 and l1
  int tot[2][kRows];                // survivors of each row in each half
  int bcol[kThreads / 32][kCols / 2];  // each warp's column bounds B_c
};

// int8 sums are s32, bf16 sums f32 (as in pairwise_topk_q.cu).  The
// prefilter compares x - B_c with A_r in the sum's own type: int8 in exact
// integers (B_c rounded down, clamped to [0, 2^30] as B_c >= 0 there; A_r
// rounded down, INT_MIN below -2^30: |x| < 2^25 on this route), bf16 in
// float32 (a rounded subtract is monotone).
template <typename T> struct Acc;
template <> struct Acc<int8_t> {
  using type = int;
  static __device__ __forceinline__ int col_bound(float b) {
    return __float2int_rd(fminf(fmaxf(b, 0.f), 1073741824.f));
  }
  static __device__ __forceinline__ int row_bound(float a) {
    return a >= -1073741824.f ? __float2int_rd(fminf(a, 1073741824.f))
                              : INT_MIN;
  }
  static __device__ __forceinline__ int lowest() { return INT_MIN; }
  static __device__ __forceinline__ int word(int v) { return v; }
  static __device__ __forceinline__ int unword(int w) { return w; }
  static __device__ __forceinline__ int larger(int a, int b) {
    return max(a, b);
  }
  // |a| < 2^22 (d <= 260): a + 1.5 * 2^23 as a float holds a in its low
  // mantissa bits, so one integer add and one float subtract convert it
  // exactly at full rate (I2F issues at a quarter of it)
  static __device__ __forceinline__ float dot(int a, bool small) {
    return small ? __int_as_float(a + 0x4B400000) - 12582912.0f
                 : __int2float_rn(a);
  }
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};
template <> struct Acc<__nv_bfloat16> {
  using type = float;
  static __device__ __forceinline__ float col_bound(float b) { return b; }
  static __device__ __forceinline__ float row_bound(float a) {
    return a >= -INFINITY ? a : -INFINITY;   // NaN: every row a candidate
  }
  static __device__ __forceinline__ float lowest() { return -INFINITY; }
  static __device__ __forceinline__ int word(float v) {
    return __float_as_int(v);
  }
  static __device__ __forceinline__ float unword(int w) {
    return __int_as_float(w);
  }
  static __device__ __forceinline__ float larger(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float dot(float a, bool) { return a; }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

// Rows [0, n_rows) of src (valid < ok_rows, row_bytes each), bytes
// [kb, kb + width) of each, to shared memory at dst with row stride ld;
// zeros past the valid rows and row_bytes.  Every thread of the block
// calls it with the same arguments (as in pairwise_topk_q.cu).
template <bool kVec>
__device__ __forceinline__ void copy_rows(uint32_t dst, int ld,
                                          const uint8_t* __restrict__ src,
                                          int n_rows, int ok_rows, int kb,
                                          int width, int row_bytes, int tid) {
  const int cpr = width / 16;   // 16-byte chunks a row
  for (int idx = tid; idx < n_rows * cpr; idx += kThreads) {
    const int r = idx / cpr, c = idx % cpr;
    const bool row_ok = r < ok_rows;
    const int gb = kb + 16 * c;
    const uint8_t* g = src + (size_t)(row_ok ? r : 0) * row_bytes + gb;
    const uint32_t dd = dst + (uint32_t)(r * ld + 16 * c);
    if constexpr (kVec) {
      const bool ok = row_ok && gb < row_bytes;
      cp_async16(dd, ok ? g : src, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        uint32_t v = 0;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int b = gb + 4 * x + y;
          v |= (uint32_t)(row_ok && b < row_bytes ? g[4 * x + y] : 0)
               << (8 * y);
        }
        w[x] = v;
      }
      st_shared_v4(dd, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// 16 keep bits (bit 2 nj + x) to 64 (bit 8 nj + x)
__device__ __forceinline__ unsigned long long spread(unsigned m) {
  unsigned long long v = m;
  v = (v | v << 24) & 0x000000FF000000FFull;
  v = (v | v << 12) & 0x000F000F000F000Full;
  v = (v | v << 6) & 0x0303030303030303ull;
  return v;
}

// entry kb = 2 nj + x of row (mi, hh) of a thread's accumulators: a chain
// of selects over compile-time indices, so the fragment stays in registers
template <typename AccT>
__device__ __forceinline__ AccT pick(const AccT (&acc)[2][8][4], int mi,
                                     int hh, int kb) {
  AccT v = acc[mi][0][2 * hh];
#pragma unroll
  for (int j = 1; j < 16; ++j)
    v = kb == j ? acc[mi][j >> 1][2 * hh + (j & 1)] : v;
  return v;
}

// an entry's score from its dot, in the plain version's operation order
template <typename A>
__device__ __forceinline__ float score_of(typename A::type a, bool small,
                                          float sprod, int l2, float cn,
                                          float rn) {
  float s = A::dot(a, small) * sprod;
  if (l2) s = (2.f * s - cn) - rn;
  return s;
}

// kResA: the strip's rows stay resident in shared memory (rows of at most
// kResBytes bytes) and only the column rows stream through the ring; else
// both stream, a slice at a time.  kWrite: the write pass (hot tiles
// only), else the count pass.
template <typename T, bool kVec, bool kResA, bool kWrite>
__global__ void __launch_bounds__(kThreads, 2)
band_tc_kernel(const T* __restrict__ q,          // [P, k, block, d]
               const float* __restrict__ sd,     // [P, k, 2] (scale, delta)
               const float* __restrict__ l1,     // [P, k, block]
               const float* __restrict__ sq,     // [P, k, block]
               const int* __restrict__ lo, const int* __restrict__ hi,
               const int* __restrict__ meta,     // [P, n_pairs, 6]
               int* __restrict__ row_count,      // [P, n_pairs, block]
               uint32_t* __restrict__ hot,       // [P, n_pairs, strips, words]
               uint8_t* __restrict__ warp_hot,   // [.., strips, tiles, 8]
               const long long* __restrict__ row_off,
               float* __restrict__ out_v,        // [P, capacity]
               int* __restrict__ out_i, int* __restrict__ out_j, int k,
               int block, int d, int n_pairs, int block_rows, float thr,
               long long capacity, int l2) {
  using A = Acc<T>;
  using AccT = typename A::type;
  constexpr int kStage = stage_bytes(kResA);
  constexpr int kCodes = (kResA ? kCols : kRows + kCols) * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int p = blockIdx.z, pair = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, block - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;   // warp tile: 32 rows x 64 cols
  const int g = lane / 4, tig = lane % 4;
  const size_t pp = (size_t)p * n_pairs + pair;
  const size_t strip = pp * block + r0;
  const int n_words = compact::hot_words(block, kCols);
  uint32_t* bits = hot + (pp * gridDim.x + blockIdx.x) * n_words;
  // this strip's warp flags: byte w of tile ct says whether warp w's
  // sub-tile held a survivor (written for the hot tiles only)
  uint8_t* wflags = warp_hot + (pp * gridDim.x + blockIdx.x) * gridDim.x * 8;
  const Meta m = load_meta(meta + pp * 6);

  if (m.active != 1 || r0 >= m.nv_lo) {
    if (!kWrite) {
      if (tid < rows) row_count[strip + tid] = 0;
      for (int w = tid; w < n_words; w += kThreads) bits[w] = 0u;
    }
    return;
  }
  if (kWrite && row_off[strip] >= capacity) return;  // nothing to keep
  const int l = lo[pair], h = hi[pair];
  const size_t lo_off = ((size_t)p * k + l) * block;
  const size_t hi_off = ((size_t)p * k + h) * block;
  const float s_lo = sd[((size_t)p * k + l) * 2];
  const float d_lo = sd[((size_t)p * k + l) * 2 + 1];
  const float s_hi = sd[((size_t)p * k + h) * 2];
  const float d_hi = sd[((size_t)p * k + h) * 2 + 1];
  const float sprod = s_lo * s_hi;
  const float c3dd = 3.0f * (float)d * d_lo * d_hi;
  const int vr = min(kRows, m.nv_lo - r0);   // the strip's valid rows
  const bool self = m.is_self == 1;
  const int row_bytes = d * (int)sizeof(T);
  const int nks = max(1, (row_bytes + kSlice - 1) / kSlice);
  const uint32_t ring = smem_u32(tc_smem);
  const int a_ld = nks * kSlice + 16;   // resident row stride (bytes)
  const uint32_t a_res = ring + kStages * kStage;
  Epi& ep = *reinterpret_cast<Epi*>(tc_smem + kStages * kStage +
                                    (kResA ? kRows * a_ld : 0));

  // the strip rows' norms (and write positions) to shared memory; the
  // warp's largest l1 and |row|^2 and smallest of both over its 32 rows
  if (tid < kRows) {
    ep.rn[tid] = l2 && tid < vr ? sq[lo_off + r0 + tid] : 0.f;
    ep.rl1[tid] = tid < vr ? l1[lo_off + r0 + tid] : 0.f;
    if (kWrite) ep.pos[0][tid] = tid < rows ? row_off[strip + tid] : 0;
  }
  float rmax, rnmax, rmin;
  {
    const int rl = 32 * wr + lane;
    rmax = rl < vr ? l1[lo_off + r0 + rl] : 0.f;
    rnmax = l2 && rl < vr ? sq[lo_off + r0 + rl] : 0.f;
    rmin = fminf(rmax, rnmax);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    rnmax = fmaxf(rnmax, __shfl_xor_sync(0xffffffffu, rnmax, off));
    rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, off));
  }
  // the bounds below need every delta and norm >= 0 (as they are)
  const bool rows_sure = rmin >= 0.f && d_lo >= 0.f && d_hi >= 0.f;
  // x units per score unit of the prefilter (x: the code dot)
  const float f = (l2 ? 0.5f : 1.f) / sprod;
  int n_row[2][2] = {{0, 0}, {0, 0}};   // count pass
  int par = 0;   // write pass: ep.pos[par] holds the rows' next positions

  // a self tile keeps only row < col: the count walk starts at the
  // strip's diagonal tile (the write walk's hot bits start there too)
  const Tiles seq =
      kWrite ? Tiles::written(bits, n_words)
             : Tiles::count(self ? (int)blockIdx.x : 0,
                            (m.nv_hi + kCols - 1) / kCols);
  Cursor lw{seq, 0, nks}, cw{seq, 0, nks};
  compact::HotWriter hw(bits, n_words);

  const uint8_t* Arows =
      reinterpret_cast<const uint8_t*>(q + (lo_off + r0) * d);
  auto load = [&](const Cursor& c, int stage) {
    const int c0 = c.t.ct * kCols;
    const int ok = min(kCols, m.nv_hi - c0);
    const uint8_t* B =
        reinterpret_cast<const uint8_t*>(q + (hi_off + c0) * d);
    const uint32_t dst = ring + stage * kStage;
    const int kb = c.ks * kSlice;
    if constexpr (kResA) {
      copy_rows<kVec>(dst, kLd, B, kCols, ok, kb, kSlice, row_bytes, tid);
    } else {
      copy_rows<kVec>(dst, kLd, Arows, kRows, vr, kb, kSlice, row_bytes,
                      tid);
      copy_rows<kVec>(dst + kRows * kLd, kLd, B, kCols, ok, kb, kSlice,
                      row_bytes, tid);
    }
    // the tile's column norms: sq (threads 0..127), l1 (128..255)
    const int col = tid % kCols;
    const float* src = (tid < kCols ? sq : l1) + hi_off + c0 + col;
    const bool on = col < ok && (tid >= kCols || l2);
    cp_async4(dst + kCodes + 4 * tid, on ? src : sq, on ? 4 : 0);
    if (kWrite && tid < 2)   // the tile's warp flags
      cp_async4(dst + kCodes + 2 * kCols * 4 + 4 * tid,
                wflags + (size_t)c.t.ct * 8 + 4 * tid, 4);
  };
  if constexpr (kResA)   // the strip's rows once, in the first copy group
    copy_rows<kVec>(a_res, a_ld, Arows, kRows, vr, 0, nks * kSlice,
                    row_bytes, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!lw.done()) {
      load(lw, s);
      lw.step();
    }
    cp_async_commit();
  }

  AccT acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  const bool small = d <= kSmallD;
  for (int it = 0; !cw.done(); ++it) {
    cp_async_wait<kStages - 2>();   // slice it landed
    __syncthreads();                // ... for every thread; slice it-1 done
    if (!lw.done()) {
      load(lw, (it + kStages - 1) % kStages);
      lw.step();
    }
    cp_async_commit();

    const uint32_t stage = ring + (it % kStages) * kStage;
    const uint32_t sb = stage + (kResA ? 0 : kRows * kLd);
    const uint32_t sa = kResA ? a_res + cw.ks * kSlice : stage;
    const int lda = kResA ? a_ld : kLd;
    // the write pass forms only the sub-tiles that held a survivor
    const bool mine = !kWrite || tc_smem[(it % kStages) * kStage + kCodes +
                                         2 * kCols * 4 + warp] != 0;
#pragma unroll
    for (int kk = 0; kk < kSlice / 32 && mine; ++kk) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], sa + (32 * wr + 16 * mi + lane % 16) * lda +
                                32 * kk + 16 * (lane / 16));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        ldmatrix_x4(bfr[nb],
                    sb + (64 * wc + 16 * nb + 8 * (lane / 16) + lane % 8) *
                             kLd + 32 * kk + 16 * ((lane / 8) % 2));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          A::mma(acc[mi][nj], af[mi], bfr[nj / 2][2 * (nj % 2)],
                 bfr[nj / 2][2 * (nj % 2) + 1]);
    }
    if (cw.ks != nks - 1) {
      cw.step();
      continue;
    }

    // ---- the tile is scored: dequant, band, masks, count or write ----
    const int c0 = cw.t.ct * kCols;
    const int cols = min(kCols, m.nv_hi - c0);
    // only edge tiles mask: ragged rows or columns, or a self tile's
    // diagonal
    const bool edge = vr < kRows || cols < kCols || (self && c0 == r0);
    const float* cn_s = reinterpret_cast<const float*>(
        tc_smem + (it % kStages) * kStage + kCodes);
    const float* cl1_s = cn_s + kCols;
    unsigned msk[2][2] = {{0u, 0u}, {0u, 0u}};   // bit 2 nj + x: kept
    if (mine) {
    // the warp sub-tile's columns: largest l1 and |col|^2, smallest of both
    const int ca = 64 * wc + lane, cb = ca + 32;
    const float l1a = cl1_s[ca], l1b = cl1_s[cb];
    const float sqa = cn_s[ca], sqb = cn_s[cb];
    float cmax = fmaxf(l1a, l1b), cnmax = fmaxf(sqa, sqb);
    float cmin = fminf(fminf(l1a, l1b), fminf(sqa, sqb));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      cnmax = fmaxf(cnmax, __shfl_xor_sync(0xffffffffu, cnmax, off));
      cmin = fminf(cmin, __shfl_xor_sync(0xffffffffu, cmin, off));
    }
    const bool sure = rows_sure && cmin >= 0.f;
    // the sub-tile's conservative reject bound thr - eps_max
    float eps_max = d_lo * cmax + d_hi * rmax + c3dd +
                    kFpRel * (rmax * cmax + 1.f);
    if (l2) eps_max = 2.f * eps_max;
    const float reject = sure ? thr - eps_max : -INFINITY;
    // the prefilter: a candidate has x - B_c >= A_r (x units)
    const float margin =
        (kBoundRel * (fabsf(reject) + 2.f * (cnmax + rnmax)) + kBoundAbs) /
        sprod;
    const bool fast = sure && sprod > 0.f && isfinite(f) &&
                      isfinite(reject) && isfinite(margin);
    __syncwarp();   // this warp's reads of the last tile's bounds are done
    // (prefilter off: B_c = 0 and A_r lowest pass every entry on)
    ep.bcol[warp][lane] = A::word(A::col_bound(fast ? sqa * f : 0.f));
    ep.bcol[warp][lane + 32] = A::word(A::col_bound(fast ? sqb * f : 0.f));
    __syncwarp();
    AccT best[2][2], row_a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        best[mi][hh] = A::lowest();
        row_a[mi][hh] =
            fast ? A::row_bound(
                       (reject + ep.rn[32 * wr + 16 * mi + g + 8 * hh]) * f -
                       margin)
                 : A::lowest();
      }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int2 bw =
          *reinterpret_cast<const int2*>(&ep.bcol[warp][8 * nj + 2 * tig]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const AccT b = A::unword(x ? bw.y : bw.x);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            best[mi][hh] =
                A::larger(best[mi][hh], acc[mi][nj][2 * hh + x] - b);
      }
    }
    // the exact band test, only on the candidates of rows that have one:
    // the row's candidate bits, then one exact test per set bit
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!(best[mi][hh] >= row_a[mi][hh])) continue;
        const int rl = 32 * wr + 16 * mi + g + 8 * hh;
        unsigned cand = 0u;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int2 bw =
              *reinterpret_cast<const int2*>(&ep.bcol[warp][8 * nj + 2 * tig]);
#pragma unroll
          for (int x = 0; x < 2; ++x)
            cand |= (unsigned)(acc[mi][nj][2 * hh + x] -
                                   A::unword(x ? bw.y : bw.x) >=
                               row_a[mi][hh])
                    << (2 * nj + x);
        }
        while (cand != 0u) {
          const int kb = __ffs(cand) - 1;   // entry 2 nj + x of the row
          cand &= cand - 1u;
          const int cl = 64 * wc + 8 * (kb >> 1) + 2 * tig + (kb & 1);
          const float s = score_of<A>(pick(acc, mi, hh, kb), small, sprod,
                                   l2, cn_s[cl], ep.rn[rl]);
          const float rl1_r = ep.rl1[rl];
          float eps = d_lo * cl1_s[cl] + d_hi * rl1_r + c3dd +
                      kFpRel * (rl1_r * cl1_s[cl] + 1.f);
          if (l2) eps = 2.f * eps;
          bool keep = s >= thr - eps;
          if (edge)
            keep = keep && rl < vr && cl < cols &&
                   (!self || r0 + rl < c0 + cl);
          msk[mi][hh] |= (unsigned)keep << kb;
        }
      }
    }   // mine
    if (!kWrite) {
      bool any = false;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          n_row[mi][hh] += __popc(msk[mi][hh]);
          any |= msk[mi][hh] != 0u;
        }
      const bool warp_any = __any_sync(0xffffffffu, any);
      any = __syncthreads_or(any);   // ends the epilogue (stage reuse)
      if (tid == 0) hw.mark(cw.t.ct, any);
      if (any && lane == 0) wflags[(size_t)cw.t.ct * 8 + warp] = warp_any;
    } else {
      // the row's keep mask over the warp's 64 columns in column order
      // 8 nj + 2 tig + x, and each half's total (most warps keep none)
      unsigned long long M[2][2] = {{0ull, 0ull}, {0ull, 0ull}};
      if (__any_sync(0xffffffffu,
                     (msk[0][0] | msk[0][1] | msk[1][0] | msk[1][1]) != 0u)) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            unsigned long long v = spread(msk[mi][hh]) << (2 * tig);
            v |= __shfl_xor_sync(0xffffffffu, v, 1);
            v |= __shfl_xor_sync(0xffffffffu, v, 2);
            M[mi][hh] = v;
          }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (tig == 0)
            ep.tot[wc][32 * wr + 16 * mi + g + 8 * hh] = __popcll(M[mi][hh]);
      __syncthreads();   // both halves' totals; ends the reads of the norms
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = 32 * wr + 16 * mi + g + 8 * hh;
          const int t0 = ep.tot[0][rl], t1 = ep.tot[1][rl];
          const long long row_pos = ep.pos[par][rl];
          const long long b = row_pos + (wc ? t0 : 0);
          const int gi = m.ga * block_rows + r0 + rl;
          for (unsigned mk = msk[mi][hh]; mk != 0u; mk &= mk - 1u) {
            const int kb = __ffs(mk) - 1;
            const int cwi = 8 * (kb >> 1) + 2 * tig + (kb & 1);   // of 64
            const long long pos =
                b + __popcll(M[mi][hh] & ((1ull << cwi) - 1ull));
            if (pos >= capacity) continue;
            // the kept score again, by the same operations
            const float s = score_of<A>(pick(acc, mi, hh, kb), small, sprod,
                                     l2, cn_s[64 * wc + cwi], ep.rn[rl]);
            const int gj = m.gb * block_rows + c0 + 64 * wc + cwi;
            out_v[(size_t)p * capacity + pos] = s;
            out_i[(size_t)p * capacity + pos] = min(gi, gj);
            out_j[(size_t)p * capacity + pos] = max(gi, gj);
          }
          // the other buffer: read after the next tile's totals barrier
          if (wc == 1 && tig == 0) ep.pos[par ^ 1][rl] = row_pos + t0 + t1;
        }
      par ^= 1;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
    cw.step();
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (!kWrite) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int n = n_row[mi][hh];   // the quad's four threads share the row
        n += __shfl_xor_sync(0xffffffffu, n, 1);
        n += __shfl_xor_sync(0xffffffffu, n, 2);
        if (tig == 0) ep.tot[wc][32 * wr + 16 * mi + g + 8 * hh] = n;
      }
    __syncthreads();
    if (tid < rows) row_count[strip + tid] = ep.tot[0][tid] + ep.tot[1][tid];
    if (tid == 0) hw.finish();
  }
}

template <typename T, bool kVec, bool kResA>
int launch_tc(const T* q, const float* sd, const float* l1, const float* sq,
              const int* lo, const int* hi, const int* meta, uint32_t* hot,
              uint8_t* warp_hot, int* row_count, long long* row_off,
              float* out_v, int* out_i, int* out_j, int* count, int P,
              int k, int block, int d,
              int n_pairs, int block_rows, float thr, long long capacity,
              int l2, cudaStream_t s) {
  const int nks = max(1, (d * (int)sizeof(T) + kSlice - 1) / kSlice);
  const size_t smem = kStages * stage_bytes(kResA) +
                      (kResA ? kRows * (nks * kSlice + 16) : 0) + sizeof(Epi);
  const auto count_k = band_tc_kernel<T, kVec, kResA, false>;
  const auto write_k = band_tc_kernel<T, kVec, kResA, true>;
  for (const auto kern : {count_k, write_k}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((block + kRows - 1) / kRows, n_pairs, P);
  count_k<<<grid, kThreads, smem, s>>>(
      q, sd, l1, sq, lo, hi, meta, row_count, hot, warp_hot, nullptr,
      nullptr, nullptr, nullptr, k, block, d, n_pairs, block_rows, thr,
      capacity, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = compact::launch_scan(row_count, row_off, count, out_v, out_i, out_j,
                             P, n_pairs * block, capacity, s);
  if (err != cudaSuccess) return (int)err;
  write_k<<<grid, kThreads, smem, s>>>(
      q, sd, l1, sq, lo, hi, meta, nullptr, hot, warp_hot, row_off, out_v,
      out_i, out_j, k, block, d, n_pairs, block_rows, thr, capacity, l2);
  return (int)cudaGetLastError();
}

template <typename T>
int run_tc(const void* q, const float* sd, const float* l1, const float* sq,
           const int* lo, const int* hi, const int* meta, uint32_t* hot,
           uint8_t* warp_hot, int* row_count, long long* row_off,
           float* out_v, int* out_i, int* out_j, int* count, int P, int k,
           int block, int d,
           int n_pairs, int block_rows, float thr, long long capacity,
           int l2, cudaStream_t s) {
  const int row_bytes = d * (int)sizeof(T);
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)q % 16 == 0;
  const bool res = row_bytes <= kResBytes;
  return (vec ? (res ? launch_tc<T, true, true> : launch_tc<T, true, false>)
              : (res ? launch_tc<T, false, true>
                     : launch_tc<T, false, false>))(
      (const T*)q, sd, l1, sq, lo, hi, meta, hot, warp_hot, row_count,
      row_off, out_v, out_i, out_j, count, P, k, block, d, n_pairs,
      block_rows, thr, capacity, l2, s);
}

// ---- route "simt": pair_tile.cuh's float32 tile ---------------------------

namespace pt = pair_tile;

template <typename T, bool kWrite>
__global__ void __launch_bounds__(pt::kThreads)
band_simt_kernel(const T* __restrict__ q,          // [P, k, block, d]
                 const float* __restrict__ sd,     // [P, k, 2]
                 const float* __restrict__ l1,     // [P, k, block]
                 const float* __restrict__ sq,     // [P, k, block]
                 const int* __restrict__ lo, const int* __restrict__ hi,
                 const int* __restrict__ meta,     // [P, n_pairs, 6]
                 int* __restrict__ row_count,      // [P, n_pairs, block]
                 uint32_t* __restrict__ hot,       // [P, n_pairs, strips, w]
                 const long long* __restrict__ row_off,
                 float* __restrict__ out_v,        // [P, capacity]
                 int* __restrict__ out_i, int* __restrict__ out_j, int k,
                 int block, int d, int n_pairs, int block_rows, float thr,
                 long long capacity, int l2) {
  constexpr int kTile = pt::kTile;
  const int p = blockIdx.z;
  const int pair = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32;
  const size_t pp = (size_t)p * n_pairs + pair;
  const size_t strip = pp * block + r0;
  const int n_words = compact::hot_words(block, kTile);
  uint32_t* bits = hot + (pp * gridDim.x + blockIdx.x) * n_words;
  const Meta m = load_meta(meta + pp * 6);

  if (m.active != 1 || r0 >= m.nv_lo) {
    if (!kWrite) {
      for (int r = tid; r < kTile && r0 + r < block; r += pt::kThreads)
        row_count[strip + r] = 0;
      for (int w = tid; w < n_words; w += pt::kThreads) bits[w] = 0u;
    }
    return;
  }
  if (kWrite && row_off[strip] >= capacity) return;  // nothing to keep
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

  __shared__ pt::TileSmem sm;
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
  // a self tile keeps only row < col: the count walk starts at the
  // strip's diagonal tile
  compact::HotWriter hw(bits, n_words);
  for (Tiles t = kWrite ? Tiles::written(bits, n_words)
                        : Tiles::count(m.is_self == 1 ? (int)blockIdx.x : 0,
                                       (m.nv_hi + kTile - 1) / kTile);
       t.ct >= 0; t.advance()) {
    const int c0 = t.ct * kTile;
    const int cols = min(kTile, m.nv_hi - c0);
    float acc[4][4];
    pt::tile_dots<T>(q + (lo_off + r0) * d, rows, q + (hi_off + c0) * d,
                     cols, d, sm, acc, nullptr);
    if (tid < kTile) {
      cn[tid] = tid < cols ? sq[hi_off + c0 + tid] : 0.f;
      cl1[tid] = tid < cols ? l1[hi_off + c0 + tid] : 0.f;
    }
    __syncthreads();
    bool any = false;
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
        const unsigned b =
            (__ballot_sync(0xffffffffu, keep) >> half_shift) & 0xffffu;
        if (kWrite && keep) {
          const long long pos = base[i] + left + __popc(b & below);
          if (pos < capacity) {
            const int gi = m.ga * block_rows + r;
            const int gj = m.gb * block_rows + c;
            out_v[(size_t)p * capacity + pos] = s;
            out_i[(size_t)p * capacity + pos] = min(gi, gj);
            out_j[(size_t)p * capacity + pos] = max(gi, gj);
          }
        }
        left += __popc(b);
      }
      base[i] += left;
      n_row[i] += left;
      any |= left != 0;
    }
    // cn / cl1 are rewritten by the next tile
    any = __syncthreads_or(any);
    if (!kWrite && tid == 0) hw.mark(t.ct, any);
  }
  if (!kWrite) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (tx == 0 && r0 + ty + 16 * i < block)
        row_count[strip + ty + 16 * i] = n_row[i];
    if (tid == 0) hw.finish();
  }
}

template <typename T>
int run_simt(const T* q, const float* sd, const float* l1, const float* sq,
             const int* lo, const int* hi, const int* meta, uint32_t* hot,
             int* row_count, long long* row_off, float* out_v, int* out_i,
             int* out_j, int* count, int P, int k, int block, int d,
             int n_pairs, int block_rows, float thr, long long capacity,
             int l2, cudaStream_t s) {
  const dim3 grid((block + pt::kTile - 1) / pt::kTile, n_pairs, P);
  band_simt_kernel<T, false><<<grid, pt::kThreads, 0, s>>>(
      q, sd, l1, sq, lo, hi, meta, row_count, hot, nullptr, nullptr, nullptr,
      nullptr, k, block, d, n_pairs, block_rows, thr, capacity, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = compact::launch_scan(row_count, row_off, count, out_v, out_i, out_j,
                             P, n_pairs * block, capacity, s);
  if (err != cudaSuccess) return (int)err;
  band_simt_kernel<T, true><<<grid, pt::kThreads, 0, s>>>(
      q, sd, l1, sq, lo, hi, meta, nullptr, hot, row_off, out_v, out_i,
      out_j, k, block, d, n_pairs, block_rows, thr, capacity, l2);
  return (int)cudaGetLastError();
}

}  // namespace

// route (kernels/pairwise_batch_q.py:route_of): 1 = tensor cores (int8
// with d <= 1,040, bf16 with d <= 128; 128-row strips), 0 = the float32
// SIMT tile (64-row strips); hot [P, n_pairs, strips, words] of
// kernels.pairwise_threshold.hot_words(block, strip rows); warp_hot
// [P, n_pairs, strips, strips, 8] bytes (route 1 only)
extern "C" int repro_pairwise_threshold_q(
    const void* q, const void* sd, const void* l1, const void* sq,
    const void* lo, const void* hi, const void* meta, void* hot,
    void* warp_hot, void* row_count, void* row_off, void* out_v,
    void* out_i, void* out_j, void* count, int P, int k, int block, int d,
    int n_pairs,
    int block_rows, float threshold, long long capacity, int l2, int bf16,
    int route, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* sdf = (const float*)sd;
  const auto* l1f = (const float*)l1;
  const auto* sqf = (const float*)sq;
  const auto* lo_i = (const int*)lo;
  const auto* hi_i = (const int*)hi;
  const auto* mt = (const int*)meta;
  auto* hb = (uint32_t*)hot;
  auto* wh = (uint8_t*)warp_hot;
  auto* rc = (int*)row_count;
  auto* ro = (long long*)row_off;
  auto* ov = (float*)out_v;
  auto* oi = (int*)out_i;
  auto* oj = (int*)out_j;
  auto* cnt = (int*)count;
  if (route == 1 && bf16)
    return run_tc<__nv_bfloat16>(q, sdf, l1f, sqf, lo_i, hi_i, mt, hb, wh,
                                 rc, ro, ov, oi, oj, cnt, P, k, block, d,
                                 n_pairs, block_rows, threshold, capacity,
                                 l2, s);
  if (route == 1)
    return run_tc<int8_t>(q, sdf, l1f, sqf, lo_i, hi_i, mt, hb, wh, rc, ro,
                          ov, oi, oj, cnt, P, k, block, d, n_pairs,
                          block_rows, threshold, capacity, l2, s);
  if (bf16)
    return run_simt<__nv_bfloat16>((const __nv_bfloat16*)q, sdf, l1f, sqf,
                                   lo_i, hi_i, mt, hb, rc, ro, ov, oi, oj,
                                   cnt, P, k, block, d, n_pairs, block_rows,
                                   threshold, capacity, l2, s);
  return run_simt<int8_t>((const int8_t*)q, sdf, l1f, sqf, lo_i, hi_i, mt,
                          hb, rc, ro, ov, oi, oj, cnt, P, k, block, d,
                          n_pairs, block_rows, threshold, capacity, l2, s);
}
