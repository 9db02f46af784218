// B8: quantized per-slot running top-k lists (replaces the Pallas kernel
// repro/kernels/pairwise_batch_q.py:pairwise_topk_q_pallas, body
// _pairwise_topk_q_kernel).
//
// B6 (pairwise_topk.cu) over int8 or bf16 codes: for every simulated
// device p and active slot pair (lo, hi), the rows of each slot take the
// other slot's valid rows as candidates (c != r on a self tile, whose hi
// side is skipped); each entry is the code dot times s_lo * s_hi (the
// per-slot scales, sd[.., 0]), and l2 subtracts the exact stored squared
// norms sq: (2 s - sq_cand) - sq_row.  Each row keeps its topk best under
// the (-score, index) order.  No error band: the host certifies and
// rescores the lists (core/quant.py).
//
// Bound on the H100: 2*d operations per candidate pair of an active tile
// at the int8 (1,979 TOP/s) or bf16 (989 TFLOP/s) tensor-core rate.
//
// Design (route "tensor_cores", every d up to kernels/pairwise_batch_q.py's
// limits: int8 d <= 66,572, bf16 d <= 2^20).  One block of 8 warps owns
// 128 rows of one (device, slot): it walks the pairs in order and scores
// every tile that touches its slot from its own side, against 128-row
// tiles of the other slot, so it is the only writer of its rows' lists (a
// non-self tile is formed twice, once per side: on the tensor cores that
// costs milliseconds).  The codes stay in their storage type: the block's
// own rows stay resident in shared memory when they fit (up to 256 bytes
// a row), and the candidate rows (and own rows, when longer) stream
// through a 2-stage 16-byte cp.async ring, 128 bytes of d a stage, all
// K-contiguous as stored, rows padded by 16 bytes so ldmatrix reads
// without bank conflicts; the ring runs on across tiles, so the next tile
// loads while this one is selected.  Each warp forms a 32 x 64 sub-tile
// with mma.sync: int8 m16n8k32 into s32, bf16 m16n8k16 into f32.
// mma.sync rather than wgmma: the dequant epilogue and the selection on
// the CUDA cores cost more than the products, and its small accumulator
// fragments leave registers for two blocks an SM.  Interior tiles skip
// the masks; int8 dots convert to float32 by an integer add and a float
// subtract where |dot| < 2^22 (I2F issues at a quarter rate).  Selection
// is B4's (topk_select.cuh): each score is compared in registers with its
// row's admission bound, the few that beat it are queued, and the queues
// drain into the rows' running lists once one is half full: shared
// memory for lists of up to 32 entries, else global scratch, held in a
// warp's registers while it drains a list of up to 512 (a separate kernel
// instance for each); order_kernel (pair_tile.cuh) sorts the lists.
//
// Exactness, int8.  Products are at most 127^2, so the s32 sums are exact
// while d * 127^2 < 2^31 (d <= 133,143) and convert once, rounding to
// nearest (__int2float_rn; exactly below 2^24, d <= 1,040).  So the dot
// is the exact integer dot rounded once to float32, and with this file
// compiled with -fmad=false the epilogue rounds op for op as the plain
// version's does.  Up to d = 1,040 every partial sum is exact in float32
// too, so the plain version's float32 matmul gives the same dot in any
// order and the int8 lists equal its lists, ties included; above, the
// lists equal a float64 evaluation of the dot rounded once to float32
// and then the same epilogue.  The route's limit, 66,572, is B7's
// (pairwise_threshold_q.cu), so one route_of serves both.
//
// Accuracy, bf16.  Products are exact.  The tensor cores add them
// without rounding to nearest (each m16n8k16 step truncates), so a single
// accumulator over d drifts with d and, near zero where the tie rule is
// 1e-5 absolute, leaves the plain version's float32 sum behind past
// d = 128.  So rows longer than 128 (never resident) join each chunk of
// kChunk = 32 of d (chunk_join.cuh, set from BF16_CHUNK) into a running
// float32 sum in ascending order,
// compensated: t = run + chunk, and the join's rounding error
// (run - t) + chunk starts the next chunk's accumulator (Kahan's
// summation with the compensation carried forward), so the joins add
// almost nothing and the truncations act on 32 products at a time.
// Against float64 this reads below the plain float32 version's error,
// which longer chunks or joins by plain adds do not (chip_smoke.py phase
// 10; scripts/pair_q_chunks.py).  The second set of 64 accumulators
// a thread needs leaves one block an SM (up to 255 registers a thread).
// The host's certificate of the lists (core/quant.py) holds the quantized
// score to eps; the slack eps leaves for rounding covers this sum at every
// width up to the route's limit (B7's argument, in
// pairwise_threshold_q.cu's header).
//
// Route "simt" (the wrapper's route= override only): pair_tile.cuh's
// float32 tile, one fmaf chain over d, kept as a yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "chunk_join.cuh"
#include "hopper.cuh"
#include "pair_tile.cuh"
#include "topk_select.cuh"

namespace {

using namespace hopper;
using chunk_join::chunked;
using namespace topk_select;
using pair_tile::load_meta;
using pair_tile::Meta;

constexpr int kRows = 128;       // own rows per block
constexpr int kCols = 128;       // other-slot rows per score tile
constexpr int kSlice = 128;      // bytes of d per ring stage
constexpr int kLd = kSlice + 16;  // ring row stride (bytes)
constexpr int kStages = 2;
constexpr int kResBytes = 256;   // own rows up to this long stay resident
constexpr int kThreads = 256;    // 8 warps: 4 (32 rows) x 2 (64 columns)
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 16;       // queued candidates per row
constexpr int kSmemTp = 32;      // lists up to this long live in shared memory
constexpr int kSmallD = 260;     // int8 dots below 2^22 in magnitude

struct Sel {
  Queues<kRows, kQueue> q;
  float rn[kRows];   // |row|^2 (l2)
  float cn[kCols];   // |candidate|^2 of the tile (l2)
};

// int8 sums are s32, bf16 sums f32; an epilogue score is kept in the same
// register as a float bit pattern
template <typename T> struct Acc;
template <> struct Acc<int8_t> {
  using type = int;
  // |a| < 2^22 (d <= 260): a + 1.5 * 2^23 as a float holds a in its low
  // mantissa bits, so one integer add and one float subtract convert it
  // exactly at full rate (I2F issues at a quarter of it)
  static __device__ __forceinline__ float dot(int a, bool small) {
    return small ? __int_as_float(a + 0x4B400000) - 12582912.0f
                 : __int2float_rn(a);
  }
  static __device__ __forceinline__ int bits(float s) {
    return __float_as_int(s);
  }
  static __device__ __forceinline__ float score(int a) {
    return __int_as_float(a);
  }
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};
template <> struct Acc<__nv_bfloat16> {
  using type = float;
  static __device__ __forceinline__ float dot(float a, bool) { return a; }
  static __device__ __forceinline__ float bits(float s) { return s; }
  static __device__ __forceinline__ float score(float a) { return a; }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

// One (pair, side) that feeds this block's slot: the other slot, the
// candidates' global block, their valid count, the self-tile diagonal,
// and the scale product.
struct Seg {
  int other, g, nv, excl;
  float sprod;
};

// The block's walk over (pair, side, 128-row tile c0, d slice ks).
struct Walk {
  int pair, side, c0, ks;
  bool done;
  Seg seg;
};

struct Sched {
  const int *lo, *hi, *meta;  // meta of this device
  const float* sd;            // [k, 2] of this device
  int slot, n_pairs, nks;

  __device__ __forceinline__ bool seg_of(int pair, int side, Seg& s) const {
    const Meta m = load_meta(meta + (size_t)pair * 6);
    if (m.active != 1) return false;
    const int l = lo[pair], h = hi[pair];
    if (side == 0) {
      if (l != slot) return false;
      s = Seg{h, m.gb, m.nv_hi, m.is_self == 1, 0.f};
    } else {
      if (h != slot || m.is_self == 1) return false;
      s = Seg{l, m.ga, m.nv_lo, 0, 0.f};
    }
    s.sprod = sd[2 * l] * sd[2 * h];
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

// Rows [0, n_rows) of src (valid < ok_rows, row_bytes each), bytes
// [kb, kb + width) of each, to shared memory at dst with row stride ld;
// zeros past the valid rows and row_bytes.  Every thread of the block
// calls it with the same arguments.
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

// kResA: the block's own rows stay resident in shared memory (rows of at
// most kResBytes bytes), and only the candidate rows stream through the
// ring; else both stream, a slice at a time.  kLong: lists longer than
// kSmemTp, in global memory (a separate instance, so the short lists'
// kernel carries none of their drain's registers).  The chunked
// instances hold a second accumulator set: one block an SM.
template <typename T, bool kVec, bool kResA, bool kLong>
__global__ void __launch_bounds__(kThreads, chunked<T, kResA>() ? 1 : 2)
topk_tc_kernel(const T* __restrict__ quorum,   // [P, k, block, d]
               const float* __restrict__ sd,   // [P, k, 2]
               const float* __restrict__ sq,   // [P, k, block]
               const int* __restrict__ lo, const int* __restrict__ hi,
               const int* __restrict__ meta,   // [P, n_pairs, 6]
               float* __restrict__ list_v,     // [P, k, block, tp]
               int* __restrict__ list_i, int k, int block, int d,
               int n_pairs, int block_rows, int topk, int tp, int l2) {
  using A = Acc<T>;
  using AccT = typename A::type;
  constexpr int kStage = (kResA ? kCols : kRows + kCols) * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int p = blockIdx.z, slot = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, block - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;   // warp tile: 32 rows x 64 cols
  const int g = lane / 4, tig = lane % 4;
  const size_t dev_off = (size_t)p * k * block;
  const size_t slot_off = dev_off + (size_t)slot * block;
  const int row_bytes = d * (int)sizeof(T);
  const Sched sch{lo, hi, meta + (size_t)p * n_pairs * 6,
                  sd + (size_t)p * k * 2, slot, n_pairs,
                  max(1, (row_bytes + kSlice - 1) / kSlice)};
  // shared memory: the ring, the resident rows (kResA), the selection
  const uint32_t ring = smem_u32(tc_smem);
  const int a_ld = sch.nks * kSlice + 16;   // resident row stride (bytes)
  const uint32_t a_res = ring + kStages * kStage;
  Sel& sel = *reinterpret_cast<Sel*>(
      tc_smem + kStages * kStage + (kResA ? kRows * a_ld : 0));

  // the running lists: shared memory for short ones (entry t of row r's
  // list at t * kRows + r), else the global scratch; topk sentinels first
  constexpr bool in_smem = !kLong;
  float* lv = reinterpret_cast<float*>(&sel + 1);
  int* li = reinterpret_cast<int*>(lv + kRows * tp);
  if (!in_smem) {
    lv = list_v + (slot_off + r0) * tp;
    li = list_i + (slot_off + r0) * tp;
  }
  for (int e = tid; e < (in_smem ? kRows : rows) * tp; e += kThreads) {
    lv[e] = kNegInf;
    li[e] = kSentinel;
  }
  sel.q.init(tid, kThreads);
  if (tid < kRows)
    sel.rn[tid] = l2 && tid < rows ? sq[slot_off + r0 + tid] : 0.f;

  auto drain_lists = [&]() {
    if constexpr (kLong)
      sel.q.drain_warps(warp, kWarps, lv, li, tp, topk);
    else
      sel.q.drain_threads(lv, li, topk);
  };

  const uint8_t* Arows =
      reinterpret_cast<const uint8_t*>(quorum + (slot_off + r0) * d);
  auto load = [&](const Walk& w, int stage) {
    const uint8_t* B = reinterpret_cast<const uint8_t*>(
        quorum + (dev_off + (size_t)w.seg.other * block + w.c0) * d);
    const uint32_t dst = ring + stage * kStage;
    const int kb = w.ks * kSlice;
    if constexpr (kResA) {
      copy_rows<kVec>(dst, kLd, B, kCols, min(kCols, w.seg.nv - w.c0), kb,
                      kSlice, row_bytes, tid);
    } else {
      copy_rows<kVec>(dst, kLd, Arows, kRows, rows, kb, kSlice, row_bytes,
                      tid);
      copy_rows<kVec>(dst + kRows * kLd, kLd, B, kCols,
                      min(kCols, w.seg.nv - w.c0), kb, kSlice, row_bytes,
                      tid);
    }
  };
  Walk lw, cw;   // the loader runs kStages - 1 slices ahead
  sch.start(lw);
  sch.start(cw);
  if constexpr (kResA)   // the own rows once, in the first copy group
    copy_rows<kVec>(a_res, a_ld, Arows, kRows, rows, 0, sch.nks * kSlice,
                    row_bytes, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!lw.done) {
      load(lw, s);
      sch.step(lw);
    }
    cp_async_commit();
  }

  constexpr bool kChunked = chunked<T, kResA>();
  AccT acc[2][8][4], run[2][8][4];   // run: the joined chunks (kChunked)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = run[mi][nj][e] = 0;

  const bool small = d <= kSmallD;
  float cn = 0.f;   // this thread's candidate norm of the tile (l2)
  for (int it = 0; !cw.done; ++it) {
    if (cw.ks == 0 && l2 && tid < kCols) {
      const int c = cw.c0 + tid;
      cn = c < cw.seg.nv ? sq[dev_off + (size_t)cw.seg.other * block + c]
                         : 0.f;
    }
    // published before the barrier of the tile's last slice (the last
    // tile's readers are past a barrier)
    if (cw.ks == sch.nks - 1 && tid < kCols) sel.cn[tid] = cn;
    cp_async_wait<kStages - 2>();   // slice it landed
    __syncthreads();                // ... for every thread; slice it-1 done
    if (!lw.done) {
      load(lw, (it + kStages - 1) % kStages);
      sch.step(lw);
    }
    cp_async_commit();

    const uint32_t sb = ring + (it % kStages) * kStage +
                        (kResA ? 0 : kRows * kLd);
    const uint32_t sa = kResA ? a_res + cw.ks * kSlice
                              : ring + (it % kStages) * kStage;
    const int lda = kResA ? a_ld : kLd;
    const bool last = cw.ks == sch.nks - 1;
#pragma unroll
    for (int kk = 0; kk < kSlice / 32; ++kk) {
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
      // a chunk ends (or the row): into the running sums in ascending
      // chunk order (chunk_join.cuh)
      if constexpr (kChunked)
        if (chunk_join::ends(cw.ks * (kSlice / 32) + kk,
                             last && kk == kSlice / 32 - 1))
          chunk_join::join(run, acc);
    }
    if (!last) {
      sch.step(cw);
      continue;
    }
    if constexpr (kChunked) chunk_join::take(run, acc);   // the tile's dots

    // ---- the tile is scored: dequant epilogue, in place ----
    const int cols = min(kCols, cw.seg.nv - cw.c0);
    const float sprod = cw.seg.sprod;
    // only edge tiles mask: ragged rows or columns, or a self tile's
    // diagonal (cl - rl == r0 - c0 there)
    const bool edge = rows < kRows || cols < kCols ||
                      (cw.seg.excl && cw.c0 == r0);
    float rn[2][2];   // this thread's rows' norms
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rn[mi][h] = sel.rn[32 * wr + 16 * mi + g + 8 * h];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float cn_c = sel.cn[64 * wc + 8 * nj + 2 * tig + x];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            auto& a = acc[mi][nj][2 * h + x];
            float s = A::dot(a, small) * sprod;
            if (l2) s = (2.f * s - cn_c) - rn[mi][h];
            a = A::bits(s);
          }
      }
    if (edge) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = 32 * wr + 16 * mi + g + 8 * (e / 2);
            const int cl = 64 * wc + 8 * nj + 2 * tig + e % 2;
            if (rl >= rows || cl >= cols ||
                (cw.seg.excl && r0 + rl == cw.c0 + cl))
              acc[mi][nj][e] = A::bits(-INFINITY);
          }
    }
    // ---- selection: queue what beats each row's bound, then drain ----
    const int gbase = cw.seg.g * block_rows + cw.c0 + 64 * wc + 2 * tig;
    for (;;) {
      int pending = 0, drain = 0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 32 * wr + 16 * mi + g + 8 * h;   // 4 aligned lanes
          const float bv = sel.q.bound_v[rl];
          const int bi = sel.q.bound_i[rl];
          float top = A::score(acc[mi][0][2 * h]);
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              top = fmaxf(top, A::score(acc[mi][nj][2 * h + x]));
          if (!__any_sync(0xffffffffu, top >= bv)) continue;   // none passes
          unsigned m = 0;
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              if (before(A::score(acc[mi][nj][2 * h + x]), gbase + 8 * nj + x,
                         bv, bi))
                m |= 1u << (2 * nj + x);
          int pos = sel.q.template claim<4>(rl, __popc(m));
          drain |= m != 0 && pos + __popc(m) > kQueue / 2;
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              if (!(m >> (2 * nj + x) & 1)) continue;
              auto& a = acc[mi][nj][2 * h + x];
              if (pos < kQueue) {
                sel.q.put(pos, rl, A::score(a), gbase + 8 * nj + x);
                a = A::bits(-INFINITY);   // queued: never again
              } else {
                pending = 1;   // full: pending for the next round
              }
              ++pos;
            }
        }
      // a queue half full or a candidate pending: drain, then retry
      if (!__syncthreads_or(drain | pending)) break;
      drain_lists();
      if (!__syncthreads_or(pending)) break;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
    sch.step(cw);
  }

  cp_async_wait<0>();   // no copy outlives the block (no tiles at all)
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

template <typename T, bool kVec, bool kResA>
int launch_tc(const T* q, const float* sd, const float* sq, const int* lo,
              const int* hi, const int* meta, float* list_v, int* list_i,
              int P, int k, int block, int d, int n_pairs, int block_rows,
              int topk, int tp, int l2, cudaStream_t s) {
  const int nks = max(1, (d * (int)sizeof(T) + kSlice - 1) / kSlice);
  const size_t smem = kStages * (kResA ? kCols : kRows + kCols) * kLd +
                      (kResA ? kRows * (nks * kSlice + 16) : 0) +
                      sizeof(Sel) +
                      (tp <= kSmemTp ? (size_t)kRows * tp * 8 : 0);
  const auto kernel = tp <= kSmemTp ? topk_tc_kernel<T, kVec, kResA, false>
                                     : topk_tc_kernel<T, kVec, kResA, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((block + kRows - 1) / kRows, k, P);
  kernel<<<grid, kThreads, smem, s>>>(q, sd, sq, lo, hi, meta, list_v,
                                      list_i, k, block, d, n_pairs,
                                      block_rows, topk, tp, l2);
  return (int)cudaGetLastError();
}

template <typename T>
int run_tc(const void* q, const void* sd, const void* sq, const void* lo,
           const void* hi, const void* meta, void* list_v, void* list_i,
           void* out_v, void* out_i, int P, int k, int block, int d,
           int n_pairs, int block_rows, int topk, int tp, int l2,
           cudaStream_t s) {
  const int row_bytes = d * (int)sizeof(T);
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)q % 16 == 0;
  const bool res = row_bytes <= kResBytes;
  const int rc = (vec ? (res ? launch_tc<T, true, true>
                             : launch_tc<T, true, false>)
                      : (res ? launch_tc<T, false, true>
                             : launch_tc<T, false, false>))(
      (const T*)q, (const float*)sd, (const float*)sq, (const int*)lo,
      (const int*)hi, (const int*)meta, (float*)list_v, (int*)list_i, P, k,
      block, d, n_pairs, block_rows, topk, tp, l2, s);
  if (rc != 0) return rc;
  return pair_tile::launch_order((float*)list_v, (int*)list_i, (float*)out_v,
                                 (int*)out_i, (long long)P * k * block, topk,
                                 tp, s);
}

}  // namespace

// route (kernels/pairwise_batch_q.py:route_of): 1 = tensor cores (int8
// with d <= 66,572, bf16 with d <= 2^20), 0 = the float32 SIMT tile
// (the wrapper's route= override)
extern "C" int repro_pairwise_topk_q(const void* q, const void* sd,
                                     const void* sq, const void* lo,
                                     const void* hi, const void* meta,
                                     void* list_v, void* list_i, void* out_v,
                                     void* out_i, int P, int k, int block,
                                     int d, int n_pairs, int block_rows,
                                     int topk, int tp, int l2, int bf16,
                                     int route, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 1 && bf16)
    return run_tc<__nv_bfloat16>(q, sd, sq, lo, hi, meta, list_v, list_i,
                                 out_v, out_i, P, k, block, d, n_pairs,
                                 block_rows, topk, tp, l2, s);
  if (route == 1)
    return run_tc<int8_t>(q, sd, sq, lo, hi, meta, list_v, list_i, out_v,
                          out_i, P, k, block, d, n_pairs, block_rows, topk,
                          tp, l2, s);
  if (bf16)
    return pair_tile::launch_topk<__nv_bfloat16>(
        (const __nv_bfloat16*)q, (const float*)sd, (const float*)sq,
        (const int*)lo, (const int*)hi, (const int*)meta, (float*)list_v,
        (int*)list_i, (float*)out_v, (int*)out_i, P, k, block, d, n_pairs,
        block_rows, topk, tp, l2, s);
  return pair_tile::launch_topk<int8_t>(
      (const int8_t*)q, (const float*)sd, (const float*)sq, (const int*)lo,
      (const int*)hi, (const int*)meta, (float*)list_v, (int*)list_i,
      (float*)out_v, (int*)out_i, P, k, block, d, n_pairs, block_rows, topk,
      tp, l2, s);
}
