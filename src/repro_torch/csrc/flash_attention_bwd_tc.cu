// B9 backward in bf16 on Hopper's tensor cores (wgmma): the gradient of
// the forward kernels of flash_attention_tc.cu / flash_attention.cu, for
// bfloat16 q / k / v with hd a multiple of 8 up to 128 (float32, and hd
// 256, run on the TF32 kernel pair of flash_attention_bwd.cu, whose header
// states the function: D = rowsum(dO * O), P = exp(c S - lse), dV = P^T dO,
// dS = P * (dO V^T - D), dQ = c dS K, dK = c dS^T Q, dK / dV summed over
// each kv head's G query heads, end-aligned causal masks, a row that sees
// no key at P = 1 / Tk with dS = 0; flash_bwd::p_ds is the rule).  It
// replaces no TPU kernel: the JAX package has no Pallas backward and
// differentiates its plain attention with XLA; this is the gradient of
// flash_attention_pallas (repro/kernels/flash_attention.py:103), whose
// forward the port runs as flash_attention_tc.cu.
//
// Bound on the H100: the bf16 tensor cores, 10 * hd operations per visible
// (query, key) pair (S, dP, dV, dK, dQ; 989 TFLOP/s dense).  This design
// forms S and dP once per visible pair, so it issues those 10 * hd, all of
// them as wgmma; the rest is one exp per pair and the dQ sums.
//
// Design, three launches:
//   1. bwd_prologue_kernel: D = rowsum(dO * O) in f32 (8 lanes a row, each
//      over its 16-byte chunks in order, then a fixed xor tree) and lse,
//      both to [B, H, TqP] (TqP: Tq rounded up to 64, rows past Tq 0), and
//      the dQ chain counters to 0.  Bytes-bound (O and dO read once).
//   2. bwd_tc_kernel: a block per (key tile of 128, b, kv head, slice of
//      that kv head's G query heads), numbered key-tile-major.  Two
//      warpgroups of 64 keys; K and V of the tile resident in the 128-byte
//      swizzled layout of hopper.cuh.  Units of (64-row query tile, head)
//      stream through a two-stage cp.async ring (Q, dO, lse, D), query
//      tiles from the last down to the first that sees the tile's keys, the
//      slice's heads in order within each.  Per unit and warpgroup:
//        S^T = K Q^T, dP^T = V dO^T           wgmma SS m64n64, K-major,
//                                             two commit groups;
//        P^T (p_ds; ex2 on whole tiles)       while dP^T runs;
//        dV += P^T dO                         wgmma RS, P^T the bf16
//                                             register A operand;
//        dS^T = P^T (dP^T - D), to shared     while dV runs;
//        memory in bf16; dK += dS^T Q         wgmma RS;
//        dQ_tile = dS K                        wgmma SS m64n64, A and B
//                                             MN-major (hd 128: each
//                                             warpgroup 64 columns; hd 64:
//                                             warpgroup 0).
//      dQ without float atomics, in a fixed order: each (b, h, query tile)
//      has an integer counter.  At the top of a unit the block of key tile
//      kt waits (acquire) until it reads kt and copies the f32 dQ so far
//      into shared memory (cp.async, landing under the products); after
//      the product it adds its tile and stores it with plain stores (key
//      tile 0 writes it, the last key tile of the chain writes dq in bf16
//      with the scale), and thread 0 releases kt + 1 after the next
//      barrier.  A block only waits on the block ncol linear indices before
//      it, so with blocks dispatched in order the lowest unfinished block
//      always runs; key tile 0, the heaviest under causal masking, comes
//      first.  A wait longer than 10 s traps (a fault, never a hang).
//   3. bwd_slices_kernel (only when the heads are cut into s > 1 slices,
//      chosen by the wrapper so that the grid has about three blocks per
//      SM): dK and dV's f32 partials summed in slice order, to bf16.
// P and dS enter their products rounded to bf16 (2^-9 relative), as in
// FlashAttention-2; S, dP and every sum stay f32.  Every sum runs in a
// fixed order, so two launches give the same bits.
//
// What holds it back on the H100 (measured times in PERF.md): the two
// warpgroups run each unit in lockstep between two block barriers, so the
// tensor cores idle while P, dS and the dQ sums are formed; hd 128 fills
// the 255 registers (dK and dV stay in the accumulators), which leaves no
// room for a second block on the SM or for the next unit's products in
// flight.  A producer warp with TMA and setmaxnreg, and the two
// warpgroups out of phase, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using flash_bwd::p_ds;

constexpr int kBQ = 64;          // query rows a unit
constexpr int kBK = 128;         // keys a block, 64 a warpgroup
constexpr int kThreads = 256;    // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned long long kSpinLimitNs = 10000000000ull;

template <int HDP>
struct Cfg {
  static constexpr int kKV = kBK * HDP * 2;   // a K or V tile
  static constexpr int kQ = kBQ * HDP * 2;    // a Q or dO tile
  static constexpr int kDS = kBK * kBQ * 2;   // the dS^T tile
  static constexpr int kRing = 2 * 2 * kQ;    // two stages of Q, dO
  static constexpr int kRows = 2 * kBQ * 4;   // a stage's lse and D
  static constexpr int kAccLd = HDP + 4;      // row stride of the dQ tile
  static constexpr int kAcc = kBQ * kAccLd * 4;   // a unit's f32 dQ so far
  static constexpr int kSmem =
      2 * kKV + kDS + kRing + 2 * kRows + kAcc + 1024;
  static constexpr int kNDQ = HDP / 64;       // warpgroups that form dQ
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// until the chain counter reads at least want (a key tile's predecessors
// have added their dQ); a wait past kSpinLimitNs traps
__device__ __forceinline__ void wait_for(const int* ctr, int want) {
  if (ld_acquire(ctr) >= want) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(ctr) < want) {
    __nanosleep(64);
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// rows [t0, t0 + R) x columns [0, HDP) of a [T, hd] bf16 slice with row
// stride st into the swizzled tile at dst, by cp.async (zero past T and
// past hd; hd % 8 == 0, 16-byte aligned rows)
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, int R,
                                          const bf16* __restrict__ g, int t0,
                                          int T, long long st, int hd,
                                          int tid) {
  constexpr int CPR = HDP / 8;   // 16-byte chunks per row
  for (int idx = tid; idx < R * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = t0 + r < T && c * 8 < hd;
    cp_async16(dst + swizzled(R, r, c * 8),
               ok ? g + (long long)(t0 + r) * st + c * 8 : g, ok ? 16 : 0);
  }
}

// S^T or dP^T [64 keys x 64 queries] = X Y^T: X the warpgroup's 64 rows of
// a K-major [kBK x HDP] tile (sX at its first row), Y a K-major
// [kBQ x HDP] tile
template <int HDP>
__device__ __forceinline__ void mma_keys(float (&acc)[32], uint32_t sX,
                                         uint32_t sY) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t cx = (kk / 4) * (kBK * 128) + (kk % 4) * 32;
    const uint32_t cy = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
    wgmma_ss_n64(acc, wgmma_desc(sX + cx, 16, 1024),
                 wgmma_desc(sY + cy, 16, 1024), kk > 0);
  }
}

template <int HDP>
__device__ __forceinline__ void mma_hd(float (&d)[HDP / 2],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_hd<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  wgmma_rs_n64(d, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_hd<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n128(d, a, db, 1);
}

// acc [64 keys x HDP] += W [64 keys x 64 queries] (register A fragments)
// Y [64 queries x HDP] (Y the MN-major B operand, read in place)
template <int HDP>
__device__ __forceinline__ void mma_acc(float (&acc)[HDP / 2],
                                        const uint32_t (&w)[4][4],
                                        uint32_t sY) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_hd<HDP>(acc, w[kk], wgmma_desc(sY + kk * 16 * 128, kBQ * 128, 1024));
}

// dQ [64 queries x 64 columns] = dS [64 queries x 128 keys] K [128 keys x
// 64 columns]: dS^T (rows = keys) and K's 64-column block (sKc), both
// MN-major
__device__ __forceinline__ void mma_dq(float (&acc)[32], uint32_t sDS,
                                       uint32_t sKc) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss_tt_n64(acc, wgmma_desc(sDS + kk * 2048, kBK * 128, 1024),
                    wgmma_desc(sKc + kk * 2048, kBK * 128, 1024), kk > 0);
}

// the warpgroup's dS^T fragments into the [kBK keys x kBQ queries] tile
// (rows 64 wg ..), for dQ
__device__ __forceinline__ void store_ds(uint32_t sDS, int wg, int rrow,
                                         int tig, const uint32_t (&w)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st_shared_u32(sDS + swizzled(kBK, 64 * wg + rrow + 8 * (r & 1),
                                   8 * (2 * kk + r / 2) + 2 * tig),
                    w[kk][r]);
}

// D = rowsum(dO * O) and lse as [B, H, TqP] f32 (rows past Tq: 0), and the
// chain counters to 0.  Eight lanes a row.
__global__ void __launch_bounds__(256)
bwd_prologue_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ Dt,
                    float* __restrict__ lset, int* __restrict__ counters,
                    long long n_counters, int B, int Tq, int TqP, int H,
                    int hd) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gtid < n_counters) counters[gtid] = 0;
  const long long row = gtid / 8;
  if (row >= (long long)B * H * TqP) return;   // whole groups of 8 leave
  const int part = threadIdx.x % 8;
  const unsigned mask = 0xffu << (threadIdx.x % 32 / 8 * 8);
  const long long bh = row / TqP;
  const int i = (int)(row % TqP), b = (int)(bh / H), h = (int)(bh % H);
  float acc = 0.f, l = 0.f;
  if (i < Tq) {
    const long long at = ((long long)b * Tq + i) * H + h;
    for (int c = part; c * 8 < hd; c += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + at * hd + c * 8);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + at * hd + c * 8);
      const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yo = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xo[e]);
        const float2 d = __bfloat1622float2(yo[e]);
        acc = fmaf(d.x, a.x, acc);
        acc = fmaf(d.y, a.y, acc);
      }
    }
    l = lse[at];
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1) acc += __shfl_xor_sync(mask, acc, w, 8);
  if (part == 0) {
    Dt[row] = acc;
    lset[row] = l;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lset, const float* __restrict__ Dt,
              float* __restrict__ dqacc, bf16* __restrict__ dq,
              float* __restrict__ dkp, float* __restrict__ dvp,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              int* __restrict__ counters, int B, int Tq, int Tk, int H,
              int KV, int hd, int nsl, int causal, float scale) {
  using C = Cfg<HDP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::kKV, sDS = base + 2 * C::kKV;
  const uint32_t sRing = sDS + C::kDS;      // stage st: Q, then dO
  const uint32_t sRows = sRing + C::kRing;  // stage st: lse [64], D [64]
  const uint32_t sAcc = sRows + 2 * C::kRows;   // the unit's dQ so far
  const float* rows_g =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  const float* acc_s = reinterpret_cast<const float*>(smem_raw + (sAcc - raw));

  const int G = H / KV, ncol = B * KV * nsl;
  const int kt = blockIdx.x / ncol, col = blockIdx.x % ncol;
  const int sl = col % nsl, b = col / nsl / KV, kvh = col / nsl % KV;
  const int g_lo = sl * G / nsl, nh = (sl + 1) * G / nsl - g_lo;
  const int k0 = kt * kBK, off = Tk - Tq;
  const int nqt = (Tq + kBQ - 1) / kBQ, TqP = nqt * kBQ;
  const int nkt = (Tk + kBK - 1) / kBK;
  // the first query tile with a row that sees these keys; with causal
  // Tq > Tk the first rows see no key and weigh every key: start at 0
  const int qt0 = causal && off >= 0 ? max(0, k0 - off) / kBQ : 0;
  const int nunits = (nqt - qt0) * nh;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, tig = lt % 4;
  const int rrow = 16 * (lt / 32) + (lt % 32) / 4;   // accumulator row (+8)
  const int kw0 = k0 + 64 * wg;                      // warpgroup's first key
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const bf16* kb = k + (long long)b * Tk * sk + (long long)kvh * hd;
  const bf16* vb = v + (long long)b * Tk * sk + (long long)kvh * hd;

  // unit u: query tile nqt - 1 - u / nh, head kvh * G + g_lo + u % nh
  auto load_unit = [&](int u, int st) {
    const int qt = nqt - 1 - u / nh, h = kvh * G + g_lo + u % nh;
    const long long qo = (long long)b * Tq * sq + (long long)h * hd;
    const uint32_t sQ = sRing + st * 2 * C::kQ;
    load_tile<HDP>(sQ, kBQ, q + qo, qt * kBQ, Tq, sq, hd, tid);
    load_tile<HDP>(sQ + C::kQ, kBQ, dout + qo, qt * kBQ, Tq, sq, hd, tid);
    if (tid < 32) {
      const long long ro = ((long long)b * H + h) * TqP + qt * kBQ;
      const float* src = tid < 16 ? lset + ro + 4 * tid
                                  : Dt + ro + 4 * (tid - 16);
      cp_async16(sRows + st * C::kRows + tid * 16, src, 16);
    }
  };

  // group 0: K, V and unit 0; group 1: unit 1
  load_tile<HDP>(sK, kBK, kb, k0, Tk, sk, hd, tid);
  load_tile<HDP>(sV, kBK, vb, k0, Tk, sk, hd, tid);
  load_unit(0, 0);
  cp_async_commit();
  if (nunits > 1) load_unit(1, 1);
  cp_async_commit();

  float dka[HDP / 2], dva[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dka[i] = dva[i] = 0.f;
  const float inv_tk = 1.f / (float)Tk;
  const float sl2 = scale * kLog2e;
  int* release = nullptr;   // the counter to release at the next barrier

  for (int u = 0; u < nunits; ++u) {
    const int st = u & 1;
    const int qt = nqt - 1 - u / nh, h = kvh * G + g_lo + u % nh;
    const int q0 = qt * kBQ;
    cp_async_wait<1>();   // unit u (and K, V) landed
    fence_proxy_async();
    __syncthreads();
    // every thread's dQ stores of the previous unit precede this barrier:
    // pass the chain on
    if (release != nullptr && tid == 0) st_release(release, kt + 1);
    release = nullptr;

    const uint32_t sQ = sRing + st * 2 * C::kQ, sdO = sQ + C::kQ;
    const float* lse_s = rows_g + st * (C::kRows / 4);
    const float* D_s = lse_s + kBQ;
    // this warpgroup's 64 keys against the unit's rows: nothing visible
    // (and no row that sees no key), or every pair visible
    const bool skip = kw0 >= Tk ||
                      (causal && q0 + off >= 0 &&
                       kw0 > min(q0 + kBQ, Tq) - 1 + off);
    const bool whole = q0 + kBQ <= Tq && kw0 + 64 <= Tk &&
                       (!causal || kw0 + 63 <= q0 + off);

    // the dQ chain of (b, h, qt): key tiles 0 .. last in order
    const int last = causal && off >= 0
                         ? min(nkt - 1, (q0 + kBQ - 1 + off) / kBK)
                         : nkt - 1;
    int* ctr = counters + ((long long)b * H + h) * nqt + qt;
    float* acc = dqacc + (((long long)b * H + h) * TqP + q0) * HDP + 64 * wg;

    // once key tile kt - 1 has added its part, the unit's dQ so far (this
    // warpgroup's 64 columns) into shared memory, landing under the
    // products below (the spin stays outside every wgmma's flight)
    if (kt > 0 && wg < C::kNDQ) {
      wait_for(ctr, kt);
      for (int idx = lt; idx < kBQ * 16; idx += 128) {
        const int r = idx / 16, c4 = idx % 16;
        cp_async16(sAcc + (r * C::kAccLd + 64 * wg + 4 * c4) * 4,
                   acc + (long long)r * HDP + 4 * c4, 16);
      }
    }
    cp_async_commit();

    uint32_t dsa[4][4];   // dS^T, bf16 A fragments
    if (!skip) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_keys<HDP>(s, sK + wg * 64 * 128, sQ);    // S^T = K Q^T
      wgmma_commit();
      mma_keys<HDP>(dp, sV + wg * 64 * 128, sdO);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();   // S^T (dP^T may still run)
      fence_regs(s);
      // element i: key kw0 + rrow + 8 ((i / 2) & 1), query q0 + 8 (i / 4)
      // + 2 tig + (i & 1); P^T first (dS^T needs dP^T), in s
      if (whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2_approx(fmaf(
              s[i], sl2, -lse_s[8 * (i / 4) + 2 * tig + (i & 1)] * kLog2e));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + 2 * tig + (i & 1);
          float ds;
          p_ds(s[i], 0.f, q0 + c, kw0 + rrow + 8 * ((i / 2) & 1), Tq, Tk,
               off, causal, scale, lse_s[c], 0.f, inv_tk, s[i], ds);
        }
      }
      // P^T as bf16 A fragments (k step kk holds queries 16 kk ..)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wgmma_fence();
      mma_acc<HDP>(dva, pa, sdO);   // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();   // dP^T (dV may still run)
      fence_regs(dp);
      // dS^T = P^T * (dP^T - D), 0 where p_ds passes no gradient (masked
      // keys, rows past Tq or that see no key)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + 2 * tig + (i & 1);
        float ds = s[i] * (dp[i] - D_s[c]);
        if (!whole) {
          const int qi = q0 + c, kj = kw0 + rrow + 8 * ((i / 2) & 1);
          if (qi >= Tq || kj >= Tk || (causal && (qi + off < 0 ||
                                                  kj > qi + off)))
            ds = 0.f;
        }
        dp[i] = ds;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      store_ds(sDS, wg, rrow, tig, dsa);   // before dsa feeds a wgmma
      wgmma_fence();
      mma_acc<HDP>(dka, dsa, sQ);   // dK += dS^T Q
      wgmma_commit();
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsa[kk][r] = 0u;
      store_ds(sDS, wg, rrow, tig, dsa);
    }
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    cp_async_wait<0>();   // the dQ tile, and unit u + 1 (issued a unit ago)
    fence_proxy_async();
    __syncthreads();   // dS^T and the dQ tile whole; ring stage st is free
    if (u + 2 < nunits) load_unit(u + 2, st);
    cp_async_commit();

    if (wg < C::kNDQ) {
      float dqa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      fence_regs(dqa);
      wgmma_fence();
      mma_dq(dqa, sDS, sK + wg * kBK * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int r2 = n / 8, j = n % 8, row = rrow + 8 * r2;
        const int c = 8 * j + 2 * tig;
        float2 x = make_float2(dqa[4 * j + 2 * r2], dqa[4 * j + 2 * r2 + 1]);
        if (kt > 0) {
          const float2 y = *reinterpret_cast<const float2*>(
              acc_s + row * C::kAccLd + 64 * wg + c);
          x.x = y.x + x.x;
          x.y = y.y + x.y;
        }
        if (kt == last) {
          const int i = q0 + row, d = 64 * wg + c;
          if (i < Tq && d < hd)
            *reinterpret_cast<__nv_bfloat162*>(
                dq + (((long long)b * Tq + i) * H + h) * hd + d) =
                __floats2bfloat162_rn(x.x * scale, x.y * scale);
        } else {
          __stcg(reinterpret_cast<float2*>(acc + (long long)row * HDP + c),
                 x);
        }
      }
      // released by thread 0 after the next barrier, which orders every
      // thread's stores before it (the release is cumulative)
      if (kt != last) release = ctr;
    }
  }
  __syncthreads();
  if (release != nullptr && tid == 0) st_release(release, kt + 1);

  // dK (scaled) and dV of the warpgroup's 64 keys: bf16 when the heads are
  // one slice, else this slice's f32 partial
  const long long n_kv = (long long)B * Tk * KV * hd;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int key = kw0 + rrow + 8 * r2;
    if (key >= Tk) continue;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * tig;
      if (d >= hd) continue;
      const long long at = (((long long)b * Tk + key) * KV + kvh) * hd + d;
      const float2 kx = make_float2(dka[4 * j + 2 * r2], dka[4 * j + 2 * r2 + 1]);
      const float2 vx = make_float2(dva[4 * j + 2 * r2], dva[4 * j + 2 * r2 + 1]);
      if (nsl == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(kx.x * scale, kx.y * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(vx.x, vx.y);
      } else {
        *reinterpret_cast<float2*>(dkp + sl * n_kv + at) = kx;
        *reinterpret_cast<float2*>(dvp + sl * n_kv + at) = vx;
      }
    }
  }
}

// dK = scale * sum of the slices' partials, dV = their sum, in slice order
__global__ void __launch_bounds__(256)
bwd_slices_kernel(const float* __restrict__ dkp, const float* __restrict__ dvp,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, long long n4,
                  int nsl, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = reinterpret_cast<const float4*>(dkp)[i];
  float4 c = reinterpret_cast<const float4*>(dvp)[i];
  for (int s = 1; s < nsl; ++s) {
    const float4 x = reinterpret_cast<const float4*>(dkp + s * 4 * n4)[i];
    const float4 y = reinterpret_cast<const float4*>(dvp + s * 4 * n4)[i];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  __nv_bfloat162* ko = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i;
  __nv_bfloat162* vo = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i;
  ko[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
  ko[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  vo[0] = __floats2bfloat162_rn(c.x, c.y);
  vo[1] = __floats2bfloat162_rn(c.z, c.w);
}

template <int HDP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dout, float* Dt, float* lset,
           float* dqacc, int* counters, float* dkp, float* dvp, bf16* dq,
           bf16* dk, bf16* dv, int B, int Tq, int Tk, int H, int KV, int hd,
           int causal, int nsl, cudaStream_t stream) {
  const int bytes = Cfg<HDP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + kBQ - 1) / kBQ, nkt = (Tk + kBK - 1) / kBK;
  const long long n_counters = (long long)B * H * nqt;
  const long long pro_threads =
      max(n_counters, 8LL * B * H * (long long)nqt * kBQ);
  const long long pro_blocks = (pro_threads + 255) / 256;
  const long long blocks = (long long)nkt * B * KV * nsl;
  if (pro_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const float scale = 1.f / sqrtf((float)hd);
  bwd_prologue_kernel<<<(unsigned)pro_blocks, 256, 0, stream>>>(
      o, dout, lse, Dt, lset, counters, n_counters, B, Tq, nqt * kBQ, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_tc_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      q, k, v, dout, lset, Dt, dqacc, dq, dkp, dvp, dk, dv, counters, B, Tq,
      Tk, H, KV, hd, nsl, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsl == 1) return (int)err;
  const long long n4 = (long long)B * Tk * KV * hd / 4;
  bwd_slices_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      dkp, dvp, dk, dv, n4, nsl, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, o, do, dq, dk, dv, contiguous, hd % 8 == 0 and hd <=
// 128, 16-byte aligned; lse [B, Tq, H] float32.  Scratch from the caller:
// Dt, lset [B, H, TqP] f32 and dqacc [B, H, TqP, HDP] f32 (TqP = Tq rounded
// up to 64, HDP = 64 for hd <= 64, else 128), counters [B, H, TqP / 64]
// int32, and for nsl > 1 head slices dkp, dvp [nsl, B, Tk, KV, hd] f32
// (else null).  nsl in 1 .. H / KV.
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* Dt, void* lset, void* dqacc,
    void* counters, void* dkp, void* dvp, void* dq, void* dk, void* dv, int B,
    int Tq, int Tk, int H, int KV, int hd, int causal, int nsl,
    void* stream) {
  if (hd % 8 != 0 || hd > 128 || nsl < 1 || nsl > H / KV ||
      (nsl > 1 && (dkp == nullptr || dvp == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto* st = (cudaStream_t)stream;
  const auto* bq = (const bf16*)q;
  const auto* bk = (const bf16*)k;
  const auto* bv = (const bf16*)v;
  const auto* bo = (const bf16*)o;
  const auto* bdo = (const bf16*)dout;
  if (hd <= 64)
    return launch<64>(bq, bk, bv, bo, (const float*)lse, bdo, (float*)Dt,
                      (float*)lset, (float*)dqacc, (int*)counters,
                      (float*)dkp, (float*)dvp, (bf16*)dq, (bf16*)dk,
                      (bf16*)dv, B, Tq, Tk, H, KV, hd, causal, nsl, st);
  return launch<128>(bq, bk, bv, bo, (const float*)lse, bdo, (float*)Dt,
                     (float*)lset, (float*)dqacc, (int*)counters, (float*)dkp,
                     (float*)dvp, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, Tq, Tk,
                     H, KV, hd, causal, nsl, st);
}
