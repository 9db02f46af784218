// B9 backward: the gradient of flash attention (dq, dk, dv), hand-written
// for the H100.  The JAX package has no Pallas backward: its train step
// differentiates the plain jnp attention of repro/models/attention.py with
// XLA, so this kernel is the counterpart of that autodiff, for the forward
// kernels of flash_attention.cu / flash_attention_tc.cu (which replace
// repro/kernels/flash_attention.py:flash_attention_pallas).  It runs
// float32 inputs, and bfloat16 at the head widths the wgmma kernels of
// flash_attention_bwd_tc.cu do not take (hd not a multiple of 8, or above
// 128), on the TF32 tensor cores with the three-product split of
// tf32x3.cuh.
//
// q, o, do [B, Tq, H, hd], k / v [B, Tk, KV, hd], all contiguous, in one
// type (float32 or bfloat16); lse [B, Tq, H] float32 is the forward's
// m + log(l); head h reads kv head h / G (G = H / KV).  With the scale
// c = hd^-1/2 and S = c Q K^T under the forward's masks:
//   D  = rowsum(dO * O)                       (per query row and head)
//   P  = exp(S - lse)                         (0 on masked keys)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = c dS K,  dK = c dS^T Q,
// dK and dV summed over the G query heads of each kv head.  Causal masking
// is end-aligned (key j visible to query i iff j <= i + Tk - Tq).  A row
// that sees no key at all (Tq > Tk) averaged v over all Tk keys in the
// forward (the finite NEG_INF mask), so its P is 1 / Tk on every key and
// its dS is 0: the plain softmax's where() passes no gradient to a masked
// score.  Accumulation is float32; dq, dk, dv are written in the inputs'
// type.
//
// Design: two launches, no atomics, every sum in a fixed order (two calls
// give the same bits, as the reference's gradient is deterministic).
//   1. dq_kernel: a block of four warps per (b, h, 64 query rows), heavy
//      (late) tiles first, 16 rows a warp.  Prologue: D for its rows (a
//      warp a row, lanes over hd in order), written to the scratch
//      D [B, Tq, H] for launch 2.  Then a loop over the key tiles the rows
//      can see (64 keys at hd <= 64, else 32; tiles past the causal
//      diagonal skipped): S = Q K^T and dP = dO V^T into registers, dS by
//      flash_bwd::p_ds, dQ += dS K from dS's own C fragments.
//   2. dkv_kernel: a block of four warps per (b, kv head, BK keys), heavy
//      (early) tiles first, K and V held in shared memory.  It walks the G
//      query heads and, for each, the query tiles that see its keys (64
//      rows at hd <= 64, else 32), in that order: S^T = K Q^T, dP^T =
//      V dO^T, P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q.  At
//      hd <= 64 a warp owns 16 keys and their dK / dV rows (BK = 64); above,
//      two warps share 16 keys (BK = 32), each owning half the columns of
//      dK / dV (the two accumulators stay within the registers) and
//      forming S^T and dP^T over its half of hd; the two halves are added
//      through shared memory (both warps add the same two numbers, so both
//      get the same bits).
// Every product is mma.sync m16n8k8 TF32 (tf32x3.cuh), with the split
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi for float32 factors: one TF32
// product would miss the float32 rule of 1e-4 max(1, max |want|); the
// split reads at most 0.093 of it at starcoder2's training shape on the
// card (PERF.md).  bfloat16 inputs
// are exact in TF32: S and dP take one product, and dV, dK, dQ (one
// factor the split P or dS) two.  Operands sit in shared memory as float32
// rows (stride HDP + 4, zero past T and past hd rounded up to 8; float32
// by cp.async, bfloat16 widened on the way) and are split as their
// fragments are read.  The tensor core sums at most 32 of hd, or one
// tile, into a zeroed temp; the temps join the sums in float32 rounded to
// nearest (tf32x3.cuh: the MMA's accumulation rounds toward zero).
//
// Bound on the H100: 10 * hd operations per visible (query, key) pair for
// the algorithm (the products dV, dP, dS^T Q and dS K and the recomputed
// S), at the bf16 tensor cores' 989 TFLOP/s for bf16 inputs and the fp32
// rate, 67 TFLOP/s, for float32 ones; the split's own bound is its TF32
// operations at 495 TFLOP/s: 30 * hd a pair in float32, 16 * hd in
// bfloat16.  This pair forms S and dP in both launches, 14 * hd a pair of
// the algorithm's (42 * hd / 20 * hd TF32): passing dQ between the blocks
// of one key walk, as the wgmma route does, would keep a dQ tile in
// registers beside dK and dV, past the 255 a thread at hd 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_bwd.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using flash_bwd::p_ds;
using tf32x3::mma_regs;
using tf32x3::mma_rows;

constexpr int kThreads = 128;   // four warps

template <int HDP>
struct Tile {
  static constexpr int LD = HDP + 4;      // row stride of every tile
  static constexpr int ND = HDP / 8;      // n-tiles of a dQ row block
  // dq_kernel: 64 query rows, BKQ keys a tile
  static constexpr int BQ = 64;
  static constexpr int BKQ = HDP == 64 ? 64 : 32;
  // dkv_kernel: NH warps share 16 keys, BQK query rows a unit
  static constexpr int NH = HDP >= 128 ? 2 : 1;
  static constexpr int BK = 64 / NH;
  static constexpr int BQK = HDP == 64 ? 64 : 32;
  static constexpr int NDH = ND / NH;     // a warp's n-tiles of dK / dV
  static constexpr int NQ = BQK / 8;      // n-tiles of S^T
  static constexpr int kX = NH == 2 ? 4 * 2 * NQ * 4 * 32 : 0;  // exchange
  static constexpr int kDqFloats = (2 * BQ + 2 * BKQ) * LD + 2 * BQ;
  static constexpr int kDkvFloats = (2 * BK + 2 * BQK) * LD + 2 * BQK + kX;
};

template <typename T>
constexpr bool kExact = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// rows [t0, t0 + R) x columns [0, W) of a [T, hd] slice with row stride st
// into the float tile dst [R][LD] (zero past T and past hd; W = hd rounded
// up to 8).  float32 by cp.async (16-byte copies where hd % 4 == 0: the
// wrapper passes 16-byte-aligned contiguous tensors); bfloat16 widened by
// plain loads (16 bytes where hd % 8 == 0).  The caller commits / waits.
template <int LD, typename T>
__device__ __forceinline__ void load_rows(float* dst, int R,
                                          const T* __restrict__ g, int t0,
                                          int Tn, long long st, int hd,
                                          int W) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t s = smem_u32(dst);
    if (hd % 4 == 0) {
      const int cpr = W / 4;
      for (int idx = threadIdx.x; idx < R * cpr; idx += kThreads) {
        const int r = idx / cpr, c = (idx % cpr) * 4;
        const bool ok = t0 + r < Tn && c < hd;
        cp_async16(s + (uint32_t)(r * LD + c) * 4,
                   ok ? g + (long long)(t0 + r) * st + c : g, ok ? 16 : 0);
      }
    } else {
      for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
        const int r = idx / W, c = idx % W;
        const bool ok = t0 + r < Tn && c < hd;
        cp_async4(s + (uint32_t)(r * LD + c) * 4,
                  ok ? g + (long long)(t0 + r) * st + c : g, ok ? 4 : 0);
      }
    }
  } else {
    if (hd % 8 == 0) {
      const int cpr = W / 8;
      for (int idx = threadIdx.x; idx < R * cpr; idx += kThreads) {
        const int r = idx / cpr, c = (idx % cpr) * 8;
        float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (t0 + r < Tn) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(g + (long long)(t0 + r) * st + c);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = __bfloat162float(e[u]);
        }
        float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c);
        d4[0] = make_float4(x[0], x[1], x[2], x[3]);
        d4[1] = make_float4(x[4], x[5], x[6], x[7]);
      }
    } else {
      for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
        const int r = idx / W, c = idx % W;
        float x = 0.f;
        if (t0 + r < Tn && c < hd) x = to_f(g[(long long)(t0 + r) * st + c]);
        dst[r * LD + c] = x;
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// rows row0 (fragments 0, 1) and row0 + 8 (2, 3) of acc * mul, columns
// col0 + nd * 8 + 2 t + {0, 1}, into dst [Tn, hd] with row stride st
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long st,
                                           const float (&acc)[N][4], int row0,
                                           int col0, int Tn, int hd,
                                           float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= Tn) continue;
#pragma unroll
    for (int nd = 0; nd < N; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = col0 + nd * 8 + 2 * t + e;
        if (d < hd)
          dst[(long long)i * st + d] = from_f<T>(acc[nd][2 * r + e] * mul);
      }
  }
}

template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
dq_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const float* __restrict__ lse, const T* __restrict__ dout,
               float* __restrict__ Dg, T* __restrict__ dq, int BH, int nqt,
               int Tq, int Tk, int H, int KV, int G, int hd, int causal,
               float scale) {
  using C = Tile<HDP>;
  constexpr int LD = C::LD, BQ = C::BQ, BK = C::BKQ, NT = BK / 8;
  constexpr bool E = kExact<T>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ks = dOs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* lse_s = Vs + BK * LD;   // [BQ]
  float* D_s = lse_s + BQ;       // [BQ]

  const int qt = nqt - 1 - blockIdx.x / BH;   // heavy (late) tiles first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int off = Tk - Tq;
  const int W = (hd + 7) & ~7, nks = W / 8;
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const T* qb = q + ((long long)b * Tq * H + h) * hd;
  const T* ob = o + ((long long)b * Tq * H + h) * hd;
  const T* dob = dout + ((long long)b * Tq * H + h) * hd;
  const T* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  load_rows<LD>(Qs, BQ, qb, q0, Tq, sq, hd, W);
  load_rows<LD>(dOs, BQ, dob, q0, Tq, sq, hd, W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // D = rowsum(dO * O): a warp a row, lanes over hd in a fixed order
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int i = q0 + r;
    float acc = 0.f;
    if (i < Tq)
      for (int d = lane; d < hd; d += 32)
        acc = fmaf(dOs[r * LD + d], to_f(ob[(long long)i * sq + d]), acc);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      D_s[r] = acc;
      lse_s[r] = i < Tq ? lse[((long long)b * Tq + i) * H + h] : 0.f;
      if (i < Tq) Dg[((long long)b * Tq + i) * H + h] = acc;
    }
  }

  float acc[C::ND][4];
  zero(acc);
  // keys the rows can see; rows that see none get dQ = 0
  int kv_end = Tk;
  if (causal) kv_end = max(0, min(Tk, min(q0 + BQ, Tq) - 1 + off + 1));
  const float inv_tk = 1.f / (float)Tk, one[2] = {1.f, 1.f};
  const int r0 = warp * 16 + gq;   // the thread's rows r0 and r0 + 8

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's K and V are consumed
    load_rows<LD>(Ks, BK, kb, k0, Tk, sk, hd, W);
    load_rows<LD>(Vs, BK, vb, k0, Tk, sk, hd, W);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    mma_rows<NT, LD, E, E, 4>(s, Qs + warp * 16 * LD, Ks, 0, nks, 1.f);
    mma_rows<NT, LD, E, E, 4>(dp, dOs + warp * 16 * LD, Vs, 0, nks, 1.f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e / 2);
        float p, ds;
        p_ds(s[nt][e], dp[nt][e], q0 + r, k0 + nt * 8 + 2 * tq + (e & 1),
             Tq, Tk, off, causal, scale, lse_s[r], D_s[r], inv_tk, p, ds);
        s[nt][e] = ds;
      }
    mma_regs<NT, C::ND, LD, E>(acc, s, Ks, nks, one);
  }
  store_rows<C::ND>(dq + ((long long)b * Tq * H + h) * hd, sq, acc, q0 + r0,
                    0, Tq, hd, scale);
}

template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
dkv_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lse,
                const T* __restrict__ dout, const float* __restrict__ Dg,
                T* __restrict__ dk, T* __restrict__ dv, int BKV, int nqt,
                int Tq, int Tk, int H, int KV, int G, int hd, int causal,
                float scale) {
  using C = Tile<HDP>;
  constexpr int LD = C::LD, BQ = C::BQK, BK = C::BK, NH = C::NH;
  constexpr int NQ = C::NQ, NDH = C::NDH;
  constexpr bool E = kExact<T>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* lse_s = dOs + BQ * LD;  // [BQ]
  float* D_s = lse_s + BQ;       // [BQ]
  float* X = D_s + BQ;           // NH == 2: each warp's partial S^T, dP^T

  const int kt = blockIdx.x / BKV;            // heavy (early) tiles first
  const int bk = blockIdx.x % BKV;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int kg = warp / NH, half = warp % NH;  // key group, column half
  const int off = Tk - Tq;
  const int W = (hd + 7) & ~7, nks = W / 8;
  // the warp's k-steps of S^T / dP^T and n-tiles of dK / dV
  const int ks0 = NH == 2 ? min(nks, half * (HDP / 16)) : 0;
  const int ks1 = NH == 2 ? min(nks, (half + 1) * (HDP / 16)) : nks;
  const int col0 = half * (HDP / NH);
  const int nnd = max(0, min(NDH, (W - col0) / 8));
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const T* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  load_rows<LD>(Ks, BK, kb, k0, Tk, sk, hd, W);
  load_rows<LD>(Vs, BK, vb, k0, Tk, sk, hd, W);
  cp_async_commit();

  float acc_k[NDH][4], acc_v[NDH][4];
  zero(acc_k);
  zero(acc_v);

  // the first query tile with a row that sees these keys; with causal
  // Tq > Tk the first rows see no key and weigh every key: start at 0
  const int qt0 = causal && off >= 0 ? max(0, k0 - off) / BQ : 0;
  const float inv_tk = 1.f / (float)Tk, one[2] = {1.f, 1.f};
  const int kr0 = kg * 16 + gq;   // the thread's keys kr0 and kr0 + 8

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((long long)b * Tq * H + h) * hd;
    const T* dob = dout + ((long long)b * Tq * H + h) * hd;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous unit's Q, dO and rows are consumed
      load_rows<LD>(Qs, BQ, qb, q0, Tq, sq, hd, W);
      load_rows<LD>(dOs, BQ, dob, q0, Tq, sq, hd, W);
      cp_async_commit();
      for (int r = tid; r < BQ; r += kThreads) {
        const int i = q0 + r;
        const long long row = ((long long)b * Tq + i) * H + h;
        lse_s[r] = i < Tq ? lse[row] : 0.f;
        D_s[r] = i < Tq ? Dg[row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float s[NQ][4], dp[NQ][4];
      zero(s);
      zero(dp);
      mma_rows<NQ, LD, E, E, 4>(s, Ks + kg * 16 * LD, Qs, ks0, ks1, 1.f);
      mma_rows<NQ, LD, E, E, 4>(dp, Vs + kg * 16 * LD, dOs, ks0, ks1, 1.f);
      if constexpr (NH == 2) {
        // the two halves of hd: each warp adds the other's partial sums
        // (the same two numbers in both warps, so the same bits)
        float* mine = X + warp * (2 * NQ * 4 * 32);
        const float* other = X + (warp ^ 1) * (2 * NQ * 4 * 32);
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[(n * 4 + e) * 32 + lane] = s[n][e];
            mine[((NQ + n) * 4 + e) * 32 + lane] = dp[n][e];
          }
        __syncthreads();
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += other[(n * 4 + e) * 32 + lane];
            dp[n][e] += other[((NQ + n) * 4 + e) * 32 + lane];
          }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * tq + (e & 1);   // query of the unit
          float p, ds;
          p_ds(s[n][e], dp[n][e], q0 + c, k0 + kr0 + 8 * (e / 2), Tq, Tk,
               off, causal, scale, lse_s[c], D_s[c], inv_tk, p, ds);
          s[n][e] = p;
          dp[n][e] = ds;
        }
      mma_regs<NQ, NDH, LD, E>(acc_v, s, dOs + col0, nnd, one);
      mma_regs<NQ, NDH, LD, E>(acc_k, dp, Qs + col0, nnd, one);
    }
  }
  const long long base = ((long long)b * Tk * KV + kvh) * hd;
  store_rows<NDH>(dk + base, sk, acc_k, k0 + kr0, col0, Tk, hd, scale);
  store_rows<NDH>(dv + base, sk, acc_v, k0 + kr0, col0, Tk, hd, 1.f);
}

template <int HDP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* D, void* dq, void* dk,
           void* dv, int B, int Tq, int Tk, int H, int KV, int hd, int causal,
           cudaStream_t stream) {
  using C = Tile<HDP>;
  const int dq_bytes = C::kDqFloats * (int)sizeof(float);
  const int dkv_bytes = C::kDkvFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_tf32_kernel<HDP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_tf32_kernel<HDP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + C::BQ - 1) / C::BQ;
  const int nqt_kv = (Tq + C::BQK - 1) / C::BQK;
  const int nkt = (Tk + C::BK - 1) / C::BK;
  const long long dq_blocks = (long long)nqt * B * H;
  const long long dkv_blocks = (long long)nkt * B * KV;
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const float scale = 1.f / sqrtf((float)hd);
  dq_tf32_kernel<HDP, T><<<(unsigned)dq_blocks, kThreads, dq_bytes,
                           stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, lse,
      (const T*)dout, D, (T*)dq, B * H, nqt, Tq, Tk, H, KV, H / KV, hd,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_tf32_kernel<HDP, T><<<(unsigned)dkv_blocks, kThreads, dkv_bytes,
                            stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, D,
      (T*)dk, (T*)dv, B * KV, nqt_kv, Tq, Tk, H, KV, H / KV, hd, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* D, void* dq,
             void* dk, void* dv, int B, int Tq, int Tk, int H, int KV,
             int hd, int causal, cudaStream_t stream) {
  if (hd <= 64)
    return launch<64, T>(q, k, v, o, lse, dout, D, dq, dk, dv, B, Tq, Tk, H,
                         KV, hd, causal, stream);
  if (hd <= 128)
    return launch<128, T>(q, k, v, o, lse, dout, D, dq, dk, dv, B, Tq, Tk,
                          H, KV, hd, causal, stream);
  if (hd <= 256)
    return launch<256, T>(q, k, v, o, lse, dout, D, dq, dk, dv, B, Tq, Tk,
                          H, KV, hd, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o, do, dq, dk, dv contiguous in one type (bf16 != 0: bfloat16,
// else float32), 16-byte aligned; lse [B, Tq, H] float32; D [B, Tq, H]
// float32 scratch
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* D, void* dq, void* dk, void* dv,
    int B, int Tq, int Tk, int H, int KV, int hd, int causal, int bf16_in,
    void* stream) {
  auto* st = (cudaStream_t)stream;
  if (bf16_in)
    return dispatch<bf16>(q, k, v, o, (const float*)lse, dout, (float*)D, dq,
                          dk, dv, B, Tq, Tk, H, KV, hd, causal, st);
  return dispatch<float>(q, k, v, o, (const float*)lse, dout, (float*)D, dq,
                         dk, dv, B, Tq, Tk, H, KV, hd, causal, st);
}
