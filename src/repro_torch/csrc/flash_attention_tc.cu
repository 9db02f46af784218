// B9 in bf16 on Hopper's tensor cores (replaces the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention_pallas, body
// _flash_kernel, for bfloat16 inputs; float32 runs on flash_attention.cu,
// whose three-product TF32 split keeps the float32 limits below).
//
// The function is flash_attention.cu's, mask for mask and epilogue for
// epilogue: q [B, Tq, H, hd], k / v [B, Tk, KV, hd] with strides and a
// contiguous last axis, head h reads kv head h / G, end-aligned causality
// (key j visible to query i iff j <= i + Tk - Tq) with the finite
// NEG_INF = -1e30 on masked keys (a row that sees no key gets p = 1),
// -inf for keys past Tk, the normalized bf16 output (with, where lse is
// given, the row's m + log(l) for the backward) or the f32 (o, m, l)
// partial, and rows with row_valid 0 written as the merge identity
// without computing.  m stays in natural-log units: exp(x) is computed as
// ex2((x - m) * log2 e), so a row that sees no key keeps m = -1e30 and
// l = Tk exactly.
//
// Design.  One block of kNWG warpgroups per (batch*head, kNWG*64 q rows),
// heavy q tiles first; a warpgroup owns 64 q rows (wgmma's M).  Q goes to
// shared memory once; K and V tiles of BK keys go through a two-stage
// ring, each 16-byte chunk copied by cp.async into the 128-byte swizzled
// layout that the wgmma descriptors name (hopper.cuh), with zero fill for
// rows past T and columns past hd (hd is padded to HDP = 64, 128 or 256),
// or by plain loads where a stride or hd is not a multiple of 8 elements.
//   S = Q K^T: wgmma m64nBKk16, both operands K-major in shared memory,
//     HDP / 16 k steps, f32 accumulators; the 1/sqrt(hd) scale is applied
//     to S in f32 (the plain version scales q first: about 1e-7 apart).
//   Softmax on the accumulator fragments: each row lives on the four
//     threads of a quad (shuffles for its max and sum); only tiles that
//     cross the diagonal or the ragged end are masked element by element;
//     a warpgroup skips tiles past its rows' last visible key.
//   O += P V as two bf16 products, P_hi V + P_lo V with P_hi = bf16(p),
//     P_lo = bf16(p - P_hi): about 16 bits of p, an error about 1e-7 in
//     o / l.  One rounding of p to bf16 errs by about 6e-5 at the main
//     path's statistics, six times the 1e-5 limit on the partials.  P
//     goes from the S accumulators straight into wgmma A registers (the
//     m64n accumulator layout is the k16 A-fragment layout), and V is the
//     MN-major B operand read in place.  l sums the f32 p.  The tensor
//     cores' f32 accumulation does not round to nearest, so for hd <= 128
//     a tile's P V goes to fresh accumulators and joins O by one f32 fmaf
//     (O * corr + PV); carried in the accumulators across the 64 tiles of
//     a 4,096-key block it errs by about 7e-6 in o / l (PERF.md).  hd 256
//     has no registers for that and accumulates O in the tensor cores.
//
// Bound on the H100: the bf16 tensor cores, 4 * hd operations per visible
// (query, key) pair for the algorithm (989 TFLOP/s dense); this design
// issues 6 * hd (the split P V), plus one exp per visible pair on the
// MUFU units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBQ = 64;         // q rows per warpgroup
constexpr int kNWG = 2;         // warpgroups per block
constexpr int kThreads = 128 * kNWG;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HDP>
struct Cfg {
  static constexpr int BK = HDP > 128 ? 32 : 64;   // keys per tile
  static constexpr int kQBytes = kBQ * HDP * 2;     // one warpgroup's Q
  static constexpr int kTileBytes = BK * HDP * 2;   // one K or V tile
  static constexpr int kSmem = kNWG * kQBytes + 2 * 2 * kTileBytes + 1024;
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

// rows [t0, t0 + R) x columns [0, HDP) of a [T, hd] slice with row stride
// st into the swizzled tile at dst (rows past T, columns past hd: zero)
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, int R,
                                          const bf16* __restrict__ g, int t0,
                                          int T, long long st, int hd,
                                          int vec, int tid) {
  constexpr int CPR = HDP / 8;   // 16-byte chunks per row
  for (int idx = tid; idx < R * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const uint32_t d = dst + swizzled(R, r, c * 8);
    const bool row_ok = t0 + r < T;
    const bf16* src = g + (row_ok ? (t0 + r) * st : 0) + c * 8;
    if (vec) {
      cp_async16(d, row_ok && c * 8 < hd ? src : g,
                 row_ok && c * 8 < hd ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 8 + 2 * e;
        const float a =
            row_ok && col < hd ? __bfloat162float(src[2 * e]) : 0.f;
        const float b =
            row_ok && col + 1 < hd ? __bfloat162float(src[2 * e + 1]) : 0.f;
        w[e] = pack_bf16(a, b);
      }
      st_shared_v4(d, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t da,
                                       uint64_t db, int acc);
template <>
__device__ __forceinline__ void mma_qk<64>(float (&s)[32], uint64_t da,
                                           uint64_t db, int acc) {
  wgmma_ss_n64(s, da, db, acc);
}
template <>
__device__ __forceinline__ void mma_qk<32>(float (&s)[16], uint64_t da,
                                           uint64_t db, int acc) {
  wgmma_ss_n32(s, da, db, acc);
}

template <int HDP>
__device__ __forceinline__ void mma_pv(float (&o)[HDP / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc);
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  wgmma_rs_n64(o, a, db, acc);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  wgmma_rs_n128(o, a, db, acc);
}
template <>
__device__ __forceinline__ void mma_pv<256>(float (&o)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  wgmma_rs_n256(o, a, db, acc);
}

// one past the last key that rows [r0, r0 + 64) must visit (0: no rows)
__device__ __forceinline__ int kv_end_of(int r0, int Tq, int Tk, int causal) {
  if (r0 >= Tq) return 0;
  if (causal && r0 + Tk - Tq >= 0)   // every row sees key 0
    return min(Tk, min(r0 + kBQ, Tq) - 1 + Tk - Tq + 1);
  return Tk;   // no mask, or a row that sees no key: every tile
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, void* __restrict__ o_out,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ lse_out,
                const int* __restrict__ row_valid, int BH, int nqt, int Tq,
                int Tk, int H, int G, int hd, long long sq_b, long long sq_t,
                long long sq_h, long long sk_b, long long sk_t,
                long long sk_h, long long sv_b, long long sv_t,
                long long sv_h, int causal, int partial, int vec,
                float scale) {
  using C = Cfg<HDP>;
  constexpr int BK = C::BK;
  constexpr int NS = BK / 2;     // S accumulators a thread holds
  constexpr int NO = HDP / 2;    // O accumulators a thread holds
  // hd <= 128: each tile's P V in its own accumulators (registers allow
  // it); hd 256: P V accumulates into O inside the tensor cores
  constexpr bool kTileSum = HDP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // [kNWG][64 x HDP]
  const uint32_t sKV = base + kNWG * C::kQBytes;  // 2 stages of K, V

  // heavy (late) q tiles of every head first
  const int qt = nqt - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * kBQ * kNWG;
  const int tid = threadIdx.x;
  const int wg = tid / 128, lt = tid % 128;
  const int rq = q0 + wg * kBQ + 16 * (lt / 32) + (lt % 32) / 4;  // + 8
  const int tig = lt % 4;
  const int off = Tk - Tq;

  if (row_valid != nullptr && row_valid[b] == 0) {
    // the merge identity, nothing computed
    for (int idx = tid; idx < kNWG * kBQ * hd; idx += kThreads) {
      const int i = q0 + idx / hd, d = idx % hd;
      if (i >= Tq) continue;
      const size_t row = ((size_t)b * Tq + i) * H + h;
      if (partial) {
        ((float*)o_out)[row * hd + d] = 0.f;
        if (d == 0) { m_out[row] = kNegInf; l_out[row] = 0.f; }
      } else {
        ((bf16*)o_out)[row * hd + d] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  const bf16* qb = q + b * sq_b + h * sq_h;
  const bf16* kb = k + b * sk_b + kvh * sk_h;
  const bf16* vb = v + b * sv_b + kvh * sv_h;

  int end_cta = 0;
#pragma unroll
  for (int w = 0; w < kNWG; ++w)
    end_cta = max(end_cta, kv_end_of(q0 + w * kBQ, Tq, Tk, causal));
  const int end_wg = kv_end_of(q0 + wg * kBQ, Tq, Tk, causal);
  const int nt = (end_cta + BK - 1) / BK;
  const int nt_wg = (end_wg + BK - 1) / BK;

  // group 0: Q and the first K / V tile
  for (int w = 0; w < kNWG; ++w)
    load_tile<HDP>(sQ + w * C::kQBytes, kBQ, qb, q0 + w * kBQ, Tq, sq_t, hd,
                   vec, tid);
  if (nt > 0) {
    load_tile<HDP>(sKV, BK, kb, 0, Tk, sk_t, hd, vec, tid);
    load_tile<HDP>(sKV + C::kTileBytes, BK, vb, 0, Tk, sv_t, hd, vec, tid);
  }
  cp_async_commit();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  const uint32_t sQw = sQ + wg * C::kQBytes;

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      const uint32_t nxt = sKV + ((t + 1) & 1) * 2 * C::kTileBytes;
      load_tile<HDP>(nxt, BK, kb, (t + 1) * BK, Tk, sk_t, hd, vec, tid);
      load_tile<HDP>(nxt + C::kTileBytes, BK, vb, (t + 1) * BK, Tk, sv_t, hd,
                     vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and Q) landed
    fence_proxy_async();
    __syncthreads();

    if (t < nt_wg) {
      const int k0 = t * BK;
      const uint32_t sK = sKV + (t & 1) * 2 * C::kTileBytes;
      const uint32_t sV = sK + C::kTileBytes;

      // ---- S = Q K^T (f32) ----
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t cq = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
        const uint32_t ck = (kk / 4) * (BK * 128) + (kk % 4) * 32;
        mma_qk<BK>(s, wgmma_desc(sQw + cq, 16, 1024),
                   wgmma_desc(sK + ck, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // ---- scale, masks, online softmax ----
      const bool edge = k0 + BK > Tk ||
                        (causal && k0 + BK - 1 > q0 + wg * kBQ + off);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = s[i] * scale;
        if (edge) {
          const int row = rq + 8 * ((i / 2) & 1);
          const int col = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
          if (col >= Tk) x = -INFINITY;
          else if (causal && col > row + off) x = kNegInf;
        }
        s[i] = x;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        corr[r] = exp2_approx((m_i[r] - m_new) * kLog2e);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i / 2) & 1;
        s[i] = exp2_approx((s[i] - m_i[r]) * kLog2e);
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_i[r] = l_i[r] * corr[r] + sum[r];
      }

      // ---- P = P_hi + P_lo as bf16 A fragments ----
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
          __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = *reinterpret_cast<uint32_t*>(&hi);
          pl[kk][r] = pack_bf16(a - hf.x, c - hf.y);
        }

      // ---- O = O * corr + P_hi V + P_lo V ----
      if constexpr (kTileSum) {
        // the tile's P V in fresh accumulators, folded into O by one f32
        // fmaf per element: the tensor cores' accumulation then spans 2 *
        // BK / 16 steps, not the whole sequence's
        float pv[NO];
        fence_regs(pv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = wgmma_desc(sV + kk * 16 * 128, BK * 128, 1024);
          mma_pv<HDP>(pv, ph[kk], dv, kk > 0);
          mma_pv<HDP>(pv, pl[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < NO; ++i)
          o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
      } else {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) & 1];
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = wgmma_desc(sV + kk * 16 * 128, BK * 128, 1024);
          mma_pv<HDP>(o, ph[kk], dv, 1);
          mma_pv<HDP>(o, pl[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
    }
    __syncthreads();   // stage t & 1 consumed before tile t + 2 lands there
  }

  // ---- epilogue: rows rq and rq + 8, columns 8j + 2 tig + {0, 1} ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rq + 8 * r;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * tig;
      if (d >= hd) continue;
      const float a = o[4 * j + 2 * r], c = o[4 * j + 2 * r + 1];
      if (partial) {
        float* dst = (float*)o_out + row * hd + d;
        if (d + 1 < hd && (hd & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(a, c);
        } else {
          dst[0] = a;
          if (d + 1 < hd) dst[1] = c;
        }
      } else {
        bf16* dst = (bf16*)o_out + row * hd + d;
        if (d + 1 < hd && (hd & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(a * inv, c * inv);
        } else {
          dst[0] = __float2bfloat16(a * inv);
          if (d + 1 < hd) dst[1] = __float2bfloat16(c * inv);
        }
      }
    }
    if (partial && tig == 0) {
      m_out[row] = m_i[r];
      l_out[row] = l_i[r];
    }
    if (lse_out != nullptr && tig == 0)
      lse_out[row] = m_i[r] + logf(l_i[r]);
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, float* lse, const int* row_valid, int B, int Tq, int Tk,
           int H, int KV, int hd, long long sq_b, long long sq_t,
           long long sq_h, long long sk_b, long long sk_t, long long sk_h,
           long long sv_b, long long sv_t, long long sv_h, int causal,
           int partial, cudaStream_t stream) {
  const int bytes = Cfg<HDP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every row start on a 16-byte boundary
  const long long strides[9] = {sq_b, sq_t, sq_h, sk_b, sk_t,
                                sk_h, sv_b, sv_t, sv_h};
  int vec = hd % 8 == 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  for (long long s : strides) vec = vec && s % 8 == 0;
  const int rows = kBQ * kNWG;
  const int nqt = (Tq + rows - 1) / rows;
  const long long blocks = (long long)nqt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_tc_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, o, m, l, lse, row_valid,
      B * H, nqt, Tq, Tk, H, H / KV, hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h,
      sv_b, sv_t, sv_h, causal, partial, vec, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q / k / v only; hd in 1..256 (padded to 64, 128 or 256)
extern "C" int repro_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    void* lse, const void* row_valid, int B, int Tq, int Tk, int H, int KV,
    int hd, long long sq_b, long long sq_t, long long sq_h, long long sk_b,
    long long sk_t, long long sk_h, long long sv_b, long long sv_t,
    long long sv_h, int causal, int partial, void* stream) {
  auto* mm = (float*)m;
  auto* ll = (float*)l;
  auto* ls = (float*)lse;
  auto* rv = (const int*)row_valid;
  auto* st = (cudaStream_t)stream;
  if (hd <= 64)
    return launch<64>(q, k, v, o, mm, ll, ls, rv, B, Tq, Tk, H, KV, hd, sq_b,
                      sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal,
                      partial, st);
  if (hd <= 128)
    return launch<128>(q, k, v, o, mm, ll, ls, rv, B, Tq, Tk, H, KV, hd, sq_b,
                       sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal,
                       partial, st);
  if (hd <= 256)
    return launch<256>(q, k, v, o, mm, ll, ls, rv, B, Tq, Tk, H, KV, hd, sq_b,
                       sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal,
                       partial, st);
  return (int)cudaErrorInvalidValue;
}
