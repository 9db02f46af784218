// B9: flash attention with an online softmax (replaces the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention_pallas, body
// _flash_kernel).
//
// q [B, Tq, H, hd], k / v [B, Tk, KV, hd] (float32, any strides with a
// contiguous last axis; bfloat16 runs on flash_attention_tc.cu); head h
// reads kv head h / (H / KV), so grouped-query attention needs no
// broadcast copy.  Scores are
// (q * hd^-1/2) . k in float32.  Causal masking is end-aligned: key j is
// visible to query i iff j <= i + Tk - Tq; a masked score is the finite
// NEG_INF = -1e30 of the reference, never -inf, so a row that sees no key
// of a tile gets p = exp(NEG_INF - NEG_INF) = 1 there, as the plain softmax
// does.  Keys past Tk (the ragged last tile) get -inf and weigh exactly 0.
//
// Two epilogues:
//   * normalized (partial = 0): o = acc / max(l, 1e-30) in q's type, the
//     TPU kernel's output, and where lse is given the row's log-sum-exp
//     m + log(l) [B, Tq, H] float32 for the backward
//     (flash_attention_bwd.cu);
//   * partial (partial = 1): the unnormalized acc [B, Tq, H, hd] and the
//     row statistics m, l [B, Tq, H] in float32 — apps/attention.py's
//     flash_block, merged by the (o, m, l) monoid.
// With row_valid, a batch row whose flag is 0 writes the merge identity
// (o = 0, m = NEG_INF, l = 0) and computes nothing: the quorum schedule's
// invalid (device, pair) slots.
//
// Design: the TF32 tensor cores with the three-product split of
// tf32x3.cuh.  One TF32 product per multiply-add would put the f32
// partials 27-48 times over their 1e-5 rule (CPU emulation,
// tests/test_torch_flash_tf32x3.py); the split's products
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi keep it, as float32 arithmetic does:
// on the card the partials read at most 0.439 of the rule over the GPU
// tests' cells, and against a float64 evaluation at scores of std 8 0.434
// where the plain float32 version reads 0.922 (PERF.md).  The TPU kernel's
// sequential kv grid axis becomes a loop over key tiles, heavy (late) q
// tiles first; tiles past the last key a tile's rows see are skipped, the
// others masked element by element, and a q tile holding a row that sees
// no key (Tq > Tk) visits every tile, so that row averages v over all Tk
// keys like the plain softmax.  The online softmax (row max, expf,
// rescale) runs in float32 registers, a row on the four lanes of a quad.
// The tensor cores' float32 accumulation rounds toward zero: carried over
// a long sum of one sign it drifts (S over hd 256 put l 1.109e-5 off,
// past its rule), so they sum at most 32 of hd of S, or one tile of P V, into a
// fresh accumulator, which joins S, or O by one fmaf (o * corr + PV), in
// float32 rounded to nearest.  No atomics.
//
// hd <= 128 (flash_tf32_wg_kernel): wgmma.  A block of two warpgroups per
// (batch*head, 128 q rows), a warpgroup owning 64 rows (wgmma's M).  Q
// sits raw in shared memory (16-byte chunks XOR-swizzled by row) and is
// scaled and split into hi / lo A fragments in registers as S's k-steps
// read it.  Each 64-key tile of K and V lands raw in one staging tile
// (cp.async: V while S runs, the next K while P V runs) and is split once
// for the block into hi / lo tiles in the 128-byte swizzled layout wgmma
// reads.  TF32 operands in shared memory must be K-major, so V goes in as
// V^T, the keys of each 8 in the order P's C fragments give them as A
// fragments (tf32x3.cuh).  S = Q K^T is m64n64k8 (three products a k-step,
// A from registers); P V is m64nHDPk8 with P's hi / lo from registers.
// The shared memory (two Q tiles, the staging tile, K and V^T hi / lo:
// 225 KB at hd 128) leaves one block on an SM.
// hd 256 (flash_tf32_kernel): the split tiles would not fit, so each warp
// runs mma.sync m16n8k8 on its 16 rows.  One block of four warps per
// (batch*head, 64-row q tile), 32-key tiles; Q, K and V sit in shared
// memory as float32 rows (stride HDP + 4, zero past T and past hd rounded
// up to 8: the k-steps stop there), copied by cp.async (16 bytes where hd,
// the strides and the base allow, else 4), K and V alternating in two
// buffers; each operand is split as its fragment is read (mma.sync takes
// fragments from registers in any layout, so V needs no transposed copy),
// and P's C fragments are P V's A fragments.
//
// Bound on the H100: 4 * hd operations per visible (query, key) pair; the
// split issues three TF32 products a multiply-add, 12 * hd at 495 TFLOP/s
// (165 TFLOP/s of the algorithm's operations, against 67 for fp32 FFMA).
// mma.sync's TF32 rate on the card is about half of wgmma's (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace hopper;
using tf32x3::mma_regs;
using tf32x3::mma_rows;

constexpr int kBQ = 64;
constexpr int kThreads = 128;   // four warps of 16 query rows
constexpr float kNegInf = -1e30f;

template <int HDP>
struct Cfg {
  static constexpr int BK = 32;                     // keys a tile
  static constexpr int LD = HDP + 4;               // row stride (floats)
  static constexpr int NT = BK / 8;                // n-tiles of S
  static constexpr int ND = HDP / 8;               // n-tiles of O
  static constexpr int kSmemFloats = (kBQ + 2 * BK) * LD;
};

// rows [t0, t0 + R) x columns [0, W) of a [T, hd] float slice with row
// stride st into the shared tile at dst (row stride LD floats), by
// cp.async; zeros past T and past hd (W = hd rounded up to 8).  vec:
// 16-byte copies (hd, st and the slice's base multiples of 4 floats).
template <int LD>
__device__ __forceinline__ void load_tile(uint32_t dst, int R,
                                          const float* __restrict__ g, int t0,
                                          int T, long long st, int hd, int W,
                                          int vec) {
  if (vec) {
    const int cpr = W / 4;
    for (int idx = threadIdx.x; idx < R * cpr; idx += kThreads) {
      const int r = idx / cpr, c = (idx % cpr) * 4;
      const bool ok = t0 + r < T && c < hd;
      cp_async16(dst + (uint32_t)(r * LD + c) * 4,
                 ok ? g + (long long)(t0 + r) * st + c : g, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
      const int r = idx / W, c = idx % W;
      const bool ok = t0 + r < T && c < hd;
      cp_async4(dst + (uint32_t)(r * LD + c) * 4,
                ok ? g + (long long)(t0 + r) * st + c : g, ok ? 4 : 0);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o_out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ lse_out,
                  const int* __restrict__ row_valid, int BH, int nqt, int Tq,
                  int Tk, int H, int G, int hd, long long sq_b,
                  long long sq_t, long long sq_h, long long sk_b,
                  long long sk_t, long long sk_h, long long sv_b,
                  long long sv_t, long long sv_h, int causal, int partial,
                  int vec, float scale) {
  using C = Cfg<HDP>;
  constexpr int BK = C::BK, LD = C::LD, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]

  // heavy (late) q tiles of every head first
  const int qt = nqt - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int off = Tk - Tq;

  if (row_valid != nullptr && row_valid[b] == 0) {
    // the merge identity, nothing computed
    for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
      const int i = q0 + idx / hd, d = idx % hd;
      if (i >= Tq) continue;
      const size_t row = ((size_t)b * Tq + i) * H + h;
      o_out[row * hd + d] = 0.f;
      if (partial && d == 0) {
        m_out[row] = kNegInf;
        l_out[row] = 0.f;
      }
    }
    return;
  }

  const float* qb = q + b * sq_b + h * sq_h;
  const float* kb = k + b * sk_b + kvh * sk_h;
  const float* vb = v + b * sv_b + kvh * sv_h;
  const int W = (hd + 7) & ~7, nks = W / 8;
  const uint32_t sQ = smem_u32(Qs), sK = smem_u32(Ks), sV = smem_u32(Vs);

  load_tile<LD>(sQ, kBQ, qb, q0, Tq, sq_t, hd, W, vec);
  load_tile<LD>(sK, BK, kb, 0, Tk, sk_t, hd, W, vec);
  cp_async_commit();

  int kv_end = Tk;
  if (causal && q0 + off >= 0) {
    // every row sees key 0: stop after the last key the last row sees
    const int last_q = min(q0 + kBQ, Tq) - 1;
    kv_end = min(Tk, last_q + off + 1);
  }

  // the thread's rows of the tile: r0 (C fragments 0, 1) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + gq;
  const int i0 = q0 + r0, i1 = i0 + 8;
  float o[ND][4], m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    cp_async_wait<0>();
    __syncthreads();   // K (and Q) landed; every warp is done with V
    load_tile<LD>(sV, BK, vb, k0, Tk, sv_t, hd, W, vec);
    cp_async_commit();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    mma_rows<NT, LD, false, false, 4>(s, Qs + warp * 16 * LD, Ks, 0, nks,
                                      scale);

    // masks, online softmax (a row's scores live on the 4 lanes of a quad)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * tq + (e & 1);
        const int i = e < 2 ? i0 : i1;
        if (j >= Tk) s[nt][e] = -INFINITY;
        else if (causal && j > i + off) s[nt][e] = kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new[e / 2]);
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];

    cp_async_wait<0>();
    __syncthreads();   // V landed; every warp is done with K
    if (k0 + BK < kv_end) {
      load_tile<LD>(sK, BK, kb, k0 + BK, Tk, sk_t, hd, W, vec);
      cp_async_commit();
    }
    mma_regs<NT, ND, LD, false>(o, s, Vs, nks, corr);   // o = o corr + P V
  }

  // a row's sum over its quad (each lane summed its own columns in order)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? i1 : i0;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * tq + e;
        if (d < hd)
          o_out[row * hd + d] =
              partial ? o[nd][2 * r + e] : o[nd][2 * r + e] * inv;
      }
    if (partial && tq == 0) {
      m_out[row] = m_r[r];
      l_out[row] = l_r[r];
    }
    if (lse_out != nullptr && tq == 0)
      lse_out[row] = m_r[r] + logf(l_r[r]);
  }
}

// ---- hd <= 128: two warpgroups on wgmma ----------------------------------

constexpr int kWG = 2;                 // warpgroups a block, 64 q rows each
constexpr int kWThreads = 128 * kWG;
constexpr int kWBK = 64;               // keys a tile

template <int HDP>
struct WCfg {
  static constexpr int kRaw = 64 * HDP * 4;     // a raw [64 x HDP] tile
  static constexpr int kSplit = 64 * HDP * 4;   // a hi or lo tile
  // Q (each warpgroup's rows, raw), the staging tile (raw K or V), K hi /
  // lo, V^T hi / lo
  static constexpr int kSmem = kWG * kRaw + kRaw + 4 * kSplit + 1024;
};

// byte offset of float (r, c) in a raw tile of HDP columns whose 16-byte
// chunks are XOR-swizzled by r % 8 (a warp's fragment reads, eight rows
// at one column, and the split pass's reads stay free of bank conflicts)
template <int HDP>
__device__ __forceinline__ uint32_t raw_at(int r, int c) {
  return (uint32_t)(r * HDP * 4 + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7))
                                       * 16 + (c & 3) * 4);
}

// byte offset of float (r, c) in a K-major TF32 tile of R rows for wgmma
// (hopper.cuh's 128-byte swizzle; 32 floats a 128-byte row)
__device__ __forceinline__ uint32_t sw32(int R, int r, int c) {
  return swizzled(R, r, 2 * c);
}

// rows [t0, t0 + 64) x columns [0, HDP) of a [T, hd] float slice with row
// stride st into a raw tile at dst (zeros past T and past hd), cp.async
template <int HDP>
__device__ __forceinline__ void load_raw(uint32_t dst,
                                         const float* __restrict__ g, int t0,
                                         int T, long long st, int hd,
                                         int vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < 64 * (HDP / 4); idx += kWThreads) {
      const int r = idx / (HDP / 4), c = (idx % (HDP / 4)) * 4;
      const bool ok = t0 + r < T && c < hd;
      cp_async16(dst + raw_at<HDP>(r, c),
                 ok ? g + (long long)(t0 + r) * st + c : g, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * HDP; idx += kWThreads) {
      const int r = idx / HDP, c = idx % HDP;
      const bool ok = t0 + r < T && c < hd;
      cp_async4(dst + raw_at<HDP>(r, c),
                ok ? g + (long long)(t0 + r) * st + c : g, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint4 split4(float4 x, uint4& lo) {
  uint4 hi;
  tf32x3::split<false>(x.x, hi.x, lo.x);
  tf32x3::split<false>(x.y, hi.y, lo.y);
  tf32x3::split<false>(x.z, hi.z, lo.z);
  tf32x3::split<false>(x.w, hi.w, lo.w);
  return hi;
}

// the raw K tile (keys x HDP) at src as the K-major hi / lo tiles of S's B
template <int HDP>
__device__ __forceinline__ void split_k(const unsigned char* smem,
                                       uint32_t src, uint32_t hi,
                                       uint32_t lo) {
  for (int idx = threadIdx.x; idx < 64 * (HDP / 4); idx += kWThreads) {
    const int r = idx / (HDP / 4), c = (idx % (HDP / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(
        smem + (src - smem_u32(smem)) + raw_at<HDP>(r, c));
    uint4 l;
    const uint4 h = split4(x, l);
    st_shared_v4(hi + sw32(64, r, c), h);
    st_shared_v4(lo + sw32(64, r, c), l);
  }
}

// the raw V tile (keys x HDP) at src as V^T's K-major hi / lo tiles (HDP
// rows, 64 keys) of P V's B, the keys of each 8 in the order P's C
// fragments give them as A fragments: position t holds key 2t, t + 4 key
// 2t + 1 (tf32x3.cuh)
template <int HDP>
__device__ __forceinline__ void split_v(const unsigned char* smem,
                                       uint32_t src, uint32_t hi,
                                       uint32_t lo) {
  for (int idx = threadIdx.x; idx < 64 * (HDP / 4); idx += kWThreads) {
    const int r = idx % 64, c = (idx / 64) * 4;   // a warp: 32 keys
    const float4 x = *reinterpret_cast<const float4*>(
        smem + (src - smem_u32(smem)) + raw_at<HDP>(r, c));
    uint4 l;
    const uint4 h = split4(x, l);
    const int w = r & 7;
    const int p = (r & ~7) + ((w & 1) ? 4 + (w >> 1) : (w >> 1));
    const uint32_t hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t at = sw32(HDP, c + u, p);
      asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(hi + at), "r"(hv[u])
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(lo + at), "r"(lv[u])
                   : "memory");
    }
  }
}

template <int HDP>
__device__ __forceinline__ void wg_pv(float (&d)[HDP / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int scale_d);
template <>
__device__ __forceinline__ void wg_pv<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  tf32x3::wgmma_rs_n64(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void wg_pv<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  tf32x3::wgmma_rs_n128(d, a, db, scale_d);
}

// one past the last key that rows [r0, r0 + 64) must visit (0: no rows)
__device__ __forceinline__ int kv_end_of(int r0, int Tq, int Tk, int causal) {
  if (r0 >= Tq) return 0;
  if (causal && r0 + Tk - Tq >= 0)   // every row sees key 0
    return min(Tk, min(r0 + 64, Tq) - 1 + Tk - Tq + 1);
  return Tk;   // no mask, or a row that sees no key: every tile
}

template <int HDP>
__global__ void __launch_bounds__(kWThreads, 1)
flash_tf32_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o_out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ lse_out,
                     const int* __restrict__ row_valid, int BH, int nqt,
                     int Tq, int Tk, int H, int G, int hd, long long sq_b,
                     long long sq_t, long long sq_h, long long sk_b,
                     long long sk_t, long long sk_h, long long sv_b,
                     long long sv_t, long long sv_h, int causal, int partial,
                     int vec, float scale) {
  using C = WCfg<HDP>;
  constexpr int NS = kWBK / 2;     // S accumulators a thread holds
  constexpr int NO = HDP / 2;      // O accumulators a thread holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                         // [kWG] raw [64 x HDP]
  const uint32_t sRaw = sQ + kWG * C::kRaw;         // staging: raw K or V
  const uint32_t sKh = sRaw + C::kRaw, sKl = sKh + C::kSplit;
  const uint32_t sVh = sKl + C::kSplit, sVl = sVh + C::kSplit;

  // heavy (late) q tiles of every head first
  const int qt = nqt - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * 64 * kWG;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int gq = (lt % 32) / 4, tq = lt % 4;
  const int rw = 16 * (lt / 32) + gq;            // row in the warpgroup's 64
  const int i0 = q0 + wg * 64 + rw, i1 = i0 + 8;
  const int off = Tk - Tq;

  if (row_valid != nullptr && row_valid[b] == 0) {
    // the merge identity, nothing computed
    for (int idx = tid; idx < kWG * 64 * hd; idx += kWThreads) {
      const int i = q0 + idx / hd, d = idx % hd;
      if (i >= Tq) continue;
      const size_t row = ((size_t)b * Tq + i) * H + h;
      o_out[row * hd + d] = 0.f;
      if (partial && d == 0) {
        m_out[row] = kNegInf;
        l_out[row] = 0.f;
      }
    }
    return;
  }

  const float* qb = q + b * sq_b + h * sq_h;
  const float* kb = k + b * sk_b + kvh * sk_h;
  const float* vb = v + b * sv_b + kvh * sv_h;
  const int nks = ((hd + 7) & ~7) / 8;

  int end_cta = 0;
#pragma unroll
  for (int w = 0; w < kWG; ++w)
    end_cta = max(end_cta, kv_end_of(q0 + w * 64, Tq, Tk, causal));
  const int nt = (end_cta + kWBK - 1) / kWBK;
  const int nt_wg =
      (kv_end_of(q0 + wg * 64, Tq, Tk, causal) + kWBK - 1) / kWBK;

  for (int w = 0; w < kWG; ++w)
    load_raw<HDP>(sQ + w * C::kRaw, qb, q0 + w * 64, Tq, sq_t, hd, vec);
  if (nt > 0) load_raw<HDP>(sRaw, kb, 0, Tk, sk_t, hd, vec);
  cp_async_commit();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const unsigned char* qw =
      smem_raw + (sQ - smem_u32(smem_raw)) + wg * C::kRaw;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kWBK;
    cp_async_wait<0>();
    __syncthreads();   // K_t (and Q) landed; tile t - 1 consumed
    split_k<HDP>(smem_raw, sRaw, sKh, sKl);
    fence_proxy_async();
    __syncthreads();   // K_t split for wgmma; the staging tile is free
    load_raw<HDP>(sRaw, vb, k0, Tk, sv_t, hd, vec);
    cp_async_commit();

    float s[NS];
    float corr[2] = {1.f, 1.f};
    if (t < nt_wg) {
      // ---- S = (q hd^-1/2) K^T: per 4 k-steps, the split's products
      // summed by wgmma into tmp, then added to S in float32 ----
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      for (int c0 = 0; c0 < nks; c0 += 4) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = (c0 + u) * 8 + tq;
          const float* x0 = reinterpret_cast<const float*>(
              qw + raw_at<HDP>(rw, c));
          const float* x1 = reinterpret_cast<const float*>(
              qw + raw_at<HDP>(rw + 8, c));
          const float* x2 = reinterpret_cast<const float*>(
              qw + raw_at<HDP>(rw, c + 4));
          const float* x3 = reinterpret_cast<const float*>(
              qw + raw_at<HDP>(rw + 8, c + 4));
          const tf32x3::FragA f = tf32x3::frag_a<false>(
              *x0 * scale, *x1 * scale, *x2 * scale, *x3 * scale);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[u][e] = f.hi[e];
            al[u][e] = f.lo[e];
          }
        }
        float tmp[NS];
        fence_regs(tmp);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ks = c0 + u;
          if (ks >= nks) break;
          const uint32_t ck = (ks / 4) * (64 * 128) + (ks % 4) * 32;
          const uint64_t dh = wgmma_desc(sKh + ck, 16, 1024);
          const uint64_t dl = wgmma_desc(sKl + ck, 16, 1024);
          tf32x3::wgmma_rs_n64(tmp, al[u], dh, u > 0);
          tf32x3::wgmma_rs_n64(tmp, ah[u], dl, 1);
          tf32x3::wgmma_rs_n64(tmp, ah[u], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tmp);
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] += tmp[i];
      }

      // ---- masks, online softmax (a row on the 4 lanes of a quad) ----
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int row = (i & 2) ? i1 : i0;
        if (j >= Tk) s[i] = -INFINITY;
        else if (causal && j > row + off) s[i] = kNegInf;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m_r[r], mx[r]);
        corr[r] = expf(m_r[r] - m_new[r]);
        m_r[r] = m_new[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = expf(s[i] - m_new[(i / 2) & 1]);
        sum[(i / 2) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
    }

    cp_async_wait<0>();
    __syncthreads();   // V_t landed; every warpgroup is done with K_t
    split_v<HDP>(smem_raw, sRaw, sVh, sVl);
    fence_proxy_async();
    __syncthreads();   // V_t split for wgmma; the staging tile is free
    if (t + 1 < nt) {
      load_raw<HDP>(sRaw, kb, k0 + kWBK, Tk, sk_t, hd, vec);
      cp_async_commit();
    }

    if (t < nt_wg) {
      // ---- O = O corr + P V: P's C fragments as A (key 2t at position
      // t, 2t + 1 at t + 4), the tile's products summed by wgmma into pv,
      // joined to O by one fmaf ----
      uint32_t ph[kWBK / 8][4], pl[kWBK / 8][4];
#pragma unroll
      for (int j = 0; j < kWBK / 8; ++j) {
        const tf32x3::FragA f = tf32x3::frag_a<false>(
            s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ph[j][e] = f.hi[e];
          pl[j][e] = f.lo[e];
        }
      }
      float pv[NO];
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kWBK / 8; ++j) {
        const uint32_t cv = (j / 4) * (HDP * 128) + (j % 4) * 32;
        const uint64_t dh = wgmma_desc(sVh + cv, 16, 1024);
        const uint64_t dl = wgmma_desc(sVl + cv, 16, 1024);
        wg_pv<HDP>(pv, pl[j], dh, j > 0);
        wg_pv<HDP>(pv, ph[j], dl, 1);
        wg_pv<HDP>(pv, ph[j], dh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < NO; ++i)
        o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
    }
  }

  // ---- epilogue: rows i0 and i1, columns 8j + 2 tq + {0, 1} ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? i1 : i0;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * tq + e;
        if (d < hd)
          o_out[row * hd + d] =
              partial ? o[4 * j + 2 * r + e] : o[4 * j + 2 * r + e] * inv;
      }
    if (partial && tq == 0) {
      m_out[row] = m_r[r];
      l_out[row] = l_r[r];
    }
    if (lse_out != nullptr && tq == 0)
      lse_out[row] = m_r[r] + logf(l_r[r]);
  }
}

template <int HDP>
int launch_wg(const void* q, const void* k, const void* v, void* o, float* m,
              float* l, float* lse, const int* row_valid, int B, int Tq,
              int Tk, int H, int KV, int hd, long long sq_b, long long sq_t,
              long long sq_h, long long sk_b, long long sk_t, long long sk_h,
              long long sv_b, long long sv_t, long long sv_h, int causal,
              int partial, int vec, cudaStream_t stream) {
  const int bytes = WCfg<HDP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_wg_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + 64 * kWG - 1) / (64 * kWG);
  const long long blocks = (long long)nqt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_tf32_wg_kernel<HDP><<<(unsigned)blocks, kWThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, m, l,
      lse, row_valid, B * H, nqt, Tq, Tk, H, H / KV, hd, sq_b, sq_t, sq_h,
      sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal, partial, vec,
      1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, float* lse, const int* row_valid, int B, int Tq, int Tk,
           int H, int KV, int hd, long long sq_b, long long sq_t,
           long long sq_h, long long sk_b, long long sk_t, long long sk_h,
           long long sv_b, long long sv_t, long long sv_h, int causal,
           int partial, int vec, cudaStream_t stream) {
  const int bytes = Cfg<HDP>::kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nqt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_tf32_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, m, l,
      lse, row_valid, B * H, nqt, Tq, Tk, H, H / KV, hd, sq_b, sq_t, sq_h,
      sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal, partial, vec,
      1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* m,
             float* l, float* lse, const int* row_valid, int B, int Tq,
             int Tk, int H, int KV, int hd, long long sq_b, long long sq_t,
             long long sq_h, long long sk_b, long long sk_t, long long sk_h,
             long long sv_b, long long sv_t, long long sv_h, int causal,
             int partial, cudaStream_t stream) {
  // 16-byte copies where every row of every (b, head) slice starts on a
  // 16-byte boundary
  const int vec =
      hd % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
      (uintptr_t)v % 16 == 0 &&
      (sq_b | sq_t | sq_h | sk_b | sk_t | sk_h | sv_b | sv_t | sv_h) % 4 ==
          0;
  if (hd <= 64)
    return launch_wg<64>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV,
                         hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,
                         sv_h, causal, partial, vec, stream);
  if (hd <= 128)
    return launch_wg<128>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H,
                          KV, hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b,
                          sv_t, sv_h, causal, partial, vec, stream);
  if (hd <= 256)
    return launch<256>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV,
                       hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,
                       sv_h, causal, partial, vec, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    void* lse, const void* row_valid, int B, int Tq, int Tk, int H, int KV,
    int hd, long long sq_b, long long sq_t, long long sq_h, long long sk_b,
    long long sk_t, long long sk_h, long long sv_b, long long sv_t,
    long long sv_h, int causal, int partial, void* stream) {
  return dispatch(q, k, v, o, (float*)m, (float*)l, (float*)lse,
                  (const int*)row_valid, B, Tq, Tk, H, KV, hd, sq_b, sq_t,
                  sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, causal, partial,
                  (cudaStream_t)stream);
}
