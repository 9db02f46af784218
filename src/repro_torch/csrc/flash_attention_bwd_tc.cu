// B9 backward in bf16 on the tensor cores (mma.sync): the gradient of the
// forward kernels of flash_attention_tc.cu / flash_attention.cu, for
// bfloat16 q / k / v with hd a multiple of 8 up to 128 (float32, and hd
// 256, run on the SIMT kernel pair of flash_attention_bwd.cu, whose header
// states the function: D = rowsum(dO * O), P = exp(c S - lse), dV = P^T dO,
// dS = P * (dO V^T - D), dQ = c dS K, dK = c dS^T Q, dK / dV summed over
// each kv head's G query heads, end-aligned causal masks, a row that sees
// no key at P = 1 / Tk with dS = 0).  No Pallas backward exists: the JAX
// package differentiates its plain attention with XLA.
//
// Design: the SIMT pair's two launches and loop orders, with every product
// on mma.sync m16n8k16 (bf16 in, f32 accumulators) and every operand
// staged in shared memory as bf16 rows of stride HDP + 8 (ldmatrix reads
// them without bank conflicts, .trans where the product contracts over
// rows).  A block is four warps, each owning 16 rows.
//   1. dq_tc_kernel: a block per (b, h, 64 query rows), heavy (late) tiles
//      first; D for its rows first (written for launch 2).  Per key tile of
//      64: S = Q K^T and dP = dO V^T (16 x 64 a warp), dS in registers,
//      dQ += dS K with dS as the A operand straight from the accumulators.
//   2. dkv_tc_kernel: a block per (b, kv head, 64 keys), heavy (early)
//      tiles first, K and V staged once; it walks the G query heads and,
//      for each, the query tiles of 32 that see its keys, in that order:
//      S^T = K Q^T and dP^T = V dO^T (16 keys x 32 queries a warp), then
//      dV += P^T dO and dK += dS^T Q from the accumulators.
// P and dS enter their products rounded to bf16 (2^-9 relative), as in
// FlashAttention-2; S, dP and every sum stay f32.  No atomics: every sum
// runs in a fixed order.
//
// Bound on the H100: 10 * hd operations per visible (query, key) pair at
// the bf16 tensor cores' 989 TFLOP/s; this design issues 14 * hd (S and dP
// in both launches) on mma.sync, not wgmma (a wgmma / TMA redesign is
// ROADMAP B's item for it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using flash_bwd::p_ds;

constexpr int kThreads = 128;   // four warps of 16 rows
constexpr int kBQ = 64;         // query rows a dq block
constexpr int kBK = 64;         // keys a dkv block (and a dq key tile)
constexpr int kBQ2 = 32;        // query rows a dkv step

// ldmatrix .trans: thread t receives 32 bits of column t / 4 of each
// matrix (rows 2 (t % 4), + 1)
__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + n) x HDP of a [T, hd] bf16 slice with row stride st into
// a bf16 tile of stride HDP + 8 (zero past T and past hd; hd % 8 == 0)
template <int HDP>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ g,
                                          long long st, int r0, int n, int Tn,
                                          int hd) {
  constexpr int CPR = HDP / 8, LDS = HDP + 8;
  for (int idx = threadIdx.x; idx < n * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < Tn && c * 8 < hd)
      x = *reinterpret_cast<const uint4*>(g + (long long)(r0 + r) * st +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = x;
  }
}

// acc[j] (16 rows x 8 columns, j < NJ) += A (16 rows at a_row of tile A)
// . B^T (NJ * 8 rows from b_row of tile B), contracting HDP columns; both
// tiles bf16 with stride HDP + 8
template <int HDP, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], uint32_t sA,
                                         int a_row, uint32_t sB, int b_row,
                                         int lane) {
  constexpr int LDS = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + 2 * ((a_row + lane % 16) * LDS + 16 * kk +
                             8 * (lane / 16)));
#pragma unroll
    for (int nb = 0; nb < NJ / 2; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + 2 * ((b_row + 16 * nb + 8 * (lane / 16) +
                                lane % 8) * LDS +
                               16 * kk + 8 * ((lane / 8) % 2)));
      mma_bf16(acc[2 * nb], a, b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (16 rows x HDP columns) += W (16 x 16 * NK, as A fragments w[kk])
// . X (16 * NK rows from x_row of tile X, contracting over its rows)
template <int HDP, int NK>
__device__ __forceinline__ void mma_acc(float (&acc)[HDP / 8][4],
                                        const uint32_t (&w)[NK][4],
                                        uint32_t sX, int x_row, int lane) {
  constexpr int LDS = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int np = 0; np < HDP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_t(b, sX + 2 * ((x_row + 16 * kk + lane % 8 +
                                  8 * ((lane / 8) % 2)) * LDS +
                                 16 * np + 8 * (lane / 16)));
      mma_bf16(acc[2 * np], w[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], w[kk], b[2], b[3]);
    }
}

// the A fragments (16 x 16 per k step) of a 16 x 8 NJ accumulator tile
template <int NJ>
__device__ __forceinline__ void to_a(uint32_t (&w)[NJ / 2][4],
                                     const float (&x)[NJ][4]) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    w[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    w[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    w[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    w[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// rows row0 + g (+ 8) of acc * mul (16 x HDP) into dst [Tn, hd], stride st
template <int HDP>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst,
                                          long long st,
                                          const float (&acc)[HDP / 8][4],
                                          int row0, int lane, int Tn, int hd,
                                          float mul) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row0 + g + 8 * h2;
    if (r >= Tn) continue;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * st + d) =
            __floats2bfloat162_rn(acc[n][2 * h2] * mul,
                                  acc[n][2 * h2 + 1] * mul);
    }
  }
}

template <int HDP>
constexpr int dq_smem_bytes() {
  return 4 * kBQ * (HDP + 8) * 2 + 2 * kBQ * 4;
}

template <int HDP>
constexpr int dkv_smem_bytes() {
  return (2 * kBK + 2 * kBQ2) * (HDP + 8) * 2 + 2 * kBQ2 * 4;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const float* __restrict__ lse, const bf16* __restrict__ dout,
             float* __restrict__ Dg, bf16* __restrict__ dq, int BH, int nqt,
             int Tq, int Tk, int H, int KV, int G, int hd, int causal,
             float scale) {
  constexpr int LDS = HDP + 8, NJ = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBQ * LDS;
  bf16* Ks = dOs + kBQ * LDS;
  bf16* Vs = Ks + kBK * LDS;
  float* lse_s = reinterpret_cast<float*>(Vs + kBK * LDS);
  float* D_s = lse_s + kBQ;

  const int qt = nqt - 1 - blockIdx.x / BH;   // heavy (late) tiles first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = Tk - Tq;
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const long long qbase = ((long long)b * Tq * H + h) * hd;
  const bf16* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const bf16* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  load_rows<HDP>(Qs, q + qbase, sq, q0, kBQ, Tq, hd);
  load_rows<HDP>(dOs, dout + qbase, sq, q0, kBQ, Tq, hd);
  __syncthreads();
  // D = rowsum(dO * O): a warp a row, lanes over hd in a fixed order
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int i = q0 + r;
    float acc = 0.f;
    if (i < Tq)
      for (int d = lane; d < hd; d += 32)
        acc = fmaf(__bfloat162float(dOs[r * LDS + d]),
                   __bfloat162float(o[qbase + (long long)i * sq + d]), acc);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      D_s[r] = acc;
      lse_s[r] = i < Tq ? lse[((long long)b * Tq + i) * H + h] : 0.f;
      if (i < Tq) Dg[((long long)b * Tq + i) * H + h] = acc;
    }
  }

  float acc[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kv_end = Tk;
  if (causal) kv_end = max(0, min(Tk, min(q0 + kBQ, Tq) - 1 + off + 1));
  const float inv_tk = 1.f / (float)Tk;
  const uint32_t sQ = smem_u32(Qs), sdO = smem_u32(dOs);
  const uint32_t sK = smem_u32(Ks), sV = smem_u32(Vs);
  const int row = warp * 16;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and V are consumed
    load_rows<HDP>(Ks, kb, sk, k0, kBK, Tk, hd);
    load_rows<HDP>(Vs, vb, sk, k0, kBK, Tk, hd);
    __syncthreads();
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows<HDP, NJ>(s, sQ, row, sK, 0, lane);
    mma_rows<HDP, NJ>(dp, sdO, row, sV, 0, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + g + 8 * (e / 2);
        float p, ds;
        p_ds(s[j][e], dp[j][e], q0 + r, k0 + 8 * j + 2 * t + (e & 1), Tq,
             Tk, off, causal, scale, lse_s[r], D_s[r], inv_tk, p, ds);
        s[j][e] = ds;
      }
    uint32_t w[NJ / 2][4];
    to_a<NJ>(w, s);
    mma_acc<HDP, NJ / 2>(acc, w, sK, 0, lane);
  }
  store_acc<HDP>(dq + qbase, sq, acc, q0 + row, lane, Tq, hd, scale);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ lse,
              const bf16* __restrict__ dout, const float* __restrict__ Dg,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int BKV, int Tq,
              int Tk, int H, int KV, int G, int hd, int causal,
              float scale) {
  constexpr int LDS = HDP + 8, NJ = kBQ2 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBK * LDS;
  bf16* Qs = Vs + kBK * LDS;
  bf16* dOs = Qs + kBQ2 * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + kBQ2 * LDS);
  float* D_s = lse_s + kBQ2;

  const int kt = blockIdx.x / BKV;            // heavy (early) tiles first
  const int bk = blockIdx.x % BKV;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = Tk - Tq;
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const long long kbase = ((long long)b * Tk * KV + kvh) * hd;

  load_rows<HDP>(Ks, k + kbase, sk, k0, kBK, Tk, hd);
  load_rows<HDP>(Vs, v + kbase, sk, k0, kBK, Tk, hd);

  float acc_k[HDP / 8][4], acc_v[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // the first query tile with a row that sees these keys; with causal
  // Tq > Tk the first rows see no key and weigh every key: start at 0
  const int qt0 = causal && off >= 0 ? max(0, k0 - off) / kBQ2 : 0;
  const int nqt = (Tq + kBQ2 - 1) / kBQ2;
  const float inv_tk = 1.f / (float)Tk;
  const uint32_t sQ = smem_u32(Qs), sdO = smem_u32(dOs);
  const uint32_t sK = smem_u32(Ks), sV = smem_u32(Vs);
  const int row = warp * 16;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kvh * G + gq;
    const long long qbase = ((long long)b * Tq * H + h) * hd;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * kBQ2;
      __syncthreads();   // the previous tile's Q and dO are consumed
      load_rows<HDP>(Qs, q + qbase, sq, q0, kBQ2, Tq, hd);
      load_rows<HDP>(dOs, dout + qbase, sq, q0, kBQ2, Tq, hd);
      for (int r = tid; r < kBQ2; r += kThreads) {
        const int i = q0 + r;
        const long long at = ((long long)b * Tq + i) * H + h;
        lse_s[r] = i < Tq ? lse[at] : 0.f;
        D_s[r] = i < Tq ? Dg[at] : 0.f;
      }
      __syncthreads();
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows<HDP, NJ>(s, sK, row, sQ, 0, lane);     // S^T = K Q^T
      mma_rows<HDP, NJ>(dp, sV, row, sdO, 0, lane);   // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);      // query in the tile
          float p, ds;
          p_ds(s[j][e], dp[j][e], q0 + c, k0 + row + g + 8 * (e / 2), Tq,
               Tk, off, causal, scale, lse_s[c], D_s[c], inv_tk, p, ds);
          s[j][e] = p;
          dp[j][e] = ds;
        }
      uint32_t w[NJ / 2][4];
      to_a<NJ>(w, s);
      mma_acc<HDP, NJ / 2>(acc_v, w, sdO, 0, lane);   // dV += P^T dO
      to_a<NJ>(w, dp);
      mma_acc<HDP, NJ / 2>(acc_k, w, sQ, 0, lane);    // dK += dS^T Q
    }
  }
  store_acc<HDP>(dk + kbase, sk, acc_k, k0 + row, lane, Tk, hd, scale);
  store_acc<HDP>(dv + kbase, sk, acc_v, k0 + row, lane, Tk, hd, 1.f);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* D, void* dq, void* dk,
           void* dv, int B, int Tq, int Tk, int H, int KV, int hd, int causal,
           cudaStream_t stream) {
  const int dq_bytes = dq_smem_bytes<HDP>();
  const int dkv_bytes = dkv_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_tc_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + kBQ - 1) / kBQ;
  const int nkt = (Tk + kBK - 1) / kBK;
  const long long dq_blocks = (long long)nqt * B * H;
  const long long dkv_blocks = (long long)nkt * B * KV;
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const float scale = 1.f / sqrtf((float)hd);
  dq_tc_kernel<HDP><<<(unsigned)dq_blocks, kThreads, dq_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse,
      (const bf16*)dout, D, (bf16*)dq, B * H, nqt, Tq, Tk, H, KV, H / KV, hd,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_tc_kernel<HDP><<<(unsigned)dkv_blocks, kThreads, dkv_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, (const bf16*)dout,
      D, (bf16*)dk, (bf16*)dv, B * KV, Tq, Tk, H, KV, H / KV, hd, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, o, do, dq, dk, dv, contiguous, hd % 8 == 0 and hd <=
// 128, 16-byte aligned; lse [B, Tq, H] float32; D [B, Tq, H] float32
// scratch
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* D, void* dq, void* dk, void* dv,
    int B, int Tq, int Tk, int H, int KV, int hd, int causal, void* stream) {
  auto* st = (cudaStream_t)stream;
  if (hd % 8 != 0 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return launch<64>(q, k, v, o, (const float*)lse, dout, (float*)D, dq, dk,
                      dv, B, Tq, Tk, H, KV, hd, causal, st);
  return launch<128>(q, k, v, o, (const float*)lse, dout, (float*)D, dq, dk,
                     dv, B, Tq, Tk, H, KV, hd, causal, st);
}
