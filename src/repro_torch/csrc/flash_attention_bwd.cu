// B9 backward: the gradient of flash attention (dq, dk, dv), hand-written
// for the H100.  The JAX package has no Pallas backward: its train step
// differentiates the plain jnp attention of repro/models/attention.py with
// XLA, so this kernel is the counterpart of that autodiff, for the forward
// kernels of flash_attention.cu / flash_attention_tc.cu (which replace
// repro/kernels/flash_attention.py:flash_attention_pallas).  It runs
// float32 inputs, and bfloat16 at the head widths the wgmma kernels of
// flash_attention_bwd_tc.cu do not take (hd not a multiple of 8, or above
// 128).
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
// Design: simple and right, two launches, no atomics, every sum in a fixed
// order (the gradient is deterministic, as the reference's is).
//   1. dq_kernel: a block per (b, h, BQ query rows), heavy (late) tiles
//      first.  Prologue: D for its rows (a warp a row), written to the
//      scratch D [B, Tq, H] for launch 2.  Then a loop over the key tiles
//      the rows can see (tiles past the causal diagonal skipped): S and dP
//      in registers, dS to shared memory transposed, dQ += dS K.
//   2. dkv_kernel: a block per (b, kv head, BK keys), heavy (early) tiles
//      first, K and V held in shared memory.  It walks the G query heads
//      and, for each, the query tiles that see its keys, in that order:
//      S, dP, then P and dS to shared memory, dV += P^T dO, dK += dS^T Q.
// Every operand is staged in shared memory as float32 rows of stride
// HDP + 4 (zero past T and past hd), so each thread reads float4 runs
// along hd; the thread-to-row maps keep every 16-byte phase free of bank
// conflicts.  A thread owns R x R scores (R = BQ / 16) and R rows x HDP/16
// columns of its accumulators.
//
// Bound on the H100: 10 * hd operations per visible (query, key) pair for
// the algorithm (the products dV, dP, dS^T Q and dS K and the recomputed
// S), at the bf16 tensor cores' 989 TFLOP/s for bf16 inputs and the fp32
// rate, 67 TFLOP/s, for float32 ones.  This kernel issues 14 * hd (S and
// dP are formed in both launches) on the fp32 FMA units, outside the
// tensor cores (TF32 keeps about three decimal digits, short of the
// float32 rule of 1e-4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash_bwd::p_ds;

constexpr int kThreads = 256;   // 16 x 16

template <int HDP>
struct Tile {
  static constexpr int BQ = HDP > 128 ? 32 : 64;  // query rows a tile
  static constexpr int BK = BQ;                   // keys a tile
  static constexpr int R = BQ / 16;               // rows a thread owns
  static constexpr int NG = HDP / 64;             // 64-wide column groups
  static constexpr int LD = HDP + 4;              // stride of [rows][HDP]
  static constexpr int LP = BQ + 4;               // stride of P / dS tiles
};

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

// rows [r0, r0 + n) of a [T, hd] slice with row stride st into a float
// tile [n][HDP] of stride LD (zero past T and past hd)
template <int HDP, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ g,
                                          long long st, int r0, int n,
                                          int Tn, int hd) {
  constexpr int LD = Tile<HDP>::LD;
  for (int idx = threadIdx.x; idx < n * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    float x = 0.f;
    if (r0 + r < Tn && d < hd) x = to_f(g[(long long)(r0 + r) * st + d]);
    dst[r * LD + d] = x;
  }
}

// s[a][c] = A[ra(a)] . Bm[rb(c)] and dp[a][c] = dA[ra(a)] . dB[rb(c)] over
// HDP columns, rows given as float offsets into the tiles
template <int HDP, int R>
__device__ __forceinline__ void two_products(
    float (&s)[R][R], float (&dp)[R][R], const float* A, const float* Bm,
    const float* dA, const float* dB, const int (&ra)[R],
    const int (&rb)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HDP; d += 4) {
    float4 x[R], y[R];
#pragma unroll
    for (int a = 0; a < R; ++a) x[a] = *(const float4*)&A[ra[a] + d];
#pragma unroll
    for (int c = 0; c < R; ++c) y[c] = *(const float4*)&Bm[rb[c] + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float t = s[a][c];
        t = fmaf(x[a].x, y[c].x, t);
        t = fmaf(x[a].y, y[c].y, t);
        t = fmaf(x[a].z, y[c].z, t);
        s[a][c] = fmaf(x[a].w, y[c].w, t);
      }
#pragma unroll
    for (int a = 0; a < R; ++a) x[a] = *(const float4*)&dA[ra[a] + d];
#pragma unroll
    for (int c = 0; c < R; ++c) y[c] = *(const float4*)&dB[rb[c] + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float t = dp[a][c];
        t = fmaf(x[a].x, y[c].x, t);
        t = fmaf(x[a].y, y[c].y, t);
        t = fmaf(x[a].z, y[c].z, t);
        dp[a][c] = fmaf(x[a].w, y[c].w, t);
      }
  }
}

// acc[a][g*4 + e] += sum_r W[r][row0 + a] * X[r][g*64 + tx*4 + e] over
// n rows r of the weight tile W (stride LP) and the operand tile X
template <int HDP>
__device__ __forceinline__ void accumulate(
    float (&acc)[Tile<HDP>::R][Tile<HDP>::NG * 4], const float* W,
    const float* X, int row0, int tx, int n) {
  using C = Tile<HDP>;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    float w[C::R];
#pragma unroll
    for (int a = 0; a < C::R; ++a) w[a] = W[r * C::LP + row0 + a];
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const float4 x = *(const float4*)&X[r * C::LD + g * 64 + tx * 4];
#pragma unroll
      for (int a = 0; a < C::R; ++a) {
        acc[a][g * 4 + 0] = fmaf(w[a], x.x, acc[a][g * 4 + 0]);
        acc[a][g * 4 + 1] = fmaf(w[a], x.y, acc[a][g * 4 + 1]);
        acc[a][g * 4 + 2] = fmaf(w[a], x.z, acc[a][g * 4 + 2]);
        acc[a][g * 4 + 3] = fmaf(w[a], x.w, acc[a][g * 4 + 3]);
      }
    }
  }
}

// rows row0 + a (< Tn) of acc * mul into dst [Tn, hd] with row stride st
template <int HDP, typename T>
__device__ __forceinline__ void store_rows(
    T* __restrict__ dst, long long st,
    const float (&acc)[Tile<HDP>::R][Tile<HDP>::NG * 4], int row0, int tx,
    int Tn, int hd, float mul) {
  using C = Tile<HDP>;
#pragma unroll
  for (int a = 0; a < C::R; ++a) {
    const int r = row0 + a;
    if (r >= Tn) continue;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < hd)
          dst[(long long)r * st + d] = from_f<T>(acc[a][g * 4 + e] * mul);
      }
  }
}

template <int HDP>
constexpr int dq_smem_floats() {
  using C = Tile<HDP>;
  return 4 * C::BQ * C::LD + C::BK * C::LP + 2 * C::BQ;
}

template <int HDP>
constexpr int dkv_smem_floats() {
  using C = Tile<HDP>;
  return 4 * C::BQ * C::LD + 2 * C::BQ * C::LP + 2 * C::BQ;
}

template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout,
          float* __restrict__ Dg, T* __restrict__ dq, int BH, int nqt, int Tq,
          int Tk, int H, int KV, int G, int hd, int causal, float scale) {
  using C = Tile<HDP>;
  constexpr int R = C::R, LD = C::LD, LP = C::LP, BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ks = dOs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* dSt = Vs + BK * LD;     // [BK][LP]: dS transposed (key-major)
  float* lse_s = dSt + BK * LP;  // [BQ]
  float* D_s = lse_s + BQ;       // [BQ]

  const int qt = nqt - 1 - blockIdx.x / BH;   // heavy (late) tiles first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Tk - Tq;
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const T* qb = q + ((long long)b * Tq * H + h) * hd;
  const T* ob = o + ((long long)b * Tq * H + h) * hd;
  const T* dob = dout + ((long long)b * Tq * H + h) * hd;
  const T* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  load_rows<HDP>(Qs, qb, sq, q0, BQ, Tq, hd);
  load_rows<HDP>(dOs, dob, sq, q0, BQ, Tq, hd);
  __syncthreads();
  // D = rowsum(dO * O): a warp a row, lanes over hd in a fixed order
  for (int r = tid / 32; r < BQ; r += kThreads / 32) {
    const int i = q0 + r;
    float acc = 0.f;
    if (i < Tq)
      for (int d = tid % 32; d < hd; d += 32)
        acc = fmaf(dOs[r * LD + d], to_f(ob[(long long)i * sq + d]), acc);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (tid % 32 == 0) {
      D_s[r] = acc;
      lse_s[r] = i < Tq ? lse[((long long)b * Tq + i) * H + h] : 0.f;
      if (i < Tq) Dg[((long long)b * Tq + i) * H + h] = acc;
    }
  }

  float acc[R][C::NG * 4];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < C::NG * 4; ++e) acc[a][e] = 0.f;

  // keys the rows can see; rows that see none get dQ = 0
  int kv_end = Tk;
  if (causal) kv_end = max(0, min(Tk, min(q0 + BQ, Tq) - 1 + off + 1));
  const float inv_tk = 1.f / (float)Tk;
  int ra[R], rb[R];
#pragma unroll
  for (int a = 0; a < R; ++a) ra[a] = (ty * R + a) * LD;
#pragma unroll
  for (int c = 0; c < R; ++c) rb[c] = (tx + 16 * c) * LD;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's K and dS are consumed
    load_rows<HDP>(Ks, kb, sk, k0, BK, Tk, hd);
    load_rows<HDP>(Vs, vb, sk, k0, BK, Tk, hd);
    __syncthreads();
    float s[R][R], dp[R][R];
    two_products<HDP, R>(s, dp, Qs, Ks, dOs, Vs, ra, rb);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty * R + a;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float p, ds;
        p_ds(s[a][c], dp[a][c], q0 + r, k0 + tx + 16 * c, Tq, Tk, off,
             causal, scale, lse_s[r], D_s[r], inv_tk, p, ds);
        dSt[(tx + 16 * c) * LP + r] = ds;
      }
    }
    __syncthreads();
    accumulate<HDP>(acc, dSt, Ks, ty * R, tx, BK);
  }
  store_rows<HDP>(dq + ((long long)b * Tq * H + h) * hd, sq, acc,
                  q0 + ty * R, tx, Tq, hd, scale);
}

template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lse,
           const T* __restrict__ dout, const float* __restrict__ Dg,
           T* __restrict__ dk, T* __restrict__ dv, int BKV, int nqt, int Tq,
           int Tk, int H, int KV, int G, int hd, int causal, float scale) {
  using C = Tile<HDP>;
  constexpr int R = C::R, LD = C::LD, LP = C::LP, BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ps = dOs + BQ * LD;     // [BQ][LP]: P (query-major)
  float* dSs = Ps + BQ * LP;     // [BQ][LP]: dS (query-major)
  float* lse_s = dSs + BQ * LP;  // [BQ]
  float* D_s = lse_s + BQ;       // [BQ]

  const int kt = blockIdx.x / BKV;            // heavy (early) tiles first
  const int bk = blockIdx.x % BKV;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Tk - Tq;
  const long long sq = (long long)H * hd, sk = (long long)KV * hd;
  const T* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  load_rows<HDP>(Ks, kb, sk, k0, BK, Tk, hd);
  load_rows<HDP>(Vs, vb, sk, k0, BK, Tk, hd);

  float acc_k[R][C::NG * 4], acc_v[R][C::NG * 4];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < C::NG * 4; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  // the first query tile with a row that sees these keys; with causal
  // Tq > Tk the first rows see no key and weigh every key: start at 0
  const int qt0 = causal && off >= 0 ? max(0, k0 - off) / BQ : 0;
  const float inv_tk = 1.f / (float)Tk;
  int ra[R], rb[R];
#pragma unroll
  for (int a = 0; a < R; ++a) ra[a] = (tx + 16 * a) * LD;
#pragma unroll
  for (int c = 0; c < R; ++c) rb[c] = (ty * R + c) * LD;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((long long)b * Tq * H + h) * hd;
    const T* dob = dout + ((long long)b * Tq * H + h) * hd;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
      load_rows<HDP>(Qs, qb, sq, q0, BQ, Tq, hd);
      load_rows<HDP>(dOs, dob, sq, q0, BQ, Tq, hd);
      for (int r = tid; r < BQ; r += kThreads) {
        const int i = q0 + r;
        const long long row = ((long long)b * Tq + i) * H + h;
        lse_s[r] = i < Tq ? lse[row] : 0.f;
        D_s[r] = i < Tq ? Dg[row] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      two_products<HDP, R>(s, dp, Qs, Ks, dOs, Vs, ra, rb);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = tx + 16 * a;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          float p, ds;
          p_ds(s[a][c], dp[a][c], q0 + r, k0 + ty * R + c, Tq, Tk, off,
               causal, scale, lse_s[r], D_s[r], inv_tk, p, ds);
          Ps[r * LP + ty * R + c] = p;
          dSs[r * LP + ty * R + c] = ds;
        }
      }
      __syncthreads();
      accumulate<HDP>(acc_v, Ps, dOs, ty * R, tx, BQ);
      accumulate<HDP>(acc_k, dSs, Qs, ty * R, tx, BQ);
    }
  }
  const long long base = ((long long)b * Tk * KV + kvh) * hd;
  store_rows<HDP>(dk + base, sk, acc_k, k0 + ty * R, tx, Tk, hd, scale);
  store_rows<HDP>(dv + base, sk, acc_v, k0 + ty * R, tx, Tk, hd, 1.f);
}

template <int HDP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* D, void* dq, void* dk,
           void* dv, int B, int Tq, int Tk, int H, int KV, int hd, int causal,
           cudaStream_t stream) {
  using C = Tile<HDP>;
  const int dq_bytes = dq_smem_floats<HDP>() * (int)sizeof(float);
  const int dkv_bytes = dkv_smem_floats<HDP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<HDP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel<HDP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + C::BQ - 1) / C::BQ;
  const int nkt = (Tk + C::BK - 1) / C::BK;
  const long long dq_blocks = (long long)nqt * B * H;
  const long long dkv_blocks = (long long)nkt * B * KV;
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const float scale = 1.f / sqrtf((float)hd);
  dq_kernel<HDP, T><<<(unsigned)dq_blocks, kThreads, dq_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, lse,
      (const T*)dout, D, (T*)dq, B * H, nqt, Tq, Tk, H, KV, H / KV, hd,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<HDP, T><<<(unsigned)dkv_blocks, kThreads, dkv_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, D,
      (T*)dk, (T*)dv, B * KV, nqt, Tq, Tk, H, KV, H / KV, hd, causal, scale);
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
// else float32); lse [B, Tq, H] float32; D [B, Tq, H] float32 scratch
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
