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
// Design.  One block of 256 threads per (batch*head, 64-row q tile); the
// TPU kernel's sequential kv grid axis becomes a loop over 64-key tiles.
// The TPU kernel's three tile classes are kept: tiles past the diagonal
// are skipped (the loop stops at the last visible key), the others are
// masked element by element.  A q tile holding a row that sees no key at
// all (Tq > Tk) visits every tile, so that row averages v over all Tk keys
// like the plain softmax.  Q and K sit transposed in shared memory and V
// row-major, so every thread reads float4 runs: its 4 x 4 score block and
// its 4 x (hd/16) output block are register tiles fed by 3 (scores) and 5
// (p * v) shared-memory wavefronts per 16 / 32 FMAs.  K and V share one
// buffer (K, then V of the same tile) to keep two blocks on an SM.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores (4 * hd
// operations per visible (query, key) pair, 67 TFLOP/s).  TF32 tensor
// cores would break the 1e-5 limits on the f32 partials.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;   // 16 x 16; each thread owns 4 q rows
constexpr int kStride = 68;     // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

template <int HDP>
constexpr int smem_floats() {
  // Qt [HDP][kStride] + max(Kt [HDP][kStride], V [kBK][HDP]) + Pt [kBK][kStride]
  return HDP * kStride * 2 + kBK * kStride;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, void* __restrict__ o_out,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ lse_out,
             const int* __restrict__ row_valid, int BH, int nqt, int Tq,
             int Tk, int H, int G, int hd, long long sq_b, long long sq_t,
             long long sq_h, long long sk_b, long long sk_t, long long sk_h,
             long long sv_b, long long sv_t, long long sv_h, int causal,
             int partial, float scale) {
  constexpr int NG = HDP / 64;  // 64-wide column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HDP][kStride]
  float* KV = Qt + HDP * kStride;         // Kt [HDP][kStride] or V [kBK][HDP]
  float* Pt = KV + HDP * kStride;         // [kBK][kStride]

  // heavy (late) q tiles of every head first
  const int qt = nqt - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Tk - Tq;

  if (row_valid != nullptr && row_valid[b] == 0) {
    // the merge identity, nothing computed
    for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
      const int i = q0 + idx / hd, d = idx % hd;
      if (i >= Tq) continue;
      const size_t row = ((size_t)b * Tq + i) * H + h;
      if (partial) {
        ((float*)o_out)[row * hd + d] = 0.f;
        if (d == 0) { m_out[row] = kNegInf; l_out[row] = 0.f; }
      } else {
        ((float*)o_out)[row * hd + d] = 0.f;
      }
    }
    return;
  }

  const float* qb = q + b * sq_b + h * sq_h;
  const float* kb = k + b * sk_b + kvh * sk_h;
  const float* vb = v + b * sv_b + kvh * sv_h;

  for (int idx = tid; idx < kBQ * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    float x = 0.f;
    if (q0 + r < Tq && d < hd) x = qb[(q0 + r) * sq_t + d] * scale;
    Qt[d * kStride + r] = x;
  }

  float m_i[4], l_i[4], acc[4][NG * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[r][c] = 0.f;
  }

  int kv_end = Tk;
  if (causal && q0 + off >= 0) {
    // every row sees key 0: stop after the last key the last row sees
    const int last_q = min(q0 + kBQ, Tq) - 1;
    kv_end = min(Tk, last_q + off + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int idx = tid; idx < kBK * HDP; idx += kThreads) {
      const int r = idx / HDP, d = idx % HDP;
      float x = 0.f;
      if (k0 + r < Tk && d < hd) x = kb[(k0 + r) * sk_t + d];
      KV[d * kStride + r] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *(const float4*)&Qt[d * kStride + ty * 4];
      const float4 bk = *(const float4*)&KV[d * kStride + tx * 4];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // masks, online softmax (a row's 64 scores live on 16 lanes of a warp)
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        if (j >= Tk) s[r][c] = -INFINITY;
        else if (causal && j > i + off) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_i[r], mx);
      corr[r] = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_i[r] = l_i[r] * corr[r] + sum;
      m_i[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *(float4*)&Pt[(tx * 4 + c) * kStride + ty * 4] =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();  // K consumed, P written

    for (int idx = tid; idx < kBK * HDP; idx += kThreads) {
      const int r = idx / HDP, d = idx % HDP;
      float x = 0.f;
      if (k0 + r < Tk && d < hd) x = vb[(k0 + r) * sv_t + d];
      KV[r * HDP + d] = x;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *(const float4*)&Pt[j * kStride + ty * 4];
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *(const float4*)&KV[j * HDP + g * 64 + tx * 4];
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][g * 4 + c] = fmaf(pv[r], vf[c], acc[r][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d >= hd) continue;
        if (partial)
          ((float*)o_out)[row * hd + d] = acc[r][g * 4 + c];
        else
          ((float*)o_out)[row * hd + d] = acc[r][g * 4 + c] * inv;
      }
    if (partial && tx == 0) {
      m_out[row] = m_i[r];
      l_out[row] = l_i[r];
    }
    if (lse_out != nullptr && tx == 0)
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
  const int bytes = smem_floats<HDP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nqt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, o, m, l, lse,
      row_valid, B * H, nqt, Tq, Tk, H, H / KV, hd, sq_b, sq_t, sq_h, sk_b,
      sk_t, sk_h, sv_b, sv_t, sv_h, causal, partial,
      1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* m,
             float* l, float* lse, const int* row_valid, int B, int Tq,
             int Tk, int H, int KV, int hd, long long sq_b, long long sq_t,
             long long sq_h, long long sk_b, long long sk_t, long long sk_h,
             long long sv_b, long long sv_t, long long sv_h, int causal,
             int partial, cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV,
                      hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,
                      sv_h, causal, partial, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV,
                       hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,
                       sv_h, causal, partial, stream);
  if (hd <= 256)
    return launch<256>(q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV,
                       hd, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,
                       sv_h, causal, partial, stream);
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
