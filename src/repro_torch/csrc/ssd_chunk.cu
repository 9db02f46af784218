// B10: the Mamba2 SSD intra-chunk step (replaces the Pallas kernel
// repro/kernels/ssd_chunk.py:ssd_chunk_pallas, body _ssd_kernel;
// arXiv:2405.21060 algorithm 1).
//
// For every (batch row b, head h, chunk c) of length L, with a_l = dt_l * A_h:
//   cums_l = a_0 + ... + a_l                         (inclusive cumsum)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//   S      = sum_j exp(cums_{L-1} - cums_j) dt_j B_j x_j^T      [N, P]
//   cd_l   = exp(cums_l)
// Inputs x [B, T, H, P], dt [B, T, H], A [H], B / C [B, T, N], all float32
// (x, B and C with any strides and a contiguous last axis: the model's
// views into its projection); B and C are read per batch row, never
// repeated per head.  Outputs (float32, contiguous): y [B, T, H, P],
// S [B, nc, H, N, P], cd [B, T, H].  The inter-chunk recurrence stays in
// framework code (kernels/ssd_chunk.py), as in the reference.
//
// Design.  One block of 256 threads per (b * H + h, chunk).  The chunk's
// dt * A is scanned in shared memory (warp shuffles, then the warp
// totals).  y is built in 64-row tiles: for each source tile j <= i the
// 64 x 64 block of C_i B_j^T is a register-tiled product over N, scaled by
// the decay and dt_j where i >= j and set to 0 elsewhere — the exponent
// is taken only for i >= j, where cums_i - cums_j <= 0, so it never
// overflows and no inf meets a 0 mask — then folded into the 64 x P
// output tile.  Tiles above the diagonal are never formed.  S is the same
// register tiling over 64-row slices of N.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores
// (2 L^2 N / 2 for C B^T below the diagonal, 2 L^2 P / 2 for y, 2 L N P
// for S per cell; 67 TFLOP/s); the bytes (x, y, S, B, C once) are an
// order below.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxL = 256;
constexpr int kMaxPc = 8;      // P <= 128: 8 columns of 16 per thread

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ S, float* __restrict__ cd, int T, int H,
           int P, int N, int L, int nc, long long sx_b, long long sx_t,
           long long sx_h, long long sb_b, long long sb_t, long long sc_b,
           long long sc_t) {
  extern __shared__ float smem[];
  const int ns = N | 1;                 // odd row stride: no bank conflicts
  float* cums = smem;                   // [kMaxL]
  float* dts = cums + kMaxL;            // [kMaxL]
  float* Cs = dts + kMaxL;              // [kTile][ns]
  float* Bs = Cs + kTile * ns;          // [kTile][ns]
  float* Xs = Bs + kTile * ns;          // [kTile][P]
  float* Ws = Xs + kTile * P;           // [kTile][kTile + 1]

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int pc = (P + 15) / 16;
  const float a_h = A[h];

  // inclusive cumsum of dt * A over the chunk
  __shared__ float warp_sum[kThreads / 32];
  float la = 0.f, dtv = 0.f;
  if (tid < L) {
    dtv = dt[((size_t)b * T + t0 + tid) * H + h];
    la = dtv * a_h;
  }
  float run = la;
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, w);
    if (lane >= w) run += o;
  }
  if (lane == 31) warp_sum[warp] = run;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  if (tid < L) {
    cums[tid] = base + run;
    dts[tid] = dtv;
  }
  __syncthreads();
  if (tid < L) cd[((size_t)b * T + t0 + tid) * H + h] = expf(cums[tid]);

  const float* xb = x + b * sx_b + h * sx_h + t0 * sx_t;
  const float* bb = Bm + b * sb_b + t0 * sb_t;
  const float* cb = Cm + b * sc_b + t0 * sc_t;
  auto load_rows = [&](float* dst, const float* src, long long st, int r0,
                       int width, int stride) {
    for (int idx = tid; idx < kTile * width; idx += kThreads) {
      const int r = idx / width, col = idx % width;
      dst[r * stride + col] = (r0 + r < L) ? src[(r0 + r) * st + col] : 0.f;
    }
  };

  const int ntiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kTile;
    float acc[4][kMaxPc];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kMaxPc; ++q) acc[r][q] = 0.f;
    __syncthreads();
    load_rows(Cs, cb, sc_t, i0, N, ns);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // Bs / Xs / Ws of the previous tile consumed
      load_rows(Bs, bb, sb_t, j0, N, ns);
      load_rows(Xs, xb, sx_t, j0, P, P);
      __syncthreads();
      float w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[r][q] = fmaf(cv[r], bv[q], w[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx + 16 * q;
          float val = 0.f;
          if (i < L && j < L && j <= i)
            val = w[r][q] * expf(cums[i] - cums[j]) * dts[j];
          Ws[(ty + 16 * r) * (kTile + 1) + tx + 16 * q] = val;
        }
      }
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = Ws[(ty + 16 * r) * (kTile + 1) + j];
#pragma unroll
        for (int q = 0; q < kMaxPc; ++q) {
          if (q >= pc || tx + 16 * q >= P) continue;
          const float xv = Xs[j * P + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(wv[r], xv, acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= L) continue;
      float* yr = y + (((size_t)b * T + t0 + i) * H + h) * P;
#pragma unroll
      for (int q = 0; q < kMaxPc; ++q)
        if (q < pc && tx + 16 * q < P) yr[tx + 16 * q] = acc[r][q];
    }
  }

  // S = sum_j (exp(cums_{L-1} - cums_j) dt_j) B_j x_j^T, in 64-row slices of N
  float* Sout = S + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
  const float c_end = cums[L - 1];
  for (int n0 = 0; n0 < N; n0 += kTile) {
    float acc[4][kMaxPc];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kMaxPc; ++q) acc[r][q] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      load_rows(Bs, bb, sb_t, j0, N, ns);
      load_rows(Xs, xb, sx_t, j0, P, P);
      __syncthreads();
      const int jn = min(kTile, L - j0);
      for (int j = 0; j < jn; ++j) {
        const float dend = expf(c_end - cums[j0 + j]) * dts[j0 + j];
        float bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + ty + 16 * r;
          bv[r] = (n < N) ? Bs[j * ns + n] * dend : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kMaxPc; ++q) {
          if (q >= pc || tx + 16 * q >= P) continue;
          const float xv = Xs[j * P + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(bv[r], xv, acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < kMaxPc; ++q)
        if (q < pc && tx + 16 * q < P)
          Sout[(size_t)n * P + tx + 16 * q] = acc[r][q];
    }
  }
}

}  // namespace

extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* S, void* cd, int Bsz, int T, int H,
                               int P, int N, int L, long long sx_b,
                               long long sx_t, long long sx_h, long long sb_b,
                               long long sb_t, long long sc_b, long long sc_t,
                               void* stream) {
  if (L < 1 || L > kMaxL || T % L || P < 1 || P > 16 * kMaxPc || N < 1 ||
      N > 256)
    return (int)cudaErrorInvalidValue;
  const int nc = T / L;
  const int ns = N | 1;
  const int floats = 2 * kMaxL + 2 * kTile * ns + kTile * P +
                     kTile * (kTile + 1);
  const int bytes = floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if ((long long)Bsz * H > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(nc, Bsz * H);
  ssd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)S, (float*)cd, T, H, P, N, L, nc,
      sx_b, sx_t, sx_h, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}
