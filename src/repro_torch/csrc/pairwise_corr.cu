// B2: batched correlation tiles (replaces the Pallas kernel
// repro/kernels/pairwise_corr.py:pairwise_corr_pallas, body _corr_kernel).
//
// C[b] = A[b] @ B[b]^T for standardized row blocks A[b] [M, K] and
// B[b] [N, K], float32 in and out (PCIT phase 2).
//
// Design: a plain SIMT tiled GEMM.  Each CUDA block computes one 64 x 64
// output tile of one batch entry; both operands are K-contiguous, so
// 16-deep K slices of each are staged transposed in shared memory and
// every thread accumulates a 4 x 4 sub-tile with fmaf in float32.  No TF32
// and no tensor cores: the PCIT filter downstream makes threshold
// decisions on these values, and TF32 keeps about three digits.
//
// Bound on the H100: fp32 non-tensor arithmetic (2*M*N*K flops per entry,
// 67 TFLOP/s).  The 4 x 4 register tile reads shared memory twice for every
// 4 FMAs, so shared-memory bandwidth, not the FMA units, limits this first
// version; a register-blocked 8 x 8 tile or 3xTF32 on wgmma is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kThreads)
corr_kernel(const float* __restrict__ A,  // [batch, M, K]
            const float* __restrict__ Bm,  // [batch, N, K]
            float* __restrict__ C,         // [batch, M, N]
            int M, int N, int K) {
  const size_t b = blockIdx.z;
  A += b * M * K;
  Bm += b * N * K;
  C += b * M * N;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // +1 column: the transposed stores of 16 consecutive k fall in 16 banks
  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Bs[kDepth][kTile + 1];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int e = 0; e < kTile * kDepth / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int row = idx / kDepth;
      const int kk = idx % kDepth;
      const int gk = k0 + kk;
      As[kk][row] = (m0 + row < M && gk < K) ? A[(size_t)(m0 + row) * K + gk] : 0.f;
      Bs[kk][row] = (n0 + row < N && gk < K) ? Bm[(size_t)(n0 + row) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty + 16 * r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col < N) C[(size_t)row * N + col] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int repro_pairwise_corr(const void* a, const void* b, void* c,
                                   int batch, int M, int N, int K,
                                   void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch);
  corr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}
