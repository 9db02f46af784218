// B2: batched correlation tiles (replaces the Pallas kernel
// repro/kernels/pairwise_corr.py:pairwise_corr_pallas, body _corr_kernel).
//
// C[b] = A[b] @ B[b]^T for standardized row blocks A[b] [M, K] and
// B[b] [N, K], float32 in and out (PCIT phase 2).
//
// Each output is one fmaf chain from 0 over k = 0 .. K-1 in order, as the
// plain version's product (cuBLAS's FFMA kernel) is: the two agree bit for
// bit, where a reordered sum (tensor cores, 3xTF32, split-K) moves
// near-zero correlations by about 1e-5 at K = 512.  No TF32 and no tensor
// cores: TF32 keeps about three digits, and the PCIT filter downstream
// makes threshold decisions on these values.  No atomics.
//
// Design: a register-blocked SIMT GEMM on the fp32 pipe.  A block of 128
// threads computes one 128 x 128 output tile of one batch entry, two
// blocks to an SM; each thread owns an 8 x 16 sub-tile (rows ty + 16 i,
// columns tx + 8 j).  K slices of 32 go through a 3-stage ring in dynamic
// shared memory, copied by 16-byte cp.async in the operands' own
// K-contiguous layout (rows of 36 floats: 32 plus 4 of padding), with zero
// fill past M, N and K; plain loads where K or a base address is not
// 16-byte aligned.  Per 4 k a thread loads its 8 A rows and 16 B rows as
// float4 runs along k (24 LDS.128 for 512 FMAs), then runs four outer
// products of 128 independent FMAs, one per k in order.  A quarter-warp
// reads one A row (a broadcast) and 8 consecutive B rows, whose 36-word
// stride puts them in 8 distinct 4-bank groups, so no read conflicts; the
// cp.async writes of a row's 8 chunks fall in 8 distinct groups too.  This
// layout needs no transposed store, and it measured faster on the H100
// than a register-staged transposed one and than 4-byte cp.async copies
// that transpose (PERF.md).
//
// Bound on the H100: fp32 arithmetic outside the tensor cores (2*M*N*K
// flops per entry, 67 TFLOP/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;
constexpr int kDepth = 32;
constexpr int kLd = kDepth + 4;   // row stride in shared memory (floats)
constexpr int kStages = 3;
constexpr int kThreads = 128;     // 16 x 8, each 8 x 16 outputs
constexpr int kStageFloats = 2 * kTile * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);

// the k slice [k0, k0 + 32) of A rows [m0, m0 + 128) and B rows
// [n0, n0 + 128) into one ring stage at dst
template <bool kVec>
__device__ __forceinline__ void load_stage(uint32_t dst,
                                           const float* __restrict__ A,
                                           const float* __restrict__ Bm,
                                           int m0, int n0, int M, int N,
                                           int k0, int K, int tid) {
#pragma unroll
  for (int e = 0; e < kTile * kDepth / 4 / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / (kDepth / 4), c = idx % (kDepth / 4);
    const uint32_t d = dst + (uint32_t)(r * kLd + 4 * c) * 4u;
    const int gk = k0 + 4 * c;
#pragma unroll
    for (int op = 0; op < 2; ++op) {   // A, then B one tile further on
      const float* g = op ? Bm : A;
      const bool row_ok = (op ? n0 + r < N : m0 + r < M);
      const float* src =
          g + (size_t)(row_ok ? (op ? n0 : m0) + r : 0) * K + gk;
      const uint32_t dd = d + op * kTile * kLd * 4;
      if constexpr (kVec) {
        const bool ok = row_ok && gk < K;
        cp_async16(dd, ok ? src : g, ok ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          w[x] = __float_as_uint(row_ok && gk + x < K ? src[x] : 0.f);
        st_shared_v4(dd, make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// kVec: 16-byte copies (K % 4 == 0, 16-byte-aligned bases), else plain loads
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
corr_kernel(const float* __restrict__ A,  // [batch, M, K]
            const float* __restrict__ Bm,  // [batch, N, K]
            float* __restrict__ C,         // [batch, M, N]
            int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  const size_t b = blockIdx.z;
  A += b * M * K;
  Bm += b * N * K;
  C += b * M * N;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const uint32_t s0 = smem_u32(smem);
  const int nk = (K + kDepth - 1) / kDepth;

  auto load = [&](int t) {
    load_stage<kVec>(s0 + (uint32_t)((t % kStages) * kStageFloats) * 4u, A,
                     Bm, m0, n0, M, N, t * kDepth, K, tid);
  };

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();   // slice t landed
    __syncthreads();                // ... for every thread; slice t-1 done
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    const float* As = smem + (t % kStages) * kStageFloats;
    const float* Bs = As + kTile * kLd;
#pragma unroll
    for (int k4 = 0; k4 < kDepth / 4; ++k4) {
      float4 a[8], bv[16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[(ty + 16 * i) * kLd +
                                                     4 * k4]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 8 * j) * kLd +
                                                      4 * k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // k in order
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[i][j] = fmaf(lane(a[i], kk), lane(bv[j], kk), acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + tx + 8 * j;
      if (col < N) C[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <bool kVec>
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      corr_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch);
  corr_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_pairwise_corr(const void* a, const void* b, void* c,
                                   int batch, int M, int N, int K,
                                   void* stream) {
  const bool vec = K % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  return vec ? launch<true>(a, b, c, batch, M, N, K, (cudaStream_t)stream)
             : launch<false>(a, b, c, batch, M, N, K, (cudaStream_t)stream);
}
