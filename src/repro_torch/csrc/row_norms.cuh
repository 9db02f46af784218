// Squared row norms for the fp32 pair kernels B5 pairwise_threshold and
// B6 pairwise_topk: |row|^2 of every row of x [n_rows, d], one fmaf chain
// from 0 over d in ascending order (the chain their score tiles use for a
// dot), once per slot row rather than per strip and per tile.

#pragma once

#include <cuda_runtime.h>

namespace row_norms {

constexpr int kNormRows = 128;

// 32 columns at a time through shared memory, so a warp reads 32
// consecutive floats of a row (static: each source that includes this
// header has its own copy)
static __global__ void __launch_bounds__(kNormRows)
norm_kernel(const float* __restrict__ x, float* __restrict__ out,
            long long n_rows, int d) {
  __shared__ float t[kNormRows][33];
  const long long r0 = (long long)blockIdx.x * kNormRows;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
#pragma unroll 4
    for (int e = 0; e < 32; ++e) {
      const int r = 4 * e + tid / 32, c = tid % 32;
      t[r][c] = r0 + r < n_rows && k0 + c < d
                    ? x[(size_t)(r0 + r) * d + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 32; ++c)   // past d: + 0, exact
      s = fmaf(t[tid][c], t[tid][c], s);
    __syncthreads();
  }
  if (r0 + tid < n_rows) out[r0 + tid] = s;
}

inline void launch(const float* x, float* out, long long n_rows, int d,
                   cudaStream_t s) {
  norm_kernel<<<(unsigned)((n_rows + kNormRows - 1) / kNormRows), kNormRows,
                0, s>>>(x, out, n_rows, d);
}

}  // namespace row_norms
