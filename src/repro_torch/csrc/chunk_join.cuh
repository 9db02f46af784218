// bf16 dots of B7 and B8 in chunks (pairwise_threshold_q.cu and
// pairwise_topk_q.cu, their streamed instances: rows longer than 128).
// Each chunk of kChunk of d sums in a fresh tensor-core accumulator and
// joins a float32 running sum in ascending chunk order, compensated; B7's
// header gives the argument.  kChunk is kernels/pairwise_batch_q.py's
// BF16_CHUNK, which kernels/_build.py passes as -DREPRO_BF16_CHUNK, so the
// wrappers, the CPU model of this sum (tests/test_torch_pair_tc_chunks.py)
// and the kernels read one number.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#ifndef REPRO_BF16_CHUNK
#error "REPRO_BF16_CHUNK is not set (kernels/_build.py passes BF16_CHUNK)"
#endif

namespace chunk_join {

constexpr int kChunk = REPRO_BF16_CHUNK;  // bf16: d summed between joins
static_assert(kChunk % 16 == 0 && kChunk >= 16 && kChunk <= 128,
              "a chunk is whole m16n8k16 steps, at most 128 of d");
constexpr int kSteps = kChunk / 16;       // m16n8k16 steps a chunk

// streamed bf16 rows (d > 128) sum in chunks
template <typename T, bool kResA>
__host__ __device__ constexpr bool chunked() {
  return std::is_same<T, __nv_bfloat16>::value && !kResA;
}

// whether k-step `step` (m16n8k16 steps along d from 0) ends a chunk, or
// the row ends there
__device__ __forceinline__ bool ends(int step, bool row_end) {
  return (step + 1) % kSteps == 0 || row_end;
}

// a chunk's sums acc into the running sums run, compensated (Kahan): the
// add's rounding error, exact where |run| >= |chunk|, starts the next
// chunk's sum.  -DREPRO_BF16_PLAIN_JOINS joins by plain adds instead
// (scripts/pair_q_chunks.py compares the two).
template <int M, int N>
__device__ __forceinline__ void join(float (&run)[M][N][4],
                                     float (&acc)[M][N][4]) {
#pragma unroll
  for (int mi = 0; mi < M; ++mi)
#pragma unroll
    for (int nj = 0; nj < N; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& r = run[mi][nj][e];
        float& a = acc[mi][nj][e];
#ifdef REPRO_BF16_PLAIN_JOINS
        r = __fadd_rn(r, a);
        a = 0.f;
#else
        const float t = __fadd_rn(r, a);
        a = __fadd_rn(__fsub_rn(r, t), a);
        r = t;
#endif
      }
}

// the tile's dots, for the epilogue: acc takes the running sums, which
// restart from 0 for the next tile
template <int M, int N>
__device__ __forceinline__ void take(float (&run)[M][N][4],
                                     float (&acc)[M][N][4]) {
#pragma unroll
  for (int mi = 0; mi < M; ++mi)
#pragma unroll
    for (int nj = 0; nj < N; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][nj][e] = run[mi][nj][e];
        run[mi][nj][e] = 0.f;
      }
}

}  // namespace chunk_join
