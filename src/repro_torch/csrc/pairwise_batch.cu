// B1: fused batched n-body pair step (replaces the Pallas kernel
// repro/kernels/pairwise_batch.py:pairwise_batch_pallas, body
// _nbody_batch_kernel).
//
// For every batch entry b (a simulated device) and every scheduled slot
// pair n = (lo[n], hi[n]), softened gravity between the two [block, 4]
// body blocks of quorum[b]: slot lo gathers w[b, n, 0] * (force on its
// bodies), slot hi gathers w[b, n, 1] * (force on its bodies), and the
// result is out[b] = [k, block, 3].
//
// Design (a) of the port: the TPU kernel runs the pairs on a sequential
// grid and accumulates both sides into one VMEM scratch; Hopper blocks run
// in no order and float atomics are ruled out, so each CUDA block owns one
// (b, output slot, 256-body row tile).  Each thread owns one body and walks
// the pairs in order, adding its slot's side of each pair whose weight is
// non-zero; the other block streams through shared memory 256 bodies at a
// time.  The sum is deterministic and needs no second pass, at the cost of
// forming every non-self tile twice (once from each side).
//
// Bound on the H100: fp32 non-tensor arithmetic (about 20 flops per body
// pair, nothing re-read from device memory but the small body blocks).
// rsqrtf(r2)^3 stands for the reference's rsqrt(r2) / r2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nbody_batch_kernel(const float4* __restrict__ quorum,  // [B, k, block]
                   const int* __restrict__ lo,         // [n_pairs]
                   const int* __restrict__ hi,         // [n_pairs]
                   const float* __restrict__ w,        // [B, n_pairs, 2]
                   float* __restrict__ out,            // [B, k, block, 3]
                   int k, int block, int n_pairs, float softening) {
  const int b = blockIdx.z;
  const int slot = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4* qb = quorum + (size_t)b * k * block;
  __shared__ float4 tile[kThreads];

  float4 me = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < block) me = qb[(size_t)slot * block + i];
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int n = 0; n < n_pairs; ++n) {
    const int l = lo[n];
    const int h = hi[n];
    for (int side = 0; side < 2; ++side) {
      // side 0: this slot is the pair's lo block, the partner is hi;
      // side 1: the reverse.  Both conditions are uniform over the block.
      const int mine = side == 0 ? l : h;
      const float wt = w[((size_t)b * n_pairs + n) * 2 + side];
      if (mine != slot || wt == 0.f) continue;
      const float4* ob = qb + (size_t)(side == 0 ? h : l) * block;
      float fx = 0.f, fy = 0.f, fz = 0.f;
      for (int j0 = 0; j0 < block; j0 += kThreads) {
        const int j = j0 + threadIdx.x;
        // zero-mass padding past the ragged edge contributes zero force
        tile[threadIdx.x] = j < block ? ob[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
#pragma unroll 8
        for (int t = 0; t < kThreads; ++t) {
          const float4 o = tile[t];
          const float dx = o.x - me.x;
          const float dy = o.y - me.y;
          const float dz = o.z - me.z;
          const float r2 = dx * dx + dy * dy + dz * dz + softening;
          const float ir = rsqrtf(r2);
          const float s = me.w * o.w * (ir * ir * ir);
          fx += s * dx;
          fy += s * dy;
          fz += s * dz;
        }
        __syncthreads();
      }
      ax += wt * fx;
      ay += wt * fy;
      az += wt * fz;
    }
  }
  if (i < block) {
    float* o = out + (((size_t)b * k + slot) * block + i) * 3;
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
}

}  // namespace

extern "C" int repro_pairwise_batch_forces(const void* quorum, const void* lo,
                                           const void* hi, const void* w,
                                           void* out, int B, int k, int block,
                                           int n_pairs, float softening,
                                           void* stream) {
  const dim3 grid((block + kThreads - 1) / kThreads, k, B);
  nbody_batch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)quorum, (const int*)lo, (const int*)hi, (const float*)w,
      (float*)out, k, block, n_pairs, softening);
  return (int)cudaGetLastError();
}
