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
// The TPU kernel runs the pairs on a sequential grid and accumulates both
// sides into one VMEM scratch.  Hopper's blocks run in no order and float
// atomics are ruled out, so the work is cut into equal items and summed in
// a second pass, in the plain version's order:
//   1. plan_kernel (one block) lists the (b, n, side) with a non-zero
//      weight, in order, with an exclusive scan: integers only;
//   2. side_kernel gives each listed item x 512-body row tile one block of
//      128 threads, 4 bodies a thread: one pass over the partner block's
//      bodies, streamed 256 at a time through shared memory and broadcast
//      as float4.  Every block carries the same work, whatever the
//      schedule, and the listed blocks come first in the grid, so they
//      spread evenly over the SMs (the rest return at once).  The
//      unweighted force on each body goes to partial[b, n, side, i];
//   3. reduce_kernel adds, for each (b, slot, body), w * partial over the
//      pairs in pair order, side 0 before side 1 (kernels/ref.py's order).
// Each side of a tile is formed by its own block: keeping Newton's third
// law (one tile, both sides written) would need a deterministic reduction
// across threads for the partner side.
//
// Bound on the H100: fp32 non-tensor arithmetic (about 20 flops per body
// pair; the body blocks and partials are a few MB).  Per interaction 12
// FP32 instructions and one MUFU.RSQ: 3 differences, r^2 as 3 FMAs, the
// cube of rsqrtf(r2) (the reference's rsqrt(r2) / r2) times the partner's
// mass in 3 multiplications, 3 accumulating FMAs; the body's own mass
// multiplies the sum once at the end.  r2 >= softening, so for a normal
// softening (1e-2 in every caller) the flush-to-zero rsqrt gives rsqrtf's
// bits without its denormal check.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBodies = 4;                    // bodies a thread
constexpr int kRows = kThreads * kBodies;     // row tile of a block
constexpr int kTile = 256;                    // partner bodies a stage
constexpr int kPlanThreads = 256;

// list[0] = number of items with a non-zero weight; list[1 + m] = the m-th
// such item, as (b * n_pairs + n) * 2 + side, in increasing order
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const float* __restrict__ w, int items, int* __restrict__ list) {
  __shared__ int warp_tot[kPlanThreads / 32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int c0 = 0; c0 < items; c0 += kPlanThreads) {
    const int it = c0 + tid;
    const int on = it < items && w[it] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    const int before = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int off = base;
    for (int v = 0; v < warp; ++v) off += warp_tot[v];
    if (on) list[1 + off + before] = it;
    __syncthreads();
    if (tid == 0)
      for (int v = 0; v < kPlanThreads / 32; ++v) base += warp_tot[v];
    __syncthreads();
  }
  if (tid == 0) list[0] = base;
}

// rsqrtf(r2); kFtz: the flush-to-zero form, one MUFU.RSQ with no
// denormal fix-up (the same bits wherever r2 is a normal float)
template <bool kFtz>
__device__ __forceinline__ float rsqrt_of(float r2) {
  if constexpr (kFtz) {
    float ir;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(ir) : "f"(r2));
    return ir;
  } else {
    return rsqrtf(r2);
  }
}

template <bool kFtz>
__global__ void __launch_bounds__(kThreads, 8)
side_kernel(const float4* __restrict__ quorum,  // [B, k, block]
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ list,
            float* __restrict__ partial,        // [B, n_pairs, 2, block, 3]
            int k, int block, int n_pairs, int tiles, float softening) {
  const int m = blockIdx.x / tiles;
  if (m >= list[0]) return;
  const int item = list[1 + m];
  const int side = item & 1, n = (item >> 1) % n_pairs;
  const int b = (item >> 1) / n_pairs;
  const int r0 = (blockIdx.x % tiles) * kRows;
  const float4* qb = quorum + (size_t)b * k * block;
  const float4* mine = qb + (size_t)(side ? hi[n] : lo[n]) * block;
  const float4* other = qb + (size_t)(side ? lo[n] : hi[n]) * block;
  __shared__ float4 tile[kTile];

  float4 me[kBodies];
  float fx[kBodies], fy[kBodies], fz[kBodies];
#pragma unroll
  for (int e = 0; e < kBodies; ++e) {
    const int i = r0 + threadIdx.x + e * kThreads;
    me[e] = i < block ? mine[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    fx[e] = fy[e] = fz[e] = 0.f;
  }
  for (int j0 = 0; j0 < block; j0 += kTile) {
    __syncthreads();   // the previous stage is consumed
#pragma unroll
    for (int e = 0; e < kTile / kThreads; ++e) {
      const int t = threadIdx.x + e * kThreads, j = j0 + t;
      // zero-mass padding past the ragged edge contributes zero force
      tile[t] = j < block ? other[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float4 o = tile[t];
#pragma unroll
      for (int e = 0; e < kBodies; ++e) {
        const float dx = o.x - me[e].x;
        const float dy = o.y - me[e].y;
        const float dz = o.z - me[e].z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, softening)));
        const float ir = rsqrt_of<kFtz>(r2);
        const float s = o.w * (ir * ir * ir);
        fx[e] = fmaf(s, dx, fx[e]);
        fy[e] = fmaf(s, dy, fy[e]);
        fz[e] = fmaf(s, dz, fz[e]);
      }
    }
  }
  float* out = partial + ((size_t)item * block + r0) * 3;
#pragma unroll
  for (int e = 0; e < kBodies; ++e) {
    const int i = threadIdx.x + e * kThreads;
    if (r0 + i < block) {
      out[3 * i] = me[e].w * fx[e];
      out[3 * i + 1] = me[e].w * fy[e];
      out[3 * i + 2] = me[e].w * fz[e];
    }
  }
}

// out[b, slot, i] = sum over n in order, side 0 then 1, of the weighted
// partials of the sides that land on ``slot``
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ partial, const int* __restrict__ lo,
              const int* __restrict__ hi, const float* __restrict__ w,
              float* __restrict__ out, int B, int k, int block, int n_pairs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * k * block) return;
  const int i = (int)(idx % block);
  const int slot = (int)((idx / block) % k);
  const int b = (int)(idx / block / k);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int n = 0; n < n_pairs; ++n) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const size_t item = ((size_t)b * n_pairs + n) * 2 + side;
      const float wt = w[item];
      if ((side ? hi[n] : lo[n]) != slot || wt == 0.f) continue;
      const float* p = partial + (item * block + i) * 3;
      ax += wt * p[0];
      ay += wt * p[1];
      az += wt * p[2];
    }
  }
  float* o = out + idx * 3;
  o[0] = ax;
  o[1] = ay;
  o[2] = az;
}

}  // namespace

extern "C" int repro_pairwise_batch_forces(const void* quorum, const void* lo,
                                           const void* hi, const void* w,
                                           void* list, void* partial,
                                           void* out, int B, int k,
                                           int block, int n_pairs,
                                           float softening, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long items = (long long)B * n_pairs * 2;
  const int tiles = (block + kRows - 1) / kRows;
  const long long outs = (long long)B * k * block;
  if (items * tiles > 0x7fffffffLL || (outs + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  plan_kernel<<<1, kPlanThreads, 0, s>>>((const float*)w, (int)items,
                                         (int*)list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (items > 0) {
    // r2 >= softening: with a normal softening every r2 is normal
    auto kernel = softening >= FLT_MIN ? side_kernel<true>
                                       : side_kernel<false>;
    kernel<<<(unsigned)(items * tiles), kThreads, 0, s>>>(
        (const float4*)quorum, (const int*)lo, (const int*)hi,
        (const int*)list, (float*)partial, k, block, n_pairs, tiles,
        softening);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (const int*)lo, (const int*)hi, (const float*)w,
      (float*)out, B, k, block, n_pairs);
  return (int)cudaGetLastError();
}
