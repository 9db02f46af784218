// B3: PCIT significance filter (replaces the Pallas kernel
// repro/kernels/pcit_filter.py:pcit_filter_pallas, body _pcit_kernel).
//
// keep[b, x, y] = NOT any over z of explained(x, y, z), where z runs over
// the columns of the correlation rows (the global gene ids), z = gx[x] and
// z = gy[y] are excluded, and the diagonal gx[x] == gy[y] is always kept:
//   explained = |r_xy| <= |eps * r_xz|  and  |r_xy| <= |eps * r_yz|,
//   eps = mean of the three partial-correlation ratios.
//
// Design: one thread per (x, y); a 8 x 32 block of them walks z in
// 128-wide chunks of rows_x / rows_y staged (transposed) in shared memory.
// A thread stops at the first explaining z, as the reference's loop does,
// and the block stops loading chunks once none of its threads is still
// searching (__syncthreads_or).  The TPU kernel instead evaluates every z
// and OR-reduces.
//
// The output is a decision, so rounding flips edges: this file is compiled
// with -fmad=false and IEEE sqrtf / division, and every step below is one
// rounding in the order of the plain PyTorch version's elementwise ops.
//
// Bound on the H100: fp32 non-tensor arithmetic (about 40 operations per
// visited (x, y, z) trio, three of them IEEE divisions and sqrts that cost
// several instructions each); the rows are re-read from shared memory and
// L2, not device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // x per block
constexpr int kCols = 32;    // y per block (one warp shares one x)
constexpr int kChunk = 128;  // z per shared-memory stage
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(kRows * kCols)
pcit_kernel(const float* __restrict__ r_xy,    // [batch, M, N]
            const float* __restrict__ rows_x,  // [batch, M, Z]
            const float* __restrict__ rows_y,  // [batch, N, Z]
            const int* __restrict__ gx,        // [batch, M]
            const int* __restrict__ gy,        // [batch, N]
            unsigned char* __restrict__ keep,  // [batch, M, N]
            int* __restrict__ visits,          // [batch, M, N] or null
            int M, int N, int Z) {
  const size_t b = blockIdx.z;
  const int x0 = blockIdx.y * kRows;
  const int y0 = blockIdx.x * kCols;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  const float* rx = rows_x + b * M * Z;
  const float* ry = rows_y + b * N * Z;
  // +1 column keeps the transposed stores of consecutive z in distinct banks
  __shared__ float xs[kChunk][kRows + 1];
  __shared__ float ys[kChunk][kCols + 1];

  const bool inside = x < M && y < N;
  const int gxv = inside ? gx[b * M + x] : -1;
  const int gyv = inside ? gy[b * N + y] : -1;
  const float rxy = inside ? r_xy[(b * M + x) * N + y] : 0.f;
  const float axy = fabsf(rxy);
  const float omxy = 1.f - rxy * rxy;
  const float rxye = rxy + kEps;
  // the diagonal is kept whatever z says, so it needs no search
  bool searching = inside && gxv != gyv;
  bool explained = false;
  int visited = 0;

  for (int z0 = 0; z0 < Z; z0 += kChunk) {
    for (int idx = tid; idx < kRows * kChunk; idx += kRows * kCols) {
      const int r = idx / kChunk, zz = idx % kChunk;
      const bool ok = x0 + r < M && z0 + zz < Z;
      xs[zz][r] = ok ? rx[(size_t)(x0 + r) * Z + z0 + zz] : 0.f;
    }
    for (int idx = tid; idx < kCols * kChunk; idx += kRows * kCols) {
      const int r = idx / kChunk, zz = idx % kChunk;
      const bool ok = y0 + r < N && z0 + zz < Z;
      ys[zz][r] = ok ? ry[(size_t)(y0 + r) * Z + z0 + zz] : 0.f;
    }
    __syncthreads();
    if (searching) {
      const int zn = min(kChunk, Z - z0);
      for (int zz = 0; zz < zn; ++zz) {
        const int z = z0 + zz;
        if (z == gxv || z == gyv) continue;
        const float rxz = xs[zz][threadIdx.y];
        const float ryz = ys[zz][threadIdx.x];
        const float rxz2 = rxz * rxz;
        const float ryz2 = ryz * ryz;
        const float den_z = sqrtf(fmaxf((1.f - rxz2) * (1.f - ryz2), kEps));
        const float rxy_z = (rxy - rxz * ryz) / den_z;
        const float den_y = sqrtf(fmaxf(omxy * (1.f - ryz2), kEps));
        const float rxz_y = (rxz - rxy * ryz) / den_y;
        const float den_x = sqrtf(fmaxf(omxy * (1.f - rxz2), kEps));
        const float ryz_x = (ryz - rxy * rxz) / den_x;
        // PyTorch's CUDA division by a scalar multiplies by its float
        // reciprocal, and the plain version's "/ 3.0" rounds that way
        const float eps =
            (rxy_z / rxye + rxz_y / (rxz + kEps) + ryz_x / (ryz + kEps)) *
            (1.f / 3.f);
        if (axy <= fabsf(eps * rxz) && axy <= fabsf(eps * ryz)) {
          explained = true;
          searching = false;
          visited = z + 1;
          break;
        }
      }
    }
    if (!__syncthreads_or(searching)) break;
  }

  if (inside) {
    const size_t o = (b * M + x) * N + y;
    keep[o] = explained ? 0 : 1;
    if (visits != nullptr) visits[o] = gxv == gyv ? 0 : (explained ? visited : Z);
  }
}

}  // namespace

extern "C" int repro_pcit_filter(const void* r_xy, const void* rows_x,
                                 const void* rows_y, const void* gx,
                                 const void* gy, void* keep, void* visits,
                                 int batch, int M, int N, int Z,
                                 void* stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, batch);
  const dim3 threads(kCols, kRows);
  pcit_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r_xy, (const float*)rows_x, (const float*)rows_y,
      (const int*)gx, (const int*)gy, (unsigned char*)keep, (int*)visits, M,
      N, Z);
  return (int)cudaGetLastError();
}
