// B10 bwd: the gradient of the Mamba2 SSD intra-chunk step (csrc/ssd_chunk.cu;
// the Pallas kernel it ports, repro/kernels/ssd_chunk.py:ssd_chunk_pallas,
// has no backward: the JAX package's train step differentiates its plain
// jnp scan, repro/models/ssm.py:ssd_chunked, with XLA).
//
// For every (batch row b, chunk c) of length L and head h, with a_l = dt_l A_h,
// cums the inclusive cumsum of a, W_ij = (C_i . B_j) exp(cums_i - cums_j) dt_j
// (j <= i), G_ij = dy_i . x_j, e_j = exp(cums_{L-1} - cums_j) and
// u_j = dS_h^T B_j:
//   dx_j   = sum_{i>=j} W_ij dy_i + e_j dt_j u_j
//   dCB_ij = sum_h G_ij exp(cums_i - cums_j) dt_j
//   dC = dCB B,  dB = dCB^T C + sum_h e_j dt_j dS_h x_j
//   ddt_j  = sum_{i>=j} G_ij CB_ij exp(.) + e_j u_j . x_j + dla_j A_h
//   dcums  = rowsum(G o W) - colsum(G o W) - e dt (u . x)
//            (+ its sum on row L-1) + dcd o exp(cums)
//   dla_k  = sum_{i>=k} dcums_i,  dA_h = sum_{b, c, k} dla_k dt_k
// (kernels/ref.py:ssd_intra_chunk_bwd is the same in PyTorch).  Inputs: the
// forward's x [B, T, H, P], dt [B, T, H], A [H], B / C [B, T, N] (x, B, C
// with any strides and a contiguous last axis) and the gradients dy [B, T,
// H, P], dS [B, nc, H, N, P], dcd [B, T, H] of its outputs, contiguous (dS
// and dcd may be null: zero).  Outputs, float32 and contiguous: dx, ddt,
// dB, dC, and dA as [B, nc, H] partials, which the wrapper sums.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores (67 TFLOP/s;
// no TF32, the step is held to 1e-4): per visible pair (j <= i) and head
// 4 P operations (G and dx), per position and head 4 N P (u and the S term
// of dB), per visible pair 6 N once per (b, chunk) (C B^T, dC, dB).  An SM
// issues four warp FFMAs a cycle and serves one shared-memory wavefront a
// cycle, so a product nears the fp32 rate only when every operand value it
// loads from shared memory feeds many FFMAs.
//
// Design: every product runs on a register tile of 8 x 16 outputs a thread
// (a warp's 64 x 64; 256 / CL rows x 16 CL columns in the dB / dC kernel),
// its operands read as 16-byte shared loads along the axis the thread
// walks, "nt" (A [row][k], B [col][k]) or "nn" (A [row][k], B [k][col]):
// 8 + 16 loads per 4 k and 512 FFMA.  Operands that lie in memory with k
// contiguous come through a two-stage cp.async ring (zero fill at ragged
// edges; 4-byte loads where a row is not 16-byte aligned), so the next
// stage's copies run under this stage's FFMAs; operands that must be
// transposed or summed are loaded 16 bytes at a time into registers first.
// Four launches, each with its own registers (one kernel holding every
// phase runs out of registers and spills in its hot loops), and a fifth
// where the fourth splits its depth over blocks:
//   * ssd_bwd_cb_kernel: C B^T of each (b, chunk) once, the lower 64 x 64
//     tiles of each column strip into a [L, L] scratch (nt; the warps split
//     the i-tiles and the two halves of each N stage, summed in order).
//   * ssd_bwd_dx_kernel: a block per (b, chunk, 8 heads) (a block walking
//     every group of a (b, chunk) read slower at both real shapes, whose
//     cells are fewer than the SMs); the forward's layout, a warp per 64 of
//     the 512 columns heads x P.  Per 64-row j-tile: u = B_j dS_h over N's
//     own width (nn, B rows and dS rows in the ring), u . x_j (handed to the
//     G kernel in ddt) and e_j dt_j (dend); the rows scaled by e_j dt_j;
//     then W^T dy in 16-row slices of i >= j, each warp writing its head's
//     W (the explicit masked exponent) into its own [j][i] buffer.
//   * ssd_bwd_g_kernel: the same blocks; a warp per head, per 64 x 64 tile
//     (i >= j) G = dy x^T over P (nt, 8-deep P stages of all 8 heads), then
//     at each thread's own (i, j) the decay, Q = G o CB o decay summed down
//     the columns (ddt; times dt_j, G o W's column sums) and Q dt_j along
//     the rows (G o W's row sums), into dcums in doubles from Q's float
//     terms (float partial sums lose an order of magnitude in dA at real
//     spans); G decay dt summed over the heads in warp order (two 32-row
//     halves through shared memory) into the block's dCB partial, which the
//     dB / dC kernel sums in group order.  Below the diagonal tile, for a
//     head whose dt * A <= 0 everywhere, the decay is u_i v_j about the
//     reference row r = j0 + 63 between i and j: both factors <= 1, so
//     neither overflows and one underflows only where the decay itself is
//     below float's range; on the diagonal tile, and for any head with some
//     dt * A > 0, the explicit masked exponent.  Every exponent takes the
//     forward's cumsum: per group, one lane a head scans dt * A in order
//     with its float32 roundings (ssd_chunk.cu's prep).  Last, one lane a
//     head takes the S terms and the cd term and the reverse cumsum of
//     dcums in order (the plain version's), giving ddt and dA's [B, nc, H]
//     partial; dcums and what sums it are doubles (at a layer's real spans
//     its terms are large and cancel), and the per-position inputs of these
//     serial loops are staged in shared memory by every thread first.
//   * ssd_bwd_bc_kernel<CL, KS>: a block per (b, chunk, N tiles at N's own
//     width, 16 CL columns; K block), all L rows, 8 warps over (row tile, N
//     tile, K split KS): dC = dCB B and dB = dCB^T C (nt, the dCB partials
//     summed in order as they load, B^T and C^T transposed as they are
//     stored) and dB's S term, one product of depth H P over (e dt x) and
//     dS streamed through the ring, a thread's x row scaled by its e dt as
//     the row lands.  Where the cells are too few to fill the card (jamba's
//     N = 16: a 256 x 16 output a cell), K blocks split the S term by
//     heads and write partials;
//   * ssd_bwd_sum_kernel (with K blocks): their dB partials summed in
//     order.
// No atomics: every sum runs in a fixed order, and two launches give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGH = 8;          // heads of a group: a warp each in the G pass
constexpr int kCols = 512;      // columns of the dx pass: heads x P_pad
constexpr int kT = 64;          // tile rows and columns
constexpr int kMaxL = 256;
constexpr int kSLd = kT + 4;    // row stride of the strip, G stages, dCB sums
constexpr int kNd = 32;         // N depth of a C B^T stage
constexpr int kCbLd = kNd + 4;
constexpr int kUn = 16;         // N depth of a u stage
constexpr int kUnLd = kUn + 4;
constexpr int kIs = 16;         // i depth of a dx slice
constexpr int kWLd = kIs + 4;
constexpr int kGp = 8;          // P depth of a G stage, per head
constexpr int kGLd = kGH * kGp + 4;   // row stride of a G stage

constexpr int kCbStage = (kMaxL + kT) * kCbLd;   // C rows, then B rows
constexpr int kDxStage = kIs * kCols;            // a dy slice (or a u stage)
constexpr int kGStage = 2 * kT * kGLd;           // dy rows, then x rows
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes of a stage: dst[0..4) = src[0..n) (n <= 4 valid floats), zero
// past them.  kVec: every row is 16-byte aligned and n is 0 or 4, so one
// cp.async (src is not read when n is 0); else four 4-byte loads.
template <bool kVec>
__device__ __forceinline__ void stage16(float* dst, const float* src, int n) {
  if constexpr (kVec) {
    cp_async16(smem_u32(dst), src, n > 0 ? 16 : 0);
  } else {
    float4 v;
    v.x = n > 0 ? src[0] : 0.f;
    v.y = n > 1 ? src[1] : 0.f;
    v.z = n > 2 ? src[2] : 0.f;
    v.w = n > 3 ? src[3] : 0.f;
    *reinterpret_cast<float4*>(dst) = v;
  }
}
// the same into registers (for a stage that is summed or transposed)
template <bool kVec>
__device__ __forceinline__ float4 ldg16(const float* src, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kVec) {
    if (n > 0) v = *reinterpret_cast<const float4*>(src);
  } else {
    v.x = n > 0 ? src[0] : 0.f;
    v.y = n > 1 ? src[1] : 0.f;
    v.z = n > 2 ? src[2] : 0.f;
    v.w = n > 3 ? src[3] : 0.f;
  }
  return v;
}
__device__ __forceinline__ int nvalid(bool ok, int left) {
  return ok ? (left < 4 ? (left > 0 ? left : 0) : 4) : 0;
}

// acc[r][q] += sum_{k < 4} A[row r][k] B[col q][k] ("nt"): a0 = A's row 0 at
// k, rows RS apart (lda floats each); b0 = B's column 0 at k, CS apart
template <int RS, int CS>
__device__ __forceinline__ void nt4(float (&acc)[8][16], const float* a0,
                                    int lda, const float* b0, int ldb) {
  float4 a[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = lds4(a0 + r * RS * lda);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 bv = lds4(b0 + q * CS * ldb);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][q] = dot4(a[r], bv, acc[r][q]);
  }
}

// acc[r][4 q4 + e] += sum_{k < 4} A[row r][k] B[k][col 4 q4 + e] ("nn"):
// a0 = A's row 0 at k, rows 8 apart; b0 = B's row k at the thread's first
// column, its 16 columns in four runs of 4, 16 apart
__device__ __forceinline__ void nn4(float (&acc)[8][16], const float* a0,
                                    int lda, const float* b0, int ldb) {
  float4 a[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = lds4(a0 + r * 8 * lda);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4 bq[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) bq[q4] = lds4(b0 + k * ldb + 16 * q4);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float av = comp(a[r], k);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        acc[r][4 * q4 + 0] = fmaf(av, bq[q4].x, acc[r][4 * q4 + 0]);
        acc[r][4 * q4 + 1] = fmaf(av, bq[q4].y, acc[r][4 * q4 + 1]);
        acc[r][4 * q4 + 2] = fmaf(av, bq[q4].z, acc[r][4 * q4 + 2]);
        acc[r][4 * q4 + 3] = fmaf(av, bq[q4].w, acc[r][4 * q4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][16]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[r][q] = 0.f;
}

// C B^T of one (b, chunk, 64-column j-tile): rows i >= the tile's first,
// zero above the diagonal, into the cell's [L, ldc] cb_part (nt; warp w:
// rows [64 (w % 4), +64), the half w / 4 of each N stage; the halves summed
// in order through cb_part)
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ cb_part, int N, int L, int nc, int ldc,
                  long long sb_b, long long sb_t, long long sc_b,
                  long long sc_t) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (L + kT - 1) / kT;
  const int jt = blockIdx.x % nt, c = (blockIdx.x / nt) % nc;
  const int b = blockIdx.x / nt / nc;
  const int j0 = jt * kT, nj = min(kT, L - j0), ni = L - j0;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = lane / 4, tc = lane % 4;
  const int iw = warp & 3, kh = warp >> 2;
  const bool active = iw * kT < ni;
  const float* bb = Bm + b * sb_b + (long long)t0 * sb_t;
  const float* cb = Cm + b * sc_b + (long long)t0 * sc_t;
  float* out = cb_part + ((size_t)b * nc + c) * (size_t)L * ldc +
               (size_t)j0 * ldc + j0;
  auto load = [&](int s) {
    float* st = smem + (s & 1) * kCbStage;
    const int n0 = s * kNd;
    for (int idx = tid; idx < (ni + kT) * (kNd / 4); idx += kThreads) {
      const int r = idx / (kNd / 4), k = n0 + 4 * (idx % (kNd / 4));
      const bool isc = r < ni;
      const int row = isc ? r : r - ni;
      const bool ok = (isc || row < nj) && k < N;
      const float* src =
          isc ? cb + (long long)(j0 + row) * sc_t + (ok ? k : 0)
              : bb + (long long)(j0 + (ok ? row : 0)) * sb_t + (ok ? k : 0);
      stage16<kVec>(st + (isc ? row : kMaxL + row) * kCbLd + (k - n0), src,
                    nvalid(ok, N - k));
    }
  };
  float acc[8][16];
  zero(acc);
  const int ns = (N + kNd - 1) / kNd;
  load(0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < ns) load(s + 1);
    cp_async_commit();
    if (active) {
      const float* st = smem + (s & 1) * kCbStage;
      const float* Cs = st + (iw * kT + tr) * kCbLd + kh * (kNd / 2);
      const float* Bs = st + (kMaxL + tc) * kCbLd + kh * (kNd / 2);
#pragma unroll
      for (int k = 0; k < kNd / 2; k += 4)
        nt4<8, 4>(acc, Cs + k, kCbLd, Bs + k, kCbLd);
    }
  }
  // the second halves first, then the first halves add theirs
  for (int pass = 1; pass >= 0; --pass) {
    if (active && kh == pass)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int ii = iw * kT + tr + 8 * r;
        if (ii >= ni) continue;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int j = tc + 4 * q;
          if (j >= nj) continue;
          float* o = out + (size_t)ii * ldc + j;
          *o = pass == 1 ? acc[r][q] : j <= ii ? acc[r][q] + *o : 0.f;
        }
      }
    __syncthreads();
  }
}

// A group's dt and the inclusive cumsum of dt * A, one lane a head, in
// order: fl(cums_{l-1} + fl(dt_l A)), the forward's roundings (ssd_chunk.cu's
// prep), so every exp(cums_i - cums_j) here has the forward's bits; expl
// marks a head with some dt * A > 0
__device__ __forceinline__ void prep_group(const float* __restrict__ dt,
                                           const float* __restrict__ A,
                                           float* cums, float* dts, int* expl,
                                           int b, int t0, int T, int H,
                                           int L, int h0, int nh) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int idx = tid; idx < kGH * L; idx += kThreads) {
    const int l = idx / kGH, g = idx % kGH;
    dts[g * kMaxL + l] =
        g < nh ? dt[((size_t)b * T + t0 + l) * H + h0 + g] : 0.f;
  }
  __syncthreads();
  if (lane == 0) {
    const float ah = warp < nh ? A[h0 + warp] : 0.f;
    float run = 0.f;
    bool pos = false;
    for (int l = 0; l < L; ++l) {
      const float a = __fmul_rn(dts[warp * kMaxL + l], ah);
      pos |= a > 0.f;
      run = __fadd_rn(run, a);
      cums[warp * kMaxL + l] = run;
    }
    if (expl != nullptr) expl[warp] = pos;
  }
  __syncthreads();
}

// the strip strip[ii][j] = C_{j0+ii} . B_{j0+j} (ii < ni) from the first
// launch's [L, ldc] C B^T; it lands with the caller's next wait
__device__ __forceinline__ void copy_strip(float* strip, const float* cbp,
                                           int ldc, int j0, int nj, int ni) {
  const float* src = cbp + (size_t)j0 * ldc + j0;
  for (int idx = threadIdx.x; idx < ni * (kT / 4); idx += kThreads) {
    const int ii = idx / (kT / 4), j = 4 * (idx % (kT / 4));
    stage16<true>(strip + ii * kSLd + j, src + (size_t)ii * ldc + j,
                  j < nj ? 4 : 0);
  }
  cp_async_commit();
}

// dynamic shared memory of ssd_bwd_dx_kernel, in floats
struct DxLay {
  static constexpr int cums = 0;                    // [kGH][kMaxL]
  static constexpr int dts = cums + kGH * kMaxL;    // [kGH][kMaxL]
  static constexpr int ux = dts + kGH * kMaxL;      // [kWarps][kT] u . x parts
  static constexpr int dsc = ux + kWarps * kT;      // [kGH][kT] e dt of a tile
  static constexpr int strip = dsc + kGH * kT;      // [kMaxL][kSLd] C B^T
  static constexpr int ring = strip + kMaxL * kSLd; // 2 dy slices / dS stages
  static constexpr int wb = ring + 2 * kDxStage;    // per warp W [kT][kWLd];
                                                    // the u stages' B rows
  static constexpr int total = wb + kWarps * kT * kWLd;
};
static_assert(DxLay::total * 4 <= 227 * 1024, "shared memory");
static_assert(2 * kT * kUnLd <= kWarps * kT * kWLd, "u stages' B rows");

// dx of one (b, chunk, group of 8 heads), the forward's layout: a warp per
// 64 of the 512 columns heads x P_pad (PP: P padded to 64 or 128, 512 / PP
// heads a sub-pass).  Per 64-row j-tile: u_j = B_j dS_h over N (nn), u . x_j
// (left in ddt for the G kernel) and e_j dt_j (dend); the rows scaled by e_j
// dt_j; then W^T dy in 16-row slices of i >= j, each warp's W (the explicit
// masked exponent) in its own [j][i] buffer
template <int PP, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ cb_part,
                  const float* __restrict__ dy, const float* __restrict__ dS,
                  float* __restrict__ dx, float* __restrict__ uxo,
                  float* __restrict__ dend, int T, int H, int P, int N, int L,
                  int nc, int ngroups, int ldc, long long sx_b,
                  long long sx_t, long long sx_h, long long sb_b,
                  long long sb_t) {
  constexpr int HS = kCols / PP;      // heads of a sub-pass
  constexpr int WPH = PP / 64;        // warps per head
  extern __shared__ __align__(16) float smem[];
  float* cums = smem + DxLay::cums;
  float* dts = smem + DxLay::dts;
  float* uxs = smem + DxLay::ux;
  float* dsc = smem + DxLay::dsc;
  float* strip = smem + DxLay::strip;
  float* ring = smem + DxLay::ring;
  float* wball = smem + DxLay::wb;

  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const int b = blockIdx.x / ngroups / nc;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = lane / 4, tc = lane % 4;
  const int cw = warp * 64;           // this warp's first column
  const int gl = cw / PP;             // its head in a sub-pass
  const int pw = cw - gl * PP;        // ... and its first p
  const float* xb = x + b * sx_b + (long long)t0 * sx_t;
  const float* bb = Bm + b * sb_b + (long long)t0 * sb_t;
  const float* cbp = cb_part + ((size_t)b * nc + c) * (size_t)L * ldc;
  const long long HP = (long long)H * P;
  const long long row0 = ((long long)b * T + t0) * HP;   // dy / dx at (b, t0)
  float* wb = wball + warp * kT * kWLd;
  const int nt = (L + kT - 1) / kT;
  float acc[8][16];

  const int h0 = grp * kGH, nh = min(kGH, H - h0);
  prep_group(dt, A, cums, dts, nullptr, b, t0, T, H, L, h0, nh);

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT, nj = min(kT, L - j0), ni = L - j0;
    __syncthreads();   // the previous tile's strip is read
    copy_strip(strip, cbp, ldc, j0, nj, ni);

    for (int hs0 = 0; hs0 < kGH; hs0 += HS) {
      const int gme = hs0 + gl;             // this warp's head in the group
      const int h = h0 + gme;
      const float* cg = cums + gme * kMaxL;
      const float* dg = dts + gme * kMaxL;
      zero(acc);

      // u_j = B_j dS_h over N, rows j of the tile; u . x_j; the rows
      // scaled by e_j dt_j
      if (dS != nullptr) {
        auto load_u = [&](int s) {
          float* dst = ring + (s & 1) * kDxStage;          // dS [kUn][kCols]
          float* bst = wball + (s & 1) * kT * kUnLd;       // B [kT][kUnLd]
          const int n0 = s * kUn;
          for (int idx = tid; idx < kT * (kUn / 4) + kUn * (kCols / 4);
               idx += kThreads) {
            if (idx < kT * (kUn / 4)) {
              const int j = idx / (kUn / 4), k = n0 + 4 * (idx % (kUn / 4));
              const bool ok = j < nj && k < N;
              stage16<kVec>(bst + j * kUnLd + (k - n0),
                            bb + (long long)(j0 + (ok ? j : 0)) * sb_t +
                                (ok ? k : 0),
                            nvalid(ok, N - k));
            } else {
              const int e = idx - kT * (kUn / 4);
              const int n = n0 + e / (kCols / 4);
              const int col = 4 * (e % (kCols / 4));
              const int hh = h0 + hs0 + col / PP, p = col % PP;
              const bool ok = n < N && hh < H && p < P;
              const float* src =
                  ok ? dS + (((size_t)b * nc + c) * H + hh) * (size_t)N * P +
                           (size_t)n * P + p
                     : dS;
              stage16<kVec>(dst + (n - n0) * kCols + col, src,
                            nvalid(ok, P - p));
            }
          }
        };
        const int ns = (N + kUn - 1) / kUn;
        __syncthreads();   // the ring and W buffers are free
        load_u(0);
        cp_async_commit();
        for (int s = 0; s < ns; ++s) {
          cp_async_wait<0>();
          __syncthreads();
          if (s + 1 < ns) load_u(s + 1);
          cp_async_commit();
          const float* Bs = wball + (s & 1) * kT * kUnLd + tr * kUnLd;
          const float* Ds = ring + (s & 1) * kDxStage + cw + 4 * tc;
#pragma unroll
          for (int k = 0; k < kUn; k += 4)
            nn4(acc, Bs + k, kUnLd, Ds + k * kCols, kCols);
        }
        // u . x_j over this warp's columns, then over its 4 lanes tc
        float ux[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = tr + 8 * r;
          float s = 0.f;
          if (j < nj && h < H) {
            const float* xr =
                xb + (long long)(j0 + j) * sx_t + (long long)h * sx_h;
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              const int p = pw + 4 * tc + 16 * q4;
              const float4 xv = ldg16<kVec>(xr + p, nvalid(p < P, P - p));
              s = fmaf(acc[r][4 * q4 + 0], xv.x, s);
              s = fmaf(acc[r][4 * q4 + 1], xv.y, s);
              s = fmaf(acc[r][4 * q4 + 2], xv.z, s);
              s = fmaf(acc[r][4 * q4 + 3], xv.w, s);
            }
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          ux[r] = s;
        }
        if (tc == 0)
#pragma unroll
          for (int r = 0; r < 8; ++r) uxs[warp * kT + tr + 8 * r] = ux[r];
        __syncthreads();
        for (int idx = tid; idx < HS * kT; idx += kThreads) {
          const int g2 = idx / kT, j = idx % kT;
          const int gg = hs0 + g2, hh = h0 + gg;
          float u = 0.f;
          for (int w2 = 0; w2 < WPH; ++w2) u += uxs[(g2 * WPH + w2) * kT + j];
          const bool ok = j < nj && hh < H;
          const float e =
              ok ? expf(cums[gg * kMaxL + L - 1] - cums[gg * kMaxL + j0 + j])
                 : 0.f;
          const float de = ok ? e * dts[gg * kMaxL + j0 + j] : 0.f;
          dsc[g2 * kT + j] = de;
          if (ok) {
            const size_t at = ((size_t)b * T + t0 + j0 + j) * H + hh;
            uxo[at] = u;
            dend[at] = de;
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float de = dsc[gl * kT + tr + 8 * r];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[r][q] *= de;
        }
      }

      // dx += W^T dy in 16-row slices of i in [j0, L)
      auto load_dy = [&](int s) {
        float* st = ring + (s & 1) * kDxStage;
        const int i0 = j0 + s * kIs;
        for (int idx = tid; idx < kIs * (kCols / 4); idx += kThreads) {
          const int ii = idx / (kCols / 4), col = 4 * (idx % (kCols / 4));
          const int hh = h0 + hs0 + col / PP, p = col % PP;
          const bool ok = i0 + ii < L && hh < H && p < P;
          stage16<kVec>(st + ii * kCols + col,
                        ok ? dy + row0 + (long long)(i0 + ii) * HP +
                                 (long long)hh * P + p
                           : dy,
                        nvalid(ok, P - p));
        }
      };
      const int nsl = (ni + kIs - 1) / kIs;
      __syncthreads();   // the u stages and u . x sums are read
      load_dy(0);
      cp_async_commit();
      for (int s = 0; s < nsl; ++s) {
        cp_async_wait<0>();
        __syncthreads();
        if (s + 1 < nsl) load_dy(s + 1);
        cp_async_commit();
        // this warp's head: wb[j][ii] = W_{i, j0+j}, i = i0 + ii
        const int i0 = j0 + s * kIs;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = lane + 32 * hf, J = j0 + j;
          const bool jok = j < nj;
          const float cj = jok ? cg[J] : 0.f;
          const float dj = jok ? dg[J] : 0.f;
#pragma unroll
          for (int i4 = 0; i4 < kIs / 4; ++i4) {
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + 4 * i4 + e;
              const bool ok = jok && J <= i && i < L;
              const int ic = min(i, L - 1);
              const float v =
                  strip[(ic - j0) * kSLd + j] * expf(cg[ic] - cj) * dj;
              w[e] = ok ? v : 0.f;
            }
            *reinterpret_cast<float4*>(wb + j * kWLd + 4 * i4) =
                make_float4(w[0], w[1], w[2], w[3]);
          }
        }
        __syncwarp();
        const float* st = ring + (s & 1) * kDxStage;
#pragma unroll
        for (int k = 0; k < kIs; k += 4)
          nn4(acc, wb + tr * kWLd + k, kWLd, st + k * kCols + cw + 4 * tc,
              kCols);
        __syncwarp();   // wb is read before the next slice's W
      }

      // dx rows j0 + j, this warp's columns
      if (h < H)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = tr + 8 * r;
          if (j >= nj) continue;
          float* o = dx + row0 + (long long)(j0 + j) * HP + (long long)h * P;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int p = pw + 4 * tc + 16 * q4;
            if constexpr (kVec) {
              if (p < P)
                *reinterpret_cast<float4*>(o + p) =
                    make_float4(acc[r][4 * q4], acc[r][4 * q4 + 1],
                                acc[r][4 * q4 + 2], acc[r][4 * q4 + 3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (p + e < P) o[p + e] = acc[r][4 * q4 + e];
            }
          }
        }
    }
  }
}

// The G tile's epilogue, at (i, j) = (i0 + tr + 8 r, j0 + tc + 4 q) of one
// head (cg / dg its cumsum and dt; cbt the tile of C B^T): the decay exp(cums_i - cums_j), masked to
// j <= i; Q = G o CB o decay summed down each column (ddt; times dt_j, G o
// W's column sums out of dcums) and Q dt_j along each row (G o W's row sums
// into dcums), in doubles from Q's float terms; acc becomes G decay dt, the
// head's part of dCB.  kFact (a tile below the diagonal tile, the head's dt
// * A <= 0 everywhere): decay = u_i v_j about the reference row r = j0 + 63
// between them, u_i = exp(cums_i - cums_r) and v_j = exp(cums_r - cums_j),
// both <= 1, so neither overflows and one underflows only where the decay
// itself is below float's range; else the explicit exponent.
template <bool kFact>
__device__ __forceinline__ void g_epilogue(float (&acc)[8][16],
                                           const float* cg, const float* dg,
                                           const float* cbt, float* ddq,
                                           double* dcm, int i0, int j0,
                                           int nit, int nj, int L,
                                           bool live) {
  const int lane = threadIdx.x % 32, tr = lane / 4, tc = lane % 4;
  const float cr = kFact ? cg[j0 + kT - 1] : 0.f;
  if (kFact)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float u = expf(cg[min(i0 + tr + 8 * r, L - 1)] - cr);
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[r][q] *= u;
    }
  double rs[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rs[r] = 0.0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int j = tc + 4 * q, J = j0 + j;
    const bool jok = j < nj && live;
    const float cj = cg[min(J, L - 1)];
    const float dj = jok ? dg[J] : 0.f;
    const float v = kFact ? expf(cr - cj) : 0.f;
    const double djd = dj;
    double cq = 0.0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = tr + 8 * r, I = i0 + i;
      const bool ok = jok && i < nit && J <= I;
      const int Ic = min(I, L - 1);
      const float gd = acc[r][q] * (kFact ? v : expf(cg[Ic] - cj));
      const float qv = ok ? gd * cbt[(Ic - i0) * kSLd + j] : 0.f;
      const double qd = qv;
      cq += qd;
      rs[r] = fma(qd, djd, rs[r]);
      acc[r][q] = ok ? gd * dj : 0.f;
    }
    // the column over the 8 lanes tr
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) cq += __shfl_xor_sync(0xffffffffu, cq, o);
    if (tr == 0 && jok) {
      ddq[J] += (float)cq;
      dcm[J] -= cq * djd;
    }
  }
  __syncwarp();   // column sums land before the row sums (diagonal)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    double d = rs[r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const int i = tr + 8 * r;
    if (tc == 0 && i < nit && live) dcm[i0 + i] += d;
  }
}

// dynamic shared memory of ssd_bwd_g_kernel, in floats
struct GLay {
  static constexpr int cums = 0;                    // [kGH][kMaxL]
  static constexpr int dts = cums + kGH * kMaxL;    // [kGH][kMaxL]
  static constexpr int ddq = dts + kGH * kMaxL;     // [kGH][kMaxL] ddt, direct
  static constexpr int pos = ddq + kGH * kMaxL;     // [kGH][kMaxL] u . x, dcd
  static constexpr int cbt = pos + kGH * kMaxL;     // [kT][kSLd] C B^T tile
  static constexpr int work = cbt + kT * kSLd;      // the ring; dCB sums
  static constexpr int dcm = work + (2 * kGStage > kWarps * 32 * kSLd
                                         ? 2 * kGStage
                                         : kWarps * 32 * kSLd);
  static constexpr int total = dcm + 2 * kGH * kMaxL;   // dcums, doubles
};
static_assert(GLay::dcm % 2 == 0, "dcums must be 8-byte aligned");
static_assert(GLay::total * 4 <= 227 * 1024, "shared memory");

// G of one (b, chunk, group of 8 heads): a warp per head, per 64-row i-tile
// (i >= j) of each j-tile, G = dy x^T over P (nt, 8-deep P stages for all 8
// heads), its sums and dCB; the S terms from the dx kernel's u . x (left in
// ddt); then per head the reverse cumsum of dcums
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_g_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ cb_part,
                 const float* __restrict__ dy, const float* __restrict__ dcd,
                 float* __restrict__ ddt, float* __restrict__ dA_part,
                 float* __restrict__ dcb_part, int has_s, int T, int H, int P,
                 int L, int nc, int ngroups, int ldc, long long sx_b,
                 long long sx_t, long long sx_h) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double stot[kGH];        // per head: sum_j e_j dt_j u_j . x_j
  __shared__ int expl[kGH];           // per head: some dt * A > 0
  float* cums = smem + GLay::cums;
  float* dts = smem + GLay::dts;
  float* ddq = smem + GLay::ddq;
  float* pos = smem + GLay::pos;
  float* cbt = smem + GLay::cbt;
  float* work = smem + GLay::work;
  double* dcm = reinterpret_cast<double*>(smem + GLay::dcm);

  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const int b = blockIdx.x / ngroups / nc;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = lane / 4, tc = lane % 4;
  const float* xb = x + b * sx_b + (long long)t0 * sx_t;
  const float* cbp = cb_part + ((size_t)b * nc + c) * (size_t)L * ldc;
  const long long HP = (long long)H * P;
  const long long row0 = ((long long)b * T + t0) * HP;   // dy at (b, t0)
  float* dcbp =
      dcb_part + (((size_t)b * nc + c) * ngroups + grp) * (size_t)L * ldc;
  const int nt = (L + kT - 1) / kT;
  const int g = warp;
  const float* cg = cums + g * kMaxL;
  const float* dg = dts + g * kMaxL;
  float acc[8][16];

  const int h0 = grp * kGH, nh = min(kGH, H - h0), h = h0 + g;
  for (int idx = tid; idx < kGH * kMaxL; idx += kThreads) {
    dcm[idx] = 0.0;
    ddq[idx] = 0.f;
  }
  prep_group(dt, A, cums, dts, expl, b, t0, T, H, L, h0, nh);

  // the S terms: u . x_j (the dx kernel's, fetched by every thread) times
  // e_j into ddt, times e_j dt_j out of dcums, and their sum, in order,
  // onto row L-1
  auto fetch = [&](const float* src) {   // pos[g][l] = src[b, t0 + l, h]
    for (int idx = tid; idx < kGH * L; idx += kThreads) {
      const int l = idx / kGH, g2 = idx % kGH;
      if (g2 < nh)
        pos[g2 * kMaxL + l] = src[((size_t)b * T + t0 + l) * H + h0 + g2];
    }
    __syncthreads();
  };
  if (has_s) fetch(ddt);
  if (lane == 0) {
    double tot = 0.0;
    if (has_s && warp < nh)
      for (int j = 0; j < L; ++j) {
        const float u = pos[g * kMaxL + j];
        const float e = expf(cg[L - 1] - cg[j]);
        const float s = e * dg[j] * u;
        ddq[g * kMaxL + j] += e * u;
        dcm[g * kMaxL + j] -= s;
        tot += s;
      }
    stot[g] = tot;
  }

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT, nj = min(kT, L - j0);
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * kT, nit = min(kT, L - i0);
      auto load_g = [&](int s) {
        float* st = work + (s & 1) * kGStage;
        const int p0 = s * kGp;
        constexpr int per = kT * kGH * (kGp / 4);   // chunks of dy (or x)
        for (int idx = tid; idx < 2 * per; idx += kThreads) {
          const bool isx = idx >= per;
          const int e = isx ? idx - per : idx;
          const int row = e / (kGH * (kGp / 4)), rem = e % (kGH * (kGp / 4));
          const int gg = rem / (kGp / 4), p = p0 + 4 * (rem % (kGp / 4));
          const int hh = h0 + gg;
          const bool ok = (isx ? row < nj : row < nit) && hh < H && p < P;
          const float* src =
              !ok ? dy
              : isx ? xb + (long long)(j0 + row) * sx_t +
                          (long long)hh * sx_h + p
                    : dy + row0 + (long long)(i0 + row) * HP +
                          (long long)hh * P + p;
          stage16<kVec>(st + (isx ? kT * kGLd : 0) + row * kGLd + gg * kGp +
                            (p - p0),
                        src, nvalid(ok, P - p));
        }
      };
      zero(acc);
      const int nps = (P + kGp - 1) / kGp;
      __syncthreads();   // the ring and the C B^T tile are free
      // the tile C_i . B_j (i in [i0, i0 + nit), j in [j0, j0 + nj)) of
      // the first launch's C B^T, with the first stage
      for (int idx = tid; idx < nit * (kT / 4); idx += kThreads) {
        const int ii = idx / (kT / 4), j = 4 * (idx % (kT / 4));
        stage16<true>(cbt + ii * kSLd + j,
                      cbp + (size_t)(i0 + ii) * ldc + j0 + j,
                      j < nj ? 4 : 0);
      }
      load_g(0);
      cp_async_commit();
      for (int s = 0; s < nps; ++s) {
        cp_async_wait<0>();
        __syncthreads();
        if (s + 1 < nps) load_g(s + 1);
        cp_async_commit();
        const float* st = work + (s & 1) * kGStage;
        const float* Ys = st + tr * kGLd + g * kGp;
        const float* Xs = st + kT * kGLd + tc * kGLd + g * kGp;
#pragma unroll
        for (int k = 0; k < kGp; k += 4)
          nt4<8, 4>(acc, Ys + k, kGLd, Xs + k, kGLd);
      }
      // the decay, sums and this head's dCB part (g_epilogue)
      if (it > jt && !expl[g])
        g_epilogue<true>(acc, cg, dg, cbt, ddq + g * kMaxL,
                         dcm + g * kMaxL, i0, j0, nit, nj, L, h < H);
      else
        g_epilogue<false>(acc, cg, dg, cbt, ddq + g * kMaxL,
                          dcm + g * kMaxL, i0, j0, nit, nj, L, h < H);

      // dCB: the 8 heads summed in warp order, two 32-row halves through
      // shared memory, added to the block's partial in group order
      __syncthreads();   // the ring is read
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* red = work;   // [kWarps][32][kSLd]
#pragma unroll
        for (int r = 4 * hf; r < 4 * hf + 4; ++r) {
          const int i = tr + 8 * r - 32 * hf;
#pragma unroll
          for (int q = 0; q < 16; ++q)
            red[(warp * 32 + i) * kSLd + tc + 4 * q] = acc[r][q];
        }
        __syncthreads();
        for (int e = tid; e < 32 * kT; e += kThreads) {
          const int row = e / kT, col = e % kT;
          float v = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < kWarps; ++w2)
            v += red[(w2 * 32 + row) * kSLd + col];
          if (32 * hf + row < nit && col < nj) {
            float* o = dcbp + (size_t)(i0 + 32 * hf + row) * ldc + j0 + col;
            *o = v;
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- per head, one lane, in order: dcums += dcd o exp(cums) (and the S
  // term's sum on the last row); dla = reverse cumsum; ddt; dA's partial
  __syncthreads();
  if (dcd != nullptr) fetch(dcd);
  if (lane == 0 && warp < nh) {
    const float ah = A[h];
    dcm[g * kMaxL + L - 1] += stot[g];
    double run = 0.0, da = 0.0;
    for (int l = L - 1; l >= 0; --l) {
      const size_t at = ((size_t)b * T + t0 + l) * H + h;
      double dc = dcm[g * kMaxL + l];
      if (dcd != nullptr) dc += pos[g * kMaxL + l] * expf(cg[l]);
      run += dc;
      ddt[at] = (float)(ddq[g * kMaxL + l] + run * ah);
      da += run * dg[l];
    }
    dA_part[((size_t)b * nc + c) * H + h] = (float)da;
  }
}

// dC and dB of one (b, chunk, ns N tiles of 16 CL columns), all L rows.
// Warp w: row tile w % CL (256 / CL rows), N tile (w / CL) % ns, K split
// w / CL / ns of KS; lanes: CL along the columns, 32 / CL along the rows.
// Each stage holds KD = 8 KS (16 KS for KS <= 2) of the depth, kw a split;
// A operands [256][ld], B operands [ns 16 CL][ld], ld = KD + 4.
constexpr int kBcWork = 2 * (kMaxL + 16) * 68 > kWarps * 128 * 32
                            ? 2 * (kMaxL + 16) * 68
                            : kWarps * 128 * 32;

template <int CL, int KS, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dS,
                  const float* __restrict__ dend,
                  const float* __restrict__ dcb_part, float* __restrict__ dB,
                  float* __restrict__ dC, int T, int H, int P, int N, int L,
                  int nc, int nparts, int ldc, int kbs,
                  long long sx_b, long long sx_t, long long sx_h,
                  long long sb_b, long long sb_t, long long sc_b,
                  long long sc_t) {
  constexpr int RW = 8 * 32 / CL;     // rows of a warp tile
  constexpr int NW = 16 * CL;         // columns of an N tile
  constexpr int LR = 32 / CL;         // lanes along the rows
  constexpr int ns = kWarps / CL / KS;
  constexpr int kw = KS <= 2 ? 16 : 8;
  constexpr int KD = kw * KS, ld = KD + 4;
  constexpr int NWb = ns * NW;        // the block's columns
  constexpr int stage_f = (kMaxL + NWb) * ld;
  static_assert(2 * stage_f <= kBcWork, "stages");
  extern __shared__ __align__(16) float smem[];

  // block: (b, chunk, N tiles, K block kbi of kbs: the heads [hb0, hb1) of
  // the S term; the first also takes dC and dB's dCB term).  kbs > 1: dB
  // holds kbs partials [kbs][B, T, N], summed in order by the last launch
  const int nnb = (N + NWb - 1) / NWb;
  const int kbi = blockIdx.x % kbs;
  const int nb = blockIdx.x / kbs % nnb;
  const int c = (blockIdx.x / kbs / nnb) % nc;
  const int b = blockIdx.x / kbs / nnb / nc;
  const int hpb = (H + kbs - 1) / kbs;
  const int hb0 = min(H, kbi * hpb), hb1 = min(H, hb0 + hpb);
  const int n0 = nb * NWb;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % CL, sl = warp / CL, ntl = sl % ns, ks = sl / ns;
  const int lc = lane % CL, lr = lane / CL;
  const int rbase = rt * RW;
  const bool rows_live = rbase < L;
  const float* dcbp = dcb_part + ((size_t)b * nc + c) * nparts * (size_t)L * ldc;
  const size_t part = (size_t)L * ldc;
  const float* xb = x + b * sx_b + (long long)t0 * sx_t;
  const float* bb = Bm + b * sb_b + (long long)t0 * sb_t;
  const float* cbm = Cm + b * sc_b + (long long)t0 * sc_t;
  float acc[8][16];

  // dCB[i][j0 .. j0 + 4) summed over the partials in order, 0 where j > i
  // or j >= L or i >= L
  auto dcb4 = [&](int i, int j0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < L && j0 <= i) {
      for (int pt = 0; pt < nparts; ++pt) {
        const float4 w =
            *reinterpret_cast<const float4*>(dcbp + pt * part + (size_t)i * ldc + j0);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      v.y = j0 + 1 <= i && j0 + 1 < L ? v.y : 0.f;
      v.z = j0 + 2 <= i && j0 + 2 < L ? v.z : 0.f;
      v.w = j0 + 3 <= i && j0 + 3 < L ? v.w : 0.f;
    }
    return v;
  };
  // a row of B / C, transposed into dst[n][kk] for the block's n
  auto load_bt = [&](float* dst, const float* rows, long long rs, int r0,
                     int nrow) {
    for (int idx = tid; idx < KD * (NWb / 4); idx += kThreads) {
      const int kk = idx % KD, n4 = 4 * (idx / KD);
      const int n = n0 + n4;
      const bool ok = kk < nrow && r0 + kk < L && n < N;
      const float4 v = ldg16<kVec>(rows + (long long)(ok ? r0 + kk : 0) * rs +
                                       (ok ? n : 0),
                                   nvalid(ok, N - n));
      dst[(n4 + 0) * ld + kk] = v.x;
      dst[(n4 + 1) * ld + kk] = v.y;
      dst[(n4 + 2) * ld + kk] = v.z;
      dst[(n4 + 3) * ld + kk] = v.w;
    }
  };
  // one stage of the product: rows rbase + lr + LR r, columns ntl NW + lc +
  // CL q, this split's kw of the stage's depth
  auto fma_stage = [&](const float* st) {
    const float* As = st + (rbase + lr) * ld + ks * kw;
    const float* Bs = st + kMaxL * ld + (ntl * NW + lc) * ld + ks * kw;
    for (int k8 = 0; k8 < kw; k8 += 8) {
      nt4<LR, CL>(acc, As + k8, ld, Bs + k8, ld);
      nt4<LR, CL>(acc, As + k8 + 4, ld, Bs + k8 + 4, ld);
    }
  };
  // stages 0 .. n-1 through the two-stage ring; load(st, s) fills stage s,
  // land(st, s) runs on a thread's own copies once they have arrived, use(s)
  // says whether this warp's rows take stage s
  auto ring = [&](int n, auto&& load, auto&& land, auto&& use) {
    __syncthreads();   // the work area is free
    load(smem, 0);
    cp_async_commit();
    for (int s = 0; s < n; ++s) {
      float* st = smem + (s & 1) * stage_f;
      cp_async_wait<0>();
      land(st, s);
      __syncthreads();
      if (s + 1 < n) load(smem + ((s + 1) & 1) * stage_f, s + 1);
      cp_async_commit();
      if (rows_live && use(s)) fma_stage(st);
    }
    __syncthreads();   // the ring is read
  };
  auto none = [](float*, int) {};
  // the K splits summed in order in shared memory, then stored
  auto finish = [&](float* out) {
    if (KS > 1) {
      float* red = smem;   // [kWarps][8 * 16][32]
      if (ks > 0)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 16; ++q)
            red[(warp * 128 + r * 16 + q) * 32 + lane] = acc[r][q];
      __syncthreads();
      if (ks == 0)
        for (int k2 = 1; k2 < KS; ++k2) {
          const int w2 = warp + CL * ns * k2;
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 16; ++q)
              acc[r][q] += red[(w2 * 128 + r * 16 + q) * 32 + lane];
        }
      __syncthreads();
    }
    if (ks == 0 && rows_live)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = rbase + lr + LR * r;
        if (row >= L) continue;
        float* o = out + ((size_t)b * T + t0 + row) * N;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int n = n0 + ntl * NW + lc + CL * q;
          if (n < N) o[n] = acc[r][q];
        }
      }
  };

  // ---- dC[i][n] = sum_{j <= i} dCB[i][j] B[j][n] -------------------------
  if (kbi == 0) {
    zero(acc);
    ring((L + KD - 1) / KD,
         [&](float* st, int s) {
           const int j0 = s * KD;
           for (int idx = tid; idx < kMaxL * (KD / 4); idx += kThreads) {
             const int i = idx / (KD / 4), k4 = 4 * (idx % (KD / 4));
             *reinterpret_cast<float4*>(st + i * ld + k4) = dcb4(i, j0 + k4);
           }
           load_bt(st + kMaxL * ld, bb, sb_t, j0, KD);
         },
         none, [&](int s) { return s * KD < rbase + RW; });
    finish(dC);
  }
  // ---- dB[j][n] = sum_{i >= j} dCB[i][j] C[i][n] + sum_k xs[j][k] dS[n][k]
  zero(acc);
  if (kbi == 0) {
    ring((L + KD - 1) / KD,
         [&](float* st, int s) {
           const int i0 = s * KD;
           for (int idx = tid; idx < KD * (kMaxL / 4); idx += kThreads) {
             const int kk = idx % KD, j4 = 4 * (idx / KD);
             const float4 v = dcb4(i0 + kk, j4);
             st[(j4 + 0) * ld + kk] = v.x;
             st[(j4 + 1) * ld + kk] = v.y;
             st[(j4 + 2) * ld + kk] = v.z;
             st[(j4 + 3) * ld + kk] = v.w;
           }
           load_bt(st + kMaxL * ld, cbm, sc_t, i0, KD);
         },
         none, [&](int s) { return (s + 1) * KD > rbase; });
  }
  if (dS != nullptr) {
    // stage s: head hb0 + s / sph, p from (s % sph) KD; x rows [256][KD]
    // (thread t copies row t, and fetches its e_t dt_t as it issues the
    // copy), dS rows [NWb][KD]
    static_assert(kThreads == kMaxL, "a thread a row");
    const int sph = (P + KD - 1) / KD;
    const int row = tid;
    float dnext = 0.f;   // e dt of this thread's row, for the stage in flight
    ring((hb1 - hb0) * sph,
         [&](float* st, int s) {
           const int hh = hb0 + s / sph, p0 = (s % sph) * KD;
#pragma unroll
           for (int k4 = 0; k4 < KD / 4; ++k4) {
             const int p = p0 + 4 * k4;
             const bool ok = row < L && p < P;
             stage16<kVec>(st + row * ld + 4 * k4,
                           ok ? xb + (long long)row * sx_t +
                                    (long long)hh * sx_h + p
                              : x,
                           nvalid(ok, P - p));
           }
           dnext = row < L ? dend[((size_t)b * T + t0 + row) * H + hh] : 0.f;
           for (int idx = tid; idx < NWb * (KD / 4); idx += kThreads) {
             const int n = idx / (KD / 4), p = p0 + 4 * (idx % (KD / 4));
             const bool ok = n0 + n < N && p < P;
             stage16<kVec>(st + (kMaxL + n) * ld + (p - p0),
                           ok ? dS + (((size_t)b * nc + c) * H + hh) *
                                         (size_t)N * P +
                                    (size_t)(n0 + n) * P + p
                              : dS,
                           nvalid(ok, P - p));
           }
         },
         // e_j dt_j scales this thread's own x row once it has landed
         [&](float* st, int) {
           float* xr = st + row * ld;
#pragma unroll
           for (int k4 = 0; k4 < KD / 4; ++k4) {
             float4 w = *reinterpret_cast<float4*>(xr + 4 * k4);
             w.x *= dnext;
             w.y *= dnext;
             w.z *= dnext;
             w.w *= dnext;
             *reinterpret_cast<float4*>(xr + 4 * k4) = w;
           }
         },
         [](int) { return true; });
  }
  finish(kbs == 1 ? dB
                  : dB + (size_t)kbi * (gridDim.x / (kbs * nnb)) * L * N);
}

// out[e] = sum over k < parts, in order, of part[k][e]
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                   long long n, int parts) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    float v = part[e];
    for (int k = 1; k < parts; ++k) v += part[k * n + e];
    out[e] = v;
  }
}

template <int PP, bool kVec>
int launch_dx(unsigned blocks, cudaStream_t s, const float* x,
              const float* dt, const float* A, const float* Bm,
              const float* cb_part, const float* dy, const float* dS,
              float* dx, float* uxo, float* dend, int T, int H, int P, int N,
              int L, int nc, int ngroups, int ldc, long long sx_b,
              long long sx_t, long long sx_h, long long sb_b,
              long long sb_t) {
  const int bytes = DxLay::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_dx_kernel<PP, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dx_kernel<PP, kVec><<<blocks, kThreads, bytes, s>>>(
      x, dt, A, Bm, cb_part, dy, dS, dx, uxo, dend, T, H, P, N, L, nc,
      ngroups, ldc, sx_b, sx_t, sx_h, sb_b, sb_t);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_g(unsigned blocks, cudaStream_t s, const float* x,
             const float* dt, const float* A, const float* cb_part,
             const float* dy, const float* dcd, float* ddt, float* dA_part,
             float* dcb_part, int has_s, int T, int H, int P, int L, int nc,
             int ngroups, int ldc, long long sx_b, long long sx_t,
             long long sx_h) {
  const int bytes = GLay::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_g_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_g_kernel<kVec><<<blocks, kThreads, bytes, s>>>(
      x, dt, A, cb_part, dy, dcd, ddt, dA_part, dcb_part, has_s, T, H, P, L,
      nc, ngroups, ldc, sx_b, sx_t, sx_h);
  return (int)cudaGetLastError();
}

template <int CL, int KS, bool kVec>
int launch_bc(int cells, cudaStream_t s, const float* x, const float* Bm,
              const float* Cm, const float* dS, const float* dend,
              const float* dcb_part, float* dB, float* dC, int T, int H,
              int P, int N, int L, int nc, int nparts, int ldc, int kbs,
              long long sx_b, long long sx_t, long long sx_h, long long sb_b,
              long long sb_t, long long sc_b, long long sc_t) {
  constexpr int NWb = kWarps / CL / KS * 16 * CL;
  const long long blocks = (long long)cells * ((N + NWb - 1) / NWb) * kbs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bytes = kBcWork * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_bc_kernel<CL, KS, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_bc_kernel<CL, KS, kVec><<<(unsigned)blocks, kThreads, bytes, s>>>(
      x, Bm, Cm, dS, dend, dcb_part, dB, dC, T, H, P, N, L, nc, nparts, ldc,
      kbs, sx_b, sx_t, sx_h, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_cb(int cells, cudaStream_t s, const float* Bm, const float* Cm,
              float* cb_part, int N, int L, int nc, int ldc, long long sb_b,
              long long sb_t, long long sc_b, long long sc_t) {
  const long long blocks = (long long)cells * ((L + kT - 1) / kT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bytes = 2 * kCbStage * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cb_kernel<kVec><<<(unsigned)blocks, kThreads, bytes, s>>>(
      Bm, Cm, cb_part, N, L, nc, ldc, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches: C B^T into cb_part ([B, nc, L, ldc], ldc = L rounded up to 4);
// dx, then G (a block per (b, chunk, group of 8 heads); dcb_part holds one
// [L, ldc] dCB partial per block); dB and dC (kbs blocks a (b, chunk, N
// tiles) split dB's S term by heads; kbs > 1: their partials in db_part
// [kbs, B, T, N]), and then the partials' sum in order.  kbs is the
// wrapper's choice.
extern "C" int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dS, const void* dcd,
    void* dx, void* ddt, void* dA_part, void* dB, void* dC, void* dcb_part,
    void* cb_part, void* db_part, void* dend, int Bsz, int T, int H, int P,
    int N, int L, int kbs, long long sx_b, long long sx_t,
    long long sx_h, long long sb_b, long long sb_t, long long sc_b,
    long long sc_t, void* stream) {
  if (L < 1 || L > kMaxL || T % L || P < 1 || P > 128 || N < 1 ||
      N > 256 || H < 1 || Bsz < 1 || kbs < 1 || kbs > H ||
      (kbs > 1 && db_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = T / L;
  const int ngroups = (H + kGH - 1) / kGH;
  const int ldc = (L + 3) / 4 * 4;
  const long long cells = (long long)Bsz * nc;
  if (cells * ngroups > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies where every row of x, B, C, dy, dS and dx starts on 16
  // bytes, else 4-byte loads
  const bool vec =
      P % 4 == 0 && N % 4 == 0 &&
      ((sx_b | sx_t | sx_h | sb_b | sb_t | sc_b | sc_t) & 3) == 0 &&
      (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)dy |
        (uintptr_t)dS | (uintptr_t)dx) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *bf = (const float*)Bm,
              *cf = (const float*)Cm, *sf = (const float*)dS;
  int rc = vec ? launch_cb<true>((int)cells, s, bf, cf, (float*)cb_part, N,
                                 L, nc, ldc, sb_b, sb_t, sc_b, sc_t)
               : launch_cb<false>((int)cells, s, bf, cf, (float*)cb_part, N,
                                  L, nc, ldc, sb_b, sb_t, sc_b, sc_t);
  if (rc) return rc;
  // dx (u . x left in ddt for the G kernel), then G
#define DX_ARGS (unsigned)(cells * ngroups), s, xf, (const float*)dt,          \
    (const float*)A, bf, (const float*)cb_part, (const float*)dy, sf,         \
    (float*)dx, (float*)ddt, (float*)dend, T, H, P, N, L, nc, ngroups, ldc,   \
    sx_b, sx_t, sx_h, sb_b, sb_t
  if (P <= 64)
    rc = vec ? launch_dx<64, true>(DX_ARGS) : launch_dx<64, false>(DX_ARGS);
  else
    rc = vec ? launch_dx<128, true>(DX_ARGS) : launch_dx<128, false>(DX_ARGS);
#undef DX_ARGS
  if (rc) return rc;
#define G_ARGS (unsigned)(cells * ngroups), s, xf, (const float*)dt,           \
    (const float*)A, (const float*)cb_part, (const float*)dy,                 \
    (const float*)dcd, (float*)ddt, (float*)dA_part, (float*)dcb_part,        \
    dS != nullptr, T, H, P, L, nc, ngroups, ldc, sx_b, sx_t, sx_h
  rc = vec ? launch_g<true>(G_ARGS) : launch_g<false>(G_ARGS);
#undef G_ARGS
  if (rc) return rc;
  // the N tiles at N's own width: 16, 32 or 64 columns (two a block past 64)
  float* dbo = kbs > 1 ? (float*)db_part : (float*)dB;
#define BC_ARGS (int)cells, s, xf, bf, cf, sf, (const float*)dend,           \
    (const float*)dcb_part, dbo, (float*)dC, T, H, P, N, L, nc, ngroups,     \
    ldc, kbs, sx_b, sx_t, sx_h, sb_b, sb_t, sc_b, sc_t
  if (N <= 16)
    rc = vec ? launch_bc<1, 8, true>(BC_ARGS) : launch_bc<1, 8, false>(BC_ARGS);
  else if (N <= 32)
    rc = vec ? launch_bc<2, 4, true>(BC_ARGS) : launch_bc<2, 4, false>(BC_ARGS);
  else if (N <= 64)
    rc = vec ? launch_bc<4, 2, true>(BC_ARGS) : launch_bc<4, 2, false>(BC_ARGS);
  else
    rc = vec ? launch_bc<4, 1, true>(BC_ARGS) : launch_bc<4, 1, false>(BC_ARGS);
#undef BC_ARGS
  if (rc || kbs == 1) return rc;
  const long long n = (long long)Bsz * T * N;
  const long long sum_blocks = (n + kThreads - 1) / kThreads;
  ssd_bwd_sum_kernel<<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096),
                       kThreads, 0, s>>>((const float*)db_part, (float*)dB,
                                         n, kbs);
  return (int)cudaGetLastError();
}
