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
// views into its projection).  Outputs (float32, contiguous): y [B, T, H,
// P], S [B, nc, H, N, P], cd [B, T, H].  The inter-chunk recurrence stays
// in framework code (kernels/ssd_chunk.py), as in the reference.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores (67 TFLOP/s;
// no TF32: the reference holds the step to 1e-4).  B and C are one group
// for all heads, so the function needs C B^T below the diagonal once per
// (b, chunk) (2 N L(L+1)/2), and per head the decay-weighted product with
// x (2 P L(L+1)/2) and S (2 L N P); the bytes are an order below.
//
// Design.  One block of 8 warps owns (b, chunk) and walks the heads in
// groups of G = 8 (P <= 64; G * P_pad = 512 output columns, a warp per 64
// of them); where (b, chunk) cells are too few to fill the card, each
// group gets its own block instead.
//   * cums: per group, one lane a head scans its dt * A over the chunk in
//     order, with the plain version's float32 roundings (a difference
//     cums_i - cums_j then carries only the roundings between j and i);
//     a head with some dt * A > 0 is marked "explicit".
//   * y in i-tiles of 64 rows.  The strip C_i B_j^T, j < i0 + 64, is formed
//     once into shared memory (fp32 tile: 8 x 8 a thread, 16-byte loads
//     along N through a 2-stage cp.async ring), zero above the diagonal,
//     and serves every group.  Then y_tile = sum over 16-row slices of x:
//       - below the diagonal tile (j < i0) with one reference row r = i0 - 1:
//         exp(cums_i - cums_j) = exp(cums_i - cums_r) exp(cums_r - cums_j)
//         = u_i v_j.  Where every a <= 0 both factors are <= 1: neither
//         overflows, and one underflows only where the exact product is
//         below it.  The slice is a plain product with the shared strip,
//         v_j dt_j multiplies the strip's values as they are read, and the
//         accumulator rows are scaled by u_i once, when the diagonal tile
//         is reached;
//       - on the diagonal tile, and on every tile of an explicit head, each
//         warp writes its head's 16 x 64 slice of C B^T * exp(cums_i -
//         cums_j) (masked to j <= i, the exponent taken only there) into
//         its own shared buffer, and dt_j multiplies as above;
//     each product runs on an 8 x 16 register tile a thread (rows 4 tr +
//     {0..3, 32..35}, columns 4 tc + 16 q + {0..3}, all of one head), 6
//     LDS.128 per 128 FFMA, x slices through a 2-stage cp.async ring.
//   * S per group in 64-row passes over N: S_h = B^T diag(exp(c_end -
//     cums) dt)_h x_h, B^T shared by the G heads, on the same register
//     tile.
// A chunk of one position (a decode step) takes ssd_step_kernel: y =
// (C . B) dt x, S = dt B x^T, cd = exp(dt A) in one pass, a block per
// (b, t, h).  Every sum runs in a fixed order: two launches give the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 512;      // output columns of a block: G heads x P_pad
constexpr int kTi = 64;         // rows of an i-tile, and of an S pass
constexpr int kSl = 16;         // x rows (j) of one slice
constexpr int kMaxL = 256;
constexpr int kNd = 32;         // N depth of one C B^T stage
constexpr int kLd = kNd + 4;    // row stride of the C / B rows of a stage
constexpr int kCbLd = kTi + 4;  // row stride of the strip [j][i]

// dynamic shared memory, in floats
template <int PP>
struct Layout {
  static constexpr int G = kCols / PP;                 // heads of a group
  static constexpr int cums = 0;                       // [G][kMaxL]
  static constexpr int dts = cums + G * kMaxL;         // [G][kMaxL]
  static constexpr int sc = dts + G * kMaxL;           // [G][kMaxL] x scales
  static constexpr int u = sc + G * kMaxL;             // [G][kTi] row scales
  static constexpr int cb = u + G * kTi;               // [kMaxL][kCbLd]
  static constexpr int w = cb + kMaxL * kCbLd;         // [kWarps][kSl][kTi]
  static constexpr int ring = w + kWarps * kSl * kTi;  // 2 stages
  static constexpr int cb_stage = (kTi + kMaxL) * kLd;        // C, B rows
  static constexpr int x_stage = kSl * kCols + kSl * kTi;     // x, B slice
  static constexpr int stage =
      cb_stage > x_stage ? cb_stage : x_stage;
  static constexpr int total = ring + 2 * stage;
};

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int PP, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ S, float* __restrict__ cd, int T, int H,
           int P, int N, int L, int nc, int ngroups, int gpb, long long sx_b,
           long long sx_t, long long sx_h, long long sb_b, long long sb_t,
           long long sc_b, long long sc_t) {
  using Lay = Layout<PP>;
  constexpr int G = Lay::G;
  extern __shared__ __align__(16) float smem[];
  __shared__ int expl[G];
  float* cums = smem + Lay::cums;
  float* dts = smem + Lay::dts;
  float* scl = smem + Lay::sc;
  float* us = smem + Lay::u;
  float* cbt = smem + Lay::cb;

  // this block: (b, chunk c) and the groups [g_begin, g_end) of G heads
  const int nblk = (ngroups + gpb - 1) / gpb;
  const int g_begin = blockIdx.x % nblk * gpb;
  const int g_end = min(ngroups, g_begin + gpb);
  const int c = (blockIdx.x / nblk) % nc;
  const int b = blockIdx.x / nblk / nc;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = lane % 4, tr = lane / 4;
  const int cw = warp * 64;           // the warp's first output column
  const int gme = cw / PP;            // the head of this thread's columns
  const int pw = cw - gme * PP;       // ... and their first p
  float* wbuf = smem + Lay::w + warp * kSl * kTi;
  auto stage = [&](int s) { return smem + Lay::ring + (s & 1) * Lay::stage; };
  const float* xb = x + b * sx_b;
  const float* bb = Bm + b * sb_b + (long long)t0 * sb_t;
  const float* cb = Cm + b * sc_b + (long long)t0 * sc_t;

  // ---- a group's dt and the inclusive cumsum of dt * A, a warp per head --
  int h0 = 0, loaded = -1;            // the loaded group's first head
  auto prep = [&](int grp, bool write_cd) {
    if (grp == loaded) return;
    loaded = grp;
    h0 = grp * G;
    __syncthreads();   // the previous group's scales and cumsums are read
    for (int idx = tid; idx < G * L; idx += kThreads) {
      const int l = idx / G, g = idx % G;
      dts[g * kMaxL + l] =
          h0 + g < H ? dt[((size_t)b * T + t0 + l) * H + h0 + g] : 0.f;
    }
    __syncthreads();
    // one lane per head, in order: cums_l = fl(cums_{l-1} + fl(dt_l A)),
    // the plain version's float32 product and sequential scan, so that
    // cums_i - cums_j carries only the roundings between j and i.  (A scan
    // of lane stretches plus a base adds independent roundings of |cums|
    // to every difference, even of neighbours; where a chunk's cumsum
    // spans hundreds, as a Mamba layer's real dt and A give, that error
    // reaches y at its 1e-4 tolerance.)
    for (int g = warp; g < G; g += kWarps) {
      if (lane == 0) {
        const float ah = h0 + g < H ? A[h0 + g] : 0.f;
        float run = 0.f;
        bool pos = false;
        for (int l = 0; l < L; ++l) {
          const float a = __fmul_rn(dts[g * kMaxL + l], ah);
          pos |= a > 0.f;
          run = __fadd_rn(run, a);
          cums[g * kMaxL + l] = run;
        }
        expl[g] = pos;
      }
    }
    __syncthreads();
    if (write_cd)
      for (int idx = tid; idx < G * L; idx += kThreads) {
        const int l = idx / G, g = idx % G;
        if (h0 + g < H)
          cd[((size_t)b * T + t0 + l) * H + h0 + g] =
              expf(cums[g * kMaxL + l]);
      }
  };

  // ---- the x slice [j0, j0 + 16) x (G heads x P_pad) into a stage --------
  // (rows j >= lim, heads >= H and p >= P read as 0)
  auto load_x = [&](float* st, int j0, int lim) {
#pragma unroll
    for (int e = 0; e < kSl * kCols / 4 / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int jj = idx / (kCols / 4), rem = idx % (kCols / 4);
      const int g = rem / (PP / 4), p = 4 * (rem % (PP / 4));
      const int j = j0 + jj, h = h0 + g;
      const bool ok = j < lim && h < H && p < P;
      const float* src = xb + (long long)(t0 + (ok ? j : 0)) * sx_t +
                         (long long)(ok ? h : 0) * sx_h + (ok ? p : 0);
      float* dst = st + jj * kCols + 4 * rem;
      if constexpr (kVec) {
        cp_async16(smem_u32(dst), src, ok ? 16 : 0);
      } else {
        float4 v;
        v.x = ok ? src[0] : 0.f;
        v.y = ok && p + 1 < P ? src[1] : 0.f;
        v.z = ok && p + 2 < P ? src[2] : 0.f;
        v.w = ok && p + 3 < P ? src[3] : 0.f;
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
  };

  // ---- one slice of the product: acc[r][.] += sum_jj A[jj][row r] sc[jj]
  // X[jj][.]; sc: this thread's head's x scales of the slice's rows
  // (v_j dt_j, dt_j or exp(c_end - cums_j) dt_j), folded into the 8 A
  // values of a row
  float acc[8][16];
  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[r][q] = 0.f;
  };
  auto fma_slice = [&](const float* As, int lda, const float* Xs,
                       const float* sc) {
#pragma unroll 2
    for (int jj = 0; jj < kSl; ++jj) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(As + jj * lda + 4 * tr);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + jj * lda + 4 * tr + 32);
      const float sj = sc[jj];
      float4 xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[q] = *reinterpret_cast<const float4*>(Xs + jj * kCols + cw +
                                                 4 * tc + 16 * q);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = comp(r < 4 ? a0 : a1, r & 3) * sj;
#pragma unroll
        for (int q = 0; q < 16; ++q)
          acc[r][q] = fmaf(av, comp(xv[q / 4], q & 3), acc[r][q]);
      }
    }
  };
  // acc rows -> out + row * row_stride (row < rows), this thread's columns
  // of head h0 + gme (p < P)
  auto store_acc = [&](float* out, long long row_stride, int rows) {
    if (h0 + gme >= H) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = 4 * tr + (r & 3) + 32 * (r >> 2);
      if (row >= rows) continue;
      float* o = out + row * row_stride;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = pw + 4 * tc + 16 * q;
        if constexpr (kVec) {
          if (p < P)
            *reinterpret_cast<float4*>(o + p) =
                make_float4(acc[r][4 * q], acc[r][4 * q + 1],
                            acc[r][4 * q + 2], acc[r][4 * q + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p + e < P) o[p + e] = acc[r][4 * q + e];
        }
      }
    }
  };

  // ---- y, one i-tile of 64 rows at a time --------------------------------
  const int nit = (L + kTi - 1) / kTi;
  for (int it = 0; it < nit; ++it) {
    const int i0 = it * kTi, ni = min(kTi, L - i0), J = i0 + ni;
    const int Jp = (J + 31) & ~31;   // strip rows formed, a multiple of 32
    const int qn = Jp / 32;

    // the strip cbt[j][i] = C_{i0+i} . B_j, j < Jp, zero where j > i0 + i
    {
      const int tx = tid % 32, ty = tid / 32;
      float cacc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) cacc[r][q] = 0.f;
      auto load_cb = [&](int t) {
        float* st = stage(t);
        const int k0 = t * kNd;
        for (int idx = tid; idx < (kTi + Jp) * (kNd / 4); idx += kThreads) {
          const int r = idx / (kNd / 4), k = k0 + 4 * (idx % (kNd / 4));
          const bool isc = r < kTi;
          const int row = isc ? r : r - kTi;
          const bool ok = (isc ? row < ni : row < J) && k < N;
          const float* src =
              isc ? cb + (long long)(ok ? i0 + row : 0) * sc_t + (ok ? k : 0)
                  : bb + (long long)(ok ? row : 0) * sb_t + (ok ? k : 0);
          float* dst = st + r * kLd + (k - k0);
          if constexpr (kVec) {
            cp_async16(smem_u32(dst), src, ok ? 16 : 0);
          } else {
            float4 v;
            v.x = ok ? src[0] : 0.f;
            v.y = ok && k + 1 < N ? src[1] : 0.f;
            v.z = ok && k + 2 < N ? src[2] : 0.f;
            v.w = ok && k + 3 < N ? src[3] : 0.f;
            *reinterpret_cast<float4*>(dst) = v;
          }
        }
      };
      __syncthreads();   // the previous tile's strip and ring are consumed
      const int nk = (N + kNd - 1) / kNd;
      load_cb(0);
      cp_async_commit();
      for (int t = 0; t < nk; ++t) {
        cp_async_wait<0>();
        __syncthreads();
        if (t + 1 < nk) load_cb(t + 1);
        cp_async_commit();
        const float* Cs = stage(t);
        const float* Bs = Cs + kTi * kLd;
#pragma unroll
        for (int k4 = 0; k4 < kNd / 4; ++k4) {
          float4 a[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            a[r] = *reinterpret_cast<const float4*>(Cs + (ty + 8 * r) * kLd +
                                                    4 * k4);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q >= qn) continue;
            const float4 bv = *reinterpret_cast<const float4*>(
                Bs + (tx + 32 * q) * kLd + 4 * k4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int r = 0; r < 8; ++r)
                cacc[r][q] = fmaf(comp(a[r], kk), comp(bv, kk), cacc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q >= qn) continue;
          const int i = ty + 8 * r, j = tx + 32 * q;
          cbt[j * kCbLd + i] = j <= i0 + i ? cacc[r][q] : 0.f;
        }
    }

    for (int grp = g_begin; grp < g_end; ++grp) {
      prep(grp, it == 0);
      // x scales (v_j dt_j below the diagonal tile, dt_j on it and for an
      // explicit head; 0 past J up to the slices' end) and row scales u_i,
      // with the reference row i0 - 1
      const int Jr = (J + kSl - 1) / kSl * kSl;
      __syncthreads();   // the previous group's y loop is done
      for (int idx = tid; idx < G * Jr; idx += kThreads) {
        const int g = idx / Jr, j = idx % Jr;
        float s = j < J ? dts[g * kMaxL + j] : 0.f;
        if (!expl[g] && j < i0)
          s *= expf(cums[g * kMaxL + i0 - 1] - cums[g * kMaxL + j]);
        scl[g * kMaxL + j] = s;
      }
      for (int idx = tid; idx < G * kTi; idx += kThreads) {
        const int g = idx / kTi, i = idx % kTi;
        us[g * kTi + i] =
            !expl[g] && i0 > 0 && i < ni
                ? expf(cums[g * kMaxL + i0 + i] - cums[g * kMaxL + i0 - 1])
                : 1.f;
      }
      __syncthreads();   // strip, scales; the ring is free

      zero_acc();
      const bool ex_head = expl[gme];
      const int ns = Jr / kSl;
      load_x(stage(0), 0, J);
      cp_async_commit();
      for (int s = 0; s < ns; ++s) {
        const int j0 = s * kSl;
        cp_async_wait<0>();
        __syncthreads();
        if (s + 1 < ns) load_x(stage(s + 1), j0 + kSl, J);
        cp_async_commit();
        const bool diag = j0 >= i0;
        if (diag && j0 == i0 && i0 > 0 && !ex_head) {
          // the rows' factored sums so far, back to exact units
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float ur =
                us[gme * kTi + 4 * tr + (r & 3) + 32 * (r >> 2)];
#pragma unroll
            for (int q = 0; q < 16; ++q) acc[r][q] *= ur;
          }
        }
        if (!diag && !ex_head) {
          fma_slice(cbt + j0 * kCbLd, kCbLd, stage(s),
                    scl + gme * kMaxL + j0);
        } else {
          // this warp's head: C B^T * exp(cums_i - cums_j), j <= i
          __syncwarp();
          const float* cg = cums + gme * kMaxL;
          const int ia = i0 + lane, ib = i0 + lane + 32;
          const float ca = ia < L ? cg[ia] : 0.f;
          const float cbv = ib < L ? cg[ib] : 0.f;
#pragma unroll 4
          for (int jj = 0; jj < kSl; ++jj) {
            const int j = j0 + jj;
            const float cj = j < L ? cg[j] : 0.f;
            wbuf[jj * kTi + lane] =
                j <= ia && ia < L ? cbt[j * kCbLd + lane] * expf(ca - cj)
                                  : 0.f;
            wbuf[jj * kTi + lane + 32] =
                j <= ib && ib < L ? cbt[j * kCbLd + lane + 32] * expf(cbv - cj)
                                  : 0.f;
          }
          __syncwarp();
          fma_slice(wbuf, kTi, stage(s), scl + gme * kMaxL + j0);
        }
      }
      store_acc(y + (((size_t)b * T + t0 + i0) * H + h0 + gme) * P,
                (long long)H * P, ni);
    }
  }

  // ---- S = B^T diag(exp(c_end - cums) dt) x, in 64-row passes over N;
  // the groups in reverse, so the last y group's cumsums serve first -----
  const int nsl = (L + kSl - 1) / kSl;
  auto load_s = [&](int s, int n0) {
    float* st = stage(s);
    load_x(st, s * kSl, L);
    // B rows [j0, j0 + 16) x columns [n0, n0 + 64): one chunk a thread
    const int jj = tid / (kTi / 4), n = n0 + 4 * (tid % (kTi / 4));
    const int j = s * kSl + jj;
    const bool ok = j < L && n < N;
    const float* src = bb + (long long)(ok ? j : 0) * sb_t + (ok ? n : 0);
    float* dst = st + kSl * kCols + jj * kTi + 4 * (tid % (kTi / 4));
    if constexpr (kVec) {
      cp_async16(smem_u32(dst), src, ok ? 16 : 0);
    } else {
      float4 v;
      v.x = ok ? src[0] : 0.f;
      v.y = ok && n + 1 < N ? src[1] : 0.f;
      v.z = ok && n + 2 < N ? src[2] : 0.f;
      v.w = ok && n + 3 < N ? src[3] : 0.f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  };
  for (int grp = g_end - 1; grp >= g_begin; --grp) {
    prep(grp, false);
    __syncthreads();   // the last y loop's scales are read
    for (int idx = tid; idx < G * nsl * kSl; idx += kThreads) {
      const int g = idx / (nsl * kSl), j = idx % (nsl * kSl);
      scl[g * kMaxL + j] =
          j < L ? expf(cums[g * kMaxL + L - 1] - cums[g * kMaxL + j]) *
                      dts[g * kMaxL + j]
                : 0.f;
    }
    float* sout = S + (((size_t)b * nc + c) * H + h0 + gme) * (size_t)N * P;
    for (int n0 = 0; n0 < N; n0 += kTi) {
      __syncthreads();   // scales written; the ring is free
      zero_acc();
      load_s(0, n0);
      cp_async_commit();
      for (int s = 0; s < nsl; ++s) {
        cp_async_wait<0>();
        __syncthreads();
        if (s + 1 < nsl) load_s(s + 1, n0);
        cp_async_commit();
        fma_slice(stage(s) + kSl * kCols, kTi, stage(s),
                  scl + gme * kMaxL + s * kSl);
      }
      store_acc(sout + (size_t)n0 * P, P, N - n0);
    }
  }
}

// L = 1 (a decode step): every chunk is one position, so y = (C . B) dt x,
// S = (dt B) x^T and cd = exp(dt A), in one pass: a block per (b, t, h).
__global__ void __launch_bounds__(kThreads)
ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ S, float* __restrict__ cd, int T, int H,
                int P, int N, long long sx_b, long long sx_t, long long sx_h,
                long long sb_b, long long sb_t, long long sc_b,
                long long sc_t) {
  __shared__ float cbs;
  const int h = blockIdx.x % H, bt = blockIdx.x / H;
  const int b = bt / T, t = bt % T;
  const float* xr = x + b * sx_b + t * sx_t + h * sx_h;
  const float* br = Bm + b * sb_b + t * sb_t;
  const float* cr = Cm + b * sc_b + t * sc_t;
  const float d = dt[(size_t)bt * H + h];
  if (threadIdx.x < 32) {
    float v = 0.f;
    for (int n = threadIdx.x; n < N; n += 32) v = fmaf(cr[n], br[n], v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) {
      cbs = v * d;
      cd[(size_t)bt * H + h] = expf(d * A[h]);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads)
    y[(size_t)blockIdx.x * P + p] = cbs * xr[p];
  float* so = S + (size_t)blockIdx.x * N * P;
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads)
    so[idx] = d * br[idx / P] * xr[idx % P];
}

template <int PP, bool kVec>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* S, void* cd, int Bsz, int T, int H,
           int P, int N, int L, long long sx_b, long long sx_t,
           long long sx_h, long long sb_b, long long sb_t, long long sc_b,
           long long sc_t, cudaStream_t stream) {
  using Lay = Layout<PP>;
  const int bytes = Lay::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<PP, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  static int sm_count[64];   // per device, read once
  int sms = dev < 64 ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sm_count[dev] = sms;
  }
  const int nc = T / L;
  const int ngroups = (H + Lay::G - 1) / Lay::G;
  // one block walks every group of a (b, chunk) when the cells alone fill
  // the card twice over (C B^T formed once per chunk), else a block a group
  const long long cells = (long long)Bsz * nc;
  const int gpb = cells >= 2LL * sms ? ngroups : 1;
  const long long blocks = cells * ((ngroups + gpb - 1) / gpb);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_kernel<PP, kVec><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)S, (float*)cd, T, H, P, N, L, nc,
      ngroups, gpb, sx_b, sx_t, sx_h, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* S, void* cd, int Bsz, int T, int H,
                               int P, int N, int L, long long sx_b,
                               long long sx_t, long long sx_h, long long sb_b,
                               long long sb_t, long long sc_b, long long sc_t,
                               void* stream) {
  if (L < 1 || L > kMaxL || T % L || P < 1 || P > 128 || N < 1 || N > 256)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies and stores where every row of x, B, C, y and S starts
  // on 16 bytes, else 4-byte loads
  const bool vec =
      P % 4 == 0 && N % 4 == 0 &&
      ((sx_b | sx_t | sx_h | sb_b | sb_t | sc_b | sc_t) & 3) == 0 &&
      (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)y |
        (uintptr_t)S) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (L == 1) {
    if ((long long)Bsz * T * H > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    ssd_step_kernel<<<Bsz * T * H, kThreads, 0, s>>>(
        (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
        (const float*)Cm, (float*)y, (float*)S, (float*)cd, T, H, P, N, sx_b,
        sx_t, sx_h, sb_b, sb_t, sc_b, sc_t);
    return (int)cudaGetLastError();
  }
#define SSD_ARGS x, dt, A, Bm, Cm, y, S, cd, Bsz, T, H, P, N, L, sx_b, sx_t, \
                 sx_h, sb_b, sb_t, sc_b, sc_t, s
  if (P <= 64)
    return vec ? launch<64, true>(SSD_ARGS) : launch<64, false>(SSD_ARGS);
  return vec ? launch<128, true>(SSD_ARGS) : launch<128, false>(SSD_ARGS);
#undef SSD_ARGS
}
