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
// of dB), per visible pair 6 N once per (b, chunk) (C B^T, dC, dB).
//
// Design (correct first; every product is an fp32 SIMT tile, 4 x 4 a
// thread of a 64 x 64 output, operands in shared memory):
//   * ssd_bwd_kernel: a block owns (b, chunk, a group of 8 heads).  Its
//     warps scan each head's dt * A in one lane, in order, with the
//     forward's float32 roundings (ssd_chunk.cu's prep), so every
//     exp(cums_i - cums_j) here has the forward's bits.  Then, per
//     64-column j-tile: the strip C_i B_j^T (i >= the tile's first row) is
//     formed once into shared memory for every head of the group; per head
//     the S term of dx (B_j dS_h, a product over N), then per i-tile
//     (i >= j) W (the explicit masked exponent, no factoring: at a real
//     layer's spans a factor about a reference row underflows), G = dy x^T
//     and dx += W^T dy over P, and G's row and column sums into dcums and
//     ddt; dCB sums over the group's heads in a shared strip, written out
//     as the group's partial [B, nc, groups, L, L] when the j-tile is done.
//     Last, one lane a head adds the cd term and takes the reverse cumsum
//     of dcums in order (the plain version's), giving ddt and dA's partial.
//     dcums and what sums it (the row and column sums, the reverse cumsum,
//     dA's partial) are doubles: at a layer's real spans (hundreds) its
//     terms are large and cancel, and float32 sums in a lane's serial order
//     lose more than the plain version's pairwise ones.
//   * ssd_bwd_bc_kernel: a block per (b, chunk, 64 rows, 64 of N) sums the
//     groups' dCB partials in group order and forms dC = dCB B and dB =
//     dCB^T C + the S term (e dt x) dS^T, a product over the heads and P.
// No atomics: every sum runs in a fixed order, and two launches give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 output tile each
constexpr int kT = 64;          // rows and columns of a tile, depth of a stage
constexpr int kLd = kT + 1;     // row stride of a shared tile (odd, so column
                                // reads spread over the banks)
constexpr int kMaxL = 256;
constexpr int kG = kThreads / 32;   // heads of a block: a warp scans each

// dynamic shared memory of ssd_bwd_kernel, in floats
struct Lay {
  static constexpr int cums = 0;                    // [kG][kMaxL]
  static constexpr int dts = cums + kG * kMaxL;     // [kG][kMaxL]
  static constexpr int ddq = dts + kG * kMaxL;      // [kG][kMaxL] ddt, direct
  static constexpr int red = ddq + kG * kMaxL;      // [kT] a tile's s_j
  static constexpr int cb = red + kT;               // [kMaxL][kLd] C B^T strip
  static constexpr int dcb = cb + kMaxL * kLd;      // [kMaxL][kLd] dCB strip
  static constexpr int t0 = dcb + kMaxL * kLd;      // three [kT][kLd] tiles
  static constexpr int t1 = t0 + kT * kLd;
  static constexpr int t2 = t1 + kT * kLd;
  static constexpr int dcm = t2 + kT * kLd;         // [kG][kMaxL] dcums, as
                                                    // doubles (2 floats each)
  static constexpr int total = dcm + 2 * kG * kMaxL;
};

// dst[r][c] = src[r * rs + c] for r < nr, c < ncol, else 0
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int nr, int ncol) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    dst[r * kLd + c] = r < nr && c < ncol ? src[r * rs + c] : 0.f;
  }
}

// acc[r][q] (row ty + 16 r, column tx + 16 q) += sum_k A(row, k) B(k, col),
// A and B tiles of stride kLd:
//   nt: A = a[row][k], B = b[col][k];  nn: A = a[row][k], B = b[k][col];
//   tn: A = a[k][row], B = b[k][col]
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * kLd + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = b[(tx + 16 * q) * kLd + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void mm_nn(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * kLd + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = b[k * kLd + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void mm_tn(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[k * kLd + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = b[k * kLd + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// NPC: 64-column pieces of P (1 for P <= 64, else 2)
template <int NPC>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dy,
               const float* __restrict__ dS, const float* __restrict__ dcd,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dcb_part,
               float* __restrict__ dend, int T, int H, int P, int N, int L,
               int nc, int ngroups, long long sx_b, long long sx_t,
               long long sx_h, long long sb_b, long long sb_t,
               long long sc_b, long long sc_t) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double stot[kG];         // per head: sum_j e_j dt_j u_j . x_j
  float* cums = smem + Lay::cums;
  float* dts = smem + Lay::dts;
  double* dcm = reinterpret_cast<double*>(smem + Lay::dcm);
  float* ddq = smem + Lay::ddq;
  float* red = smem + Lay::red;
  float* cbs = smem + Lay::cb;
  float* dcbs = smem + Lay::dcb;
  float* t0s = smem + Lay::t0;
  float* t1s = smem + Lay::t1;
  float* t2s = smem + Lay::t2;

  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const int b = blockIdx.x / ngroups / nc;
  const int h0 = grp * kG, nh = min(kG, H - h0);
  const int t0 = c * L;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xb = x + b * sx_b + (long long)t0 * sx_t;
  const float* bb = Bm + b * sb_b + (long long)t0 * sb_t;
  const float* cb = Cm + b * sc_b + (long long)t0 * sc_t;
  const long long HP = (long long)H * P;
  const long long row0 = ((long long)b * T + t0) * HP;   // dy / dx at (b, t0)

  // ---- dt of the group and the inclusive cumsum of dt * A, one lane a
  // head, in order: fl(cums_{l-1} + fl(dt_l A)), the forward's roundings --
  for (int idx = tid; idx < kG * L; idx += kThreads) {
    const int l = idx / kG, g = idx % kG;
    dts[g * kMaxL + l] =
        g < nh ? dt[((size_t)b * T + t0 + l) * H + h0 + g] : 0.f;
  }
  for (int idx = tid; idx < kG * kMaxL; idx += kThreads) {
    dcm[idx] = 0.0;
    ddq[idx] = 0.f;
  }
  if (tid < kG) stot[tid] = 0.0;
  __syncthreads();
  if (tid % 32 == 0) {
    const int g = tid / 32;
    const float ah = g < nh ? A[h0 + g] : 0.f;
    float run = 0.f;
    for (int l = 0; l < L; ++l) {
      const float a = __fmul_rn(dts[g * kMaxL + l], ah);
      run = __fadd_rn(run, a);
      cums[g * kMaxL + l] = run;
    }
  }
  __syncthreads();

  const int nt = (L + kT - 1) / kT;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT, nj = min(kT, L - j0);

    // ---- the strip cbs[i][j] = C_i . B_{j0+j}, i in [j0, L) (64-row tiles),
    // and the dCB strip zeroed -------------------------------------------
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * kT, ni = min(kT, L - i0);
      float acc[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += kT) {
        __syncthreads();
        load_tile(t0s, cb + (long long)i0 * sc_t + n0, sc_t, ni,
                  min(kT, N - n0));
        load_tile(t1s, bb + (long long)j0 * sb_t + n0, sb_t, nj,
                  min(kT, N - n0));
        __syncthreads();
        mm_nt(acc, t0s, t1s, ty, tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty + 16 * r, j = tx + 16 * q;
          cbs[i * kLd + j] = acc[r][q];
          dcbs[i * kLd + j] = 0.f;
        }
    }

    for (int g = 0; g < nh; ++g) {
      const int h = h0 + g;
      const float* cg = cums + g * kMaxL;
      const float* dg = dts + g * kMaxL;
      float dxa[NPC][4][4] = {};       // dx rows j0 + ty + 16 r, columns p

      // ---- the S term: u_j = B_j dS_h (over N), u . x_j, dx = e dt u ----
      if (dS != nullptr) {
        const float* dsh = dS + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
#pragma unroll
        for (int pc = 0; pc < NPC; ++pc)
          for (int n0 = 0; n0 < N; n0 += kT) {
            __syncthreads();
            load_tile(t0s, bb + (long long)j0 * sb_t + n0, sb_t, nj,
                      min(kT, N - n0));
            load_tile(t1s, dsh + (size_t)n0 * P + pc * kT, P,
                      min(kT, N - n0), min(kT, P - pc * kT));
            __syncthreads();
            mm_nn(dxa[pc], t0s, t1s, ty, tx);
          }
        float ux[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
#pragma unroll
          for (int pc = 0; pc < NPC; ++pc)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int p = pc * kT + tx + 16 * q;
              if (j < nj && p < P)
                ux[r] = fmaf(dxa[pc][r][q],
                             xb[(long long)(j0 + j) * sx_t + h * sx_h + p],
                             ux[r]);
            }
        }
        // sum over the 16 lanes of a row (tx), a fixed butterfly
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            ux[r] += __shfl_xor_sync(0xffffffffu, ux[r], o);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          const bool ok = j < nj;
          const float e = ok ? expf(cg[L - 1] - cg[j0 + j]) : 0.f;
          const float de = ok ? e * dg[j0 + j] : 0.f;
#pragma unroll
          for (int pc = 0; pc < NPC; ++pc)
#pragma unroll
            for (int q = 0; q < 4; ++q) dxa[pc][r][q] *= de;
          if (tx == 0 && ok) {
            const float s = de * ux[r];
            ddq[g * kMaxL + j0 + j] += e * ux[r];
            dcm[g * kMaxL + j0 + j] -= s;
            red[j] = s;
            dend[((size_t)b * T + t0 + j0 + j) * H + h] = de;
          }
        }
        __syncthreads();
        if (tid == 0) {
          double s = 0.0;
          for (int j = 0; j < nj; ++j) s += red[j];
          stot[g] += s;
        }
      }

      // ---- per i-tile (i >= j): W, G = dy x^T, dx += W^T dy, the sums ----
      for (int it = jt; it < nt; ++it) {
        const int i0 = it * kT, ni = min(kT, L - i0);
        float dec[4][4];
        __syncthreads();   // the tiles of the last step are read
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = ty + 16 * r, j = tx + 16 * q;
            const bool ok = i < ni && j < nj && j0 + j <= i0 + i;
            dec[r][q] = ok ? expf(cg[i0 + i] - cg[j0 + j]) : 0.f;
            t2s[i * kLd + j] =
                ok ? cbs[(i0 + i) * kLd + j] * dec[r][q] * dg[j0 + j] : 0.f;
          }
        float ga[4][4] = {};
#pragma unroll
        for (int pc = 0; pc < NPC; ++pc) {
          if (pc > 0) __syncthreads();
          load_tile(t0s, dy + row0 + (long long)i0 * HP + (long long)h * P +
                             pc * kT,
                    HP, ni, min(kT, P - pc * kT));
          load_tile(t1s, xb + (long long)j0 * sx_t + (long long)h * sx_h +
                             pc * kT,
                    sx_t, nj, min(kT, P - pc * kT));
          __syncthreads();
          mm_nt(ga, t0s, t1s, ty, tx);         // G_ij += dy_i . x_j
          mm_tn(dxa[pc], t2s, t0s, ty, tx);    // dx_jp += W_ij dy_ip
        }
        __syncthreads();   // t0s / t1s are read
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = ty + 16 * r, j = tx + 16 * q;
            const float d = j < nj ? dg[j0 + j] : 0.f;
            const float gd = ga[r][q] * dec[r][q];
            const float qv = gd * cbs[(i0 + i) * kLd + j];
            t0s[i * kLd + j] = qv * d;         // G o W
            t1s[i * kLd + j] = qv;             // G o CB o exp(.)
            dcbs[(i0 + i) * kLd + j] += gd * d;
          }
        __syncthreads();
        if (tid < ni) {
          double s = 0.0;
          for (int j = 0; j < kT; ++j) s += t0s[tid * kLd + j];
          dcm[g * kMaxL + i0 + tid] += s;
        }
        __syncthreads();   // the diagonal tile's rows and columns meet
        if (tid < nj) {
          double s = 0.0;
          for (int i = 0; i < kT; ++i) s += t0s[i * kLd + tid];
          dcm[g * kMaxL + j0 + tid] -= s;
        } else if (tid >= kT && tid - kT < nj) {
          const int j = tid - kT;
          float s = 0.f;
          for (int i = 0; i < kT; ++i) s += t1s[i * kLd + j];
          ddq[g * kMaxL + j0 + j] += s;
        }
      }

#pragma unroll
      for (int pc = 0; pc < NPC; ++pc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = ty + 16 * r, p = pc * kT + tx + 16 * q;
            if (j < nj && p < P)
              dx[row0 + (long long)(j0 + j) * HP + (long long)h * P + p] =
                  dxa[pc][r][q];
          }
    }

    // ---- the group's dCB partial: rows [j0, L), columns [j0, j0 + nj) ----
    __syncthreads();
    float* dcbp =
        dcb_part + (((size_t)b * nc + c) * ngroups + grp) * (size_t)L * L;
    for (int idx = tid; idx < (L - j0) * kT; idx += kThreads) {
      const int i = j0 + idx / kT, j = idx % kT;
      if (j < nj) dcbp[(size_t)i * L + j0 + j] = dcbs[i * kLd + j];
    }
  }

  // ---- per head, one lane, in order: dcums += dcd o exp(cums) (and the S
  // term's sum on the last row); dla = reverse cumsum; ddt; dA's partial --
  __syncthreads();
  if (tid % 32 == 0 && tid / 32 < nh) {
    const int g = tid / 32, h = h0 + g;
    const float ah = A[h];
    const float* cg = cums + g * kMaxL;
    const float* dg = dts + g * kMaxL;
    dcm[g * kMaxL + L - 1] += stot[g];
    double run = 0.0, da = 0.0;
    for (int l = L - 1; l >= 0; --l) {
      const size_t at = ((size_t)b * T + t0 + l) * H + h;
      double dc = dcm[g * kMaxL + l];
      if (dcd != nullptr) dc += dcd[at] * expf(cg[l]);
      run += dc;
      ddt[at] = (float)(ddq[g * kMaxL + l] + run * ah);
      da += run * dg[l];
    }
    dA_part[((size_t)b * nc + c) * H + h] = (float)da;
  }
}

// dC and dB of one (b, chunk, 64 rows, 64 columns of N)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dS,
                  const float* __restrict__ dend,
                  const float* __restrict__ dcb_part, float* __restrict__ dB,
                  float* __restrict__ dC, int T, int H, int P, int N, int L,
                  int nc, int ngroups, long long sx_b, long long sx_t,
                  long long sx_h, long long sb_b, long long sb_t,
                  long long sc_b, long long sc_t) {
  __shared__ float s0[kT * kLd], s1[kT * kLd];
  const int nnk = (N + kT - 1) / kT, nt = (L + kT - 1) / kT;
  int id = blockIdx.x;
  const int nk = id % nnk;
  id /= nnk;
  const int rt = id % nt;
  id /= nt;
  const int c = id % nc, b = id / nc;
  const int r0 = rt * kT, nr = min(kT, L - r0);
  const int n0 = nk * kT, nn = min(kT, N - n0);
  const int t0 = c * L;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* dcbp = dcb_part + ((size_t)b * nc + c) * ngroups * (size_t)L * L;

  // dst[i][j] = sum over groups, in order, of dCB[i0 + i][j0 + j] (j <= i)
  auto load_dcb = [&](float* dst, int i0, int ni, int j0, int nj) {
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      float v = 0.f;
      if (i < ni && j < nj && j0 + j <= i0 + i)
        for (int g = 0; g < ngroups; ++g)
          v += dcbp[((size_t)g * L + i0 + i) * L + j0 + j];
      dst[i * kLd + j] = v;
    }
  };

  float ac[4][4] = {}, ab[4][4] = {};
  // dC rows r0 + i: sum_j dCB_ij B_j
  for (int jt = 0; jt <= rt; ++jt) {
    const int j0 = jt * kT, nj = min(kT, L - j0);
    __syncthreads();
    load_dcb(s0, r0, nr, j0, nj);
    load_tile(s1, Bm + b * sb_b + (long long)(t0 + j0) * sb_t + n0, sb_t, nj,
              nn);
    __syncthreads();
    mm_nn(ac, s0, s1, ty, tx);
  }
  // dB rows r0 + j: sum_i dCB_ij C_i
  for (int it = rt; it < nt; ++it) {
    const int i0 = it * kT, ni = min(kT, L - i0);
    __syncthreads();
    load_dcb(s0, i0, ni, r0, nr);
    load_tile(s1, Cm + b * sc_b + (long long)(t0 + i0) * sc_t + n0, sc_t, ni,
              nn);
    __syncthreads();
    mm_tn(ab, s0, s1, ty, tx);
  }
  // ... + sum_{h, p} e_j dt_j x_jhp dS_h[n][p]
  if (dS != nullptr)
    for (int h = 0; h < H; ++h)
      for (int p0 = 0; p0 < P; p0 += kT) {
        const int np = min(kT, P - p0);
        __syncthreads();
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int j = e / kT, p = e % kT;
          const int t = t0 + r0 + j;
          s0[j * kLd + p] =
              j < nr && p < np
                  ? dend[((size_t)b * T + t) * H + h] *
                        x[b * sx_b + (long long)t * sx_t + h * sx_h + p0 + p]
                  : 0.f;
        }
        load_tile(s1,
                  dS + (((size_t)b * nc + c) * H + h) * (size_t)N * P +
                      (size_t)n0 * P + p0,
                  P, nn, np);
        __syncthreads();
        mm_nt(ab, s0, s1, ty, tx);
      }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ty + 16 * r, n = tx + 16 * q;
      if (i < nr && n < nn) {
        const size_t at = ((size_t)b * T + t0 + r0 + i) * N + n0 + n;
        dC[at] = ac[r][q];
        dB[at] = ab[r][q];
      }
    }
}

template <int NPC>
int launch_main(dim3 grid, cudaStream_t s, const float* x, const float* dt,
                const float* A, const float* Bm, const float* Cm,
                const float* dy, const float* dS, const float* dcd, float* dx,
                float* ddt, float* dA_part, float* dcb_part, float* dend,
                int T, int H, int P, int N, int L, int nc, int ngroups,
                long long sx_b, long long sx_t, long long sx_h,
                long long sb_b, long long sb_t, long long sc_b,
                long long sc_t) {
  const int bytes = Lay::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<NPC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<NPC><<<grid, kThreads, bytes, s>>>(
      x, dt, A, Bm, Cm, dy, dS, dcd, dx, ddt, dA_part, dcb_part, dend, T, H,
      P, N, L, nc, ngroups, sx_b, sx_t, sx_h, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dS, const void* dcd,
    void* dx, void* ddt, void* dA_part, void* dB, void* dC, void* dcb_part,
    void* dend, int Bsz, int T, int H, int P, int N, int L, long long sx_b,
    long long sx_t, long long sx_h, long long sb_b, long long sb_t,
    long long sc_b, long long sc_t, void* stream) {
  if (L < 1 || L > kMaxL || T % L || P < 1 || P > 2 * kT || N < 1 ||
      N > 256 || H < 1 || Bsz < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = T / L;
  const int ngroups = (H + kG - 1) / kG;
  const long long blocks = (long long)Bsz * nc * ngroups;
  const long long blocks2 = (long long)Bsz * nc * ((L + kT - 1) / kT) *
                            ((N + kT - 1) / kT);
  if (blocks > 0x7fffffffLL || blocks2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* bf = (const float*)Bm;
  const float* cf = (const float*)Cm;
  const float* sf = (const float*)dS;
  const int rc =
      P <= kT
          ? launch_main<1>(dim3((unsigned)blocks), s, xf, (const float*)dt,
                           (const float*)A, bf, cf, (const float*)dy, sf,
                           (const float*)dcd, (float*)dx, (float*)ddt,
                           (float*)dA_part, (float*)dcb_part, (float*)dend,
                           T, H, P, N, L, nc, ngroups, sx_b, sx_t, sx_h,
                           sb_b, sb_t, sc_b, sc_t)
          : launch_main<2>(dim3((unsigned)blocks), s, xf, (const float*)dt,
                           (const float*)A, bf, cf, (const float*)dy, sf,
                           (const float*)dcd, (float*)dx, (float*)ddt,
                           (float*)dA_part, (float*)dcb_part, (float*)dend,
                           T, H, P, N, L, nc, ngroups, sx_b, sx_t, sx_h,
                           sb_b, sb_t, sc_b, sc_t);
  if (rc) return rc;
  ssd_bwd_bc_kernel<<<(unsigned)blocks2, kThreads, 0, s>>>(
      xf, bf, cf, sf, (const float*)dend, (const float*)dcb_part, (float*)dB,
      (float*)dC, T, H, P, N, L, nc, ngroups, sx_b, sx_t, sx_h, sb_b, sb_t,
      sc_b, sc_t);
  return (int)cudaGetLastError();
}
