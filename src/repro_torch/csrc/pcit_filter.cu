// B3: PCIT significance filter (replaces the Pallas kernel
// repro/kernels/pcit_filter.py:pcit_filter_pallas, body _pcit_kernel).
//
// keep[b, x, y] = NOT any over z of explained(x, y, z), where z runs over
// the columns of the correlation rows (the global gene ids), z = gx[x] and
// z = gy[y] are excluded, and the diagonal gx[x] == gy[y] is always kept:
//   explained = |r_xy| <= |eps * r_xz|  and  |r_xy| <= |eps * r_yz|,
//   eps = mean of the three partial-correlation ratios.
// visits[b, x, y] (optional) is the first explaining z + 1, Z for a kept
// edge and 0 on the diagonal: the trios the search needs.
//
// Design.  The TPU kernel evaluates every z and OR-reduces; here a pair's
// search stops at its first explaining z, as the reference's loop does.
// Searches are short or very long: at PCIT's main-path shape (40 tiles of
// 1,024 x 1,024 pairs, Z = 8,192) 30 % of the pairs stop at z = 0 and half
// by z = 3, while a kept edge (1.3 % of the pairs) runs all 8,192 z and
// makes 54 % of the trios (scripts/pcit_visits.py).  So one block of 8
// warps owns 8 x 32 pairs and searches in two phases:
//
//   1. each pair's own thread tries z < kHead (8), from rows staged in
//      shared memory, the per-element terms hoisted there;
//   2. the pairs still searching go, in warp order, into a list in shared
//      memory, and each warp takes the next pair from it (an integer
//      shared counter) and runs 32 consecutive z of that pair a step, one
//      on each lane, streaming the pair's two rows from L2 (one aligned
//      128-byte line a row a step, from z = 0 with the lanes below kHead
//      idle in the first step; the next step's loads in flight).
//      __ballot_sync / __ffs give the first explaining z exactly, and the
//      warp leaves the pair at once.
//
// A kept edge thus runs 32 useful trios a step, not about one, and no
// warp holds idle lanes while another pair of it searches on.  Split at
// 8 z, the lanes issue 1.06x the visited trios (lanes from z = 0: 1.13x;
// a split at 32: 1.13x, at 128: 1.55x).  Phase 2 streams each pair's rows
// rather than staging the block's strips a window at a time: most of its
// trios belong to the block's few kept edges (about 3 of its 256 pairs),
// so a staged strip element would serve one live pair or none, and
// staging (and hoisting an element's terms once) would save little and
// cost a barrier a window.
//
// Exactness.  The output is a decision, so rounding flips edges: this file
// is compiled with -fmad=false and IEEE sqrtf / division, and the exact
// chain (exact_explains) is the plain version's elementwise ops, one
// rounding each in its order; 1 - r^2 and r + 1e-12 of each row element
// are hoisted with the same single-rounding operations, so their bits are
// those the chain would compute.
//
// Prefilter (kPre).  Most trios are far from their boundary.  With
// rsqrt.approx / rcp.approx of the hoisted terms (relative error at most
// d = 2^-22 each: PTX ISA, 2^-22.9 for rsqrt, 1 ulp for rcp), the trio's
// eps costs multiplications only, and a trio is decided without the exact
// chain wherever the approximate margin exceeds its error bound:
//
//   t1' = ((a - bc) q_b) q_c g_a,  t2' = ((b - ac) q_a) q_c g_b,
//   t3' = ((c - ab) q_a) q_b g_c,  q_r ~ (1 - r^2)^-1/2, g_r ~ 1/(r + 1e-12)
//   E' = ((t1' + t2') + t3') / 3,  W = (|t1'| + |t2'|) + |t3'|
//   m = min(|b|, |c|),  lo = (|E'| - tau W) m,  hi = (|E'| + tau W) m
//   explained if lo > |a|;  not explained if hi < |a|;  else exact chain.
//
// Proof, with u = 2^-24 and tau = 2^-19.  Domain: |a|, |b|, |c| in
// [2^-20, 1 - 2^-10]; outside it g is NaN, every comparison fails and the
// exact chain decides (this covers |r| near 1, where the chain clamps
// 1 - r^2 products at 1e-12, r + 1e-12 near 0, NaN and Inf).  Inside it
// every intermediate is a normal float (products >= 2^-40, differences 0
// or >= 2^-64, no term above 2^31) and no clamp is active (1 - r^2 >=
// 2^-9.1).  The numerators are the chain's own floats.  Let R_i be a
// term's real value n_i / (sqrt(D_i) A_i) from the chain's n_i, D_i, A_i.
// The chain's t_i = R_i (1 + e), |e| <= 3.01 u (sqrt, two divisions).
// t_i' = R_i (1 + e'), |e'| <= (1 + d)^3 (1 + u)^3.5 - 1 <= 9.3e-7 (two
// rsqrts and one rcp; three products; D_i's own rounding, under a square
// root).  The two three-term sums each err by at most 2.01 u times the
// sum of magnitudes, and the products by 1/3 by u.  So |E - E'| <= (1/3)
// (9.3e-7 + 3.01 u + 4.02 u + 2 u) sum|R_i| <= 4.91e-7 W =: k W (W >=
// sum|R_i| / (1 + 1e-6)).  The chain's |fl(E b)| lies in |E| |b| (1 -+ u).
// Computed lo <= (|E'| - tau W)(1 + u)^2 m <= (|E'| - k W)(1 - u) m when
// 3.01 u |E'| <= (tau - k) W, which holds as |E'| <= 0.34 W: then lo > |a|
// gives |fl(E b)| > |a| and |fl(E c)| > |a|, explained.  Computed hi >=
// (|E'| + tau W)(1 - u)^2 m >= (|E'| + k W)(1 + u) m >= |fl(E r)| for r the
// one of b, c with |r| = m: hi < |a| makes that test fail, not explained.
// tau W is exact (tau a power of two).  tests/test_torch_pcit.py checks the
// bound against a model with the worst approximations, and
// tests/test_torch_kernels_gpu.py the kernel's own prefilter on trios
// packed around their boundaries.
//
// Bound on the H100: fp32 arithmetic outside the tensor cores; the repo
// counts 36 operations per visited trio (chip_smoke.py's PCIT_OPS).  The
// rows are streamed from L2, not device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;     // x per block
constexpr int kCols = 32;    // y per block (one warp shares one x)
constexpr int kThreads = kRows * kCols;
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 8;     // z a pair's own thread tries (phase 1)
constexpr float kEps = 1e-12f;
constexpr float kDomLo = 0x1p-20f;        // the prefilter's domain of |r|
constexpr float kDomHi = 1.f - 0x1p-10f;
constexpr float kTau = 0x1p-19f;          // its error bound per unit of W

// stats[]: lane-trios issued, trios the prefilter decided, trios the
// exact chain decided
enum { kIssued, kDecided, kExact };

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool in_domain(float r) {
  const float m = fabsf(r);
  return m >= kDomLo && m <= kDomHi;
}

// a row element's hoisted terms: (r, 1 - r^2 with the chain's bits,
// ~(1 - r^2)^-1/2, ~1/(r + 1e-12) or NaN outside the prefilter's domain)
__device__ __forceinline__ float4 hoist(float r) {
  const float om = 1.f - r * r;
  const float g = in_domain(r) ? rcp_approx(r + kEps) : __int_as_float(0x7fffffff);
  return make_float4(r, om, rsqrt_approx(om), g);
}

// a pair's terms: r_xy, |r_xy|, 1 - r_xy^2, r_xy + 1e-12 (the chain's
// bits), ~(1 - r_xy^2)^-1/2, ~1/(r_xy + 1e-12) or NaN
struct Pair {
  float a, aa, om, ae, q, g;
};

__device__ __forceinline__ Pair make_pair(float a) {
  Pair p;
  p.a = a;
  p.aa = fabsf(a);
  p.om = 1.f - a * a;
  p.ae = a + kEps;
  p.q = rsqrt_approx(p.om);
  p.g = in_domain(a) ? rcp_approx(p.ae) : __int_as_float(0x7fffffff);
  return p;
}

// The plain version's chain, op for op (X = (r_xz, 1 - r_xz^2, ..),
// Y = (r_yz, 1 - r_yz^2, ..)).
__device__ __forceinline__ bool exact_explains(const Pair& p, float4 X,
                                               float4 Y) {
  const float b = X.x, c = Y.x;
  const float den_z = sqrtf(fmaxf(X.y * Y.y, kEps));
  const float rxy_z = (p.a - b * c) / den_z;
  const float den_y = sqrtf(fmaxf(p.om * Y.y, kEps));
  const float rxz_y = (b - p.a * c) / den_y;
  const float den_x = sqrtf(fmaxf(p.om * X.y, kEps));
  const float ryz_x = (c - p.a * b) / den_x;
  // PyTorch's CUDA division by a scalar multiplies by its float
  // reciprocal, and the plain version's "/ 3.0" rounds that way
  const float eps =
      (rxy_z / p.ae + rxz_y / (b + kEps) + ryz_x / (c + kEps)) * (1.f / 3.f);
  return p.aa <= fabsf(eps * b) && p.aa <= fabsf(eps * c);
}

// 1: explained, 0: not explained, -1: too close to call (see the header)
__device__ __forceinline__ int prefilter(const Pair& p, float4 X, float4 Y) {
  const float b = X.x, c = Y.x;
  const float t1 = (((p.a - b * c) * X.z) * Y.z) * p.g;
  const float t2 = (((b - p.a * c) * p.q) * Y.z) * X.w;
  const float t3 = (((c - p.a * b) * p.q) * X.z) * Y.w;
  const float e = fabsf(((t1 + t2) + t3) * (1.f / 3.f));
  const float bd = ((fabsf(t1) + fabsf(t2)) + fabsf(t3)) * kTau;
  const float m = fminf(fabsf(b), fabsf(c));
  if ((e - bd) * m > p.aa) return 1;
  if ((e + bd) * m < p.aa) return 0;
  return -1;
}

// One trio's decision; n_dec / n_ex count who made it (kStats).
template <bool kPre>
__device__ __forceinline__ bool explains(const Pair& p, float4 X, float4 Y,
                                         unsigned& n_dec, unsigned& n_ex) {
  if (kPre) {
    const int v = prefilter(p, X, Y);
    if (v >= 0) {
      ++n_dec;
      return v == 1;
    }
  }
  ++n_ex;
  return exact_explains(p, X, Y);
}

template <bool kPre, bool kStats>
__global__ void __launch_bounds__(kThreads)
pcit_kernel(const float* __restrict__ r_xy,    // [batch, M, N]
            const float* __restrict__ rows_x,  // [batch, M, Z]
            const float* __restrict__ rows_y,  // [batch, N, Z]
            const int* __restrict__ gx,        // [batch, M]
            const int* __restrict__ gy,        // [batch, N]
            unsigned char* __restrict__ keep,  // [batch, M, N]
            int* __restrict__ visits,          // [batch, M, N] or null
            unsigned long long* __restrict__ stats,  // [3] (kStats)
            int M, int N, int Z) {
  const size_t bz = blockIdx.z;
  const int x0 = blockIdx.y * kRows;
  const int y0 = blockIdx.x * kCols;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* rx = rows_x + bz * M * Z;
  const float* ry = rows_y + bz * N * Z;
  __shared__ float4 xe[kHead][kRows];
  __shared__ float4 ye[kHead][kCols];
  __shared__ unsigned char live[kThreads];  // the pairs still searching
  __shared__ int warp_live[kWarps];
  __shared__ int n_live, next;
  unsigned n_issued = 0, n_dec = 0, n_ex = 0;

  // ---- phase 1: z < kHead, a thread per pair ----
  const int zh = min(kHead, Z);
  for (int idx = tid; idx < (kRows + kCols) * kHead; idx += kThreads) {
    const int r = idx / kHead, zz = idx % kHead;
    const bool isx = r < kRows;
    const int row = isx ? x0 + r : y0 + r - kRows;
    const bool ok = zz < zh && row < (isx ? M : N);
    const float v = ok ? (isx ? rx : ry)[(size_t)row * Z + zz] : 0.f;
    if (isx)
      xe[zz][r] = hoist(v);
    else
      ye[zz][r - kRows] = hoist(v);
  }
  if (tid == 0) next = 0;
  __syncthreads();

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  const bool inside = x < M && y < N;
  const int gxv = inside ? gx[bz * M + x] : -1;
  const int gyv = inside ? gy[bz * N + y] : -1;
  // the diagonal is kept whatever z says, so it needs no search
  bool searching = inside && gxv != gyv;
  int visited = 0;   // first explaining z + 1, 0 while none
  if (searching) {
    const Pair p = make_pair(r_xy[(bz * M + x) * N + y]);
    int zz = 0;
    for (; zz < zh; ++zz) {
      if (zz == gxv || zz == gyv) continue;
      if (explains<kPre>(p, xe[zz][threadIdx.y], ye[zz][threadIdx.x], n_dec,
                         n_ex)) {
        visited = zz + 1;
        searching = false;
        break;
      }
    }
    if (kStats) n_issued = min(zz + 1, zh);
  }
  if (kStats) n_issued = 32 * __reduce_max_sync(0xffffffffu, n_issued);

  // ---- the pairs past kHead, in warp order ----
  const bool more = searching && zh < Z;
  const unsigned mine = __ballot_sync(0xffffffffu, more);
  if (lane == 0) warp_live[warp] = __popc(mine);
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_live[w];
  if (more) live[base + __popc(mine & ((1u << lane) - 1u))] = (unsigned char)tid;
  if (tid == kThreads - 1) n_live = base + __popc(mine);
  if (inside && !more) {
    const size_t o = (bz * M + x) * N + y;
    keep[o] = visited ? 0 : 1;
    if (visits != nullptr) visits[o] = gxv == gyv ? 0 : (visited ? visited : Z);
  }
  __syncthreads();

  // ---- phase 2: a warp per pair, 32 z a step ----
  for (;;) {
    int s = 0;
    if (lane == 0) s = atomicAdd(&next, 1);
    s = __shfl_sync(0xffffffffu, s, 0);
    if (s >= n_live) break;
    const int t = live[s];
    const int px = x0 + t / kCols, py = y0 + t % kCols;
    const size_t o = (bz * M + px) * N + py;
    const Pair p = make_pair(r_xy[o]);
    const int pgx = gx[bz * M + px], pgy = gy[bz * N + py];
    const float* __restrict__ fx = rx + (size_t)px * Z;
    const float* __restrict__ fy = ry + (size_t)py * Z;
    int found = 0;
    int z = lane;   // z < kHead was phase 1's
    float bn = z < Z ? __ldg(fx + z) : 0.f;
    float cn = z < Z ? __ldg(fy + z) : 0.f;
    for (int z0 = 0; z0 < Z; z0 += 32, z += 32) {
      const float b = bn, c = cn;
      if (z + 32 < Z) {   // the next step's loads in flight
        bn = __ldg(fx + z + 32);
        cn = __ldg(fy + z + 32);
      }
      bool hit = false;
      if (z >= kHead && z < Z && z != pgx && z != pgy)
        hit = explains<kPre>(p, hoist(b), hoist(c), n_dec, n_ex);
      if (kStats) n_issued += 32;
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (bits) {
        found = z0 + __ffs(bits);
        break;
      }
    }
    if (lane == 0) {
      keep[o] = found ? 0 : 1;
      if (visits != nullptr) visits[o] = found ? found : Z;
    }
  }

  if (kStats) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_dec += __shfl_xor_sync(0xffffffffu, n_dec, off);
      n_ex += __shfl_xor_sync(0xffffffffu, n_ex, off);
    }
    if (lane == 0) {   // n_issued: already the warp's lane-trios
      atomicAdd(stats + kIssued, (unsigned long long)n_issued);
      atomicAdd(stats + kDecided, (unsigned long long)n_dec);
      atomicAdd(stats + kExact, (unsigned long long)n_ex);
    }
  }
}

// Trio by trio, for tests and for reading the SASS of one decision:
// exact_probe writes the exact chain's verdict, prefilter_probe the
// prefilter's (1 explained, 0 not, -1 undecided).
__global__ void exact_probe(const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ c, int* __restrict__ out,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = exact_explains(make_pair(a[i]), hoist(b[i]), hoist(c[i]));
}

__global__ void prefilter_probe(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ c,
                                int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = prefilter(make_pair(a[i]), hoist(b[i]), hoist(c[i]));
}

template <bool kPre, bool kStats>
int launch(const void* r_xy, const void* rows_x, const void* rows_y,
           const void* gx, const void* gy, void* keep, void* visits,
           void* stats, int batch, int M, int N, int Z, cudaStream_t s) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, batch);
  pcit_kernel<kPre, kStats><<<grid, dim3(kCols, kRows), 0, s>>>(
      (const float*)r_xy, (const float*)rows_x, (const float*)rows_y,
      (const int*)gx, (const int*)gy, (unsigned char*)keep, (int*)visits,
      (unsigned long long*)stats, M, N, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// prefilter: 1 runs the prefilter in front of the exact chain, 0 the exact
// chain alone; stats (null on the main path): [3] uint64 counters,
// zeroed by the caller
extern "C" int repro_pcit_filter(const void* r_xy, const void* rows_x,
                                 const void* rows_y, const void* gx,
                                 const void* gy, void* keep, void* visits,
                                 void* stats, int batch, int M, int N, int Z,
                                 int prefilter, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto fn = prefilter ? (stats ? launch<true, true> : launch<true, false>)
                            : (stats ? launch<false, true>
                                     : launch<false, false>);
  return fn(r_xy, rows_x, rows_y, gx, gy, keep, visits, stats, batch, M, N, Z,
            s);
}

// exact: 1 the exact chain's verdicts, 0 the prefilter's
extern "C" int repro_pcit_probe(const void* a, const void* b, const void* c,
                                void* out, int n, int exact, void* stream) {
  const int blocks = (n + 255) / 256;
  if (blocks == 0) return 0;
  if (exact)
    exact_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)c, (int*)out, n);
  else
    prefilter_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)c, (int*)out, n);
  return (int)cudaGetLastError();
}
