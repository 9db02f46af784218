// The three-product TF32 split ("3xTF32") of B9's float32 routes
// (flash_attention.cu, flash_attention_bwd.cu): warp-level products on the
// tensor cores (mma.sync m16n8k8, TF32 in, float32 accumulators) that keep
// the float32 rules.
//
// One TF32 product keeps 10 mantissa bits of each factor: a flash partial
// built on it is 27-48 times over the 1e-5 rule of the f32 partials
// (tests/test_torch_flash_tf32x3.py emulates it).  The split writes each
// float32 operand as x = hi + lo, hi = x rounded to TF32 (nearest, ties
// away: half a TF32 ulp added to the bits, the 13 low ones cleared) and
// lo = x - hi, exact in float32 with |lo| <= 2^-11 |x|; a.b is then
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, accumulated in float32 (the dropped
// a_lo.b_lo is below 2^-22 |a.b|).  lo enters the tensor core as it is:
// the MMA reads a .tf32 operand's top 19 bits, so lo keeps 11 of its own
// bits, about 2^-21 |x| in all (CUTLASS's 3xTF32 takes the same
// shortcut).  A float32 operand that is exact in TF32 (a bfloat16 input
// widened) has lo = 0 and needs no small product: the flags EA / EB below.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32): with g = lane / 4 and t = lane % 4,
//   A [16 x 8] row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                         a3 (g + 8, t + 4);
//   B [8 x 8] (k x n):    b0 (t, g), b1 (t + 4, g);
//   C [16 x 8]:           c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                         c3 (g + 8, 2t + 1).
// A product's C fragments feed the next product's A without a shuffle: the
// sum over k is free to visit the 8 keys of a k-step in any order, so the
// k index t is read as key 2t and t + 4 as key 2t + 1 of C's columns, and
// B's rows are read in the same order (mma_regs).

#pragma once

#include <stdint.h>

namespace tf32x3 {

// x as hi + lo (see above); exact: x is a TF32 value, lo is not formed
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    hi = h;
    lo = __float_as_uint(x - __uint_as_float(h));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool E>
__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2,
                                       float x3) {
  FragA f;
  split<E>(x0, f.hi[0], f.lo[0]);
  split<E>(x1, f.hi[1], f.lo[1]);
  split<E>(x2, f.hi[2], f.lo[2]);
  split<E>(x3, f.hi[3], f.lo[3]);
  return f;
}

template <bool E>
__device__ __forceinline__ FragB frag_b(float x0, float x1) {
  FragB f;
  split<E>(x0, f.hi[0], f.lo[0]);
  split<E>(x1, f.hi[1], f.lo[1]);
  return f;
}

// d += a.b as the split's products, the small ones first
template <bool EA, bool EB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!EA) mma(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!EB) mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// acc[nt] += A B_nt^T over the k-steps [ks0, ks1): A the warp's 16 rows of a
// float tile at pa (row stride LD, columns = k), B_nt rows nt * 8 .. + 7 of
// a float tile at pb (row stride LD, columns = k); A's values times sa.
// The tensor core sums CH k-steps at a time into a zeroed temp, which is
// then added to acc in float32 (round to nearest): the MMA's own
// accumulation rounds toward zero, and a long sum of one sign kept in its
// accumulator drifts by about an ulp an instruction (an f32 partial's l
// at hd 256 over 4,096 keys was off by 1.109e-5 relative that way, past
// its 1e-5 rule).  With LD = 4 (mod 32) both
// fragments' loads are free of bank conflicts.
template <int NT, int LD, bool EA, bool EB, int CH>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const float* pa,
                                         const float* pb, int ks0, int ks1,
                                         float sa) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a = pa + g * LD + t;
  const float* bp = pb + g * LD + t;
  for (int c0 = ks0; c0 < ks1; c0 += CH) {
    float tmp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      if (c0 + u >= ks1) break;
      const int c = (c0 + u) * 8;
      const FragA fa = frag_a<EA>(a[c] * sa, a[8 * LD + c] * sa,
                                  a[c + 4] * sa, a[8 * LD + c + 4] * sa);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b = bp + nt * 8 * LD + c;
        mma3<EA, EB>(tmp[nt], fa, frag_b<EB>(b[0], b[4]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
  }
}

// acc[nd] = acc[nd] * mul[r] + P X_nd for nd < nnd (r = 0 for C fragments
// 0, 1 and 1 for 2, 3): P [16 x 8 NJ] the C fragments p of an earlier
// product (its columns the k of this one), X the rows 0 .. 8 NJ - 1 of a
// float tile at pb (row stride LD) and columns nd * 8 .. + 7.  Each
// n-tile's product is summed by the tensor core into a zeroed temp and
// joined to acc by one fmaf (round to nearest).  With LD = 4 (mod 16) B's
// loads are free of bank conflicts.
template <int NJ, int ND, int LD, bool EB>
__device__ __forceinline__ void mma_regs(float (&acc)[ND][4],
                                         const float (&p)[NJ][4],
                                         const float* pb, int nnd,
                                         const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* bp = pb + 2 * t * LD + g;
  FragA fa[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    fa[j] = frag_a<false>(p[j][0], p[j][2], p[j][1], p[j][3]);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (nd >= nnd) continue;
    float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b = bp + j * 8 * LD + nd * 8;
      mma3<false, EB>(tmp, fa[j], frag_b<EB>(b[0], b[LD]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nd][e] = fmaf(acc[nd][e], mul[e / 2], tmp[e]);
  }
}

// ---- warpgroup products (wgmma) on TF32 ----
// The accumulator layout of m64nN (f32) is m16n8's per warp: thread t of
// the warpgroup holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 +
// 8 (e / 2), column 8j + 2 (t % 4) + e % 2; TF32 operands from shared
// memory must be K-major.

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32: A in registers (the
// m16n8k8 A fragment of each warp's 16 rows), B K-major in shared memory;
// scale_d 0 writes A B over D
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in TF32: A in registers (the
// m16n8k8 A fragment of each warp's 16 rows), B K-major in shared memory;
// scale_d 0 writes A B over D
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace tf32x3
