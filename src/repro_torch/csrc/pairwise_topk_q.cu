// B8: quantized per-slot running top-k lists (replaces the Pallas kernel
// repro/kernels/pairwise_batch_q.py:pairwise_topk_q_pallas, body
// _pairwise_topk_q_kernel).
//
// B6 (pairwise_topk.cu) with int8 or bf16 codes: each tile entry is the
// code dot widened to float32 times s_lo * s_hi (the per-slot scales,
// sd[.., 0]), and l2 subtracts the exact stored squared norms sq:
// (2 s - sq_cand) - sq_row.  No error band: the host certifies and
// rescores the lists (core/quant.py).  The selection is B6's, from
// pair_tile.cuh.
//
// Exactness.  int8 products are at most 127^2 and, with d = 128, every
// partial sum stays below 2^24, so the dot is exact in float32 in any
// order, as the plain version's float32 matmul is; this file is compiled
// with -fmad=false, so the dequant epilogue rounds op for op as the plain
// version's does, and the int8 lists equal the plain version's, ties
// included.  bf16 products are exact, their sums round in the kernel's
// order.
//
// Bound on the H100: 2*d operations per candidate pair of an active tile,
// at the int8 (bf16) tensor-core rate; this SIMT kernel runs the float32
// pipe and forms non-self tiles twice.

#include "pair_tile.cuh"

extern "C" int repro_pairwise_topk_q(const void* q, const void* sd,
                                     const void* sq, const void* lo,
                                     const void* hi, const void* meta,
                                     void* list_v, void* list_i, void* out_v,
                                     void* out_i, int P, int k, int block,
                                     int d, int n_pairs, int block_rows,
                                     int topk, int tp, int l2, int bf16,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return pair_tile::launch_topk<__nv_bfloat16, true>(
        (const __nv_bfloat16*)q, (const float*)sd, (const float*)sq,
        (const int*)lo, (const int*)hi, (const int*)meta, (float*)list_v,
        (int*)list_i, (float*)out_v, (int*)out_i, P, k, block, d, n_pairs,
        block_rows, topk, tp, l2, s);
  return pair_tile::launch_topk<int8_t, true>(
      (const int8_t*)q, (const float*)sd, (const float*)sq, (const int*)lo,
      (const int*)hi, (const int*)meta, (float*)list_v, (int*)list_i,
      (float*)out_v, (int*)out_i, P, k, block, d, n_pairs, block_rows, topk,
      tp, l2, s);
}
