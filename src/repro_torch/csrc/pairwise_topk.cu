// B6: per-slot running top-k lists over the scheduled pair tiles, the
// k-NN graph's batched step (replaces the Pallas kernel
// repro/kernels/pairwise_topk.py:pairwise_topk_pallas, body
// _pairwise_topk_kernel with _merge_rows).
//
// For every simulated device p and scheduled slot pair (lo, hi) whose
// meta row (active, is_self, ga, gb, nv_lo, nv_hi) is active, the rows of
// slot lo take the hi block's rows c < nv_hi as neighbour candidates
// (c != r on a self tile) and, on a non-self tile, the rows of slot hi
// take the lo block's rows r < nv_lo; each row keeps its topk best
// candidates under the (-score, index) order, with (NEG_INF,
// IDX_SENTINEL) padding.  Scores are the dot or the l2 score
// (2 dot - |cand|^2) - |row|^2.
//
// Design.  The TPU kernel walks the pairs in order on its sequential grid
// and merges each tile into a VMEM accumulator with topk rounds of
// extract-max.  Here one block owns one (device, slot, 64-row tile): it
// walks the pairs in order and scores every tile that touches its slot
// from its own side (B1's ownership pattern: no atomics, deterministic),
// so a non-self tile is formed twice, once per side.  Both orientations
// run the same fmaf chain over d, and each row's norm is computed once in
// a fixed order, so (u, v) and (v, u) score bit-identically.  Each row's
// list lives in global memory (any topk), behind its current worst entry
// (B4's admission rule); a second pass sorts the lists (pair_tile.cuh).
//
// Bound on the H100: fp32 arithmetic outside the tensor cores, 2*d
// operations per candidate pair of an active tile; this design does
// twice that on non-self tiles.

#include "pair_tile.cuh"

extern "C" int repro_pairwise_topk(const void* quorum, const void* lo,
                                   const void* hi, const void* meta,
                                   void* list_v, void* list_i, void* out_v,
                                   void* out_i, int P, int k, int block,
                                   int d, int n_pairs, int block_rows,
                                   int topk, int tp, int l2, void* stream) {
  return pair_tile::launch_topk<float, false>(
      (const float*)quorum, nullptr, nullptr, (const int*)lo,
      (const int*)hi, (const int*)meta, (float*)list_v, (int*)list_i,
      (float*)out_v, (int*)out_i, P, k, block, d, n_pairs, block_rows, topk,
      tp, l2, (cudaStream_t)stream);
}
