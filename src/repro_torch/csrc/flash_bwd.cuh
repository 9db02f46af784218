// B9 backward: the per-pair rule both backward kernels share
// (flash_attention_bwd.cu, TF32 mma.sync; flash_attention_bwd_tc.cu,
// wgmma).
#pragma once

namespace flash_bwd {

// P and dS of query i, key j from the unscaled score s and dP, with the
// forward's masks: 0 past Tq or Tk and on a masked key; a row that sees no
// key at all (causal, i + Tk - Tq < 0) averaged v over every key, so its
// P is 1 / Tk and its dS 0 (the plain softmax's where() passes no gradient
// to a masked score).
__device__ __forceinline__ void p_ds(float s, float dp, int i, int j, int Tq,
                                     int Tk, int off, int causal, float scale,
                                     float lse, float d, float inv_tk,
                                     float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (i >= Tq || j >= Tk) return;
  if (causal && i + off < 0) {
    p = inv_tk;
    return;
  }
  if (causal && j > i + off) return;
  p = expf(s * scale - lse);
  ds = p * (dp - d);
}

}  // namespace flash_bwd
