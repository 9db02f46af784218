// Top-k selection shared by B4 query_topk, B6 pairwise_topk, B8
// pairwise_topk_q: the (-score, index) total order, the running lists,
// and the block's candidate queues that feed them.
//
// Running list.  A list of n (value, index) entries, unordered, in shared
// or global memory, admits a candidate only if it beats the list's
// current worst entry; once the list is full, few candidates do.  It
// always holds the n best of everything offered, whatever the order of
// the offers (identical entries included), so the result does not depend
// on which thread offered first.  A warp owns a list (warp_offer), or, in
// the queue drains of short lists, a thread.
//
// Candidate queues (B4, B6, B8).  After a score tile, every thread compares
// each of its scores in registers against its list's admission bound
// (the worst entry once the list is full, else (NEG_INF, SENTINEL)), kept
// in shared memory.  The scores that beat it claim slots of the list's
// queue, the lanes that share the list together, by one integer
// atomicAdd on a shared counter; a full queue leaves a candidate pending.
// Once a queue is half full or a candidate is pending, the queued entries
// are offered to the lists (a thread per list for short lists in shared
// memory, a warp per list for long ones in global memory, held in its
// registers for the drain up to 512 entries), and the tile's
// pending candidates try again; else the queues carry over to the next
// tile behind their bounds, which are then merely looser.  No float
// atomics.

#pragma once

#include <cuda_runtime.h>

namespace topk_select {

constexpr float kNegInf = -1e30f;
constexpr int kSentinel = 0x7fffffff;

// true iff (va, ia) comes before (vb, ib) in the (-score, index) order
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The worst entry of a list of n (the last in the order; of equal ones
// the highest position).  Every lane returns the same (value, index,
// position).
__device__ __forceinline__ void warp_worst(const float* v, const int* ix,
                                           int n, float& wv, int& wi,
                                           int& wp) {
  const int lane = threadIdx.x & 31;
  wv = 3.0e38f;
  wi = -1;
  wp = -1;
  for (int t = lane; t < n; t += 32) {
    const float a = v[t];
    const int b = ix[t];
    if (wp < 0 || before(wv, wi, a, b) || (a == wv && b == wi)) {
      wv = a;
      wi = b;
      wp = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
    const int op = __shfl_xor_sync(0xffffffffu, wp, off);
    const bool take = op >= 0 && (wp < 0 || before(wv, wi, ov, oi) ||
                                  (ov == wv && oi == wi && op > wp));
    if (take) {
      wv = ov;
      wi = oi;
      wp = op;
    }
  }
}

// Offer one candidate per lane to the warp's list (v, ix) of n entries,
// `filled` of them set; the list keeps the n best offers, (wv, wi, wp) its
// worst once full.  __syncwarp orders lane 0's writes before the reads.
__device__ __forceinline__ void warp_offer(float cv, int ci, float* v,
                                           int* ix, int n, int& filled,
                                           float& wv, int& wi, int& wp) {
  const int lane = threadIdx.x & 31;
  const bool real = before(cv, ci, kNegInf, kSentinel);
  const bool want = filled < n ? real : before(cv, ci, wv, wi);
  unsigned bits = __ballot_sync(0xffffffffu, want);
  while (bits) {
    const int src = __ffs(bits) - 1;
    bits &= bits - 1;
    const float sv = __shfl_sync(0xffffffffu, cv, src);
    const int si = __shfl_sync(0xffffffffu, ci, src);
    if (filled < n) {
      if (lane == 0) {
        v[filled] = sv;
        ix[filled] = si;
      }
      ++filled;
      __syncwarp();
      if (filled == n) warp_worst(v, ix, n, wv, wi, wp);
    } else if (before(sv, si, wv, wi)) {
      if (lane == 0) {
        v[wp] = sv;
        ix[wp] = si;
      }
      __syncwarp();
      warp_worst(v, ix, n, wv, wi, wp);
    }
  }
}

// While the warp's list has room, append the lanes' real candidates
// together (the first n - filled of them); true for a lane whose
// candidate went in.  The worst entry is found once the list is full.
__device__ __forceinline__ bool warp_fill(float cv, int ci, float* v, int* ix,
                                          int n, int& filled, float& wv,
                                          int& wi, int& wp) {
  const int lane = threadIdx.x & 31;
  const bool real = before(cv, ci, kNegInf, kSentinel);
  const unsigned bits = __ballot_sync(0xffffffffu, real);
  const int rank = __popc(bits & ((1u << lane) - 1u));
  const int room = n - filled;
  const bool in = real && rank < room;
  if (in) {
    v[filled + rank] = cv;
    ix[filled + rank] = ci;
  }
  filled += min(__popc(bits), room);
  __syncwarp();
  if (filled == n) warp_worst(v, ix, n, wv, wi, wp);
  return in;
}

// The queues and list states of a block's R lists (shared memory).  The
// queue of list r holds entries (qv[t][r], qi[t][r]), t < kCap.
template <int R, int kCap>
struct Queues {
  float bound_v[R];  // admission bound: the worst entry once full
  int bound_i[R];
  float worst_v[R];  // the list's state between drains
  int worst_i[R], worst_p[R], filled[R];
  int count[R];      // claimed queue slots (may pass kCap: then full)
  float qv[kCap][R];
  int qi[kCap][R];

  // every list empty; the caller synchronizes before the first use
  __device__ __forceinline__ void init(int tid, int nthreads) {
    for (int r = tid; r < R; r += nthreads) {
      bound_v[r] = kNegInf;
      bound_i[r] = kSentinel;
      worst_v[r] = kNegInf;
      worst_i[r] = kSentinel;
      worst_p[r] = 0;
      filled[r] = 0;
      count[r] = 0;
    }
  }

  // Slots for n entries of this thread in list r's queue, claimed with
  // the kWidth aligned lanes that share list r by one atomicAdd: returns
  // the first slot (slots kCap and above are not there).  Every lane of
  // the warp calls it.
  template <int kWidth>
  __device__ __forceinline__ int claim(int r, int n) {
    const int sub = (threadIdx.x & 31) % kWidth;
    int incl = n;
#pragma unroll
    for (int off = 1; off < kWidth; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off, kWidth);
      if (sub >= off) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, kWidth - 1, kWidth);
    int base = 0;
    if (sub == kWidth - 1 && total > 0) base = atomicAdd(&count[r], total);
    base = __shfl_sync(0xffffffffu, base, kWidth - 1, kWidth);
    return base + incl - n;
  }

  __device__ __forceinline__ void put(int pos, int r, float v, int i) {
    qv[pos][r] = v;
    qi[pos][r] = i;
  }

  // list r's state after a drain (filled f of n, worst (wv, wi) at wp)
  // and its bound; its queue is empty again
  __device__ __forceinline__ void publish(int r, int f, int n, float wv,
                                          int wi, int wp) {
    filled[r] = f;
    worst_v[r] = wv;
    worst_i[r] = wi;
    worst_p[r] = wp;
    bound_v[r] = f < n ? kNegInf : wv;
    bound_i[r] = f < n ? kSentinel : wi;
    count[r] = 0;
  }

  // Short lists in shared memory, entry t of list r at (lv[t * R + r],
  // li[t * R + r]): thread r of the block offers list r's queued entries
  // one by one, rescanning its n entries for the worst after each change.
  // Between two block barriers; threads R and above do nothing.
  __device__ __forceinline__ void drain_threads(float* lv, int* li, int n) {
    const int r = threadIdx.x;
    if (r >= R) return;
    const int c = min(count[r], kCap);
    if (c == 0) return;
    int f = filled[r], wi = worst_i[r], wp = worst_p[r];
    float wv = worst_v[r];
    for (int t = 0; t < c; ++t) {
      const float cv = qv[t][r];
      const int ci = qi[t][r];
      if (f < n) {
        lv[f * R + r] = cv;
        li[f * R + r] = ci;
        if (++f < n) continue;
      } else if (before(cv, ci, wv, wi)) {
        lv[wp * R + r] = cv;
        li[wp * R + r] = ci;
      } else {
        continue;
      }
      wv = lv[r];
      wi = li[r];
      wp = 0;
#pragma unroll 8
      for (int u = 1; u < n; ++u) {
        const float a = lv[u * R + r];
        const int b = li[u * R + r];
        if (before(wv, wi, a, b)) {
          wv = a;
          wi = b;
          wp = u;
        }
      }
    }
    publish(r, f, n, wv, wi, wp);
  }

  // Long lists (global memory), list r at (lv + r * stride, li + r *
  // stride): warp `warp` of `nwarps` offers the queued entries of lists
  // warp, warp + nwarps, ... to them: appended together while a list has
  // room (warp_fill), then, for lists of up to 32 * kRegs entries, against
  // the list held in registers for the drain (lane l holds entries l,
  // l + 32, ...; each lane keeps its worst, so an admitted entry costs a
  // shuffle reduction and one lane's rescan, not a pass through L2), else
  // through warp_offer.  Between two block barriers.
  static constexpr int kRegs = 16;

  __device__ __forceinline__ void drain_warps(int warp, int nwarps, float* lv,
                                              int* li, size_t stride, int n) {
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += nwarps) {
      const int c = min(count[r], kCap);
      if (c == 0) continue;
      int f = filled[r], wi = worst_i[r], wp = worst_p[r];
      float wv = worst_v[r];
      float* v = lv + r * stride;
      int* ix = li + r * stride;
      int t0 = 0;   // the queued entries before t0 are offered
      if (f < n) {
        for (; t0 < c && f < n; t0 += 32) {
          const int t = t0 + lane;
          float cv = t < c ? qv[t][r] : kNegInf;
          int ci = t < c ? qi[t][r] : kSentinel;
          if (warp_fill(cv, ci, v, ix, n, f, wv, wi, wp)) {
            cv = kNegInf;   // appended
            ci = kSentinel;
          }
          warp_offer(cv, ci, v, ix, n, f, wv, wi, wp);
        }
      }
      if (t0 < c && n > 32 * kRegs) {   // too long for the registers
        for (; t0 < c; t0 += 32) {
          const int t = t0 + lane;
          warp_offer(t < c ? qv[t][r] : kNegInf, t < c ? qi[t][r] : kSentinel,
                     v, ix, n, f, wv, wi, wp);
        }
      } else if (t0 < c) {
        offer_in_registers(r, t0, c, v, ix, n, wv, wi, wp);
      }
      __syncwarp();
      if (lane == 0) publish(r, f, n, wv, wi, wp);
    }
  }

  // The queued entries t0 .. c - 1 of list r offered to its full list of
  // n <= 32 * kRegs entries (v, ix), held in registers meanwhile; the
  // changed entries are written back and (wv, wi, wp) is the new worst.
  __device__ __forceinline__ void offer_in_registers(int r, int t0, int c,
                                                     float* v, int* ix, int n,
                                                     float& wv, int& wi,
                                                     int& wp) {
    const int lane = threadIdx.x & 31;
    float rv[kRegs];
    int ri[kRegs];
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int t = lane + 32 * u;
      rv[u] = t < n ? v[t] : 3.0e38f;   // past n: never the worst
      ri[u] = t < n ? ix[t] : -1;
    }
    // this lane's worst entry (the last in the order)
    auto lane_worst = [&](float& lw, int& li_, int& lu) {
      lw = rv[0];
      li_ = ri[0];
      lu = 0;
#pragma unroll
      for (int u = 1; u < kRegs; ++u)
        if (before(lw, li_, rv[u], ri[u])) {
          lw = rv[u];
          li_ = ri[u];
          lu = u;
        }
    };
    // the list's worst: (value, index, lane, slot) reduced over the warp
    auto list_worst = [&](float lw, int li_, int lu, float& gv, int& gi,
                          int& gl, int& gu) {
      gv = lw;
      gi = li_;
      gl = lane;
      gu = lu;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, gv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, gi, off);
        const int ol = __shfl_xor_sync(0xffffffffu, gl, off);
        const int ou = __shfl_xor_sync(0xffffffffu, gu, off);
        if (before(gv, gi, ov, oi) || (ov == gv && oi == gi && ol > gl)) {
          gv = ov;
          gi = oi;
          gl = ol;
          gu = ou;
        }
      }
    };
    float lw, gv;
    int li_, lu, gi, gl, gu;
    lane_worst(lw, li_, lu);
    list_worst(lw, li_, lu, gv, gi, gl, gu);
    unsigned dirty = 0;
    for (int t = t0; t < c; ++t) {
      const float cv = qv[t][r];   // every lane reads the same entry
      const int ci = qi[t][r];
      if (!before(cv, ci, gv, gi)) continue;
      if (lane == gl) {   // the owner replaces its worst slot
#pragma unroll
        for (int u = 0; u < kRegs; ++u)
          if (u == gu) {
            rv[u] = cv;
            ri[u] = ci;
          }
        dirty |= 1u << gu;
        lane_worst(lw, li_, lu);
      }
      list_worst(lw, li_, lu, gv, gi, gl, gu);
    }
#pragma unroll
    for (int u = 0; u < kRegs; ++u)
      if (dirty >> u & 1) {
        v[lane + 32 * u] = rv[u];
        ix[lane + 32 * u] = ri[u];
      }
    wv = gv;
    wi = gi;
    wp = gl + 32 * gu;
  }
};

}  // namespace topk_select
