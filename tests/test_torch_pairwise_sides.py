"""A plain-torch model of B1's three kernels (``csrc/pairwise_batch.cu``),
held on the CPU against the plain ``ref.pairwise_batch_forces``.

The model does what the kernels do: the plan lists the (device, pair,
side) items with a non-zero weight in order; each listed item forms the
unweighted force on its own block from its partner block (the body's own
mass multiplied once, at the end); the reduction adds w * partial for
each slot over the pairs in pair order, side 0 before side 1.  Cells:
the P = 8 schedule with its mask table, every weighted side on one slot,
one pair, and random slot pairs with lo > hi and repeats.  Tolerance
1e-5 of the largest force (float32, another summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.scheduler import build_schedule
from repro_torch.core.sweep import pair_mask_table
from repro_torch.kernels import ref


def plan(w):
    """The items (b * n_pairs + n) * 2 + side with w != 0, in order."""
    return torch.nonzero(w.reshape(-1) != 0).reshape(-1).tolist()


def sides_model(quorum, lo, hi, wi, wj, softening=1e-2):
    B, k, block, _ = quorum.shape
    n_pairs = len(lo)
    w = torch.stack([wi, wj], -1)                          # [B, n_pairs, 2]
    partial = torch.full((B, n_pairs, 2, block, 3), float("nan"))
    for item in plan(w):
        side, n, b = item & 1, (item >> 1) % n_pairs, (item >> 1) // n_pairs
        me = quorum[b, hi[n] if side else lo[n]]
        other = quorum[b, lo[n] if side else hi[n]]
        d = other[None, :, :3] - me[:, None, :3]           # [block, block, 3]
        r2 = (d * d).sum(-1) + softening
        s = other[None, :, 3] * torch.rsqrt(r2) ** 3
        partial[b, n, side] = me[:, 3:] * (s[..., None] * d).sum(1)
    out = torch.zeros(B, k, block, 3)
    for b in range(B):
        for slot in range(k):
            for n in range(n_pairs):
                for side, s_slot in ((0, lo[n]), (1, hi[n])):
                    if s_slot == slot and w[b, n, side] != 0:
                        out[b, slot] += w[b, n, side] * partial[b, n, side]
    return out


def _bodies(rng, *shape):
    return torch.tensor(np.concatenate(
        [rng.normal(size=shape + (3,)), rng.uniform(0.5, 2, shape + (1,))],
        -1).astype(np.float32))


def _cells():
    sched = build_schedule(8)
    mask = pair_mask_table(sched)
    yield ("schedule", 8, sched.k, list(sched.pair_slots[:, 0]),
           list(sched.pair_slots[:, 1]), mask,
           np.where(sched.pair_diff == 0, 0, mask))
    lo, hi = [0, 0, 0, 0, 0], [0, 1, 2, 1, 0]
    wi = np.linspace(0.5, 2, 10).reshape(2, 5)
    yield "one slot", 2, 3, lo, hi, wi, np.where(np.equal(lo, hi), wi, 0)
    yield "one pair", 3, 2, [1], [0], np.ones((3, 1)), np.full((3, 1), 0.5)
    rng = np.random.default_rng(3)
    lo, hi = list(rng.integers(0, 4, 7)), list(rng.integers(0, 4, 7))
    wi = rng.integers(0, 2, (2, 7)).astype(float)
    yield "random", 2, 4, lo, hi, wi, wi * (np.array(lo) != np.array(hi))


@pytest.mark.parametrize("cell", list(_cells()), ids=lambda c: c[0])
def test_sides_model_matches_plain(cell):
    _name, B, k, lo, hi, wi, wj = cell
    rng = np.random.default_rng(B * 10 + k)
    q = _bodies(rng, B, k, 37)
    wi, wj = (torch.tensor(np.asarray(w, np.float32)) for w in (wi, wj))
    lo, hi = [int(v) for v in lo], [int(v) for v in hi]
    got = sides_model(q, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(q, lo, hi, wi, wj)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_plan_lists_each_nonzero_side_once():
    sched = build_schedule(8)
    w = torch.tensor(np.stack([pair_mask_table(sched),
                               np.where(sched.pair_diff == 0, 0,
                                        pair_mask_table(sched))], -1))
    items = plan(w)
    assert items == sorted(items) and len(items) == int((w != 0).sum())
    assert all(w.reshape(-1)[i] != 0 for i in items)
