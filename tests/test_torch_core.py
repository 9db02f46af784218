"""The port's framework-neutral layer, comm layer and sweep runtime held
against the JAX package (``repro.core.*``), in-process on the CPU.

Schedules, masks and placements must be *identical* for every P <= 64
(every registered placement at every P where it is defined); the sweep
helpers must agree with the reference's, and the top-k monoid must select
the same (-score, index) lists.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import env as r_env
from repro.core import placement as r_plc
from repro.core import quorum as r_quorum
from repro.core import scheduler as r_sched
from repro.core import sweep as r_sweep
from repro_torch.core import comm as t_comm
from repro_torch.core import env as t_env
from repro_torch.core import placement as t_plc
from repro_torch.core import quorum as t_quorum
from repro_torch.core import scheduler as t_sched
from repro_torch.core import sweep as t_sweep
from repro_torch.obs import trace as t_trace

MAX_P = 64
PS = list(range(1, MAX_P + 1))


def _placement_cases():
    return [(name, P)
            for name, cls in sorted(r_plc.registered_placements().items())
            for P in PS if cls.supports(P)]


@pytest.mark.parametrize("P", PS)
def test_schedule_and_mask_identical(P):
    assert t_quorum.difference_set(P) == r_quorum.difference_set(P)
    assert t_quorum.cyclic_quorums(P) == r_quorum.cyclic_quorums(P)
    ts, rs = t_sched.build_schedule(P), r_sched.build_schedule(P)
    assert ts.A == rs.A and ts.k == rs.k
    for field in ("shifts", "pair_slots", "pair_diff"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(rs, field))
    np.testing.assert_array_equal(t_sweep.pair_mask_table(ts),
                                  r_sweep.pair_mask_table(rs))
    assert t_sweep.pair_ready_order(ts) == r_sweep.pair_ready_order(rs)
    for mode in t_sweep.ENGINE_MODES:
        assert t_sweep.sweep_rounds(ts, mode) == r_sweep.sweep_rounds(rs, mode)
    # carried across by the comm layer's duck-typed constructor
    cs = t_comm.schedule_from_numpy(rs.P, rs.A, rs.shifts, rs.pair_slots,
                                    rs.pair_diff)
    assert isinstance(cs, t_sched.PairSchedule) and cs.A == ts.A
    for field in ("shifts", "pair_slots", "pair_diff"):
        np.testing.assert_array_equal(getattr(cs, field), getattr(ts, field))


def test_registered_placements_identical():
    assert sorted(t_plc.registered_placements()) == \
        sorted(r_plc.registered_placements())
    for P in PS:
        assert [p.name for p in t_plc.supported_placements(P)] == \
            [p.name for p in r_plc.supported_placements(P)]
        assert t_plc.auto_placement(P).name == r_plc.auto_placement(P).name


@pytest.mark.parametrize("name,P", _placement_cases(),
                         ids=[f"{n}-P{P}" for n, P in _placement_cases()])
def test_placement_identical(name, P):
    tp, rp = t_plc.get_placement(name, P), r_plc.get_placement(name, P)
    assert tp.residency_sets == rp.residency_sets
    assert tp.replication == rp.replication and tp.full == rp.full
    assert tp.shifts == rp.shifts
    owners_t = [[tp.owner_of(x, y) for y in range(P)] for x in range(P)]
    owners_r = [[rp.owner_of(x, y) for y in range(P)] for x in range(P)]
    assert owners_t == owners_r
    if not tp.full:
        ts, rs = tp.schedule(), rp.schedule()
        np.testing.assert_array_equal(ts.pair_slots, rs.pair_slots)
        np.testing.assert_array_equal(ts.shifts, rs.shifts)


@pytest.mark.parametrize("P,failed", [(5, [1]), (8, [0, 3]), (13, [2, 7, 9]),
                                      (16, [5])])
def test_reassign_and_weighted_owners_identical(P, failed):
    ts, rs = t_sched.build_schedule(P), r_sched.build_schedule(P)
    tplan, rplan = t_sched.reassign(ts, failed), r_sched.reassign(rs, failed)
    assert tplan.extra_pairs == rplan.extra_pairs
    assert tplan.fetch_pairs == rplan.fetch_pairs
    w = list(np.random.default_rng(P).uniform(0.5, 2.0, P))
    np.testing.assert_array_equal(
        t_plc.weighted_owner_table(t_plc.get_placement("cyclic", P), w),
        r_plc.weighted_owner_table(r_plc.get_placement("cyclic", P), w))


def test_env_registry_identical(monkeypatch):
    assert sorted(t_env.ENV_KNOBS) == sorted(r_env.ENV_KNOBS)
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "overlap")
    monkeypatch.setenv("REPRO_BATCH_BYTES_LIMIT", "4096")
    assert t_sweep.env_mode_override() == r_sweep.env_mode_override() == \
        "overlap"
    assert t_sweep.auto_batch_bytes() == r_sweep.auto_batch_bytes() == 4096
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "batch")  # typo raises in both
    for mod in (t_sweep, r_sweep):
        with pytest.raises(ValueError, match="REPRO_ALLPAIRS_MODE"):
            mod.env_mode_override()


def test_select_and_validate_mode(monkeypatch):
    sched = t_sched.build_schedule(8)       # k = 4
    monkeypatch.delenv("REPRO_ALLPAIRS_MODE", raising=False)
    monkeypatch.delenv("REPRO_BATCH_BYTES_LIMIT", raising=False)
    assert t_sweep.select_mode(sched, 1024, None) == "batched"
    assert t_sweep.select_mode(sched, 1 << 40, object()) == "batched"
    assert t_sweep.select_mode(sched, 1 << 40, None) == "overlap"
    assert t_sweep.select_mode(t_sched.build_schedule(2), 1 << 40,
                               None) == "scan"
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "scan")
    with pytest.raises(ValueError, match="conflicts"):
        t_sweep.select_mode(sched, 1024, object())
    with pytest.raises(ValueError, match="mode must be"):
        t_sweep.validate_mode("fast", None)
    with pytest.raises(ValueError, match="batch_fn"):
        t_sweep.validate_mode("scan", object())


@pytest.mark.parametrize("P", [1, 2, 5, 8])
def test_comm_layer(P):
    comm = t_comm.SingleProcessComm(P, "cpu")
    x = torch.arange(P * 3 * 2, dtype=torch.float32).reshape(P, 3, 2)
    for a in range(-P, 2 * P):
        got = comm.ppermute(x, a)
        # _shift_perm: source j -> destination (j - a) % P, i.e. device i
        # receives block (i + a) % P
        for src, dst in r_sweep._shift_perm(P, a):
            assert torch.equal(got[dst], x[src])
    np.testing.assert_array_equal(comm.axis_index().numpy(), np.arange(P))
    g = comm.all_gather(x)
    assert g.shape == (P, P, 3, 2) and all(torch.equal(g[i], x)
                                           for i in range(P))
    data = np.random.default_rng(P).normal(size=(P * 4, 3))
    sh = t_comm.shard(data, comm, dtype=torch.float32)
    assert sh.shape == (P, 4, 3)
    np.testing.assert_array_equal(t_comm.unshard(sh).numpy(),
                                  data.astype(np.float32))
    if P > 1:
        with pytest.raises(ValueError, match="divide"):
            t_comm.shard(np.zeros((P * 4 + 1, 2)), comm)


@pytest.mark.parametrize("P", [2, 5, 8])
def test_gather_scatter_semantics(P):
    """Slot s of device i holds block (i + shifts[s]) % P; scattering the
    gathered stack home sums k copies of each block (pytree payloads ride
    the same shifts)."""
    comm = t_comm.SingleProcessComm(P, "cpu")
    sched = t_sched.build_schedule(P)
    x = torch.randn(P, 4, 3, generator=torch.Generator().manual_seed(P))
    q = t_sweep.quorum_gather(x, sched, comm)
    assert q.shape == (P, sched.k, 4, 3)
    for i in range(P):
        for s, a in enumerate(sched.shifts):
            assert torch.equal(q[i, s], x[(i + int(a)) % P])
    back = t_sweep.quorum_scatter(q, sched, comm)
    torch.testing.assert_close(back, sched.k * x)
    tree = t_sweep.quorum_gather({"a": x, "b": (x[..., 0],)}, sched, comm)
    assert torch.equal(tree["a"], q) and torch.equal(tree["b"][0], q[..., 0])
    as_list = [q[:, s] for s in range(sched.k)]
    torch.testing.assert_close(
        t_sweep.quorum_scatter(as_list, sched, comm, reduce_fn=torch.maximum),
        x)


def test_gather_scatter_trace_counters():
    """Comm counters record bytes per device, as the reference's do."""
    P = 8
    comm = t_comm.SingleProcessComm(P, "cpu")
    sched = t_sched.build_schedule(P)
    x = torch.zeros(P, 16, 4)
    tr = t_trace.configure(profiler=True)
    try:
        q = t_sweep.quorum_gather(x, sched, comm)
        t_sweep.quorum_scatter(q, sched, comm)
    finally:
        t_trace.reset()
    hops = sched.k - 1
    assert tr.counter_total("comm.ppermute.gather_hops") == hops
    assert tr.counter_total("comm.ppermute.gather_bytes") == hops * 16 * 4 * 4
    assert tr.counter_total("comm.ppermute.scatter_bytes") == \
        hops * 16 * 4 * 4
    assert {e["name"] for e in tr.events} == {"sweep.gather", "sweep.scatter"}


@pytest.mark.parametrize("n,topk", [(10, 4), (3, 6), (16, 16)])
def test_topk_monoid_matches_reference(n, topk):
    rng = np.random.default_rng(n * 31 + topk)
    vals = rng.integers(0, 5, size=(3, n)).astype(np.float32)   # many ties
    idx = np.stack([rng.permutation(100)[:n] for _ in range(3)]).astype(
        np.int32)
    tv, ti = t_sweep.topk_by_score(torch.as_tensor(vals),
                                   torch.as_tensor(idx), topk)
    rv, ri = r_sweep.topk_by_score(jnp.asarray(vals), jnp.asarray(idx), topk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    # merging a list with an overlapping copy of itself dedups indices
    mv, mi = t_sweep.merge_topk(tv, ti, tv, ti, topk)
    rmv, rmi = r_sweep.merge_topk(rv, ri, rv, ri, topk)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(rmi))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rmv))
