"""The port's fault-tolerant sweep (``repro_torch/core/faults.py``), held
against the JAX package's (``repro.core.faults``, numpy on the host,
imported in-process).

  * ``FaultPlan.random_kills`` gives the reference's event lists;
  * within the port, faulted = fault-free, bit-exact, for every registered
    placement x engine mode at P in {5, 8}, and through a restore from the
    checkpoint when every holder of a block dies;
  * ``RecoveryStats``' ``n_kills``, ``n_reassigned``, ``n_rereplicated``,
    ``n_fetches`` and ``bytes_fetched`` equal the reference's for the same
    plan: they are pure functions of the placement and the plan;
  * the results against the reference's: the dense total within rtol
    1e-6, the join's pairs and the k-NN ids equal (the fault-free runs
    also meet each workload's brute-force ``check_oracle``).
"""

import numpy as np
import pytest
import torch

from repro.core import faults as r_faults
from repro.core.placement import get_placement as r_get_placement
from repro_torch.ckpt.checkpoint import latest_step, restore_or_none
from repro_torch.core.faults import (CHAOS_P, DenseReduceWorkload,
                                     FaultEvent, FaultPlan, KnnGraphWorkload,
                                     SparseJoinWorkload, WORKLOADS,
                                     chaos_selfcheck, residency_invariant_ok,
                                     run_fault_tolerant_sweep)
from repro_torch.core.placement import get_placement, registered_placements
from repro_torch.core.sweep import ENGINE_MODES, sweep_rounds

R_WORKLOADS = dict(zip(("dense", "sparse", "knn"), r_faults.WORKLOADS))
STAT_KEYS = ("n_kills", "n_slow", "n_drops", "n_drop_retries",
             "n_reassigned", "n_fetches", "n_rereplicated", "n_restores",
             "n_recomputed", "n_checkpoints", "bytes_fetched",
             "bytes_rereplicated", "pairs_by_device", "busy_by_device")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_matches_reference(name, got, want):
    if name == "dense":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [3, 5, 8, 13])
@pytest.mark.parametrize("every", [1, 2, 4])
def test_random_kills_match_reference(P, every):
    for n_rounds in (1, 3, 9):
        for seed in (0, 5):
            for chaos in (True, False):
                got = FaultPlan.random_kills(P, n_rounds, every=every,
                                             seed=seed, chaos=chaos)
                want = r_faults.FaultPlan.random_kills(
                    P, n_rounds, every=every, seed=seed, chaos=chaos)
                assert ([tuple(vars(e).values()) for e in got.events]
                        == [tuple(vars(e).values()) for e in want.events])


def test_fault_plan_contracts():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent("explode", 0, 1)
    with pytest.raises(ValueError, match="every"):
        FaultPlan.random_kills(4, 3, every=0)
    a = FaultPlan.random_kills(8, 6, every=2, seed=3)
    assert a == FaultPlan.random_kills(8, 6, every=2, seed=3)
    assert a != FaultPlan.random_kills(8, 6, every=2, seed=4)
    assert FaultPlan.random_kills(3, 50, every=1, chaos=False).n_kills == 2
    short = FaultPlan.random_kills(8, 1, every=4, seed=0)
    assert short.n_kills == 1 and short.events_at(0)[0].kind == "kill"
    plan = FaultPlan(events=(FaultEvent("slow", 1, 2, factor=2.0),
                             FaultEvent("kill", 1, 0), FaultEvent("drop", 1)))
    assert [e.kind for e in plan.events_at(1)] == ["kill", "drop", "slow"]
    assert plan.events_at(0) == []


def test_workload_inputs_match_reference():
    """The corpus is the reference's RandomState draw, bit for bit, and the
    join's threshold places the same pair set."""
    for wl_cls in WORKLOADS:
        wl = wl_cls(8, seed=2, device="cpu")
        ref = R_WORKLOADS[wl_cls.name](8, seed=2)
        np.testing.assert_array_equal(wl.corpus.numpy(), ref.corpus)
        assert wl.offsets == ref.offsets
    wl, ref = SparseJoinWorkload(8, device="cpu"), r_faults.SparseJoinWorkload(8)
    np.testing.assert_allclose(wl.threshold, ref.threshold, rtol=1e-5)


def test_threshold_with_gap_matches_reference():
    """The port's one-pass gap search (numpy or tensor input) places the
    reference's threshold, ties and all."""
    from repro.core.sparse import threshold_with_gap as r_thr
    from repro_torch.core.sparse import threshold_with_gap
    rng = np.random.RandomState(0)
    for scores, sel in ((rng.randn(500), 0.15), (rng.randn(40, 30), 0.3),
                        (np.round(rng.randn(300), 2), 0.5),
                        (np.repeat(rng.randn(20), 7), 0.05),
                        (rng.randn(64).astype(np.float32) * 1e-3, 0.9)):
        want = r_thr(scores, sel)
        assert threshold_with_gap(scores, sel) == want
        assert threshold_with_gap(torch.as_tensor(scores), sel) == want
    with pytest.raises(ValueError, match="no score gap"):
        threshold_with_gap(np.zeros(10), 0.5)


# ---------------------------------------------------------------------------
# fault-free runs: all modes agree, the oracle holds, the reference agrees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wl_cls", WORKLOADS, ids=lambda c: c.name)
def test_fault_free_modes_bit_identical(wl_cls):
    P = 8
    plc = get_placement("cyclic", P)
    wl = wl_cls(P, seed=1, device="cpu")
    results = []
    for mode in ENGINE_MODES:
        out, stats = run_fault_tolerant_sweep(wl, plc, mode)
        assert stats.n_kills == stats.n_fetches == 0
        assert stats.rounds == len(sweep_rounds(plc.schedule(), mode))
        results.append(out)
    wl.check_oracle(results[0])
    assert all(wl.equal(out, results[0]) for out in results[1:])
    ref, _ = r_faults.run_fault_tolerant_sweep(
        R_WORKLOADS[wl_cls.name](P, seed=1), r_get_placement("cyclic", P),
        "batched")
    _assert_matches_reference(wl_cls.name, results[0], ref)


# ---------------------------------------------------------------------------
# chaos: faulted = fault-free, and the recovery counters match the reference
# ---------------------------------------------------------------------------

def _cases(Ps):
    return [(P, name) for P in Ps for name, cls in
            sorted(registered_placements().items()) if cls.supports(P)]


@pytest.mark.parametrize("P,name", _cases((5, 8)))
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_chaos_bit_exact_and_stats_match_reference(P, name, mode, tmp_path):
    plc, rplc = get_placement(name, P), r_get_placement(name, P)
    n_rounds = len(sweep_rounds(plc.schedule(), mode))
    plan = FaultPlan.random_kills(P, n_rounds, every=1, seed=5 + P)
    rplan = r_faults.FaultPlan.random_kills(P, n_rounds, every=1,
                                            seed=5 + P)
    for wl_cls in WORKLOADS:
        wl = wl_cls(P, seed=2, device="cpu")
        baseline, _ = run_fault_tolerant_sweep(wl, plc, "batched")
        out, stats = run_fault_tolerant_sweep(
            wl, plc, mode, plan, ckpt_dir=str(tmp_path / wl.name))
        assert stats.n_kills == plan.n_kills > 0
        assert wl.equal(out, baseline), (wl.name, name, P, mode)
        rwl = R_WORKLOADS[wl.name](P, seed=2)
        rout, rstats = r_faults.run_fault_tolerant_sweep(
            rwl, rplc, mode, rplan, ckpt_dir=str(tmp_path / ("r" + wl.name)))
        _assert_matches_reference(wl.name, out, rout)
        for key in STAT_KEYS:
            assert getattr(stats, key) == getattr(rstats, key), (key, wl.name)


def test_recovery_restores_residency_invariant():
    P = 13
    plc = get_placement("projective", P)
    wl = DenseReduceWorkload(P, seed=0, device="cpu")
    plan = FaultPlan.random_kills(
        P, len(sweep_rounds(plc.schedule(), "scan")), every=2, seed=1)
    baseline, _ = run_fault_tolerant_sweep(wl, plc, "batched")
    out, stats = run_fault_tolerant_sweep(wl, plc, "scan", plan)
    assert stats.n_rereplicated > 0 and wl.equal(out, baseline)
    res = [set(S) for S in plc.residency_sets]
    alive = [True] * P
    assert residency_invariant_ok(plc, res, alive)
    alive[0], res[0] = False, set()
    assert not residency_invariant_ok(plc, res, alive)


# ---------------------------------------------------------------------------
# block loss: every holder dies, the checkpoint restore resumes
# ---------------------------------------------------------------------------

def _holders(plc, b):
    return [i for i in range(plc.P) if b in plc.residency_sets[i]]


@pytest.mark.parametrize("wl_cls", WORKLOADS, ids=lambda c: c.name)
def test_block_loss_restores_from_checkpoint(wl_cls, tmp_path):
    P = 8
    plc = get_placement("cyclic", P)
    holders = _holders(plc, 0)
    wl = wl_cls(P, seed=3, device="cpu")
    baseline, _ = run_fault_tolerant_sweep(wl, plc, "batched")
    plan = FaultPlan(events=tuple(FaultEvent("kill", 2, d) for d in holders))
    out, stats = run_fault_tolerant_sweep(
        wl, plc, "scan", plan, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1)
    assert stats.n_kills == len(holders) and stats.n_restores >= 1
    assert wl.equal(out, baseline)
    rplan = r_faults.FaultPlan(events=tuple(
        r_faults.FaultEvent("kill", 2, d) for d in holders))
    rout, rstats = r_faults.run_fault_tolerant_sweep(
        R_WORKLOADS[wl.name](P, seed=3), r_get_placement("cyclic", P),
        "scan", rplan, ckpt_dir=str(tmp_path / "rckpt"), ckpt_every=1)
    _assert_matches_reference(wl.name, out, rout)
    for key in ("n_restores", "n_rereplicated", "n_reassigned",
                "n_recomputed"):
        assert getattr(stats, key) == getattr(rstats, key), key


def test_block_loss_without_checkpoint_reseeds_pristine():
    P = 8
    plc = get_placement("cyclic", P)
    wl = DenseReduceWorkload(P, seed=4, device="cpu")
    baseline, _ = run_fault_tolerant_sweep(wl, plc, "batched")
    plan = FaultPlan(events=tuple(FaultEvent("kill", 1, d)
                                  for d in _holders(plc, 0)))
    out, stats = run_fault_tolerant_sweep(wl, plc, "scan", plan)
    assert stats.n_restores >= 1 and wl.equal(out, baseline)


def test_checkpoint_store_roundtrips_partials(tmp_path):
    P = 5
    plc = get_placement("cyclic", P)
    wl = SparseJoinWorkload(P, seed=0, device="cpu")
    d = str(tmp_path / "ckpt")
    assert restore_or_none(d) is None
    out, stats = run_fault_tolerant_sweep(wl, plc, "scan", ckpt_dir=d,
                                          ckpt_every=1)
    n_rounds = len(sweep_rounds(plc.schedule(), "scan"))
    assert stats.n_checkpoints == n_rounds and latest_step(d) == n_rounds
    tree, step = restore_or_none(d, device="cpu")
    assert step == n_rounds and int(tree["round"]) == n_rounds
    assert set(tree["blocks"]) == {str(b) for b in range(P)}
    partials = {tuple(int(v) for v in k.split("_")): wl.decode_partial(v)
                for k, v in tree["partials"].items()}
    assert len(partials) == P * (P + 1) // 2
    assert wl.equal(wl.fold(partials), out)


def test_ckpt_every_knob_controls_cadence(tmp_path, monkeypatch):
    P = 5
    plc = get_placement("cyclic", P)
    wl = DenseReduceWorkload(P, seed=0, device="cpu")
    monkeypatch.setenv("REPRO_CKPT_EVERY", "2")
    _out, stats = run_fault_tolerant_sweep(wl, plc, "scan",
                                           ckpt_dir=str(tmp_path / "c"))
    assert stats.n_checkpoints == len(sweep_rounds(plc.schedule(),
                                                   "scan")) // 2
    monkeypatch.setenv("REPRO_CKPT_EVERY", "zero")
    with pytest.raises(ValueError, match="REPRO_CKPT_EVERY"):
        run_fault_tolerant_sweep(wl, plc, "scan",
                                 ckpt_dir=str(tmp_path / "c2"))
    with pytest.raises(ValueError, match="ckpt_every"):
        run_fault_tolerant_sweep(wl, plc, "scan", ckpt_every=0)
    with pytest.raises(ValueError, match="mode"):
        run_fault_tolerant_sweep(wl, plc, "auto")


# ---------------------------------------------------------------------------
# weighted ownership rides the same sweep
# ---------------------------------------------------------------------------

def test_weighted_ownership_same_result_more_fetches():
    P = 8
    plc = get_placement("cyclic", P)
    wl = DenseReduceWorkload(P, seed=5, device="cpu")
    baseline, base = run_fault_tolerant_sweep(wl, plc, "batched")
    assert base.n_fetches == 0
    weights = [4.0 if i == 0 else 1.0 for i in range(P)]
    out, stats = run_fault_tolerant_sweep(wl, plc, "batched",
                                          weights=weights)
    assert wl.equal(out, baseline) and stats.n_fetches > 0
    _r, rstats = r_faults.run_fault_tolerant_sweep(
        r_faults.DenseReduceWorkload(P, seed=5),
        r_get_placement("cyclic", P), "batched", weights=weights)
    assert (stats.n_fetches, stats.bytes_fetched) == (rstats.n_fetches,
                                                      rstats.bytes_fetched)


def test_weighted_ownership_survives_faults(tmp_path):
    P = 12
    plc = get_placement("affine", P)
    wl = KnnGraphWorkload(P, seed=6, device="cpu")
    weights = [1.0 + (i % 3) for i in range(P)]
    baseline, _ = run_fault_tolerant_sweep(wl, plc, "batched")
    plan = FaultPlan.random_kills(
        P, len(sweep_rounds(plc.schedule(), "overlap")), every=2, seed=2)
    out, stats = run_fault_tolerant_sweep(
        wl, plc, "overlap", plan, ckpt_dir=str(tmp_path / "ckpt"),
        weights=weights)
    assert stats.n_kills > 0 and wl.equal(out, baseline)


# ---------------------------------------------------------------------------
# the chaos selfcheck entry point
# ---------------------------------------------------------------------------

def test_chaos_selfcheck_small_slice_and_cli(capsys):
    from repro_torch.core import faults
    assert chaos_selfcheck(Ps=(5,), modes=("scan",), placements=("cyclic",),
                           verbose=False, device="cpu") == 3
    assert faults._main(["--P", "8", "--modes", "batched", "overlap",
                         "--placements", "cyclic", "--device", "cpu"]) == 0
    assert "chaos selfcheck OK (6 faulted cases" in capsys.readouterr().out
    assert CHAOS_P == r_faults.CHAOS_P
