"""The port's feedback loop (``repro_torch/obs/feedback.py``), the
counterpart of tests/test_obs_feedback.py: throughput-weight arithmetic,
and the closed loop on the CPU — a slowed device's pair share shrinks
under the derived weights while the sweep output stays bit-exact.  The
weights equal the JAX package's (``repro.obs.feedback``, host-only) on
the same statistics to 1e-12, and the port's fault-tolerant sweep yields
the reference's statistics, so the loop closes on the same weights.
"""

import pytest

from repro.core import faults as r_faults
from repro.core.placement import get_placement as r_get_placement
from repro.obs import feedback as r_feedback
from repro_torch.core import faults as faults_mod
from repro_torch.core.placement import get_placement
from repro_torch.obs import feedback as feedback_mod
from repro_torch.obs.feedback import (feedback_selfcheck, throughput_weights,
                                      weights_from_stats)


def _close(a, b):
    assert len(a) == len(b) and all(abs(x - y) < 1e-12 for x, y in zip(a, b))


def test_throughput_weights_ratio():
    """Device 1 at half the throughput of device 0 gets half the weight."""
    w = throughput_weights({0: 10, 1: 10}, {0: 1.0, 1: 2.0}, P=2)
    assert abs(w[0] - 2 * w[1]) < 1e-12
    assert abs(sum(w) / len(w) - 1.0) < 1e-12


def test_throughput_weights_unobserved_device_gets_mean():
    w = throughput_weights({0: 8, 1: 8}, {0: 1.0, 1: 1.0}, P=4)
    assert w == [1.0, 1.0, 1.0, 1.0]
    w = throughput_weights({0: 12, 1: 4}, {0: 1.0, 1: 1.0}, P=3)
    assert abs(w[2] - 1.0) < 1e-12


def test_throughput_weights_no_observations():
    assert throughput_weights({}, {}, P=3) == [1.0, 1.0, 1.0]
    assert throughput_weights({0: 0}, {}, P=2) == [1.0, 1.0]


def test_throughput_weights_rejects_zero_busy():
    with pytest.raises(ValueError, match="busy time"):
        throughput_weights({0: 5}, {0: 0.0}, P=2)


def test_weights_from_stats():
    stats = faults_mod.RecoveryStats()
    stats.pairs_by_device = {0: 6, 1: 6}
    stats.busy_by_device = {0: 1.0, 1: 4.0}
    w = weights_from_stats(stats, P=2)
    assert abs(w[0] - 4 * w[1]) < 1e-12


@pytest.mark.parametrize("pairs,busy,P", [
    ({0: 10, 1: 10}, {0: 1.0, 1: 2.0}, 2),
    ({0: 12, 1: 4, 3: 7}, {0: 1.0, 1: 1.5, 3: 0.25}, 5),
    ({0: 3, 2: 9, 4: 1, 5: 0}, {0: 0.3, 2: 2.7, 4: 1e-3}, 6),
    ({}, {}, 3),
])
def test_weights_match_reference(pairs, busy, P):
    _close(throughput_weights(pairs, busy, P),
           r_feedback.throughput_weights(pairs, busy, P))


@pytest.mark.parametrize("P", [5, 8])
def test_feedback_selfcheck_closes_the_loop(P):
    """A 4x-slowed device gets a proportionally smaller pair share under the
    derived weights and the output stays bit-exact (asserted inside
    feedback_selfcheck per placement)."""
    n = feedback_selfcheck(P=P, device="cpu", verbose=False)
    assert n >= 1


def test_feedback_selfcheck_honors_placement_filter():
    n = feedback_selfcheck(P=8, placements=["cyclic"], slow_factor=2.0,
                           slow_device=0, mode="scan", device="cpu",
                           verbose=False)
    assert n == 1


@pytest.mark.parametrize("P,mode", [(5, "batched"), (8, "overlap"),
                                    (13, "scan")])
def test_loop_weights_match_reference(P, mode):
    """The slowed sweep's statistics, the weights derived from them and the
    reweighted ownership equal the reference's for the same plan."""
    plan = faults_mod.FaultPlan(events=(
        faults_mod.FaultEvent("slow", 0, 2, factor=4.0),))
    r_plan = r_faults.FaultPlan(events=(
        r_faults.FaultEvent("slow", 0, 2, factor=4.0),))
    wl = faults_mod.DenseReduceWorkload(P, n_items=8 * P, device="cpu")
    r_wl = r_faults.DenseReduceWorkload(P, n_items=8 * P)
    plc, r_plc = get_placement("cyclic", P), r_get_placement("cyclic", P)
    _, stats = faults_mod.run_fault_tolerant_sweep(wl, plc, mode, plan)
    _, r_stats = r_faults.run_fault_tolerant_sweep(r_wl, r_plc, mode, r_plan)
    w = weights_from_stats(stats, P)
    _close(w, r_feedback.weights_from_stats(r_stats, P))
    _, stats2 = faults_mod.run_fault_tolerant_sweep(wl, plc, mode, plan,
                                                    weights=w)
    _, r_stats2 = r_faults.run_fault_tolerant_sweep(r_wl, r_plc, mode,
                                                    r_plan, weights=w)
    assert stats2.pairs_by_device == r_stats2.pairs_by_device


def test_cli_on_cpu(capsys):
    assert feedback_mod._main(["--P", "5", "--on", "cpu"]) == 0
    assert "feedback selfcheck OK" in capsys.readouterr().out
