"""The port's elastic control plane (``repro_torch/launch/elastic.py``)
against the JAX package's (``repro.launch.elastic``, pure Python,
imported in-process): ``RescalePlan``, ``failover`` and
``ReplicationRepairPlan`` must be identical for the same inputs, since
they are pure functions of (P, placement, failures)."""

import pytest

from repro.core.placement import get_placement as r_get_placement
from repro.launch import elastic as r_elastic
from repro_torch.core.placement import get_placement, registered_placements
from repro_torch.core.scheduler import reassign
from repro_torch.launch.elastic import (failover, plan_replication_repair,
                                        rescale)


def _rescale_fields(plan):
    return (plan.P_old, plan.P_new, plan.new_quorums, plan.fetches,
            plan.schedule.P, tuple(plan.schedule.shifts.tolist()),
            plan.placement_old.name, plan.placement_new.name,
            plan.is_migration, plan.total_fetch_blocks)


@pytest.mark.parametrize("P_old,P_new", [
    (1, 1), (4, 4), (8, 8), (13, 13), (5, 12), (3, 8), (7, 12), (12, 5),
    (8, 3), (4, 8), (1, 6), (2, 6), (4, 12), (8, 4), (6, 1), (12, 4)])
def test_rescale_matches_reference(P_old, P_new):
    assert (_rescale_fields(rescale(P_old, P_new))
            == _rescale_fields(r_elastic.rescale(P_old, P_new)))


@pytest.mark.parametrize("P,name", [(12, "affine"), (13, "projective"),
                                    (31, "projective"), (8, "full"),
                                    (6, "full")])
def test_migration_matches_reference(P, name):
    for old, new in (("cyclic", name), (name, "cyclic")):
        plan = rescale(P, P, placement_old=old, placement_new=new)
        assert _rescale_fields(plan) == _rescale_fields(
            r_elastic.rescale(P, P, placement_old=old, placement_new=new))
        assert plan.is_migration or plan.total_fetch_blocks == 0


def test_env_placement_steers_rescale(monkeypatch):
    monkeypatch.setenv("REPRO_PLACEMENT", "full")
    plan = rescale(4, 8)
    assert plan.placement_new.name == "full"
    assert _rescale_fields(plan) == _rescale_fields(r_elastic.rescale(4, 8))
    monkeypatch.delenv("REPRO_PLACEMENT")
    assert rescale(4, 8).placement_new.name == "cyclic"


@pytest.mark.parametrize("P,failed,name", [
    (8, [2], "cyclic"), (13, [0, 6], "cyclic"), (16, [15], "cyclic"),
    (13, [3], "projective"), (12, [1, 7], "affine")])
def test_failover_matches_reference(P, failed, name):
    plc = get_placement(name, P)
    s = plc.schedule()
    plan = failover(s, failed, placement=plc)
    assert plan == reassign(s, failed, placement=plc)
    rplc = r_get_placement(name, P)
    want = r_elastic.failover(rplc.schedule(), failed, placement=rplc)
    assert (plan.extra_pairs, plan.fetch_pairs) == (want.extra_pairs,
                                                    want.fetch_pairs)
    assert plan.n_recovered == len(failed) * s.n_pairs


def _repair_cases():
    out = []
    for name, cls in sorted(registered_placements().items()):
        for P in (5, 7, 8, 12, 13):
            if cls.supports(P):
                out += [(name, P, [0]), (name, P, [1, P - 2])]
    return out


@pytest.mark.parametrize("name,P,dead", _repair_cases())
def test_replication_repair_matches_reference(name, P, dead):
    plan = plan_replication_repair(get_placement(name, P), dead)
    want = r_elastic.plan_replication_repair(r_get_placement(name, P), dead)
    assert (plan.P, plan.dead, plan.actions, plan.copies_after) == (
        want.P, want.dead, want.actions, want.copies_after)
    assert plan.n_copies == want.n_copies
    assert plan.blocks_repaired == want.blocks_repaired


def test_replication_repair_current_residency_and_refusals():
    plc, rplc = get_placement("cyclic", 8), r_get_placement("cyclic", 8)
    holders = [i for i in range(8) if 0 in plc.residency_sets[i]]
    dead = holders[:-1]
    current = [set(S) | {0} if i not in dead else set(S)
               for i, S in enumerate(plc.residency_sets)]
    plan = plan_replication_repair(plc, dead, residency=current)
    want = r_elastic.plan_replication_repair(rplc, dead, residency=current)
    assert (plan.actions, plan.copies_after) == (want.actions,
                                                 want.copies_after)
    assert not any(b == 0 for (b, _s, _t) in plan.actions)
    assert plan_replication_repair(plc, []).actions == ()
    with pytest.raises(RuntimeError, match="lost"):
        plan_replication_repair(plc, holders)
    with pytest.raises(ValueError, match="all devices dead"):
        plan_replication_repair(get_placement("cyclic", 4), [0, 1, 2, 3])
