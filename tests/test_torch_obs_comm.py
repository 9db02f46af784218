"""The port's comm-volume predictor (``repro_torch/obs/comm.py``), the
counterpart of tests/test_obs_comm.py: the analytical formulas, and the
predictor against the traced counters of a real sweep on the CPU at
P in {5, 8, 13} over every registered placement, exactly.  The port's
predictions equal the JAX package's (``repro.obs.comm``, whose predictor
runs on the host) field for field.

The reference counts a program's comm once, at trace time; the port's
eager engine counts every call, so each traced number here comes from a
tracer configured around exactly one sweep
(``test_counters_count_every_call`` pins that difference).
"""

import numpy as np
import pytest

from repro.core.placement import supported_placements as r_supported
from repro.obs import comm as r_comm
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.comm import SingleProcessComm, shard
from repro_torch.core.placement import get_placement, supported_placements
from repro_torch.obs import comm as comm_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.comm import (block_bytes_of, predict_ring_gather_comm,
                                  predict_sweep_comm, predict_tree_merge_comm,
                                  quant_block_bytes, traced_sweep_comm,
                                  verify_dense_comm, verify_quant_comm)


def test_predict_cyclic_counts_nonzero_shifts():
    plc = get_placement("cyclic", 8)
    sched = plc.schedule()
    nz = int(sum(1 for a in sched.shifts if a % 8 != 0))
    c = predict_sweep_comm(plc, block_bytes=1000, partial_bytes=300)
    assert c.gather_hops == nz and c.scatter_hops == nz
    assert c.gather_bytes == nz * 1000
    assert c.scatter_bytes == nz * 300
    assert c.allgather_bytes == 0
    assert c.ppermute_bytes == c.gather_bytes + c.scatter_bytes
    assert c.resident_bytes == plc.replication * 1000


def test_predict_partial_bytes_defaults_to_block_bytes():
    c = predict_sweep_comm(get_placement("cyclic", 5), block_bytes=64)
    assert c.partial_bytes == 64
    assert c.gather_bytes == c.scatter_bytes


def test_predict_full_placement_is_allgather():
    c = predict_sweep_comm(get_placement("full", 8), block_bytes=100)
    assert c.gather_hops == 0 and c.scatter_hops == 0
    assert c.ppermute_bytes == 0
    assert c.allgather_bytes == (8 - 1) * 100
    assert c.resident_bytes == 8 * 100


def test_predict_accepts_name_with_P():
    c = predict_sweep_comm("cyclic", block_bytes=10, P=13)
    assert c.P == 13 and c.placement == "cyclic"
    with pytest.raises(ValueError):
        predict_sweep_comm("cyclic", block_bytes=10)  # name needs P


def test_predict_as_dict_roundtrip():
    c = predict_sweep_comm(get_placement("cyclic", 5), block_bytes=48)
    d = c.as_dict()
    assert d["gather_bytes"] == c.gather_bytes
    assert d["placement"] == "cyclic" and d["P"] == 5


@pytest.mark.parametrize("P,hops", [(1, 0), (2, 1), (8, 3), (13, 4)])
def test_predict_tree_merge_hops(P, hops):
    c = predict_tree_merge_comm(P, payload_bytes=100)
    assert c["hops"] == hops
    assert c["bytes"] == hops * 100
    assert c == r_comm.predict_tree_merge_comm(P, payload_bytes=100)


def test_predict_ring_gather():
    c = predict_ring_gather_comm(8, payload_bytes=50)
    assert c["hops"] == 7
    assert c["bytes"] == 7 * 50
    for P in (1, 2, 5, 13):
        assert predict_ring_gather_comm(P, 50) == \
            r_comm.predict_ring_gather_comm(P, 50)


def test_traced_sweep_comm_reads_counters():
    tr = trace_mod.Tracer(metrics_only=True)
    tr.count("comm.ppermute.gather_bytes", 128)
    tr.count("comm.ppermute.scatter_bytes", 96)
    tr.count("comm.ppermute.gather_hops", 2)
    tr.count("comm.ppermute.scatter_hops", 2)
    got = traced_sweep_comm(tr)
    assert got == {"gather_bytes": 128, "scatter_bytes": 96,
                   "gather_hops": 2, "scatter_hops": 2,
                   "allgather_bytes": 0}


@pytest.mark.parametrize("P", [5, 8, 13])
def test_predictions_match_reference(P):
    """Field for field, every placement defined at P, with and without a
    separate partial size."""
    ours = {p.name: p for p in supported_placements(P)}
    theirs = {p.name: p for p in r_supported(P)}
    assert set(ours) == set(theirs)
    for name in ours:
        for pb in (None, 300):
            got = predict_sweep_comm(ours[name], 1000, partial_bytes=pb)
            want = r_comm.predict_sweep_comm(theirs[name], 1000,
                                             partial_bytes=pb)
            assert got.as_dict() == want.as_dict(), name


@pytest.mark.parametrize("P", [5, 8, 13])
@pytest.mark.parametrize("mode", ["batched", "overlap", "scan"])
def test_predictor_matches_traced_all_placements(P, mode):
    """For every registered placement defined at P, the traced ppermute /
    all-gather bytes of a real dense sweep equal the prediction exactly."""
    out = verify_dense_comm(P, mode=mode, device="cpu", verbose=False)
    assert [r["placement"] for r in out] == [
        p.name for p in supported_placements(P)]
    for r in out:
        want = predict_sweep_comm(get_placement(r["placement"], P),
                                  block_bytes_of(4, 3))
        assert r["gather_bytes"] == want.gather_bytes
        assert r["allgather_bytes"] == want.allgather_bytes


def test_block_bytes_of_itemsize():
    assert block_bytes_of(4, 3) == 4 * 3 * 4
    assert block_bytes_of(4, 3, "bfloat16") == 4 * 3 * 2
    assert block_bytes_of(4, 3, "int8") == 4 * 3
    assert block_bytes_of(7, 5, "float64") == 7 * 5 * 8


def test_quant_block_bytes_counts_side_arrays():
    block, dim = 6, 10
    assert quant_block_bytes(block, dim, "int8") == block * dim + 8 + 8 * block
    assert (quant_block_bytes(block, dim, "bf16")
            == block * dim * 2 + 8 + 8 * block)
    for mode in ("int8", "bf16"):
        assert quant_block_bytes(block, dim, mode) == \
            r_comm.quant_block_bytes(block, dim, mode)
    with pytest.raises(ValueError):
        quant_block_bytes(block, dim, "fp4")


@pytest.mark.parametrize("P,dtype", [(5, "bfloat16"), (8, "int8")])
def test_predictor_matches_traced_nondefault_dtype(P, dtype, capsys):
    """The dense predictor stays exact when the swept payload is not f32:
    traced bytes == nz * block * dim * itemsize (through the CLI)."""
    assert comm_mod._main(["--P", str(P), "--dtype", dtype,
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "comm predictor OK" in out and f"dtype={dtype}" in out


@pytest.mark.parametrize("P,qmode", [(5, "int8"), (8, "bf16"), (13, "int8")])
def test_quant_predictor_matches_traced(P, qmode):
    """The quantized-stack gather (a 5-leaf QuantBlocks through
    quorum_gather) moves exactly nz * quant_block_bytes per device."""
    out = verify_quant_comm(P, qmode=qmode, block=6, dim=5, device="cpu",
                            verbose=False)
    assert len(out) == len(supported_placements(P))
    payload = quant_block_bytes(6, 5, qmode)
    for r in out:
        assert r["gather_bytes"] == r["gather_hops"] * payload


def test_counters_count_every_call():
    """The port counts on every eager call: two gathers under one tracer
    count twice what one does."""
    comm = SingleProcessComm(8, "cpu")
    x = shard(np.zeros((32, 3), np.float32), comm)
    sched = get_placement("cyclic", 8).schedule()
    tr = trace_mod.configure(metrics_only=True)
    try:
        sweep_mod.quorum_gather(x, sched, comm)
        one = traced_sweep_comm(tr)
        sweep_mod.quorum_gather(x, sched, comm)
        two = traced_sweep_comm(tr)
    finally:
        trace_mod.reset()
    assert one["gather_bytes"] > 0
    assert two["gather_bytes"] == 2 * one["gather_bytes"]
