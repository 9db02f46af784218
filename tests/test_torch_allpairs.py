"""The port's quorum all-pairs engine held against the JAX package's.

One JAX subprocess (8 fake CPU devices, the way tests/test_engine_modes.py
runs the reference) computes every reference output this module needs and
writes them to an ``.npz``; the port runs in-process on the CPU.  Every
engine mode at P in {2, 5, 6, 8} must agree with the reference's engine,
the reference's allgather baseline and the numpy oracle within the
selfcheck tolerances (rtol 2e-4, atol 2e-5).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import selfcheck
from repro_torch.core.allpairs import (allgather_allpairs, quorum_allpairs,
                                       pair_mask_table)
from repro_torch.core.placement import get_placement
from repro_torch.core.comm import SingleProcessComm, shard, unshard
from repro_torch.core.scheduler import build_schedule
from repro_torch.obs import trace as t_trace

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (2, 5, 6, 8)
MODES = ("batched", "overlap", "scan")
TOL = dict(rtol=2e-4, atol=2e-5)

REFERENCE = r"""
import sys
import numpy as np, jax
from jax.sharding import PartitionSpec as PS
from repro.core.allpairs import (allgather_allpairs, pair_mask_table,
                                 quorum_allpairs)
from repro.core.scheduler import build_schedule
from repro.core.selfcheck import pairwise_force

out = {}
for P in (2, 5, 6, 8):
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    sched = build_schedule(P)
    x = np.random.default_rng(0).normal(size=(P * 8, 3)).astype(np.float32)
    masks = pair_mask_table(sched)
    for mode in ("batched", "overlap", "scan"):
        def f(xb, mb, mode=mode):
            return quorum_allpairs(pairwise_force, xb, axis_name="q",
                                   schedule=sched, mask=mb, mode=mode)
        out[f"P{P}_{mode}"] = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(PS("q"), PS("q")),
            out_specs=PS("q")))(x, masks))
    def g(xb):
        return allgather_allpairs(pairwise_force, xb, axis_name="q",
                                  axis_size=P)
    out[f"P{P}_allgather"] = np.asarray(jax.jit(jax.shard_map(
        g, mesh=mesh, in_specs=PS("q"), out_specs=PS("q")))(x))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "allpairs.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_outputs():
    return {P: selfcheck.main(P, device="cpu") for P in PS}


@pytest.mark.parametrize("mode", MODES + ("allgather",))
@pytest.mark.parametrize("P", PS)
def test_engine_matches_jax(reference, port_outputs, P, mode):
    np.testing.assert_allclose(port_outputs[P][mode],
                               reference[f"P{P}_{mode}"], **TOL)


@pytest.mark.parametrize("P", [4, 6])
def test_default_mask_dedups_half_orbit(P):
    """mask=None derives every device's pair_mask_table row, so the d = P/2
    orbit of even P is counted once."""
    comm = SingleProcessComm(P, "cpu")
    x = np.random.default_rng(0).normal(size=(P * 8, 3)).astype(np.float32)
    for mode in MODES:
        got = quorum_allpairs(selfcheck.pairwise_force, shard(x, comm), comm,
                              schedule=build_schedule(P), mode=mode)
        np.testing.assert_allclose(unshard(got).numpy(), selfcheck.oracle(x),
                                   **TOL, err_msg=mode)


def test_env_mode_override_and_placement(monkeypatch):
    """REPRO_ALLPAIRS_MODE forces the auto mode; REPRO_PLACEMENT selects
    the placement when none is given — one environment steers both
    packages."""
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "overlap")
    out = selfcheck.main(4, modes=("auto",), device="cpu")
    np.testing.assert_allclose(out["auto"], out["allgather"], **TOL)
    monkeypatch.delenv("REPRO_ALLPAIRS_MODE")
    monkeypatch.setenv("REPRO_PLACEMENT", "full")
    comm = SingleProcessComm(4, "cpu")
    x = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    got = quorum_allpairs(selfcheck.pairwise_force, shard(x, comm), comm)
    np.testing.assert_allclose(unshard(got).numpy(), selfcheck.oracle(x),
                               **TOL)


def test_argument_contract():
    comm = SingleProcessComm(2, "cpu")
    x = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="batch_fn"):
        quorum_allpairs(selfcheck.pairwise_force, x, comm, mode="scan",
                        batch_fn=lambda *a: None)
    with pytest.raises(ValueError, match="device axis"):
        quorum_allpairs(selfcheck.pairwise_force, torch.zeros(3, 4, 3), comm)
    with pytest.raises(ValueError, match="batch_fn fuses"):
        quorum_allpairs(selfcheck.pairwise_force, x, comm,
                        placement=get_placement("full", 2),
                        batch_fn=lambda *a: None)


def test_batch_fn_gets_device_stack_and_weights():
    """The fused hook receives the [P, k, block, F] stack, the slot ids and
    [P, n_pairs] weights with the self pair's wj zeroed."""
    P = 5
    comm = SingleProcessComm(P, "cpu")
    sched = build_schedule(P)
    seen = {}

    def batch_fn(quorum, lo, hi, wi, wj):
        seen.update(q=quorum.shape, lo=list(lo), hi=list(hi), wi=wi, wj=wj)
        return torch.zeros(P, sched.k, 4, 3)

    quorum_allpairs(selfcheck.pairwise_force, torch.zeros(P, 4, 3), comm,
                    schedule=sched, mode="batched", batch_fn=batch_fn)
    assert seen["q"] == (P, sched.k, 4, 3)
    assert seen["lo"] == list(sched.pair_slots[:, 0])
    torch.testing.assert_close(seen["wi"], torch.as_tensor(
        pair_mask_table(sched)))
    self_col = int(np.nonzero(sched.pair_diff == 0)[0][0])
    assert float(seen["wj"][:, self_col].abs().sum()) == 0.0


def test_allgather_counts_bytes_per_device():
    P = 4
    comm = SingleProcessComm(P, "cpu")
    tr = t_trace.configure()
    try:
        allgather_allpairs(selfcheck.pairwise_force, torch.zeros(P, 8, 3),
                           comm)
    finally:
        t_trace.reset()
    assert tr.counter_total("comm.allgather.bytes") == (P - 1) * 8 * 3 * 4


def test_pair_sweep_traces_tiles():
    P = 8
    sched = build_schedule(P)
    tr = t_trace.configure()
    try:
        selfcheck.main(P, modes=("scan",), device="cpu")
    finally:
        t_trace.reset()
    assert tr.counter_total("sweep.pair_tiles") == sched.n_pairs
