"""The port's ``torch.distributed`` comm backend (``core.comm.DistributedComm``)
held against the JAX package on a mesh and against ``SingleProcessComm``:
the counterpart of tests/test_distributed.py.

One JAX subprocess (8 fake CPU devices) writes the reference's outputs to
an ``.npz``.  The port runs as gloo ranks on the CPU, one process per
device, through ``torch.multiprocessing`` (``spawn``) with a ``file://``
store under the test's temporary directory and one intra-op thread a
rank; one spawn per P (4, 5, 8), all started together by a module-scoped
fixture.  Each rank writes its own rows, and the cases below assert them:

  * the engine selfcheck at P = 4, 5, 8, every mode, against the JAX
    engine and the numpy oracle (rtol 2e-4, atol 2e-5);
  * at P = 8, as tests/test_distributed.py runs them: PCIT at N = 32,
    G = 20 (corr rtol 1e-4 / atol 1e-5, keep exactly equal), n-body quorum
    and atom at N = 64 (relative error < 1e-4), quorum and ring attention
    at B = 2, T = 64, H = 4, KV = 2, hd = 16 (error < 1e-4);
  * the same rows from ``SingleProcessComm`` at the same tolerances (the
    junit property ``bit_equal`` records whether they were bit-equal);
  * ``ppermute`` (every shift), ``all_gather`` and ``axis_index`` against
    ``SingleProcessComm``'s; ``verify_dense_comm`` on every rank for every
    placement; each rank's resident quorum bytes k/P of the atom's;
  * a rank that raises, or a peer that never comes, fails the run within
    its timeout; a missing transport or device raises.
"""

import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.apps import attention, nbody, pcit
from repro_torch.core import selfcheck
from repro_torch.core.comm import DistributedComm, SingleProcessComm
from repro_torch.core.placement import supported_placements
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.sweep import quorum_gather
from repro_torch.obs import comm as obs_comm

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (4, 5, 8)
APP_P = 8
MODES = ("batched", "overlap", "scan")
SC_TOL = dict(rtol=2e-4, atol=2e-5)
RANK_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_SECONDS = 240
ATTN = dict(B=2, T=64, H=4, KV=2, hd=16)


def bodies_np():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(size=(64, 3)),
                           rng.uniform(0.5, 2, (64, 1))], -1).astype(np.float32)


def expression_np():
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(4, 20))
    W = rng.normal(size=(32, 4))
    return (W @ Z + 0.5 * rng.normal(size=(32, 20))).astype(np.float32)


def qkv_np():
    rng = np.random.default_rng(0)
    B, T, H, KV, hd = (ATTN[n] for n in ("B", "T", "H", "KV", "hd"))
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32))


def comm_stack(P):
    """A [P, 3, 2] float32 and a [P, 5] bool per-device stack, distinct
    rows, for the collectives."""
    f = torch.arange(P * 6, dtype=torch.float32).reshape(P, 3, 2) * 0.5
    b = (torch.arange(P * 5).reshape(P, 5) % 3) == 0
    return f, b


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.apps.attention import distributed_attention
from repro.apps.nbody import distributed_forces
from repro.apps.pcit import run_quorum_pcit
from repro.core.allpairs import (allgather_allpairs, pair_mask_table,
                                 quorum_allpairs)
from repro.core.scheduler import build_schedule
from repro.core.selfcheck import pairwise_force

def mesh(P):
    return jax.make_mesh((P,), ("q",), devices=jax.devices()[:P],
                         axis_types=(jax.sharding.AxisType.Auto,))

d = np.load(sys.argv[2])
out = {}
for P in %(ps)r:
    sched = build_schedule(P)
    x = np.random.default_rng(0).normal(size=(P * 8, 3)).astype(np.float32)
    masks = pair_mask_table(sched)
    for mode in %(modes)r:
        def f(xb, mb, mode=mode):
            return quorum_allpairs(pairwise_force, xb, axis_name="q",
                                   schedule=sched, mask=mb, mode=mode)
        out[f"sc{P}_{mode}"] = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh(P), in_specs=(PS("q"), PS("q")),
            out_specs=PS("q")))(x, masks))
    def g(xb, P=P):
        return allgather_allpairs(pairwise_force, xb, axis_name="q",
                                  axis_size=P)
    out[f"sc{P}_allgather"] = np.asarray(jax.jit(jax.shard_map(
        g, mesh=mesh(P), in_specs=PS("q"), out_specs=PS("q")))(x))
m = mesh(%(app_p)d)
out["pcit_corr"], out["pcit_keep"] = run_quorum_pcit(d["X"], m)
for strat in ("quorum", "atom"):
    out[f"nbody_{strat}"] = np.asarray(distributed_forces(
        jnp.asarray(d["bodies"]), m, strategy=strat))
for strat in ("quorum", "ring"):
    out[f"attn_{strat}"] = np.asarray(distributed_attention(
        jnp.asarray(d["q"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]), m,
        strategy=strat))
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _rank_outputs(comm, P):
    """Everything one rank checks, as numpy arrays keyed by name."""
    out = {}
    f, b = comm_stack(P)
    mine_f, mine_b = comm.local_rows(f), comm.local_rows(b)
    for s in range(-P, 2 * P + 1):
        out[f"ppermute_f{s}"] = _np(comm.ppermute(mine_f, s))
        out[f"ppermute_b{s}"] = _np(comm.ppermute(mine_b, s))
    out["all_gather"] = _np(comm.all_gather(mine_f))
    out["axis_index"] = _np(comm.axis_index())
    for name, v in selfcheck.main(P, device="cpu", comm=comm).items():
        out[f"sc_{name}"] = v
    try:
        traced = obs_comm.verify_dense_comm(P, comm=comm, verbose=False)
        out["comm_error"] = np.array("")
    except AssertionError as e:
        traced = []
        out["comm_error"] = np.array(str(e))
    for rec in traced:
        for field, v in rec.items():
            if field != "placement":
                out[f"comm_{rec['placement']}_{field}"] = np.array(v)
    if P != APP_P:
        return out
    bodies = bodies_np()
    for strat in ("quorum", "atom"):
        out[f"nbody_{strat}"] = _np(nbody.distributed_forces(
            bodies, comm, strategy=strat))
    xb = nbody._blocks(bodies, comm)
    out["resident_quorum"] = np.array(
        quorum_gather(xb, build_schedule(P), comm).nbytes)
    out["resident_atom"] = np.array(comm.all_gather(xb).nbytes)
    out["pcit_corr"], out["pcit_keep"] = (
        _np(t) for t in pcit.run_quorum_pcit(expression_np(), comm))
    q, k, v = (torch.as_tensor(a) for a in qkv_np())
    for strat in ("quorum", "ring"):
        out[f"attn_{strat}"] = _np(attention.distributed_attention(
            q, k, v, comm, strategy=strat))
    return out


def _rank_main(rank, P, store, out_dir):
    torch.set_num_threads(1)
    comm = DistributedComm("gloo", rank=rank, world_size=P,
                           init_method=f"file://{store}", device="cpu",
                           timeout=RANK_TIMEOUT)
    try:
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **_rank_outputs(comm, P))
    finally:
        comm.close()


def _rank_raises(rank, P, store, timeout_s):
    torch.set_num_threads(1)
    comm = DistributedComm(
        "gloo", rank=rank, world_size=P, init_method=f"file://{store}",
        device="cpu", timeout=datetime.timedelta(seconds=timeout_s))
    try:
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        comm.ppermute(torch.ones(1, 4), 1)   # waits for rank 1
    finally:
        comm.close()


def _rank_alone(rank, store, timeout_s):
    # world size 2, but the peer never starts
    DistributedComm("gloo", rank=0, world_size=2,
                    init_method=f"file://{store}", device="cpu",
                    timeout=datetime.timedelta(seconds=timeout_s))


def _join(ctxs, seconds):
    """Join ``torch.multiprocessing`` contexts until all end; a failed
    rank raises (its context kills the rest), and ranks still running at
    the deadline are killed and fail the test."""
    deadline = time.monotonic() + seconds
    pending = list(ctxs)
    while pending:
        pending = [c for c in pending if not c.join(timeout=0.2)]
        if pending and time.monotonic() > deadline:
            for c in pending:
                for p in c.processes:
                    p.kill()
            pytest.fail(f"ranks still running after {seconds} s")


def _spawn(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference and the three gloo spawns together; return
    (reference outputs, {P: [rank outputs]})."""
    d = tmp_path_factory.mktemp("torch_dist")
    q, k, v = qkv_np()
    np.savez(d / "inputs.npz", X=expression_np(), bodies=bodies_np(),
             q=q, k=k, v=v)
    code = REFERENCE % {"ps": PS, "modes": MODES, "app_p": APP_P}
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", code, str(d / "ref.npz"),
         str(d / "inputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ctxs = []
        for P in PS:
            (d / f"P{P}").mkdir()
            ctxs.append(_spawn(_rank_main, P, (P, str(d / f"store{P}"),
                                               str(d / f"P{P}"))))
        _join(ctxs, SPAWN_SECONDS)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    ranks = {P: [dict(np.load(d / f"P{P}" / f"rank{r}.npz"))
                 for r in range(P)] for P in PS}
    return dict(np.load(d / "ref.npz")), ranks


@pytest.fixture(scope="module")
def single():
    """The same paths on ``SingleProcessComm`` in this process."""
    out = {P: selfcheck.main(P, device="cpu") for P in PS}
    comm = SingleProcessComm(APP_P, "cpu")
    bodies = bodies_np()
    for strat in ("quorum", "atom"):
        out[f"nbody_{strat}"] = nbody.distributed_forces(
            bodies, comm, strategy=strat).numpy()
    corr, keep = pcit.run_quorum_pcit(expression_np(), comm)
    out["pcit_corr"], out["pcit_keep"] = corr.numpy(), keep.numpy()
    q, k, v = (torch.as_tensor(a) for a in qkv_np())
    for strat in ("quorum", "ring"):
        out[f"attn_{strat}"] = attention.distributed_attention(
            q, k, v, comm, strategy=strat).numpy()
    return out


def stacked(ranks, key, axis=0):
    """The ranks' rows of ``key`` joined in rank order."""
    return np.concatenate([r[key] for r in ranks], axis=axis)


# ---------------------------------------------------------------------------
# The engine selfcheck
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES + ("allgather",))
@pytest.mark.parametrize("P", PS)
def test_selfcheck_matches_jax(runs, P, mode):
    ref, ranks = runs
    got = stacked(ranks[P], f"sc_{mode}")
    x = np.random.default_rng(0).normal(size=(P * 8, 3)).astype(np.float32)
    np.testing.assert_allclose(got, ref[f"sc{P}_{mode}"], **SC_TOL)
    np.testing.assert_allclose(got, selfcheck.oracle(x), **SC_TOL)


@pytest.mark.parametrize("mode", MODES + ("allgather",))
@pytest.mark.parametrize("P", PS)
def test_selfcheck_matches_single_process(runs, single, P, mode,
                                          record_property):
    got = stacked(runs[1][P], f"sc_{mode}")
    want = single[P][mode]
    record_property("bit_equal", bool(np.array_equal(got, want)))
    np.testing.assert_allclose(got, want, **SC_TOL)


# ---------------------------------------------------------------------------
# PCIT, n-body, attention at P = 8
# ---------------------------------------------------------------------------

def test_pcit_matches_jax(runs):
    ref, ranks = runs
    X = expression_np()
    corr = stacked(ranks[APP_P], "pcit_corr")
    keep = stacked(ranks[APP_P], "pcit_keep")
    np.testing.assert_allclose(corr, np.asarray(ref["pcit_corr"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(corr, pcit.correlation_reference(X),
                               rtol=1e-4, atol=1e-5)
    assert (keep == np.asarray(ref["pcit_keep"])).all()
    assert (keep == pcit.pcit_reference(X)).all()


@pytest.mark.parametrize("strategy", ["quorum", "atom"])
def test_nbody_matches_jax(runs, strategy):
    ref, ranks = runs
    got = stacked(ranks[APP_P], f"nbody_{strategy}")
    for want in (ref[f"nbody_{strategy}"],
                 nbody.forces_reference(bodies_np())):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("strategy", ["quorum", "ring"])
def test_attention_matches_jax(runs, strategy):
    ref, ranks = runs
    got = stacked(ranks[APP_P], f"attn_{strategy}", axis=1)
    q, k, v = (torch.as_tensor(a) for a in qkv_np())
    for want in (ref[f"attn_{strategy}"],
                 attention.reference_attention(q, k, v).numpy()):
        assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("key,axis", [
    ("pcit_corr", 0), ("pcit_keep", 0), ("nbody_quorum", 0),
    ("nbody_atom", 0), ("attn_quorum", 1), ("attn_ring", 1)])
def test_apps_match_single_process(runs, single, key, axis,
                                   record_property):
    got = stacked(runs[1][APP_P], key, axis=axis)
    want = single[key]
    record_property("bit_equal", bool(np.array_equal(got, want)))
    if key == "pcit_keep":
        assert (got == want).all()
    elif key == "pcit_corr":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    elif key.startswith("nbody"):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    else:
        assert np.abs(got - want).max() < 1e-4


def test_resident_bytes_k_over_p(runs):
    """Each rank holds k of the P blocks under the quorum and all P under
    the atom decomposition: the paper's memory claim, per process."""
    k = build_schedule(APP_P).k
    for r in runs[1][APP_P]:
        assert int(r["resident_quorum"]) * APP_P \
            == int(r["resident_atom"]) * k
        assert int(r["resident_atom"]) == 64 * 4 * 4   # all N bodies


# ---------------------------------------------------------------------------
# The comm layer and its byte counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [5, 8])
def test_ppermute_matches_single_process(runs, P):
    ranks = runs[1][P]
    f, b = comm_stack(P)
    one = SingleProcessComm(P, "cpu")
    for s in range(-P, 2 * P + 1):
        np.testing.assert_array_equal(stacked(ranks, f"ppermute_f{s}"),
                                      one.ppermute(f, s).numpy())
        np.testing.assert_array_equal(stacked(ranks, f"ppermute_b{s}"),
                                      one.ppermute(b, s).numpy())


@pytest.mark.parametrize("P", PS)
def test_all_gather_and_axis_index(runs, P):
    ranks = runs[1][P]
    f, _ = comm_stack(P)
    one = SingleProcessComm(P, "cpu")
    np.testing.assert_array_equal(stacked(ranks, "all_gather"),
                                  one.all_gather(f).numpy())
    np.testing.assert_array_equal(stacked(ranks, "axis_index"),
                                  one.axis_index().numpy())


@pytest.mark.parametrize("P", PS)
def test_dense_comm_bytes_exact_on_every_rank(runs, P):
    block_bytes = obs_comm.block_bytes_of(4, 3)
    for rank, r in enumerate(runs[1][P]):
        assert str(r["comm_error"]) == "", f"rank {rank}: {r['comm_error']}"
        for plc in supported_placements(P):
            pred = obs_comm.predict_sweep_comm(plc, block_bytes)
            for field in ("gather_bytes", "scatter_bytes", "gather_hops",
                          "scatter_hops", "allgather_bytes"):
                assert int(r[f"comm_{plc.name}_{field}"]) \
                    == getattr(pred, field), (rank, plc.name, field)


# ---------------------------------------------------------------------------
# Failures and errors
# ---------------------------------------------------------------------------

def test_rank_that_raises_fails_the_spawn(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a shift: the spawn fails
    (with whichever rank's error it sees first: rank 1's, or rank 0's lost
    peer) well within the collective's 30 s timeout."""
    t0 = time.monotonic()
    ctx = _spawn(_rank_raises, 2, (2, str(tmp_path / "store"), 30))
    with pytest.raises(mp.ProcessRaisedException):
        _join([ctx], 120)
    assert time.monotonic() - t0 < 30


def test_missing_peer_times_out(tmp_path):
    """A rank whose peer never starts fails at its 3 s timeout instead of
    waiting for ever."""
    t0 = time.monotonic()
    ctx = _spawn(_rank_alone, 1, (str(tmp_path / "store"), 3))
    with pytest.raises(mp.ProcessRaisedException):
        _join([ctx], 120)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("backend,device,error", [
    ("nccl", "cpu", ValueError),
    ("nccl", None, RuntimeError),
    ("gloo", None, RuntimeError),
    ("mpi", "cpu", ValueError)])
def test_missing_transport_or_device_raises(tmp_path, backend, device,
                                            error):
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    with pytest.raises(error):
        DistributedComm(backend, rank=0, world_size=1,
                        init_method=f"file://{tmp_path / 'store'}",
                        device=device)
    assert not torch.distributed.is_initialized()


def test_from_env_one_rank(monkeypatch):
    with pytest.raises(RuntimeError, match="torchrun"):
        DistributedComm.from_env("gloo", device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    comm = DistributedComm.from_env("gloo", device="cpu")
    try:
        x = torch.arange(6.0).reshape(1, 3, 2)
        assert comm.P == 1 and comm.local == range(0, 1)
        assert comm.transport == "gloo" and "gloo" in repr(comm)
        assert comm.ppermute(x, 3) is x
        assert torch.equal(comm.all_gather(x), x.unsqueeze(0))
    finally:
        comm.close()
    assert not torch.distributed.is_initialized()
