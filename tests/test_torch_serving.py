"""The port's serving tier (``repro_torch/serving``) held against the JAX
package's.

One JAX subprocess (8 fake CPU devices) wraps the reference's
``quorum_query_topk`` / ``quorum_query_threshold`` in its own
``shard_map`` and converts whole outputs with ``np.asarray`` (the
reference's own ``query_fn`` indexes sharded outputs with ``vals[0]``,
which jax 0.9 refuses); it writes per-device outputs for every mode,
including the Pallas kernel in interpret mode, to an ``.npz``.  The port
runs in-process on the CPU, where the ``kernel`` mode takes B4's plain
version.  Indices and counts must be equal, values within rtol 1e-5.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import selfcheck as r_selfcheck
from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.placement import get_placement
from repro_torch.kernels import ops
from repro_torch.obs import trace as t_trace
from repro_torch.serving import engine, selfcheck, stream
from repro_torch.serving.cover import build_cover
from repro_torch.serving.engine import (ServingCorpus, quantize_pow2,
                                        quorum_query_threshold,
                                        quorum_query_topk, tree_merge_topk)

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (5, 8)
MODES = ("batched", "overlap", "scan")
METRICS = ("dot", "l2")
BLOCK, D, Q, TOPK, CAP, SMALL_CAP = 16, 24, 12, 8, 32, 4
TOL = dict(rtol=1e-5, atol=1e-5)

REFERENCE = r"""
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core.placement import get_placement
from repro.core.sparse import threshold_with_gap
from repro.kernels import ops as kops
from repro.serving.cover import build_cover
from repro.serving.engine import quorum_query_threshold, quorum_query_topk
from repro.serving.stream import build_state

BLOCK, D, Q, TOPK, CAP, SMALL_CAP = 16, 24, 12, 8, 32, 4
out = {}
for P in (5, 8):
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    plc = get_placement("cyclic", P)
    sched = plc.schedule()
    mt = jnp.asarray(build_cover(P, plc).mask_table())
    rng = np.random.default_rng(P)
    N = P * BLOCK - BLOCK
    corpus = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    out[f"P{P}_corpus"], out[f"P{P}_queries"] = corpus, queries
    st = build_state(corpus, mesh, "q", block=BLOCK, placement=plc)
    for f in st._fields:
        out[f"P{P}_state_{f}"] = np.asarray(getattr(st, f))
    for metric in ("dot", "l2"):
        for mode in ("batched", "overlap", "scan", "kernel"):
            m, bf = ((mode, None) if mode != "kernel" else
                     ("batched", functools.partial(kops.query_topk,
                                                   topk=TOPK, metric=metric)))
            def body(q, s, sv, mr, m=m, bf=bf, metric=metric):
                v, i = quorum_query_topk(q, s, sv, mr, topk=TOPK,
                                         axis_name="q", schedule=sched,
                                         mode=m, metric=metric, batch_fn=bf)
                return v[None], i[None]
            v, i = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(PS(), PS("q"), PS("q"), PS("q")),
                out_specs=(PS("q"), PS("q")), check_vma=False))(
                    queries, st.stack, st.stack_valid, mt)
            out[f"P{P}_{metric}_{mode}_v"] = np.asarray(v)
            out[f"P{P}_{metric}_{mode}_i"] = np.asarray(i)
        c = corpus
        s = queries @ c.T
        if metric == "l2":
            s = 2.0 * s - (c * c).sum(-1)[None] - (queries ** 2).sum(-1)[:, None]
        thr = threshold_with_gap(s, 0.1)
        out[f"P{P}_{metric}_thr"] = np.float32(thr)
        for mode, cap in [(m, CAP) for m in ("batched", "overlap", "scan")] + [
                ("batched", SMALL_CAP)]:
            def body(q, t, s, sv, mr, mode=mode, cap=cap, metric=metric):
                v, i, n = quorum_query_threshold(
                    q, s, sv, mr, threshold=t, capacity=cap, axis_name="q",
                    schedule=sched, mode=mode, metric=metric)
                return v[None], i[None], n[None]
            v, i, n = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(PS(), PS(), PS("q"), PS("q"), PS("q")),
                out_specs=(PS("q"),) * 3, check_vma=False))(
                    queries, jnp.float32(thr), st.stack, st.stack_valid, mt)
            key = f"P{P}_{metric}_{mode}_cap{cap}"
            out[key + "_v"], out[key + "_i"], out[key + "_n"] = (
                np.asarray(v), np.asarray(i), np.asarray(n))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "serving.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


def _setup(reference, P):
    comm = SingleProcessComm(P, "cpu")
    state = stream.build_state(reference[f"P{P}_corpus"], comm, block=BLOCK,
                               placement=get_placement("cyclic", P))
    mt = torch.as_tensor(build_cover(P).mask_table())
    return comm, state, mt, torch.as_tensor(reference[f"P{P}_queries"])


@pytest.mark.parametrize("P", PS)
def test_state_matches_jax(reference, P):
    """build_state's one gather of shard + validity equals the reference's
    resident state, carried across by state_from_numpy."""
    comm, state, _mt, _q = _setup(reference, P)
    want = stream.state_from_numpy(
        *(reference[f"P{P}_state_{f}"] for f in stream.ServingState._fields),
        P)
    for f in stream.ServingState._fields:
        assert torch.equal(getattr(state, f), getattr(want, f)), f


@pytest.mark.parametrize("mode", MODES + ("kernel",))
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_query_topk_matches_jax(reference, P, metric, mode):
    comm, state, mt, queries = _setup(reference, P)
    m, bf = ((mode, None) if mode != "kernel" else
             ("batched", functools.partial(ops.query_topk, topk=TOPK,
                                           metric=metric)))
    v, i = quorum_query_topk(queries, state.stack, state.stack_valid, mt,
                             topk=TOPK, comm=comm,
                             schedule=get_placement("cyclic", P).schedule(),
                             mode=m, metric=metric, batch_fn=bf)
    np.testing.assert_array_equal(i.numpy(),
                                  reference[f"P{P}_{metric}_{mode}_i"])
    np.testing.assert_allclose(v.numpy(),
                               reference[f"P{P}_{metric}_{mode}_v"], **TOL)


@pytest.mark.parametrize("mode,cap", [(m, CAP) for m in MODES]
                         + [("batched", SMALL_CAP)])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_query_threshold_matches_jax(reference, P, metric, mode, cap):
    """Per-device range-query buffers and true counts, including an
    overflowing capacity (the kept subset follows the ring order)."""
    comm, state, mt, queries = _setup(reference, P)
    key = f"P{P}_{metric}_{mode}_cap{cap}"
    v, i, n = quorum_query_threshold(
        queries, state.stack, state.stack_valid, mt,
        threshold=float(reference[f"P{P}_{metric}_thr"]), capacity=cap,
        comm=comm, schedule=get_placement("cyclic", P).schedule(), mode=mode,
        metric=metric)
    np.testing.assert_array_equal(n.numpy(), reference[key + "_n"])
    np.testing.assert_array_equal(i.numpy(), reference[key + "_i"])
    np.testing.assert_allclose(v.numpy(), reference[key + "_v"], **TOL)
    if cap == SMALL_CAP:
        assert (n > cap).any()


@pytest.mark.parametrize("P", [2, 5, 8])
def test_serving_selfcheck(P, capsys):
    """Every mode against the numpy oracle, through a replace and an
    append, and the threshold path with escalation."""
    selfcheck.main(P, device="cpu")
    assert "serving selfcheck OK" in capsys.readouterr().out


def test_oracles_match_reference():
    rng = np.random.default_rng(3)
    full = rng.normal(size=(40, 6)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.3
    q = rng.normal(size=(5, 6)).astype(np.float32)
    for metric in METRICS:
        for a, b in zip(selfcheck.oracle_topk(full, valid, q, 7, metric),
                        r_selfcheck.oracle_topk(full, valid, q, 7, metric)):
            np.testing.assert_array_equal(a, b)
        for (ai, av), (bi, bv) in zip(
                selfcheck.oracle_threshold(full, valid, q, 0.5, metric),
                r_selfcheck.oracle_threshold(full, valid, q, 0.5, metric)):
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(av, bv)


@pytest.mark.parametrize("mode", MODES + ("kernel",))
def test_updates_against_reference_oracles(mode):
    """After replace_block and append_block, top-k and range queries equal
    the reference's numpy oracles over the updated corpus."""
    P, block, d = 5, 12, 10
    comm = SingleProcessComm(P, "cpu")
    rng = np.random.default_rng(11)
    corpus = rng.normal(size=(P * block - block, d)).astype(np.float32)
    queries = rng.normal(size=(7, d)).astype(np.float32)
    sc = ServingCorpus.build(corpus, comm, block=block, placement="cyclic")
    full = np.zeros((P * block, d), np.float32)
    full[:len(corpus)] = corpus
    valid = np.arange(P * block) < len(corpus)
    fresh = rng.normal(size=(block - 4, d)).astype(np.float32)
    sc.replace_block(2, fresh)
    full[2 * block:3 * block] = 0.0
    full[2 * block:2 * block + len(fresh)] = fresh
    valid[2 * block:3 * block] = np.arange(block) < len(fresh)
    extra = rng.normal(size=(block, d)).astype(np.float32)
    assert sc.append_block(extra) == P - 1
    full[(P - 1) * block:] = extra
    valid[(P - 1) * block:] = True
    m, uk = ("batched", True) if mode == "kernel" else (mode, False)
    for metric in METRICS:
        wv, wi = r_selfcheck.oracle_topk(full, valid, queries, 6, metric)
        gv, gi = sc.query(queries, topk=6, mode=m, metric=metric,
                          use_kernel=uk)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_allclose(gv.numpy(), wv, **TOL)
        if mode == "kernel":
            continue
        s = queries @ full[valid].T
        if metric == "l2":
            s = (2.0 * s - (full[valid] ** 2).sum(-1)[None]
                 - (queries ** 2).sum(-1)[:, None])
        from repro.core.sparse import threshold_with_gap
        thr = threshold_with_gap(s, 0.2)
        want = r_selfcheck.oracle_threshold(full, valid, queries, thr, metric)
        gv, gi, gc = sc.query_threshold(queries, threshold=thr, mode=m,
                                        metric=metric, capacity=2)
        for r, (wi_r, wv_r) in enumerate(want):
            n = int(gc[r])
            assert n == len(wi_r)
            np.testing.assert_array_equal(gi[r, :n].numpy(), wi_r)
            np.testing.assert_allclose(gv[r, :n].numpy(), wv_r, **TOL)


def test_quantize_pow2_and_topk_buckets():
    assert [quantize_pow2(n) for n in (0, 1, 2, 3, 10, 100, 128, 129)] == \
        [1, 1, 2, 4, 16, 128, 128, 256]
    assert quantize_pow2(3, floor=8) == 8
    P = 4
    comm = SingleProcessComm(P, "cpu")
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(40, 8)).astype(np.float32)
    sc = ServingCorpus.build(corpus, comm)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    engine.query_fn.cache_clear()
    v5, i5 = sc.query(q, topk=5)
    v8, i8 = sc.query(q, topk=8)
    assert v5.shape == (3, 5) and engine.query_fn.cache_info().currsize == 1
    assert torch.equal(i5, i8[:, :5])     # the prefix of the bucket's list
    with pytest.raises(ValueError, match="topk"):
        sc.query(q, topk=0)


def test_tree_merge_gives_global_topk_on_every_device():
    """After ceil(log2 P) rounds every device holds the top-k of the union
    of all devices' lists, for P not a power of two as well."""
    for P in (3, 5, 8):
        comm = SingleProcessComm(P, "cpu")
        rng = np.random.default_rng(P)
        vals = torch.as_tensor(rng.normal(size=(P, 4, 6)).astype(np.float32))
        idx = torch.as_tensor(rng.permutation(P * 4 * 6).reshape(P, 4, 6),
                              dtype=torch.int32)
        v, i = tree_merge_topk(vals, idx, comm=comm, topk=6)
        allv = vals.permute(1, 0, 2).reshape(4, -1)
        alli = idx.permute(1, 0, 2).reshape(4, -1)
        wv, wi = engine.topk_by_score(allv, alli, 6)
        for dev in range(P):
            assert torch.equal(i[dev], wi) and torch.equal(v[dev], wv)


def test_argument_contract(monkeypatch):
    comm = SingleProcessComm(4, "cpu")
    corpus = np.zeros((27, 6), np.float32)
    # quant keeps a quantized stack (argument first, then REPRO_QUANT) that
    # query() routes to, with the f32 path's results
    rows = np.random.default_rng(2).normal(size=(27, 6)).astype(np.float32)
    queries = rows[:3] + 0.5
    want = ServingCorpus.build(rows, comm, quant="off").query(queries, topk=3)
    sc = ServingCorpus.build(rows, comm, quant="int8")
    monkeypatch.setenv("REPRO_QUANT", "bf16")
    sc_env = ServingCorpus.build(rows, comm)
    assert (sc.quant.mode, sc_env.quant.mode) == ("int8", "bf16")
    for c in (sc, sc_env):
        v, i = c.query(queries, topk=3)
        np.testing.assert_array_equal(i.numpy(), want[1].numpy())
        np.testing.assert_allclose(v.numpy(), want[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="f32 serving path only"):
        sc.query(queries, topk=3, use_kernel=True)
    monkeypatch.setenv("REPRO_QUANT", "off")
    sc = ServingCorpus.build(corpus, comm, block=9)
    with pytest.raises(ValueError, match="batched"):
        sc.query(np.zeros((2, 6), np.float32), topk=3, mode="scan",
                 use_kernel=True)
    with pytest.raises(ValueError, match="out of range"):
        sc.replace_block(4, np.zeros((2, 6)))
    with pytest.raises(ValueError, match="block capacity is 9"):
        sc.replace_block(0, np.zeros((10, 6)))
    with pytest.raises(ValueError, match=r"\[rows, 6\]"):
        sc.append_block(np.zeros((2, 5)))
    with pytest.raises(ValueError, match="nvalid"):
        sc.replace_block(1, np.zeros((3, 6)), nvalid=4)
    assert sc.append_block(np.ones((9, 6))) == 3
    with pytest.raises(ValueError, match="corpus full"):
        sc.append_block(np.ones((1, 6)))


def test_dirty_listeners_and_tracing(monkeypatch):
    """Streamed updates notify the dirty listeners; a traced query is one
    serving.query span with the queries counted, and the tree merge
    counts its hops."""
    seen = []
    fn = stream.register_dirty_listener(seen.append)
    P = 5
    comm = SingleProcessComm(P, "cpu")
    rng = np.random.default_rng(1)
    sc = ServingCorpus.build(rng.normal(size=(40, 4)).astype(np.float32),
                             comm, block=10)
    try:
        sc.replace_block(1, np.ones((3, 4)))
        sc.append_block(np.ones((2, 4)))
    finally:
        stream.unregister_dirty_listener(fn)
    stream.unregister_dirty_listener(fn)          # a no-op the second time
    assert seen == [1, 4]
    tr = t_trace.configure()
    try:
        sc.query(rng.normal(size=(3, 4)), topk=2)
        sc.query_threshold(rng.normal(size=(3, 4)), threshold=0.0,
                           capacity=1)
    finally:
        t_trace.reset()
    assert [e["name"] for e in tr.events].count("serving.query") == 1
    assert tr.counter_total("serving.queries") == 6
    assert tr.counter_total("comm.ppermute.merge_hops") == 3  # ceil(log2 5)
    assert tr.counter_total("comm.ppermute.ring_hops") >= P - 1
    assert tr.counter_total("serving.threshold_escalations") >= 1


def test_env_mode_override(monkeypatch):
    """REPRO_ALLPAIRS_MODE forces mode='auto' of both query paths, and
    conflicts with the fused kernel."""
    P = 4
    comm = SingleProcessComm(P, "cpu")
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(32, 6)).astype(np.float32)
    q = rng.normal(size=(5, 6)).astype(np.float32)
    sc = ServingCorpus.build(corpus, comm)
    want = sc.query(q, topk=4, mode="batched")
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "scan")
    got = sc.query(q, topk=4)
    assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="conflicts"):
        sc.query(q, topk=4, use_kernel=True)
