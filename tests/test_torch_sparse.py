"""The port's similarity join (``repro_torch/core/sparse.py``) held against
the JAX package's.

One JAX subprocess (8 fake CPU devices) wraps the reference's
``quorum_allpairs_threshold`` in its own ``shard_map`` (``check_vma`` off,
which the Pallas kernel needs on jax 0.9) and converts whole outputs with
``np.asarray``; it writes every device's compacted buffers for every mode,
including the Pallas kernel in interpret mode and overflowing capacities,
plus the reference's ``similarity_join`` results, to an ``.npz``.  The port
runs in-process on the CPU, where the ``kernel`` mode takes B5's plain
version.  Ids and counts must be equal, values within rtol 1e-5.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sparse as r_sparse
from repro_torch.core import quant as t_quant
from repro_torch.core import sparse
from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.placement import get_placement
from repro_torch.kernels import ops
from repro_torch.obs import trace as t_trace

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (5, 8)
MODES = ("batched", "overlap", "scan", "kernel")
METRICS = ("dot", "l2")
BLOCK, D, CAP, SMALL_CAP = 8, 16, 64, 4
TOL = dict(rtol=1e-5, atol=1e-5)

REFERENCE = r"""
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core.placement import get_placement
from repro.core.sparse import (pair_mask_table, quorum_allpairs_threshold,
                               ring_allgather_hits, similarity_join,
                               threshold_for_selectivity)
from repro.kernels import ops as kops

BLOCK, D, CAP, SMALL_CAP = 8, 16, 64, 4
out = {}
for P in (5, 8):
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    sched = get_placement("cyclic", P).schedule()
    N = P * BLOCK - 3
    rng = np.random.default_rng(P)
    corpus = rng.normal(size=(N, D)).astype(np.float32)
    corpus[:2 * BLOCK] *= 0.05           # prunable tiles for `dot`
    out[f"P{P}_corpus"] = corpus
    x = np.zeros((P * BLOCK, D), np.float32)
    x[:N] = corpus
    mt = jnp.asarray(pair_mask_table(sched))
    cases = [(metric, mode, CAP, True) for metric in ("dot", "l2")
             for mode in ("batched", "overlap", "scan", "kernel")]
    cases += [("dot", mode, SMALL_CAP, True)
              for mode in ("batched", "overlap", "scan", "kernel")]
    cases += [("l2", "batched", CAP, False)]
    for metric, mode, cap, pf in cases:
        thr = threshold_for_selectivity(corpus, 0.08, metric)
        out[f"P{P}_{metric}_thr"] = np.float32(thr)
        m, bf = ((mode, None) if mode != "kernel" else
                 ("batched", functools.partial(
                     kops.pairwise_threshold, threshold=thr, capacity=cap,
                     block_rows=BLOCK, metric=metric)))
        def body(xb, mb, m=m, bf=bf, thr=thr, cap=cap, pf=pf, metric=metric):
            h = quorum_allpairs_threshold(
                xb, threshold=thr, axis_name="q", capacity=cap,
                schedule=sched, mask=mb, metric=metric, mode=m, n_valid=N,
                prefilter=pf, batch_fn=bf)
            g = ring_allgather_hits(h, axis_name="q", P=P)
            return (h.vals[None], h.i[None], h.j[None], h.count.reshape(1),
                    g.vals[None], g.count[None])
        res = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS("q"), PS("q")),
            out_specs=(PS("q"),) * 6, check_vma=False))(x, mt)
        key = f"P{P}_{metric}_{mode}_cap{cap}_pf{int(pf)}"
        for name, a in zip(("v", "i", "j", "n", "gv", "gn"), res):
            out[f"{key}_{name}"] = np.asarray(a)
    if P == 8:
        for metric in ("dot", "l2"):
            thr = threshold_for_selectivity(corpus, 0.08, metric)
            r = similarity_join(corpus, mesh, threshold=thr, metric=metric,
                                mode="batched", placement="cyclic",
                                capacity=SMALL_CAP)
            for f in ("i", "j", "scores", "counts"):
                out[f"join_{metric}_{f}"] = getattr(r, f)
            out[f"join_{metric}_esc"] = np.int64(r.escalations)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "sparse.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


def _run(reference, P, metric, mode, cap, prefilter):
    comm = SingleProcessComm(P, "cpu")
    corpus = reference[f"P{P}_corpus"]
    N = corpus.shape[0]
    x = torch.zeros(P * BLOCK, D)
    x[:N] = torch.as_tensor(corpus)
    thr = float(reference[f"P{P}_{metric}_thr"])
    m, bf = ((mode, None) if mode != "kernel" else
             ("batched", functools.partial(
                 ops.pairwise_threshold, threshold=thr, capacity=cap,
                 block_rows=BLOCK, metric=metric)))
    hits = sparse.quorum_allpairs_threshold(
        x.reshape(P, BLOCK, D), comm, threshold=thr, capacity=cap,
        schedule=get_placement("cyclic", P).schedule(), metric=metric,
        mode=m, n_valid=N, prefilter=prefilter, batch_fn=bf)
    return comm, hits


def _check_hits(reference, key, hits):
    np.testing.assert_array_equal(hits.count.numpy(), reference[key + "_n"])
    np.testing.assert_array_equal(hits.i.numpy(), reference[key + "_i"])
    np.testing.assert_array_equal(hits.j.numpy(), reference[key + "_j"])
    np.testing.assert_allclose(hits.vals.numpy(), reference[key + "_v"],
                               **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_hits_match_jax(reference, P, metric, mode):
    """Every device's compacted (vals, i, j, count), prefilter on."""
    _comm, hits = _run(reference, P, metric, mode, CAP, True)
    _check_hits(reference, f"P{P}_{metric}_{mode}_cap{CAP}_pf1", hits)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", PS)
def test_overflow_prefix_matches_jax(reference, P, mode):
    """An overflowing capacity keeps the same first entries and the true
    counts, in every mode's own tile order."""
    _comm, hits = _run(reference, P, "dot", mode, SMALL_CAP, True)
    _check_hits(reference, f"P{P}_dot_{mode}_cap{SMALL_CAP}_pf1", hits)
    assert (hits.count > SMALL_CAP).any()


@pytest.mark.parametrize("P", PS)
def test_prefilter_off_and_ring_gather_match_jax(reference, P):
    comm, hits = _run(reference, P, "l2", "batched", CAP, False)
    key = f"P{P}_l2_batched_cap{CAP}_pf0"
    _check_hits(reference, key, hits)
    g = sparse.ring_allgather_hits(hits, comm)
    np.testing.assert_allclose(g.vals.numpy(), reference[key + "_gv"], **TOL)
    np.testing.assert_array_equal(g.count.numpy(), reference[key + "_gn"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_join_matches_jax(reference, metric, use_kernel):
    """The host entry point, escalating from a small capacity, against the
    reference's join and the brute-force oracle."""
    P = 8
    corpus = reference[f"P{P}_corpus"]
    thr = float(reference[f"P{P}_{metric}_thr"])
    res = sparse.similarity_join(corpus, SingleProcessComm(P, "cpu"),
                                 threshold=thr, metric=metric,
                                 mode="batched", placement="cyclic",
                                 capacity=SMALL_CAP, use_kernel=use_kernel)
    np.testing.assert_array_equal(res.i, reference[f"join_{metric}_i"])
    np.testing.assert_array_equal(res.j, reference[f"join_{metric}_j"])
    np.testing.assert_allclose(res.scores, reference[f"join_{metric}_scores"],
                               **TOL)
    np.testing.assert_array_equal(res.counts,
                                  reference[f"join_{metric}_counts"])
    assert res.escalations == int(reference[f"join_{metric}_esc"]) >= 1
    wi, wj, _ = r_sparse.brute_force_join(corpus, thr, metric)
    np.testing.assert_array_equal(res.i, wi)
    np.testing.assert_array_equal(res.j, wj)


@pytest.mark.parametrize("P", [2, 5, 8])
def test_sparse_selfcheck(P, capsys):
    sparse.selfcheck_main(P, device="cpu")
    assert "sparse selfcheck OK" in capsys.readouterr().out


def test_host_helpers_match_reference(monkeypatch):
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(30, 5)).astype(np.float32)
    for metric in METRICS:
        np.testing.assert_array_equal(
            sparse._pair_score_matrix(corpus, metric),
            r_sparse._pair_score_matrix(corpus, metric))
        thr = sparse.threshold_for_selectivity(corpus, 0.1, metric)
        assert thr == r_sparse.threshold_for_selectivity(corpus, 0.1, metric)
        for a, b in zip(sparse.brute_force_join(corpus, thr, metric),
                        r_sparse.brute_force_join(corpus, thr, metric)):
            np.testing.assert_array_equal(a, b)
    s = rng.normal(size=(4, 50))
    assert sparse.threshold_with_gap(s, 0.2) == r_sparse.threshold_with_gap(
        s, 0.2)
    for n in (0, 1, 1000, 10 ** 6):
        assert sparse.default_capacity(n) == r_sparse.default_capacity(n)
    monkeypatch.setenv("REPRO_SPARSE_CAPACITY", "77")
    assert sparse.default_capacity(10 ** 6) == 77
    monkeypatch.setenv("REPRO_SPARSE_CAPACITY", "0")
    with pytest.raises(ValueError, match="REPRO_SPARSE_CAPACITY"):
        sparse.default_capacity(10)


def test_pair_score_bounds_match_reference():
    """The prefilter bounds per device, with an all-invalid slot."""
    rng = np.random.default_rng(5)
    k, block = 4, 6
    quorum = rng.normal(size=(2, k, block, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, k, block)) > 0.3
    valid[1, 2] = False
    lo, hi = np.array([0, 1, 2, 3, 0]), np.array([0, 2, 3, 1, 2])
    for metric in METRICS:
        got = sparse.pair_score_bounds(torch.as_tensor(quorum),
                                       torch.as_tensor(valid), lo, hi, metric)
        for p in range(2):
            want = r_sparse.pair_score_bounds(jnp.asarray(quorum[p]),
                                              jnp.asarray(valid[p]), lo, hi,
                                              metric)
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want),
                                       rtol=1e-6)


def test_counters_and_pruned_tiles(reference):
    """The sparse.* counters of a traced join; tiles_pruned equals the
    reference's host replay."""
    P = 8
    corpus = reference[f"P{P}_corpus"]
    thr = float(reference[f"P{P}_dot_thr"])
    tr = t_trace.configure()
    try:
        res = sparse.similarity_join(corpus, SingleProcessComm(P, "cpu"),
                                     threshold=thr, capacity=SMALL_CAP)
    finally:
        t_trace.reset()
    sched = get_placement("cyclic", P).schedule()
    x = np.zeros((P * BLOCK, D), np.float32)
    x[:len(corpus)] = corpus
    want = r_sparse._count_pruned_tiles(x, len(corpus), BLOCK, sched, thr,
                                        "dot")
    assert want > 0
    assert tr.counter_total("sparse.tiles_pruned") == want
    assert tr.counter_total("sparse.tiles_scheduled") == P * sched.n_pairs
    assert tr.counter_total("sparse.escalations") == res.escalations >= 1
    assert tr.counter_total("sparse.pairs_emitted") == res.n_pairs
    assert [e["name"] for e in tr.events].count("sparse.join") == 1


def test_argument_contract(monkeypatch):
    comm = SingleProcessComm(4, "cpu")
    corpus = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    # quant routes to the quantized join (argument first, then REPRO_QUANT),
    # which gives the f32 join's pairs
    want = sparse.similarity_join(corpus, comm, threshold=0.0, quant="off")
    seen = []
    real = t_quant.quant_similarity_join
    monkeypatch.setattr(t_quant, "quant_similarity_join",
                        lambda *a, **kw: seen.append(kw["quant"])
                        or real(*a, **kw))
    got = [sparse.similarity_join(corpus, comm, threshold=0.0, quant="int8")]
    monkeypatch.setenv("REPRO_QUANT", "bf16")
    got.append(sparse.similarity_join(corpus, comm, threshold=0.0))
    assert seen == ["int8", "bf16"]
    for res in got:
        np.testing.assert_array_equal(res.i, want.i)
        np.testing.assert_array_equal(res.j, want.j)
    monkeypatch.delenv("REPRO_QUANT")
    with pytest.raises(ValueError, match="batched"):
        sparse.similarity_join(corpus, comm, threshold=0.0, mode="scan",
                               use_kernel=True)
    with pytest.raises(ValueError, match="metric"):
        sparse.similarity_join(corpus, comm, threshold=0.0, metric="cos")
    with pytest.raises(ValueError, match="capacity"):
        sparse.quorum_allpairs_threshold(torch.zeros(4, 5, 3), comm,
                                         threshold=0.0, capacity=0)
    with pytest.raises(ValueError, match="2\\^24"):
        sparse.similarity_join(np.zeros((1 << 24, 1), np.float32), comm,
                               threshold=0.0)
    low = sparse.similarity_join(corpus, comm, threshold=-1e9, capacity=2,
                                 escalate=False)
    assert low.overflow and low.n_pairs == int(np.minimum(low.counts, 2).sum())
    with pytest.raises(RuntimeError, match="overflows"):
        sparse.similarity_join(corpus, comm, threshold=-1e9, capacity=2,
                               max_doublings=1)
