"""The port's quantized scoring path (``repro_torch/core/quant.py``) held
against the JAX package's.

* quantization: ``quantize_corpus`` equals the reference's element for
  element (codes, scale, delta, l1, sq), the certified bounds agree within
  1e-12 relative;
* engines: one JAX subprocess (16 fake CPU devices) wraps the reference's
  ``quorum_allpairs_threshold_q`` / ``quorum_allpairs_knn_q`` in its own
  ``shard_map`` (``check_vma`` off; the reference's own drivers fail on
  jax 0.9) and writes every device's outputs, the Pallas kernels in
  interpret mode included; ids and counts must be equal, int8 values too,
  bf16 values within rtol 1e-5;
* drivers: ``quant_similarity_join``, ``quant_knn_graph`` and
  ``serving_query`` (after a block replace too) equal the reference's numpy
  oracles, indices exactly and scores within 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import knn as r_knn
from repro.core import quant as r_quant
from repro.core import sparse as r_sparse
from repro_torch.core import quant
from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.placement import get_placement
from repro_torch.kernels import ops
from repro_torch.serving import ServingCorpus

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [("cyclic", 4), ("cyclic", 5), ("cyclic", 8), ("cyclic", 13),
         ("full", 6)]
# (quant mode, metric, engine mode): every mode for int8 l2, the kernel
# hook for bf16 dot
CASES = ([("int8", "l2", m) for m in ("batched", "overlap", "scan", "kernel")]
         + [("bf16", "dot", "kernel")])
BLOCK, D, TOPK, CAP = 8, 16, 8, 96
TOL = dict(rtol=1e-5, atol=1e-5)
IDS = [f"{n}{p}" for n, p in CELLS]

REFERENCE = r"""
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core.placement import get_placement
from repro.core.quant import (QuantBlocks, _kernel_sd, quantize_corpus,
                              quorum_allpairs_knn_q,
                              quorum_allpairs_threshold_q)
from repro.core.sparse import threshold_for_selectivity
from repro.core.sweep import pair_mask_table
from repro.kernels import ops as kops

BLOCK, D, TOPK, CAP = 8, 16, 8, 96
out = {}
for name, P in %(cells)r:
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    sched = get_placement(name, P).schedule()
    N = P * BLOCK - 3
    rng = np.random.default_rng(P)
    corpus = rng.normal(size=(N, D)).astype(np.float32)
    corpus[:2 * BLOCK] *= 0.05
    x = np.zeros((P * BLOCK, D), np.float32)
    x[:N] = corpus
    out[f"{name}{P}_corpus"] = corpus
    mt = jnp.asarray(pair_mask_table(sched))
    for qm, metric, mode in %(cases)r:
        leaves = quantize_corpus(x, P, BLOCK, qm).device_arrays()
        thr = threshold_for_selectivity(corpus, 0.08, metric)
        out[f"{name}{P}_{metric}_thr"] = np.float64(thr)
        kern = mode == "kernel"
        m = "batched" if kern else mode
        def tbf(qb, lo, hi, meta, thr=thr, metric=metric):
            return kops.pairwise_threshold_q(
                qb.q, _kernel_sd(qb), qb.l1, qb.sq, lo, hi, meta,
                threshold=thr, capacity=CAP, block_rows=BLOCK, metric=metric)
        def kbf(qb, lo, hi, meta, metric=metric):
            return kops.pairwise_topk_q(
                qb.q, _kernel_sd(qb), qb.sq, lo, hi, meta, topk=TOPK,
                block_rows=BLOCK, metric=metric)
        def body(qa, sa, da, la, sqa, mb, m=m, thr=thr, metric=metric,
                 kern=kern):
            qb = QuantBlocks(q=qa, scale=sa, delta=da, l1=la, sq=sqa)
            h = quorum_allpairs_threshold_q(
                qb, threshold=thr, axis_name="q", capacity=CAP,
                schedule=sched, metric=metric, mode=m, mask=mb, n_valid=N,
                batch_fn=tbf if kern else None)
            v, i = quorum_allpairs_knn_q(
                qb, topk=TOPK, axis_name="q", schedule=sched, metric=metric,
                mode=m, mask=mb, n_valid=N, batch_fn=kbf if kern else None)
            return (h.vals[None], h.i[None], h.j[None], h.count.reshape(1),
                    v, i)
        res = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS("q"),) * 6,
            out_specs=(PS("q"),) * 6, check_vma=False))(*leaves, mt)
        key = f"{name}{P}_{qm}_{metric}_{mode}"
        for f, a in zip(("tv", "ti", "tj", "tn", "kv", "ki"), res):
            out[f"{key}_{f}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
""" % {"cells": CELLS, "cases": CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "quant.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


def _corpus(seed, n, d, scale_first=0):
    c = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    c[:scale_first] *= 0.05
    return c


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("P,block,d", [(4, 8, 16), (3, 5, 7), (2, 16, 130),
                                       (5, 6, 128)])
def test_quantize_corpus_matches_reference(mode, P, block, d):
    """Codes, scale, delta, l1 and sq element for element, with a zero
    (padding) block and rows of very different scales."""
    x = _corpus(P * d + block, P * block, d, scale_first=block)
    x[-block:] = 0.0
    want = r_quant.quantize_corpus(x, P, block, mode)
    got = quant.quantize_corpus(torch.as_tensor(x), P, block, mode)
    assert got.q.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
    np.testing.assert_array_equal(got.q.float().numpy(),
                                  np.asarray(want.q).astype(np.float32))
    for f in ("scale", "delta", "l1", "sq"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    assert (got.block, got.n_valid) == (want.block, want.n_valid)
    qb = got.blocks()
    assert qb.q.shape == (P, block, d) and qb.scale.shape == (P,)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_eps_bounds_match_reference(mode, metric):
    P, block, d = 4, 8, 16
    x = _corpus(7, P * block, d, scale_first=block)
    x[-3:] = 0.0
    rq = r_quant.quantize_corpus(x, P, block, mode)
    tq = quant.quantize_corpus(x, P, block, mode)
    rng = np.random.default_rng(1)
    ai, aj = rng.integers(0, P * block, 40), rng.integers(0, P * block, 40)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    pairs = [(quant.eps_pairs(tq, ai, aj, metric),
              r_quant.eps_pairs(rq, ai, aj, metric)),
             (quant.eps_rows_upper(tq, metric, P * block - 3),
              r_quant.eps_rows_upper(rq, metric, P * block - 3)),
             (quant.eps_queries(tq, queries, metric),
              r_quant.eps_queries(rq, queries, metric))]
    for got, want in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    for m in ("off", "int8", "bf16"):
        assert quant.quant_itemsize(m) == r_quant.quant_itemsize(m)
        for N, P_, k in ((262144, 8, 4), (1000, 5, 3)):
            assert quant.corpus_bytes_per_device(N, 128, P_, k, m) == \
                r_quant.corpus_bytes_per_device(N, 128, P_, k, m)
    with pytest.raises(ValueError, match="quant"):
        quant.quant_itemsize("fp8")
    with pytest.raises(ValueError, match="quant"):
        quant.quantize_corpus(x, P, block, "off")


def test_row_sum_is_numpys_order():
    """The norm reduction reproduces np.add.reduce on float32 rows bit for
    bit at every width class (below 8, one leaf, split leaves)."""
    rng = np.random.default_rng(2)
    for d in (3, 8, 21, 128, 129, 300, 1000):
        x = (rng.normal(size=(64, d))
             * rng.uniform(0.01, 100, (64, 1))).astype(np.float32)
        np.testing.assert_array_equal(
            quant.row_sum(torch.as_tensor(x * x)).numpy(),
            (x * x).sum(axis=1))


def _blocks(reference, name, P, qm):
    corpus = reference[f"{name}{P}_corpus"]
    N = corpus.shape[0]
    x = np.zeros((P * BLOCK, D), np.float32)
    x[:N] = corpus
    return quant.quantize_corpus(x, P, BLOCK, qm).blocks(), N


@pytest.mark.parametrize("qm,metric,mode", CASES,
                         ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("name,P", CELLS, ids=IDS)
def test_engines_match_jax(reference, name, P, qm, metric, mode):
    """Every device's band buffers (vals, i, j, count) and scatter-merged
    top-M lists (``kernel``: the B7 / B8 hooks)."""
    qb, N = _blocks(reference, name, P, qm)
    comm = SingleProcessComm(P, "cpu")
    sched = get_placement(name, P).schedule()
    thr = float(reference[f"{name}{P}_{metric}_thr"])
    kern = mode == "kernel"
    m = "batched" if kern else mode
    tbf = (lambda q, lo, hi, meta: ops.pairwise_threshold_q(
        q.q, quant._kernel_sd(q), q.l1, q.sq, lo, hi, meta, threshold=thr,
        capacity=CAP, block_rows=BLOCK, metric=metric)) if kern else None
    kbf = (lambda q, lo, hi, meta: ops.pairwise_topk_q(
        q.q, quant._kernel_sd(q), q.sq, lo, hi, meta, topk=TOPK,
        block_rows=BLOCK, metric=metric)) if kern else None
    hits = quant.quorum_allpairs_threshold_q(
        qb, comm, threshold=thr, capacity=CAP, schedule=sched, metric=metric,
        mode=m, n_valid=N, batch_fn=tbf)
    vals, idx = quant.quorum_allpairs_knn_q(
        qb, comm, topk=TOPK, schedule=sched, metric=metric, mode=m,
        n_valid=N, batch_fn=kbf)
    key = f"{name}{P}_{qm}_{metric}_{mode}"
    np.testing.assert_array_equal(hits.count.numpy(), reference[key + "_tn"])
    np.testing.assert_array_equal(hits.i.numpy(), reference[key + "_ti"])
    np.testing.assert_array_equal(hits.j.numpy(), reference[key + "_tj"])
    np.testing.assert_array_equal(idx.reshape(-1, TOPK).numpy(),
                                  reference[key + "_ki"])
    if qm == "int8":
        np.testing.assert_array_equal(hits.vals.numpy(),
                                      reference[key + "_tv"])
        np.testing.assert_array_equal(vals.reshape(-1, TOPK).numpy(),
                                      reference[key + "_kv"])
    else:
        np.testing.assert_allclose(hits.vals.numpy(), reference[key + "_tv"],
                                   **TOL)
        np.testing.assert_allclose(vals.reshape(-1, TOPK).numpy(),
                                   reference[key + "_kv"], **TOL)


@pytest.mark.parametrize("qm", ["int8", "bf16"])
@pytest.mark.parametrize("name,P", CELLS, ids=IDS)
def test_drivers_match_oracles(reference, name, P, qm):
    """The rescored join (with its band stats), the certified k-NN graph
    and an escalating join against the reference's numpy oracles."""
    corpus = reference[f"{name}{P}_corpus"]
    comm = SingleProcessComm(P, "cpu")
    for metric in ("dot", "l2"):
        thr = float(r_sparse.threshold_for_selectivity(corpus, 0.08, metric))
        wi, wj, ws = r_sparse.brute_force_join(corpus, thr, metric)
        for uk in (False, True):
            st = {}
            res = quant.quant_similarity_join(
                corpus, comm, threshold=thr, quant=qm, metric=metric,
                placement=name, use_kernel=uk, capacity=4, stats=st)
            np.testing.assert_array_equal(res.i, wi)
            np.testing.assert_array_equal(res.j, wj)
            np.testing.assert_allclose(res.scores, ws, **TOL)
            assert res.escalations >= 1
            assert st["emitted"] >= st["kept"] == len(wi) >= st["certain"]
            assert st["borderline"] == st["emitted"] - st["certain"]
            want = r_knn.brute_force_knn(corpus, 4, metric)
            got = quant.quant_knn_graph(corpus, comm, topk=4, quant=qm,
                                        metric=metric, placement=name,
                                        use_kernel=uk)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_allclose(got.scores, want.scores, **TOL)


def test_knn_doubles_m_until_certified():
    """Clustered rows whose neighbours sit inside the int8 bound force M to
    double; the passes are recorded and the graph stays exact, underfull
    lists included."""
    P, d = 4, 8
    rng = np.random.default_rng(5)
    centres = rng.normal(size=(3, d)) * 3
    corpus = (centres[rng.integers(0, 3, 29)]
              + 0.3 * rng.normal(size=(29, d))).astype(np.float32)
    comm = SingleProcessComm(P, "cpu")
    st = {}
    got = quant.quant_knn_graph(corpus, comm, topk=3, quant="int8",
                                metric="l2", stats=st)
    want = r_knn.brute_force_knn(corpus, 3, "l2")
    np.testing.assert_array_equal(got.indices, want.indices)
    Ms = [m for m, _ in st["passes"]]
    assert len(Ms) >= 2 and Ms == sorted(Ms) and st["passes"][-1][1] == 0
    tiny = corpus[:6]
    got = quant.quant_knn_graph(tiny, comm, topk=9, quant="bf16")
    np.testing.assert_array_equal(got.indices,
                                  r_knn.brute_force_knn(tiny, 9).indices)


@pytest.mark.parametrize("qm", ["int8", "bf16"])
@pytest.mark.parametrize("name,P", [("cyclic", 5), ("cyclic", 8),
                                    ("full", 6)])
def test_serving_query_matches_oracle(qm, name, P):
    """Every mode and metric, then a block replace and an append, against
    the reference's serving oracle; ``use_kernel`` is refused."""
    N, d = P * 8 - 11, 16
    corpus = _corpus(P, N, d, scale_first=8)
    queries = _corpus(P + 1, 5, d)
    comm = SingleProcessComm(P, "cpu")
    sc = ServingCorpus.build(corpus, comm, block=8, placement=name,
                             quant=qm)
    total = sc.P * sc.block
    rows = np.zeros((total, d), np.float32)
    rows[:N] = corpus
    valid = np.zeros(total, bool)
    valid[:N] = True
    for metric in ("dot", "l2"):
        wv, wi = r_quant._serving_topk_oracle(rows, valid, queries, 4,
                                              metric)
        for mode in ("batched", "overlap", "scan"):
            v, i = sc.query(queries, topk=4, mode=mode, metric=metric)
            assert i.dtype == torch.int64
            np.testing.assert_array_equal(i.numpy(), wi)
            np.testing.assert_allclose(v.numpy(), wv, **TOL)
    with pytest.raises(ValueError, match="f32 serving path"):
        sc.query(queries, topk=4, use_kernel=True)
    newb = _corpus(11, sc.block, d) * 3
    sc.replace_block(1, newb)
    rows[sc.block:2 * sc.block], valid[sc.block:2 * sc.block] = newb, True
    app = _corpus(12, 3, d)
    b = sc.append_block(app)
    rows[b * sc.block:b * sc.block + 3] = app
    valid[b * sc.block:b * sc.block + 3] = True
    for metric in ("dot", "l2"):
        wv, wi = r_quant._serving_topk_oracle(rows, valid, queries, 6,
                                              metric)
        v, i = quant.serving_query(sc, queries, topk=6, metric=metric)
        np.testing.assert_array_equal(i.numpy(), wi)
        np.testing.assert_allclose(v.numpy(), wv, **TOL)


def test_quant_blocks_ride_the_gather():
    """int8 / bf16 leaves pass the gather's shifts and byte count as they
    are, and a named tuple is rebuilt as one."""
    from repro_torch.core import sweep
    from repro_torch.obs import trace
    P = 5
    qc = quant.quantize_corpus(_corpus(0, P * 4, 6), P, 4, "int8")
    qb = qc.blocks()
    sched = get_placement("cyclic", P).schedule()
    tr = trace.configure()
    try:
        st = sweep.quorum_gather(qb, sched, SingleProcessComm(P, "cpu"))
    finally:
        trace.reset()
    assert isinstance(st, quant.QuantBlocks) and st.q.dtype == torch.int8
    assert st.q.shape == (P, sched.k, 4, 6) and st.scale.shape == (P, sched.k)
    per_dev = (4 * 6 * 1 + 8 + 8 * 4)
    nz = sum(1 for a in sched.shifts if a % P)
    assert tr.counter_total("comm.ppermute.gather_bytes") == nz * per_dev
    for s, a in enumerate(sched.shifts):
        assert torch.equal(st.q[:, s], torch.roll(qb.q, -int(a), dims=0))
    bf = quant.quantize_corpus(_corpus(0, P * 4, 6), P, 4, "bf16").blocks()
    assert sweep.quorum_gather(bf, sched, SingleProcessComm(P, "cpu")) \
        .q.dtype == torch.bfloat16


@pytest.mark.parametrize("P", [2, 5, 8])
def test_quant_selfcheck(P, capsys):
    quant.selfcheck_main(P, device="cpu")
    assert "quant selfcheck OK" in capsys.readouterr().out


def test_env_selects_quant_mode(monkeypatch):
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    assert quant.quant_from_env() == r_quant.quant_from_env() == "off"
    for m in ("int8", "bf16", "off"):
        monkeypatch.setenv("REPRO_QUANT", m)
        assert quant.quant_from_env() == r_quant.quant_from_env() == m
    monkeypatch.setenv("REPRO_QUANT", "fp4")
    with pytest.raises(ValueError, match="REPRO_QUANT"):
        quant.quant_from_env()
    monkeypatch.delenv("REPRO_QUANT")
    comm = SingleProcessComm(4, "cpu")
    with pytest.raises(ValueError, match="quant"):
        quant.quant_similarity_join(np.zeros((9, 3), np.float32), comm,
                                    threshold=0.0, quant="off")
    with pytest.raises(ValueError, match="topk"):
        quant.quant_knn_graph(np.zeros((9, 3), np.float32), comm, topk=0,
                              quant="int8")
    sc = ServingCorpus.build(np.zeros((9, 3), np.float32), comm, quant="off")
    with pytest.raises(ValueError, match="quantized corpus"):
        quant.serving_query(sc, np.zeros((1, 3), np.float32), topk=2)
    with pytest.raises(ValueError, match="batched"):
        quant.quant_knn_graph(np.zeros((9, 3), np.float32), comm, topk=2,
                              quant="int8", mode="scan", use_kernel=True)
