"""The port's all-pairs k-NN graph (``repro_torch/core/knn.py``) held
against the JAX package's.

One JAX subprocess (16 fake CPU devices) wraps the reference's
``quorum_allpairs_knn`` in its own ``shard_map`` (``check_vma`` off, which
its Pallas kernel needs on jax 0.9; the reference's own ``knn_graph`` fails
there) and writes every device's scatter-merged lists for every mode,
including the Pallas kernel in interpret mode, to an ``.npz``.  The port
runs in-process on the CPU, where the ``kernel`` mode takes B6's plain
version.  Indices must be equal, values within rtol 1e-5; the host entry
point must equal the reference's numpy oracle ``brute_force_knn``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import knn as r_knn
from repro_torch.core import knn
from repro_torch.core import quant as t_quant
from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.placement import get_placement
from repro_torch.core.sweep import pair_mask_table
from repro_torch.kernels import ops
from repro_torch.kernels.ref import IDX_SENTINEL, NEG_INF

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [("cyclic", 4), ("cyclic", 5), ("cyclic", 8), ("cyclic", 13),
         ("full", 6)]
MODES = ("batched", "overlap", "scan", "kernel")
METRICS = ("dot", "l2")
BLOCK, D, TOPK = 8, 16, 5
TOL = dict(rtol=1e-5, atol=1e-5)

REFERENCE = r"""
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core.placement import get_placement
from repro.core.knn import quorum_allpairs_knn
from repro.core.sweep import pair_mask_table
from repro.kernels import ops as kops

BLOCK, D, TOPK = 8, 16, 5
out = {}
for name, P in %(cells)r:
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    sched = get_placement(name, P).schedule()
    N = P * BLOCK - 3
    corpus = np.random.default_rng(P).normal(size=(N, D)).astype(np.float32)
    x = np.zeros((P * BLOCK, D), np.float32)
    x[:N] = corpus
    out[f"{name}{P}_corpus"] = corpus
    mt = jnp.asarray(pair_mask_table(sched))
    for metric in ("dot", "l2"):
        for mode in ("batched", "overlap", "scan", "kernel"):
            m, bf = ((mode, None) if mode != "kernel" else
                     ("batched", functools.partial(
                         kops.pairwise_topk, topk=TOPK, block_rows=BLOCK,
                         metric=metric)))
            def body(xb, mb, m=m, bf=bf, metric=metric):
                return quorum_allpairs_knn(
                    xb, topk=TOPK, axis_name="q", schedule=sched, mask=mb,
                    metric=metric, mode=m, n_valid=N, batch_fn=bf)
            res = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(PS("q"), PS("q")),
                out_specs=(PS("q"),) * 2, check_vma=False))(x, mt)
            key = f"{name}{P}_{metric}_{mode}"
            out[key + "_v"], out[key + "_i"] = (np.asarray(a) for a in res)
np.savez(sys.argv[1], **out)
""" % {"cells": CELLS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "knn.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name,P", CELLS, ids=[f"{n}{p}" for n, p in CELLS])
def test_engine_lists_match_jax(reference, name, P, metric, mode):
    """Every device's scatter-merged [block, topk] lists, padding rows
    included, in every mode (``kernel``: B6's hook)."""
    corpus = reference[f"{name}{P}_corpus"]
    N = corpus.shape[0]
    x = torch.zeros(P * BLOCK, D)
    x[:N] = torch.as_tensor(corpus)
    m, bf = ((mode, None) if mode != "kernel" else
             ("batched", functools.partial(ops.pairwise_topk, topk=TOPK,
                                           block_rows=BLOCK, metric=metric)))
    vals, idx = knn.quorum_allpairs_knn(
        x.reshape(P, BLOCK, D), SingleProcessComm(P, "cpu"), topk=TOPK,
        schedule=get_placement(name, P).schedule(), metric=metric, mode=m,
        n_valid=N, batch_fn=bf)
    key = f"{name}{P}_{metric}_{mode}"
    assert vals.shape == (P, BLOCK, TOPK) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.reshape(-1, TOPK).numpy(),
                                  reference[key + "_i"])
    np.testing.assert_allclose(vals.reshape(-1, TOPK).numpy(),
                               reference[key + "_v"], **TOL)


def test_even_orbit_cell_is_deduplicated():
    """The ``full`` P=6 cell exercises the d = P/2 dedup mask."""
    assert pair_mask_table(get_placement("full", 6).schedule()).min() == 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name,P", CELLS, ids=[f"{n}{p}" for n, p in CELLS])
def test_knn_graph_matches_brute_force(reference, name, P, metric):
    """The host entry point on a ragged corpus equals the reference's
    numpy oracle, through the plain batched step and through B6's hook."""
    corpus = reference[f"{name}{P}_corpus"]
    want = r_knn.brute_force_knn(corpus, TOPK, metric)
    for uk in (False, True):
        got = knn.knn_graph(corpus, SingleProcessComm(P, "cpu"), topk=TOPK,
                            metric=metric, placement=name, use_kernel=uk,
                            quant="off")
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.scores, want.scores, **TOL)
        assert got.n_rows == corpus.shape[0] and got.topk == TOPK


@pytest.mark.parametrize("mode", MODES)
def test_underfull_lists_are_sentinel_padded(mode):
    """topk above the candidate count: the tail is (NEG_INF, IDX_SENTINEL)
    padding in every mode, as the oracle's."""
    P = 5
    tiny = np.random.default_rng(3).normal(size=(P + 2, D)).astype(np.float32)
    want = r_knn.brute_force_knn(tiny, P + 4, "dot")
    m, uk = ("batched", True) if mode == "kernel" else (mode, False)
    got = knn.knn_graph(tiny, SingleProcessComm(P, "cpu"), topk=P + 4, mode=m,
                        use_kernel=uk, quant="off")
    np.testing.assert_array_equal(got.indices, want.indices)
    assert (got.indices[:, P + 1:] == IDX_SENTINEL).all()
    assert (got.scores[:, P + 1:] == np.float32(NEG_INF)).all()


def test_host_helpers_match_reference():
    rng = np.random.default_rng(9)
    corpus = rng.normal(size=(23, 6)).astype(np.float32)
    corpus[5] = corpus[2]                     # a tie, broken by index
    for metric in METRICS:
        for topk in (1, 4, 30):
            a = knn.brute_force_knn(corpus, topk, metric)
            b = r_knn.brute_force_knn(corpus, topk, metric)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.scores, b.scores)
    assert knn.KNN_METRICS == r_knn.KNN_METRICS


@pytest.mark.parametrize("P", [2, 5, 8])
def test_knn_selfcheck(P, capsys):
    knn.selfcheck_main(P, device="cpu")
    assert "knn selfcheck OK" in capsys.readouterr().out


def test_quant_routing_and_argument_contract(monkeypatch):
    """quant (argument first, then REPRO_QUANT) routes to the quantized
    graph, which equals the f32 one; bad arguments raise."""
    comm = SingleProcessComm(4, "cpu")
    corpus = np.random.default_rng(0).normal(size=(29, 6)).astype(np.float32)
    want = knn.knn_graph(corpus, comm, topk=3, quant="off")
    seen = []
    real = t_quant.quant_knn_graph
    monkeypatch.setattr(t_quant, "quant_knn_graph",
                        lambda *a, **kw: seen.append(kw["quant"])
                        or real(*a, **kw))
    got = [knn.knn_graph(corpus, comm, topk=3, quant="int8")]
    monkeypatch.setenv("REPRO_QUANT", "bf16")
    got.append(knn.knn_graph(corpus, comm, topk=3))
    assert seen == ["int8", "bf16"]
    for res in got:
        np.testing.assert_array_equal(res.indices, want.indices)
        np.testing.assert_allclose(res.scores, want.scores, **TOL)
    monkeypatch.delenv("REPRO_QUANT")
    with pytest.raises(ValueError, match="batched"):
        knn.knn_graph(corpus, comm, topk=3, mode="scan", use_kernel=True,
                      quant="off")
    with pytest.raises(ValueError, match="metric"):
        knn.knn_graph(corpus, comm, topk=3, metric="cos", quant="off")
    with pytest.raises(ValueError, match="topk"):
        knn.quorum_allpairs_knn(torch.zeros(4, 8, 6), comm, topk=0)
    with pytest.raises(ValueError, match="device axis"):
        knn.quorum_allpairs_knn(torch.zeros(3, 8, 6), comm, topk=2)
