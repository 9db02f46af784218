"""The port's continuous-batching front end (``repro_torch/serving/batching.py``)
held against the JAX package's.

Counterparts of the thirteen tests of ``tests/test_batching.py`` run on the
CPU in-process.  The reference's selfcheck cell
(``test_batching_selfcheck_small_mesh``) fails on jax 0.9 (ROADMAP C.4), so
its counterpart also holds a mixed pack against the numpy oracles
``repro_torch/serving/selfcheck.py:oracle_topk`` / ``oracle_threshold``.

One JAX subprocess (8 fake CPU devices) runs the reference's
``BatchScheduler`` over its ``ServingCorpus`` at P = 5 and 8, fed a mixed
queue of top-k and range requests (both metrics, heterogeneous k,
thresholds placed in a score gap per query, a small capacity in a pack),
and writes every request's outcome to an ``.npz``.  The port runs the same
queue: statuses and counts equal, ids equal index for index, scores within
1e-5 * max(1, |s|).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.env import ENV_KNOBS
from repro_torch.kernels.ref import IDX_SENTINEL, NEG_INF
from repro_torch.serving import ServingCorpus, selfcheck
from repro_torch.serving.batching import (AdmissionError, BatchScheduler,
                                          latency_summary, main, percentile,
                                          to_host)
from repro_torch.serving.engine import quantize_pow2, threshold_fn

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (5, 8)
BLOCK, D = 16, 24
TOPKS = (1, 3, 5, 8, 13)
SCORE_TOL = 1e-5

REFERENCE = r"""
import sys
import numpy as np, jax
from repro.core.sparse import threshold_with_gap
from repro.serving import ServingCorpus
from repro.serving.batching import BatchScheduler

BLOCK, D, TOPKS = 16, 24, (1, 3, 5, 8, 13)
out = {}
for P in (5, 8):
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P],
                         axis_types=(jax.sharding.AxisType.Auto,))
    rng = np.random.default_rng(P)
    corpus = rng.normal(size=(P * BLOCK - 5, D)).astype(np.float32)
    sc = ServingCorpus.build(corpus, mesh, block=BLOCK)
    sched = BatchScheduler(sc, max_batch=64)
    specs, queries = [], []
    for metric in ("dot", "l2"):
        for k in TOPKS:
            specs.append(dict(kind="topk", topk=k, metric=metric))
        for sel, cap in ((0.02, None), (0.1, 2), (0.3, None)):
            specs.append(dict(kind="threshold", sel=sel, capacity=cap,
                              metric=metric))
    reqs = []
    for j, spec in enumerate(specs):
        q = rng.normal(size=(D,)).astype(np.float32)
        queries.append(q)
        spec = dict(spec)
        if spec["kind"] == "threshold":
            s = corpus @ q
            if spec["metric"] == "l2":
                s = 2.0 * s - (corpus * corpus).sum(-1) - (q * q).sum()
            spec["threshold"] = threshold_with_gap(s, spec.pop("sel"))
            out[f"P{P}_r{j}_thr"] = np.float32(spec["threshold"])
        reqs.append(sched.submit(q, **spec))
    sched.drain()
    out[f"P{P}_corpus"] = corpus
    out[f"P{P}_queries"] = np.stack(queries)
    for j, r in enumerate(reqs):
        res = r.result(0)
        out[f"P{P}_r{j}_status"] = np.array(res.status)
        out[f"P{P}_r{j}_i"] = res.indices
        out[f"P{P}_r{j}_v"] = res.scores
        out[f"P{P}_r{j}_n"] = np.int64(-1 if res.count is None else res.count)
    out[f"P{P}_launches"] = np.int64(sched.counters["launches"])
    out[f"P{P}_escalations"] = np.int64(sched.counters["escalations"])
np.savez(sys.argv[1], **out)
"""


def _specs():
    out = []
    for metric in ("dot", "l2"):
        out += [dict(kind="topk", topk=k, metric=metric) for k in TOPKS]
        out += [dict(kind="threshold", capacity=cap, metric=metric)
                for cap in (None, 2, None)]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "batching.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_runs(reference):
    """The same queue through the port's scheduler, once per P."""
    runs = {}
    for P in PS:
        sc = ServingCorpus.build(reference[f"P{P}_corpus"],
                                 SingleProcessComm(P, "cpu"), block=BLOCK)
        sched = BatchScheduler(sc, max_batch=64)
        reqs = []
        for j, spec in enumerate(_specs()):
            spec = dict(spec)
            if spec["kind"] == "threshold":
                spec["threshold"] = float(reference[f"P{P}_r{j}_thr"])
            reqs.append(sched.submit(reference[f"P{P}_queries"][j], **spec))
        sched.drain()
        runs[P] = (sc, sched, reqs)
    return runs


@pytest.mark.parametrize("kind", ["topk", "threshold"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("P", PS)
def test_scheduler_matches_reference(reference, port_runs, P, metric, kind):
    """Per request: status and count equal, ids index for index, scores
    within 1e-5 * max(1, |s|)."""
    _sc, sched, reqs = port_runs[P]
    n = 0
    for j, (spec, req) in enumerate(zip(_specs(), reqs)):
        if spec["kind"] != kind or spec["metric"] != metric:
            continue
        res = req.result(0)
        key = f"P{P}_r{j}"
        assert res.status == str(reference[key + "_status"]) == "done"
        assert (res.count if res.count is not None else -1) \
            == int(reference[key + "_n"])
        np.testing.assert_array_equal(res.indices, reference[key + "_i"])
        want = reference[key + "_v"]
        assert np.all(np.abs(res.scores - want)
                      <= SCORE_TOL * np.maximum(1.0, np.abs(want)))
        n += 1
    assert n == (len(TOPKS) if kind == "topk" else 3)
    assert sched.counters["launches"] == int(reference[f"P{P}_launches"])
    assert sched.counters["escalations"] == int(
        reference[f"P{P}_escalations"])


@pytest.mark.parametrize("P", PS)
def test_packed_equals_solo_and_oracle(port_runs, P):
    """Every packed result is bit-identical to the request issued alone,
    and equal to the numpy oracles (ids exact, scores within 1e-5)."""
    sc, _sched, reqs = port_runs[P]
    full = sc.state.shard.reshape(-1, D).numpy()
    valid = sc.state.valid.reshape(-1).numpy() > 0
    for req in reqs:
        res = req.result(0)
        q = req.query[None].numpy()
        if req.kind == "topk":
            v, i = sc.query(q, topk=req.topk, metric=req.metric)
            want_v, want_i = selfcheck.oracle_topk(full, valid, q, req.topk,
                                                   req.metric)
            want_v, want_i = want_v[0], want_i[0]
        else:
            v, i, c = sc.query_threshold(q, threshold=req.threshold,
                                         metric=req.metric)
            n = int(c[0])
            v, i = v[:, :n], i[:, :n]
            (want_i, want_v), = selfcheck.oracle_threshold(
                full, valid, q, req.threshold, req.metric)
        assert np.array_equal(res.indices, i[0].numpy())
        assert np.array_equal(res.scores, v[0].numpy())
        np.testing.assert_array_equal(res.indices, want_i)
        np.testing.assert_allclose(res.scores, want_v, rtol=SCORE_TOL,
                                   atol=SCORE_TOL)


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_wide_range_pack_spans_launches(metric):
    """A range pack wider than QUERY_CHUNK runs in several fixed-width
    launches and still returns each request's solo bits."""
    from repro_torch.serving.engine import QUERY_CHUNK
    rng, sc = _corpus(5, 16, 24, 3, 4)
    n = QUERY_CHUNK + 9
    sched = BatchScheduler(sc, max_batch=2 * QUERY_CHUNK)
    thr = 2.0 if metric == "dot" else -40.0
    reqs = [sched.submit(rng.normal(size=(24,)), kind="threshold",
                         threshold=thr + 0.1 * j, capacity=4, metric=metric)
            for j in range(n)]
    sched.drain()
    assert sched.counters["launches"] >= 1
    for req in reqs:
        res = req.result(0)
        v, i, c = sc.query_threshold(req.query[None],
                                     threshold=req.threshold, metric=metric)
        k = int(c[0])
        assert res.ok and res.count == k
        assert np.array_equal(res.indices, i[0, :k].numpy())
        assert np.array_equal(res.scores, v[0, :k].numpy())


def test_to_host_splits_one_copy():
    v = torch.randn(6, 4)
    i = torch.arange(18, dtype=torch.int32).reshape(6, 3)
    c = torch.tensor([1, -2, 3, 4, 5, 6], dtype=torch.int64)
    hv, hi, hc = to_host(v, i, c)
    assert (hv.dtype, hi.dtype, hc.dtype) == (np.float32, np.int32, np.int64)
    np.testing.assert_array_equal(hv, v.numpy())
    np.testing.assert_array_equal(hi, i.numpy())
    np.testing.assert_array_equal(hc, c.numpy())


# --------------------------------------------------------------- host-side
# counterparts of tests/test_batching.py


def test_percentile_linear_interpolation():
    trace = [0.4, 0.1, 0.3, 0.2]
    assert percentile(trace, 0) == 0.1
    assert percentile(trace, 100) == 0.4
    assert percentile(trace, 50) == pytest.approx(0.25)
    assert percentile([7.0], 99) == 7.0
    xs = np.random.default_rng(3).exponential(size=37).tolist()
    for q in (0, 10, 50, 90, 99, 100):
        assert percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_rejects_bad_input():
    with pytest.raises(ValueError, match="empty"):
        percentile([], 50)
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        percentile([1.0], 101)


def test_latency_summary_deterministic_trace():
    trace = [i / 1000.0 for i in range(1, 101)]
    s = latency_summary(trace, span_s=2.0)
    assert s["n"] == 100.0
    assert s["mean_s"] == pytest.approx(0.0505)
    assert s["p50_s"] == pytest.approx(0.0505)
    assert s["p99_s"] == pytest.approx(0.09901)
    assert s["max_s"] == pytest.approx(0.1)
    assert s["qps"] == pytest.approx(50.0)
    assert latency_summary([]) == {"n": 0.0}
    assert "qps" not in latency_summary(trace)


def test_quantize_pow2_buckets():
    assert [quantize_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9, 1000)] == \
        [1, 2, 4, 4, 8, 8, 16, 1024]
    assert quantize_pow2(3, floor=8) == 8
    assert quantize_pow2(0) == 1


def test_env_knobs_registered():
    for name in ("REPRO_SERVE_MAX_BATCH", "REPRO_SERVE_QUEUE_DEPTH"):
        knob = ENV_KNOBS[name]
        assert knob.kind == "int" and knob.minimum == 1
        assert knob.parse("4") == 4
        with pytest.raises(ValueError, match=">= 1"):
            knob.parse("0")


class _FakeCorpus:
    """Just enough ServingCorpus surface for submit-side tests."""
    P, block, d = 4, 16, 8


def test_submit_validation_messages():
    sched = BatchScheduler(_FakeCorpus())
    q = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="kind"):
        sched.submit(q, kind="knn")
    with pytest.raises(ValueError, match="metric"):
        sched.submit(q, kind="topk", topk=3, metric="cosine")
    with pytest.raises(ValueError, match="8 features"):
        sched.submit(np.zeros(5, np.float32), kind="topk", topk=3)
    with pytest.raises(ValueError, match="topk >= 1"):
        sched.submit(q, kind="topk", topk=0)
    with pytest.raises(ValueError, match="needs a threshold"):
        sched.submit(q, kind="threshold")
    with pytest.raises(ValueError, match="capacity"):
        sched.submit(q, kind="threshold", threshold=1.0, capacity=0)


def test_admission_backpressure_counters():
    sched = BatchScheduler(_FakeCorpus(), max_queue=2)
    q = torch.zeros(8)
    sched.submit(q, kind="topk", topk=1)
    sched.submit(q, kind="topk", topk=1)
    with pytest.raises(AdmissionError, match="REPRO_SERVE_QUEUE_DEPTH"):
        sched.submit(q, kind="topk", topk=1)
    assert sched.counters["admitted"] == 2
    assert sched.counters["rejected"] == 1
    assert sched.queue_depth == 2


def test_scheduler_env_knob_defaults(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "7")
    monkeypatch.setenv("REPRO_SERVE_QUEUE_DEPTH", "9")
    sched = BatchScheduler(_FakeCorpus())
    assert (sched.max_batch, sched.max_queue) == (7, 9)
    sched = BatchScheduler(_FakeCorpus(), max_batch=3, max_queue=4)
    assert (sched.max_batch, sched.max_queue) == (3, 4)
    with pytest.raises(ValueError, match="narrower than"):
        BatchScheduler(_FakeCorpus(), max_batch=8, pad_queries_to=4)


# --------------------------------------------------------------- packed
# launches on the port's single-process comm layer


def _corpus(P, block, d, n_missing, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(P * block - n_missing, d)).astype(np.float32)
    return rng, ServingCorpus.build(corpus, SingleProcessComm(P, "cpu"),
                                    block=block)


def test_batching_selfcheck_small_mesh(capsys):
    """The module selfcheck at P = 5 (ragged tail): packed heterogeneous
    batches bit-exact against solo requests, the escalation ladder,
    deadline expiry / partial, admission and the async loop; then a mixed
    pack against the numpy oracles (the reference's cell fails on jax
    0.9)."""
    main(5, device="cpu")
    assert "batching selfcheck OK: P=5" in capsys.readouterr().out
    rng, sc = _corpus(5, 16, 24, 8, 0)
    full = sc.state.shard.reshape(-1, 24).numpy()
    valid = sc.state.valid.reshape(-1).numpy() > 0
    sched = BatchScheduler(sc, max_batch=64, use_kernel=True)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    reqs = [sched.submit(q[j], kind="topk", topk=j + 1, metric="l2")
            for j in range(6)]
    sched.drain()
    for j, req in enumerate(reqs):
        want_v, want_i = selfcheck.oracle_topk(full, valid, q[j:j + 1],
                                               j + 1, "l2")
        np.testing.assert_array_equal(req.result(0).indices, want_i[0])
        np.testing.assert_allclose(req.result(0).scores, want_v[0],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


def test_heterogeneous_pack_bit_exact_vs_oracles():
    P, block, d = 4, 16, 12
    rng, sc = _corpus(P, block, d, 5, 7)
    sched = BatchScheduler(sc, max_batch=32)
    specs = ([dict(kind="topk", topk=k, metric=m)
              for m in ("dot", "l2") for k in (1, 2, 5, 7)]
             + [dict(kind="threshold", threshold=t, capacity=c, metric=m)
                for m in ("dot", "l2") for t, c in ((3.0, None), (-1e9, 4))])
    reqs = [sched.submit(rng.normal(size=(d,)), **s) for s in specs]
    sched.drain()
    for req in reqs:
        res = req.result(0)
        assert res.ok, (req.rid, res.status)
        if req.kind == "topk":
            ov, oi = sc.query(req.query[None], topk=req.topk,
                              metric=req.metric)
            assert np.array_equal(res.indices, oi[0].numpy())
            assert np.array_equal(res.scores, ov[0].numpy())
        else:
            ov, oi, oc = sc.query_threshold(req.query[None],
                                            threshold=req.threshold,
                                            metric=req.metric)
            n = int(oc[0])
            assert res.count == n
            assert np.array_equal(res.indices, oi[0, :n].numpy())
            assert np.array_equal(res.scores, ov[0, :n].numpy())
    assert len(sched.program_keys) <= 10
    assert sched.counters["launches"] < len(reqs)


def test_deadline_preemption_semantics():
    P, block, d = 2, 16, 8
    rng, sc = _corpus(P, block, d, 0, 11)
    t = [0.0]
    sched = BatchScheduler(sc, max_batch=8, clock=lambda: t[0])
    live = sched.submit(rng.normal(size=(d,)), kind="topk", topk=3)
    dead = sched.submit(rng.normal(size=(d,)), kind="topk", topk=3,
                        deadline_s=1.0)
    t[0] = 5.0
    sched.drain()
    r_live, r_dead = live.result(0), dead.result(0)
    assert r_dead.status == "expired" and not r_dead.ok
    assert (r_dead.indices == IDX_SENTINEL).all()
    assert (r_dead.scores == NEG_INF).all()
    ov, oi = sc.query(live.query[None], topk=3)
    assert np.array_equal(r_live.indices, oi[0].numpy())
    assert sched.counters["expired"] == 1 and sched.counters["done"] == 1

    t2 = [0.0]

    def clock2():
        t2[0] += 0.5
        return t2[0]

    sched2 = BatchScheduler(sc, max_batch=8, clock=clock2)
    part = sched2.submit(rng.normal(size=(d,)), kind="threshold",
                         threshold=-1e9, capacity=1, deadline_s=0.6)
    sched2.step()
    res = part.result(0)
    assert res.status == "partial"
    assert res.count == sc.n_valid and len(res.indices) < res.count
    _, oi, _ = sc.query_threshold(part.query[None], threshold=-1e9)
    assert np.array_equal(res.indices, oi[0, :len(res.indices)].numpy())
    assert sched2.counters["partial"] == 1


def test_block_update_validation():
    P, block, d = 2, 8, 4
    rng, sc = _corpus(P, block, d, 4, 0)
    for bad, frag in [
            (np.zeros((block + 1, d), np.float32), "block capacity is 8"),
            (np.zeros((block, d + 1), np.float32), "[rows, 4]"),
            (np.zeros((block,), np.float32), "[rows, 4]")]:
        with pytest.raises(ValueError) as e:
            sc.replace_block(0, bad)
        assert frag in str(e.value)
        with pytest.raises(ValueError) as e:
            sc.append_block(bad)
        assert frag in str(e.value)
    with pytest.raises(ValueError, match="out of range"):
        sc.replace_block(P, np.zeros((1, d), np.float32))
    sc.replace_block(0, rng.normal(size=(block, d)).astype(np.float32))
    v, _i = sc.query(rng.normal(size=(1, d)).astype(np.float32), topk=2)
    assert v.shape == (1, 2)


def test_threshold_capacity_quantized_program_keys():
    P, block, d = 2, 32, 8
    rng, sc = _corpus(P, block, d, 0, 1)
    q = rng.normal(size=(2, d)).astype(np.float32)
    threshold_fn.cache_clear()
    for cap in (5, 6, 7, 8):
        v, _i, _c = sc.query_threshold(q, threshold=1e9, capacity=cap)
        assert v.shape[1] == 8
    assert threshold_fn.cache_info().misses == 1
    threshold_fn.cache_clear()
    v, _i, c = sc.query_threshold(q, threshold=-1e9, capacity=1)
    total = P * block
    assert int(c[0]) == total and v.shape[1] == total
    assert threshold_fn.cache_info().misses <= math.ceil(
        math.log2(total)) + 1
