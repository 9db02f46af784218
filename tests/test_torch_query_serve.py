"""The port's request-serving front end (``repro_torch/launch/query_serve.py``):
counterparts of the four tests of ``tests/test_query_serve.py``, on the
CPU.  The queue drains in request order, bit-exact per microbatch against
``ServingCorpus.query`` with the tail padded; ``--stream-every`` lands a
block replacement every N-th non-initial microbatch and the tracer's
counters record it; qps is finite once one steady-state microbatch is
measured.  The reference's CLI cell fails on jax 0.9 (ROADMAP C.4): the
port's CLI runs as a subprocess with ``--device cpu`` and its first
request is held against ``repro_torch/serving/selfcheck.py:oracle_topk``.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.comm import SingleProcessComm
from repro_torch.launch.query_serve import serve_queries
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import ServingCorpus
from repro_torch.serving.batching import BatchScheduler
from repro_torch.serving.selfcheck import oracle_topk

ROOT = Path(__file__).resolve().parents[1]


def _corpus(P, N, d, seed, R):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    queries = rng.normal(size=(R, d)).astype(np.float32)
    return rng, queries, ServingCorpus.build(corpus,
                                             SingleProcessComm(P, "cpu"))


def test_serve_queries_drains_queue_and_pads_tail():
    P, N, d, R, mb, topk = 4, 64, 8, 21, 8, 4
    _rng, queries, sc = _corpus(P, N, d, 0, R)
    vals, idx, qps = serve_queries(sc, queries, microbatch=mb, topk=topk)
    assert vals.shape == (R, topk) and idx.shape == (R, topk)
    assert math.isfinite(qps) and qps > 0
    done = 0
    for _bi in range(-(-R // mb)):
        q = queries[done:done + mb]
        n = len(q)
        if n < mb:
            q = np.concatenate([q, np.zeros((mb - n, d), np.float32)])
        v, i = sc.query(q, topk=topk)
        assert np.array_equal(v[:n].numpy(), vals[done:done + n])
        assert np.array_equal(i[:n].numpy(), idx[done:done + n])
        done += n
    assert done == R


def test_serve_queries_device_tensor_queue_with_kernel():
    """Queries handed over as a tensor, launches through the B4 hook (its
    plain version on the CPU): the same rows as the numpy queue."""
    _rng, queries, sc = _corpus(4, 64, 8, 3, 24)
    sched = BatchScheduler(sc, max_batch=8, use_kernel=True,
                           pad_queries_to=8)
    vals, idx, _qps = serve_queries(sc, torch.from_numpy(queries),
                                    microbatch=8, topk=5, scheduler=sched,
                                    use_kernel=True)
    v2, i2, _ = serve_queries(sc, queries, microbatch=8, topk=5)
    assert np.array_equal(idx, i2) and np.array_equal(vals, v2)
    assert sched.counters["launches"] == 3
    assert len(sched.latencies_s) == 24


def test_serve_queries_stream_interleave_and_counters():
    P, N, d, R, mb = 4, 64, 8, 40, 8      # 5 batches -> updates at bi=2,4
    rng, queries, sc = _corpus(P, N, d, 1, R)
    seen = []
    orig = sc.replace_block

    def spy(b, vecs):
        seen.append(int(b))
        return orig(b, vecs)

    sc.replace_block = spy
    tr = obs_trace.configure(metrics_only=True)
    try:
        vals, _idx, qps = serve_queries(sc, queries, microbatch=mb, topk=4,
                                        stream_every=2, rng=rng)
        assert len(seen) == 2
        assert vals.shape == (R, 4)
        assert math.isfinite(qps) and qps > 0
        assert tr.counter_total("serve.batches") == 5
        assert tr.counter_total("serve.queries") == R
        assert tr.counter_total("serve.stream_updates") == 2
    finally:
        obs_trace.reset()


def test_serve_queries_single_batch_warmup_clamp():
    _rng, queries, sc = _corpus(2, 32, 8, 2, 5)
    vals, _idx, qps = serve_queries(sc, queries, microbatch=8, topk=3)
    assert vals.shape == (5, 3)
    assert math.isfinite(qps) and qps > 0


def test_query_serve_cli():
    """The module CLI end to end on the CPU, stream updates on; the first
    request's printed ids against the numpy oracle."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.query_serve", "--n", "256",
         "--d", "16", "--requests", "48", "--microbatch", "8", "--topk", "4",
         "--stream-every", "2", "--P", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "queries/sec steady-state" in out
    assert "per-request latency: p50=" in out
    assert "first request top-4" in out
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(256, 16)).astype(np.float32)
    queries = rng.normal(size=(48, 16)).astype(np.float32)
    _v, want = oracle_topk(corpus, np.ones(256, bool), queries[:1], 4, "dot")
    ids = [int(t) for t in re.search(r"ids=\[([^\]]*)\]", out)
           .group(1).split(",")]
    assert ids == want[0].tolist()
