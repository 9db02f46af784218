"""The serving tier, the similarity join, the k-NN graph and their int8 /
bf16 paths under the ``torch.distributed`` backend
(``core.comm.DistributedComm``, one process per device), held against the
JAX package on a mesh and against ``SingleProcessComm``.

One JAX subprocess (8 fake CPU devices) writes the reference's outputs to
an ``.npz``: ``quorum_query_topk`` / ``quorum_query_threshold`` and
``quorum_allpairs_knn`` in its own ``shard_map`` (the reference's
``query_fn`` and ``knn_graph`` fail on jax 0.9), its ``similarity_join``
on the mesh from capacity 1, and ``ring_allgather_hits``.  The port runs
as gloo ranks on the CPU through ``torch.multiprocessing`` (``spawn``),
one intra-op thread a rank and a ``file://`` store under the test's
temporary directory; one spawn per P in (4, 5, 8), started together by a
module-scoped fixture while this process computes the same paths on
``SingleProcessComm``; the P = 5 ranks then run the batcher.

  * serving, f32 (top-k through the plain path and B4's hook, range
    query escalated from capacity 4) and int8 / bf16, ``dot`` and
    ``l2``: every rank's answer index-equal to the reference, values
    within rtol / atol 1e-5;
  * the join, f32 (plain and B5's hook) and int8 / bf16 (B7's hook):
    the union of the ranks' pairs equals the reference's pairs, scores
    within 1e-5 max(1, |s|); started at capacity 1, every rank reports
    the reference's escalations and the [P] counts; the ring gather gives
    every rank the reference's device-ordered stack;
  * the k-NN graph, f32 (B6's hook) and int8 / bf16 (B8's hook): each
    rank's rows index-equal to the reference's rows of its block; every
    rank runs the same certify passes;
  * every rank's answers bit-equal to ``SingleProcessComm``'s (a rank's
    share: its block's rows, the pairs its device owns); the junit
    property ``bit_equal`` records it, and the assertion holds it;
  * ``verify_quant_comm`` on every rank (int8, bf16): traced == predicted;
  * memory per rank: the serving stack, the quantized stack and the join
    / k-NN quorum hold k of the P blocks ([1, k, block, d]), 1/P of
    ``SingleProcessComm``'s stacked state; the quantized paths keep
    their f32 rows off the device (``RescoreRows.resident`` false);
  * the batcher at P = 5: rank 0 controls (a heterogeneous pack with
    escalation, a stream update, a deadline expiring mid-escalation under
    a stepping clock, admission backpressure), ranks 1-4 follow; every
    result bit-equal to the same script on ``SingleProcessComm``;
  * a follower that is never sent a stop fails at its timeout.

Cells held to numpy oracles instead of the reference (ROADMAP C.4): the
streamed ``replace_block`` / ``append_block`` answers (the reference's
``ServingCorpus`` fails on jax 0.9 at ``serving/engine.py:578``) are held
to ``serving/selfcheck.py``'s ``oracle_topk``; the quantized answers equal
the f32 ones by construction, so they are held to the reference's f32
answers.
"""

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import sweep as sweep_mod
from repro_torch.core.comm import DistributedComm, SingleProcessComm, pad_local
from repro_torch.core.knn import knn_graph
from repro_torch.core.placement import get_placement, supported_placements
from repro_torch.core.quant import quant_knn_graph, quant_similarity_join
from repro_torch.core.sparse import (owned_pairs, quorum_allpairs_threshold,
                                     ring_allgather_hits, similarity_join,
                                     threshold_for_selectivity,
                                     threshold_with_gap)
from repro_torch.obs import comm as obs_comm
from repro_torch.serving import ServingCorpus
from repro_torch.serving.batching import (AdmissionError, BatchScheduler,
                                          follow_launches)
from repro_torch.serving.selfcheck import _host_scores, oracle_topk

SRC = Path(__file__).resolve().parents[1] / "src"
PS = (4, 5, 8)
BATCH_P = 5
METRICS = ("dot", "l2")
QMODES = ("int8", "bf16")
SB, SD, Q, STOPK = 16, 24, 12, 8          # serving: block, d, queries, k
JB, JD, KTOPK, RING_CAP = 8, 16, 5, 64    # join / k-NN: block, d, k, ring
TOL = dict(rtol=1e-5, atol=1e-5)
RANK_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_SECONDS = 300


def serve_np(P):
    """The serving corpus (its last block left empty for an append), its
    queries, a replacement and an appended block."""
    rng = np.random.default_rng(100 + P)
    corpus = rng.normal(size=(P * SB - SB, SD)).astype(np.float32)
    return (corpus, rng.normal(size=(Q, SD)).astype(np.float32),
            rng.normal(size=(SB - 3, SD)).astype(np.float32),
            rng.normal(size=(SB, SD)).astype(np.float32))


def serve_thr(P, metric):
    corpus, queries, _, _ = serve_np(P)
    _rows, s = _host_scores(corpus, np.ones(len(corpus), bool), queries,
                            metric)
    return threshold_with_gap(s, 0.1)


def join_np(P):
    """The join / k-NN corpus: a ragged tail, two low-norm blocks."""
    c = np.random.default_rng(200 + P).normal(
        size=(P * JB - 3, JD)).astype(np.float32)
    c[:2 * JB] *= 0.05
    return c


def join_thr(P, metric):
    return threshold_for_selectivity(join_np(P), 0.08, metric)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core.knn import quorum_allpairs_knn
from repro.core.placement import get_placement
from repro.core.sparse import (pair_mask_table, quorum_allpairs_threshold,
                               ring_allgather_hits, similarity_join)
from repro.serving.cover import build_cover
from repro.serving.engine import quorum_query_threshold, quorum_query_topk
from repro.serving.stream import build_state

SB, JB, STOPK, KTOPK, RING_CAP = %(consts)r
d = np.load(sys.argv[2])
out = {}
for P in %(ps)r:
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P])
    plc = get_placement("cyclic", P)
    sched = plc.schedule()
    st = build_state(d[f"serve{P}"], mesh, "q", block=SB, placement=plc)
    mt = jnp.asarray(build_cover(P, plc).mask_table())
    queries = d[f"queries{P}"]
    for metric in ("dot", "l2"):
        def body(q, s, sv, mr, metric=metric):
            v, i = quorum_query_topk(q, s, sv, mr, topk=STOPK, axis_name="q",
                                     schedule=sched, mode="batched",
                                     metric=metric)
            return v[None], i[None]
        v, i = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS(), PS("q"), PS("q"), PS("q")),
            out_specs=(PS("q"),) * 2, check_vma=False))(
                queries, st.stack, st.stack_valid, mt)
        out[f"P{P}_serve_{metric}_v"] = np.asarray(v)[0]
        out[f"P{P}_serve_{metric}_i"] = np.asarray(i)[0]
        cap = P * SB
        def body(q, t, s, sv, mr, metric=metric, cap=cap):
            v, i, n = quorum_query_threshold(
                q, s, sv, mr, threshold=t, capacity=cap, axis_name="q",
                schedule=sched, mode="batched", metric=metric)
            return v[None], i[None], n[None]
        v, i, n = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS(), PS(), PS("q"), PS("q"), PS("q")),
            out_specs=(PS("q"),) * 3, check_vma=False))(
                queries, jnp.float32(d[f"sthr{P}_{metric}"]), st.stack,
                st.stack_valid, mt)
        for f, a in zip("vin", (v, i, n)):
            out[f"P{P}_range_{metric}_{f}"] = np.asarray(a)[0]

    corpus = d[f"join{P}"]
    N = corpus.shape[0]
    x = np.zeros((P * JB, corpus.shape[1]), np.float32)
    x[:N] = corpus
    jm = jnp.asarray(pair_mask_table(sched))
    for metric in ("dot", "l2"):
        thr = float(d[f"jthr{P}_{metric}"])
        r = similarity_join(corpus, mesh, threshold=thr, metric=metric,
                            mode="batched", placement="cyclic", capacity=1)
        for f in ("i", "j", "scores", "counts"):
            out[f"P{P}_join_{metric}_{f}"] = np.asarray(getattr(r, f))
        out[f"P{P}_join_{metric}_esc"] = np.int64(r.escalations)
        def body(xb, mb, metric=metric, thr=thr):
            h = quorum_allpairs_threshold(
                xb, threshold=thr, axis_name="q", capacity=RING_CAP,
                schedule=sched, mask=mb, metric=metric, mode="batched",
                n_valid=N)
            g = ring_allgather_hits(h, axis_name="q", P=P)
            return g.vals[None], g.i[None], g.j[None], g.count[None]
        res = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS("q"), PS("q")),
            out_specs=(PS("q"),) * 4, check_vma=False))(x, jm)
        for f, a in zip(("v", "i", "j", "n"), res):
            out[f"P{P}_ring_{metric}_{f}"] = np.asarray(a)
        def body(xb, mb, metric=metric):
            return quorum_allpairs_knn(
                xb, topk=KTOPK, axis_name="q", schedule=sched, mask=mb,
                metric=metric, mode="batched", n_valid=N)
        v, i = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(PS("q"), PS("q")),
            out_specs=(PS("q"),) * 2, check_vma=False))(x, jm)
        out[f"P{P}_knn_{metric}_v"] = np.asarray(v).reshape(-1, KTOPK)[:N]
        out[f"P{P}_knn_{metric}_i"] = np.asarray(i).reshape(-1, KTOPK)[:N]
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# What every process runs
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def paths_outputs(comm, P):
    """The serving, join and k-NN paths on ``comm``: numpy arrays keyed by
    name (a rank's share: its block's k-NN rows, its device's pairs)."""
    out = {}
    quorums = []
    gather = sweep_mod.quorum_gather

    def recording_gather(x, schedule, comm_, **kw):
        got = gather(x, schedule, comm_, **kw)
        quorums.append(tuple(sweep_mod._leaves(got)[0].shape))
        return got
    sweep_mod.quorum_gather = recording_gather
    try:
        _serving_outputs(comm, P, out)
        _join_knn_outputs(comm, P, out)
    finally:
        sweep_mod.quorum_gather = gather
    out["sweep_quorums"] = np.array(sorted(set(quorums)))
    for qm in QMODES:
        try:
            rec = obs_comm.verify_quant_comm(P, qmode=qm, comm=comm,
                                             verbose=False)
            out[f"qcomm_{qm}_error"] = np.array("")
        except AssertionError as e:
            rec = []
            out[f"qcomm_{qm}_error"] = np.array(str(e))
        for r in rec:
            out[f"qcomm_{qm}_{r['placement']}"] = np.array(
                [r["gather_bytes"], r["gather_hops"]])
    return out


def _serving_outputs(comm, P, out):
    corpus, queries, fresh, extra = serve_np(P)
    sc = ServingCorpus.build(corpus, comm, block=SB, placement="cyclic",
                             quant="off")
    out["serve_shard_shape"] = np.array(sc.state.shard.shape)
    out["serve_stack_shape"] = np.array(sc.state.stack.shape)
    for metric in METRICS:
        for kern in (False, True):
            v, i = sc.query(queries, topk=STOPK, mode="batched",
                            metric=metric, use_kernel=kern)
            out[f"serve_{metric}_{kern}_v"], out[f"serve_{metric}_{kern}_i"] \
                = _np(v), _np(i)
        v, i, n = sc.query_threshold(queries, threshold=serve_thr(P, metric),
                                     capacity=4, metric=metric)
        out[f"range_{metric}_v"], out[f"range_{metric}_i"], \
            out[f"range_{metric}_n"] = _np(v), _np(i), _np(n)
    sc.replace_block(0, fresh)
    v, i = sc.query(queries, topk=STOPK, metric="l2")
    out["replace_v"], out["replace_i"] = _np(v), _np(i)
    out["append_b"] = np.array(sc.append_block(extra))
    v, i = sc.query(queries, topk=STOPK, metric="dot", use_kernel=True)
    out["append_v"], out["append_i"] = _np(v), _np(i)
    del sc
    for qm in QMODES:
        sc = ServingCorpus.build(corpus, comm, block=SB, placement="cyclic",
                                 quant=qm)
        out[f"q{qm}_stack_shape"] = np.array(sc.quant.stacks.q.shape)
        out[f"q{qm}_resident"] = np.array(sc.quant.mirror.resident)
        for metric in METRICS:
            v, i = sc.query(queries, topk=STOPK, metric=metric)
            out[f"q{qm}_serve_{metric}_v"] = _np(v)
            out[f"q{qm}_serve_{metric}_i"] = _np(i)
        sc.replace_block(0, fresh)
        v, i = sc.query(queries, topk=STOPK, metric="l2")
        out[f"q{qm}_replace_v"], out[f"q{qm}_replace_i"] = _np(v), _np(i)


def _join_knn_outputs(comm, P, out):
    corpus = join_np(P)
    sched = get_placement("cyclic", P).schedule()
    for metric in METRICS:
        thr = join_thr(P, metric)
        for kern in (False, True):
            r = similarity_join(corpus, comm, threshold=thr, metric=metric,
                                mode="batched", placement="cyclic",
                                capacity=1, use_kernel=kern, quant="off")
            key = f"join_{metric}_{kern}"
            for f in ("i", "j", "scores", "counts"):
                out[f"{key}_{f}"] = np.asarray(getattr(r, f))
            out[f"{key}_esc"] = np.array(r.escalations)
        hits = quorum_allpairs_threshold(
            pad_local(corpus, comm), comm, threshold=thr, capacity=RING_CAP,
            schedule=sched, metric=metric, mode="batched",
            n_valid=len(corpus))
        g = ring_allgather_hits(hits, comm)
        for f, a in zip(("v", "i", "j", "n"), (g.vals, g.i, g.j, g.count)):
            out[f"ring_{metric}_{f}"] = _np(a)
        g = knn_graph(corpus, comm, topk=KTOPK, metric=metric,
                      mode="batched", placement="cyclic", use_kernel=True,
                      quant="off")
        out[f"knn_{metric}_i"], out[f"knn_{metric}_v"] = g.indices, g.scores
        out[f"knn_{metric}_row0"] = np.array(g.row0)
    thr = join_thr(P, "l2")
    for qm in QMODES:
        st: dict = {}
        r = quant_similarity_join(corpus, comm, threshold=thr, quant=qm,
                                  metric="l2", mode="batched",
                                  placement="cyclic", capacity=1,
                                  use_kernel=True, stats=st)
        for f in ("i", "j", "scores", "counts"):
            out[f"qjoin_{qm}_{f}"] = np.asarray(getattr(r, f))
        out[f"qjoin_{qm}_esc"] = np.array(r.escalations)
        st = {}
        g = quant_knn_graph(corpus, comm, topk=KTOPK, quant=qm, metric="l2",
                            mode="batched", placement="cyclic",
                            use_kernel=True, stats=st)
        out[f"qknn_{qm}_i"], out[f"qknn_{qm}_v"] = g.indices, g.scores
        out[f"qknn_{qm}_passes"] = np.array(st["passes"])


def batcher_script(sc):
    """Rank 0's (or the one process's) scheduler traffic: every resolved
    request as arrays, and the escalation counters."""
    rng = np.random.default_rng(7)
    d = sc.d
    out = {}

    def record(name, req):
        res = req.result(0)
        out[f"{name}_status"] = np.array(res.status)
        out[f"{name}_v"], out[f"{name}_i"] = res.scores, res.indices
        out[f"{name}_n"] = np.array(-1 if res.count is None else res.count)

    # a heterogeneous pack: mixed k, thresholds and capacities (the
    # range queries' group escalates), both metrics
    sched = BatchScheduler(sc, max_batch=64)
    reqs = []
    for metric in METRICS:
        for k in (1, 3, 5, 8):
            reqs.append(sched.submit(rng.normal(size=(d,)), kind="topk",
                                     topk=k, metric=metric))
        for thr, cap in ((2.0, 2), (4.0, 1), (-1e9, 2)):
            reqs.append(sched.submit(rng.normal(size=(d,)),
                                     kind="threshold", threshold=thr,
                                     capacity=cap, metric=metric))
    sched.drain()
    for n, r in enumerate(reqs):
        record(f"pack{n}", r)
    out["pack_escalations"] = np.array(sched.counters["escalations"])
    out["pack_launches"] = np.array(sched.counters["launches"])
    # a stream update between launches, then a query of the new rows
    sched.replace_block(1, rng.normal(size=(sc.block - 2, d)))
    after = sched.submit(rng.normal(size=(d,)), kind="topk", topk=6,
                         metric="l2")
    sched.drain()
    record("after_update", after)
    # a deadline that expires mid-escalation: submitted at 0.4 (deadline
    # 0.9), popped at 0.8, resolved at 1.2 while it still overflows
    t = [0.0]

    def stepping_clock():
        t[0] += 0.4
        return t[0]
    sched2 = BatchScheduler(sc, max_batch=8, clock=stepping_clock)
    part = sched2.submit(rng.normal(size=(d,)), kind="threshold",
                         threshold=-1e9, capacity=1, deadline_s=0.5)
    sched2.step()
    record("partial", part)
    # admission backpressure: the fourth waiting request is refused
    sched3 = BatchScheduler(sc, max_batch=4, max_queue=3)
    waiting = [sched3.submit(rng.normal(size=(d,)), kind="topk", topk=2)
               for _ in range(3)]
    try:
        sched3.submit(rng.normal(size=(d,)), kind="topk", topk=2)
        out["rejected"] = np.array(False)
    except AdmissionError:
        out["rejected"] = np.array(True)
    sched3.drain()
    for n, r in enumerate(waiting):
        record(f"admitted{n}", r)
    sched3.close()
    return out


def batcher_corpus(comm, P):
    rng = np.random.default_rng(300)
    corpus = rng.normal(size=(P * SB - SB // 2, SD)).astype(np.float32)
    return ServingCorpus.build(corpus, comm, block=SB, placement="cyclic",
                               quant="off")


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _comm(rank, P, store, timeout=RANK_TIMEOUT):
    torch.set_num_threads(1)
    return DistributedComm("gloo", rank=rank, world_size=P,
                           init_method=f"file://{store}", device="cpu",
                           timeout=timeout)


def _rank_main(rank, P, store, out_dir):
    """The paths at P, then (at P = 5) the batcher: rank 0 leads."""
    comm = _comm(rank, P, store)
    try:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **paths_outputs(comm, P))
        if P == BATCH_P:
            sc = batcher_corpus(comm, P)
            out = (batcher_script(sc) if rank == 0
                   else {"followed": np.array(follow_launches(sc))})
            np.savez(Path(out_dir) / f"batch{rank}.npz", **out)
    finally:
        comm.close()


def _unstopped_rank(rank, store, timeout_s):
    """Rank 0 runs one launch, never stops its follower, and idles well
    past the follower's timeout."""
    comm = _comm(rank, 2, store, datetime.timedelta(seconds=timeout_s))
    sc = batcher_corpus(comm, 2)
    if rank == 0:
        sched = BatchScheduler(sc)
        sched.submit(np.ones(SD), kind="topk", topk=2)
        sched.drain()
        time.sleep(6 * timeout_s)
    else:
        follow_launches(sc)


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
    """Start the JAX reference and the three spawns; meanwhile run the
    same on ``SingleProcessComm`` here.  Returns
    (reference, {P: [rank outputs]}, {P: single-process outputs}, batcher
    [rank outputs], batcher single-process outputs)."""
    d = tmp_path_factory.mktemp("torch_dist_serving")
    inputs = {}
    for P in PS:
        inputs[f"serve{P}"], inputs[f"queries{P}"] = serve_np(P)[:2]
        inputs[f"join{P}"] = join_np(P)
        for metric in METRICS:
            inputs[f"sthr{P}_{metric}"] = np.float32(serve_thr(P, metric))
            inputs[f"jthr{P}_{metric}"] = np.float64(join_thr(P, metric))
    np.savez(d / "inputs.npz", **inputs)
    code = REFERENCE % {"ps": PS, "consts": (SB, JB, STOPK, KTOPK, RING_CAP)}
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
        single = {P: paths_outputs(SingleProcessComm(P, "cpu"), P)
                  for P in PS}
        batch_single = batcher_script(batcher_corpus(
            SingleProcessComm(BATCH_P, "cpu"), BATCH_P))
        _join(ctxs, SPAWN_SECONDS)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    ranks = {P: [dict(np.load(d / f"P{P}" / f"rank{r}.npz"))
                 for r in range(P)] for P in PS}
    batch = [dict(np.load(d / f"P{BATCH_P}" / f"batch{r}.npz"))
             for r in range(BATCH_P)]
    return dict(np.load(d / "ref.npz")), ranks, single, batch, batch_single


def _bit_equal(record_property, pairs):
    """Record and assert that every (got, want) pair is bit-equal."""
    same = all(np.array_equal(g, w) for g, w in pairs)
    record_property("bit_equal", bool(same))
    for g, w in pairs:
        np.testing.assert_array_equal(g, w)


def union_pairs(ranks, key):
    """The ranks' pairs joined and sorted by (i, j)."""
    i = np.concatenate([r[f"{key}_i"] for r in ranks]).astype(np.int64)
    j = np.concatenate([r[f"{key}_j"] for r in ranks]).astype(np.int64)
    s = np.concatenate([r[f"{key}_scores"] for r in ranks])
    order = np.lexsort((j, i))
    return i[order], j[order], s[order]


def owned(single, key, P, rank):
    """The single process's pairs of ``key`` the rank's device owns."""
    i, j = single[f"{key}_i"], single[f"{key}_j"]
    mine = owned_pairs(i, j, JB, get_placement("cyclic", P).schedule(),
                       [rank])
    return i[mine], j[mine], single[f"{key}_scores"][mine]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kern", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_serving_topk_matches_jax(runs, P, metric, kern, record_property):
    ref, ranks, single = runs[:3]
    key = f"serve_{metric}_{kern}"
    for rank, r in enumerate(ranks[P]):
        np.testing.assert_array_equal(r[f"{key}_i"],
                                      ref[f"P{P}_serve_{metric}_i"],
                                      err_msg=f"rank {rank}")
        np.testing.assert_allclose(r[f"{key}_v"],
                                   ref[f"P{P}_serve_{metric}_v"], **TOL)
    _bit_equal(record_property, [(r[f"{key}_{f}"], single[P][f"{key}_{f}"])
                                 for r in ranks[P] for f in "vi"])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_serving_range_query_matches_jax(runs, P, metric, record_property):
    ref, ranks, single = runs[:3]
    want_n = ref[f"P{P}_range_{metric}_n"]
    for rank, r in enumerate(ranks[P]):
        n = r[f"range_{metric}_n"]
        np.testing.assert_array_equal(n, want_n, err_msg=f"rank {rank}")
        assert r[f"range_{metric}_i"].shape[1] >= n.max() > 4  # escalated
        for q in range(Q):
            np.testing.assert_array_equal(
                r[f"range_{metric}_i"][q, :n[q]],
                ref[f"P{P}_range_{metric}_i"][q, :n[q]])
            np.testing.assert_allclose(
                r[f"range_{metric}_v"][q, :n[q]],
                ref[f"P{P}_range_{metric}_v"][q, :n[q]], **TOL)
    _bit_equal(record_property,
               [(r[f"range_{metric}_{f}"], single[P][f"range_{metric}_{f}"])
                for r in ranks[P] for f in "vin"])


@pytest.mark.parametrize("P", PS)
def test_serving_updates_match_oracle(runs, P, record_property):
    """``replace_block`` then ``append_block`` under ranks: every rank's
    answers equal the numpy oracle's over the updated corpus."""
    ranks, single = runs[1][P], runs[2][P]
    corpus, queries, fresh, extra = serve_np(P)
    full = np.zeros((P * SB, SD), np.float32)
    full[:len(corpus)] = corpus
    valid = np.arange(P * SB) < len(corpus)
    full[:SB] = 0.0
    full[:len(fresh)] = fresh
    valid[:SB] = np.arange(SB) < len(fresh)
    want_replace = oracle_topk(full, valid, queries, STOPK, "l2")
    b = P - 1
    full[b * SB:(b + 1) * SB] = extra
    valid[b * SB:(b + 1) * SB] = True
    want_append = oracle_topk(full, valid, queries, STOPK, "dot")
    for r in ranks:
        assert int(r["append_b"]) == b
        for name, (wv, wi) in (("replace", want_replace),
                               ("append", want_append)):
            np.testing.assert_array_equal(r[f"{name}_i"], wi)
            np.testing.assert_allclose(r[f"{name}_v"], wv, **TOL)
    _bit_equal(record_property, [(r[k], single[k]) for r in ranks
                                 for k in ("replace_v", "replace_i",
                                           "append_v", "append_i")])


@pytest.mark.parametrize("qm", QMODES)
@pytest.mark.parametrize("P", PS)
def test_quant_serving_matches_jax(runs, P, qm, record_property):
    """The quantized path's certified answers equal the reference's f32
    ones, before and after a replace (the latter against the oracle)."""
    ref, ranks, single = runs[:3]
    corpus, queries, fresh, _ = serve_np(P)
    full = np.zeros((P * SB, SD), np.float32)
    full[:len(corpus)] = corpus
    full[:SB] = 0.0
    full[:len(fresh)] = fresh
    valid = np.arange(P * SB) < len(corpus)
    valid[:SB] = np.arange(SB) < len(fresh)
    wv, wi = oracle_topk(full, valid, queries, STOPK, "l2")
    keys = []
    for r in ranks[P]:
        for metric in METRICS:
            np.testing.assert_array_equal(r[f"q{qm}_serve_{metric}_i"],
                                          ref[f"P{P}_serve_{metric}_i"])
            np.testing.assert_allclose(r[f"q{qm}_serve_{metric}_v"],
                                       ref[f"P{P}_serve_{metric}_v"], **TOL)
            keys += [f"q{qm}_serve_{metric}_v", f"q{qm}_serve_{metric}_i"]
        np.testing.assert_array_equal(r[f"q{qm}_replace_i"], wi)
        np.testing.assert_allclose(r[f"q{qm}_replace_v"], wv, **TOL)
    keys += [f"q{qm}_replace_v", f"q{qm}_replace_i"]
    _bit_equal(record_property, [(r[k], single[P][k]) for r in ranks[P]
                                 for k in keys])


# ---------------------------------------------------------------------------
# The join
# ---------------------------------------------------------------------------

def _check_join(ref, ranks, single, P, metric, key, record_property):
    want_i = ref[f"P{P}_join_{metric}_i"]
    want_j = ref[f"P{P}_join_{metric}_j"]
    want_s = ref[f"P{P}_join_{metric}_scores"]
    i, j, s = union_pairs(ranks, key)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(j, want_j)
    assert (np.abs(s - want_s) <= 1e-5 * np.maximum(1, np.abs(want_s))).all()
    pairs = []
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"{key}_counts"],
                                      ranks[0][f"{key}_counts"])
        assert int(r[f"{key}_esc"]) == int(ranks[0][f"{key}_esc"]) > 0
        pairs += list(zip((r[f"{key}_{f}"] for f in ("i", "j", "scores")),
                          owned(single, key, P, rank)))
    _bit_equal(record_property, pairs)


@pytest.mark.parametrize("kern", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_join_matches_jax(runs, P, metric, kern, record_property):
    """The union of the ranks' pairs is the reference's join; started at
    capacity 1 every rank escalates as the reference does and reports its
    [P] counts."""
    ref, ranks, single = runs[:3]
    key = f"join_{metric}_{kern}"
    _check_join(ref, ranks[P], single[P], P, metric, key, record_property)
    for r in ranks[P]:
        np.testing.assert_array_equal(r[f"{key}_counts"],
                                      ref[f"P{P}_join_{metric}_counts"])
        assert int(r[f"{key}_esc"]) == int(ref[f"P{P}_join_{metric}_esc"])


@pytest.mark.parametrize("qm", QMODES)
@pytest.mark.parametrize("P", PS)
def test_quant_join_matches_jax(runs, P, qm, record_property):
    """The int8 / bf16 band join rescored: the reference's f32 pairs."""
    ref, ranks, single = runs[:3]
    _check_join(ref, ranks[P], single[P], P, "l2", f"qjoin_{qm}",
                record_property)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", PS)
def test_ring_gather_matches_jax(runs, P, metric):
    """Every rank ends with the reference's device-ordered stack."""
    ref, ranks = runs[:2]
    for rank, r in enumerate(ranks[P]):
        for f in ("v", "i", "j", "n"):
            got, want = r[f"ring_{metric}_{f}"], ref[f"P{P}_ring_{metric}_{f}"]
            assert got.shape == (1,) + want.shape[1:], (rank, f)
            if f == "v":
                np.testing.assert_allclose(got[0], want[rank], **TOL)
            else:
                np.testing.assert_array_equal(got[0], want[rank])


# ---------------------------------------------------------------------------
# The k-NN graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("P", PS)
def test_knn_rows_match_jax(runs, P, path, record_property):
    """Each rank's rows equal the reference's rows of its block (the
    quantized graphs: the reference's f32 l2 graph); every rank ran the
    same certify passes."""
    ref, ranks, single = runs[:3]
    N = len(join_np(P))
    pairs = []
    metrics = METRICS if path == "f32" else ("l2",)
    for metric in metrics:
        key = f"knn_{metric}" if path == "f32" else f"qknn_{path}"
        for rank, r in enumerate(ranks[P]):
            row0, n = rank * JB, min(N, (rank + 1) * JB) - rank * JB
            rows = slice(row0, row0 + n)
            assert r[f"{key}_i"].shape == (n, KTOPK)
            np.testing.assert_array_equal(r[f"{key}_i"],
                                          ref[f"P{P}_knn_{metric}_i"][rows])
            np.testing.assert_allclose(r[f"{key}_v"],
                                       ref[f"P{P}_knn_{metric}_v"][rows],
                                       **TOL)
            pairs += [(r[f"{key}_i"], single[P][f"{key}_i"][rows]),
                      (r[f"{key}_v"], single[P][f"{key}_v"][rows])]
            if path != "f32":
                np.testing.assert_array_equal(r[f"{key}_passes"],
                                              single[P][f"{key}_passes"])
    _bit_equal(record_property, pairs)


# ---------------------------------------------------------------------------
# Bytes: the comm predictor, memory per rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qm", QMODES)
@pytest.mark.parametrize("P", PS)
def test_quant_comm_bytes_exact_on_every_rank(runs, P, qm):
    payload = obs_comm.quant_block_bytes(4, 3, qm)
    for rank, r in enumerate(runs[1][P]):
        assert str(r[f"qcomm_{qm}_error"]) == "", (rank, r[f"qcomm_{qm}_error"])
        for plc in supported_placements(P):
            nz = sum(1 for a in plc.schedule().shifts if a % P)
            assert r[f"qcomm_{qm}_{plc.name}"].tolist() == [nz * payload, nz]


@pytest.mark.parametrize("P", PS)
def test_resident_blocks_k_of_p(runs, P):
    """Each rank's resident corpus state holds k of the P blocks: the
    serving stack, the quantized stacks and every sweep's quorum are
    [1, k, block, ...], 1/P of the single process's [P, k, block, ...];
    the quantized paths' f32 rows stay off a rank's device."""
    k = get_placement("cyclic", P).schedule().k
    single = runs[2][P]
    assert single["serve_stack_shape"].tolist() == [P, k, SB, SD]
    for r in runs[1][P]:
        assert r["serve_shard_shape"].tolist() == [1, SB, SD]
        assert r["serve_stack_shape"].tolist() == [1, k, SB, SD]
        for qm in QMODES:
            assert r[f"q{qm}_stack_shape"].tolist() == [1, k, SB, SD]
            assert not bool(r[f"q{qm}_resident"])
        quorums = {tuple(q) for q in r["sweep_quorums"].tolist()}
        assert quorums == {(1, k, JB, JD)}, quorums
    assert {tuple(q) for q in single["sweep_quorums"].tolist()} \
        == {(P, k, JB, JD)}


# ---------------------------------------------------------------------------
# The batcher: rank 0 controls, the others follow
# ---------------------------------------------------------------------------

def test_batcher_matches_solo_run(runs, record_property):
    batch, solo = runs[3], runs[4]
    lead = batch[0]
    assert set(lead) == set(solo)
    assert str(lead["partial_status"]) == "partial"
    assert bool(lead["rejected"])
    assert int(lead["pack_escalations"]) > 0
    for n in range(14):
        assert str(lead[f"pack{n}_status"]) == "done"
    # each follower ran every launch rank 0 made, the update included
    n_launches = (int(lead["pack_launches"]) + 1 + 1 + 1 + 1)
    for r in batch[1:]:
        assert int(r["followed"]) == n_launches, (int(r["followed"]),
                                                  n_launches)
    _bit_equal(record_property, [(lead[k], solo[k]) for k in solo])


def test_follower_without_stop_times_out(tmp_path):
    """Rank 0 never sends the stop: its follower fails at its 5 s timeout,
    long before rank 0 idles out."""
    t0 = time.monotonic()
    ctx = _spawn(_unstopped_rank, 2, (str(tmp_path / "store"), 5))
    with pytest.raises(mp.ProcessRaisedException, match="Timed out"):
        _join([ctx], 120)
    assert time.monotonic() - t0 < 30
