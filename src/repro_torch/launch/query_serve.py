"""Request-serving front end: a thin client of the continuous batcher
(counterpart of ``repro/launch/query_serve.py``).

Historically this module *was* the serving loop — a synchronous
fixed-microbatch drain.  It is now a thin client of
``serving.batching.BatchScheduler`` (DESIGN.md section 15): each
microbatch of requests is submitted to the scheduler's admission queue
and one scheduler iteration packs and launches it, with
``pad_queries_to=microbatch`` pinning the legacy launch shape so the
drain contract stays bit-exact with the original loop (and with
per-microbatch ``ServingCorpus.query`` calls).  ``--stream-every``
interleaves streamed block replacements with query traffic to exercise
the online update path under load.

Throughput accounting (DESIGN.md section 15.4): steady-state qps is
measured after a warmup that absorbs compile time, and the blocking
stream updates are timed *separately* and excluded from the query
window — so ``--stream-every`` no longer deflates the reported query
throughput; both figures are printed.  Per-request p50/p99 latency
comes from the scheduler's latency trace.

The corpus is resident over ``--P`` simulated devices of the
single-process comm layer, on the CUDA device unless ``--device cpu``.
With ``--dist gloo|nccl`` each of the P processes torchrun starts is one
device (``DistributedComm``): rank 0 runs the scheduler and broadcasts
every launch and stream update, the other ranks follow
(``serving.batching.follow_launches``), and rank 0 prints the report.

Run:  PYTHONPATH=src python -m repro_torch.launch.query_serve --requests 512
      [--P 8] [--kernel] [--device cpu]
      PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
          -m repro_torch.launch.query_serve --P 4 --dist gloo --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.comm import DistributedComm, SingleProcessComm, resolve_device
from ..obs import trace as obs_trace
from ..serving import ServingCorpus
from ..serving.batching import (BatchScheduler, follow_launches,
                                latency_summary)


def serve_queries(sc: ServingCorpus, queries, *, microbatch: int,
                  topk: int, mode: str = "auto", metric: str = "dot",
                  use_kernel: bool = False, warmup_batches: int = 2,
                  stream_every: int = 0, rng=None,
                  scheduler: BatchScheduler | None = None):
    """Drain ``queries`` [R, d] (numpy or a tensor) through the continuous
    batcher in fixed-size microbatches; returns (scores [R, topk], ids
    [R, topk] as host arrays, queries/sec over the steady-state tail).

    Each microbatch is submitted as ``n`` top-k requests and resolved by
    one scheduler iteration, so results are bit-identical to the
    original per-microbatch ``sc.query`` loop (the launch payload is the
    same zero-padded [microbatch, d] array).  The qps window starts
    after ``warmup_batches`` and excludes the separately-timed stream
    updates (DESIGN.md section 15.4); pass ``scheduler`` to reuse an
    externally-built :class:`BatchScheduler` (its latency trace then
    covers this drain).  Stream updates go through the scheduler, so
    under ``DistributedComm`` (on rank 0) the follower ranks apply them
    in the same order.
    """
    R, d = queries.shape
    rng = rng if rng is not None else np.random.default_rng(0)
    sched = scheduler if scheduler is not None else BatchScheduler(
        sc, max_batch=microbatch, mode=mode, use_kernel=use_kernel,
        pad_queries_to=microbatch)
    vals_out, idx_out = [], []
    n_batches = -(-R // microbatch)
    warmup_batches = min(warmup_batches, n_batches - 1)  # measure >= 1 batch
    done = served = stream_updates = 0
    stream_s = stream_s_measured = 0.0
    t0 = time.perf_counter() if warmup_batches == 0 else None
    for bi in range(n_batches):
        q = queries[done:done + microbatch]
        n = len(q)
        if stream_every and bi and bi % stream_every == 0:
            # online update under load: re-stream a random block with
            # fresh vectors through the ppermute push path.  Timed
            # separately — the blocking push must not deflate query qps.
            ts = time.perf_counter()
            b = int(rng.integers(sc.P))
            sched.replace_block(b, rng.normal(size=(sc.block, d))
                                .astype(np.float32))
            if sc.comm.device.type == "cuda":   # the push runs async
                torch.cuda.synchronize(sc.comm.device)
            dt_stream = time.perf_counter() - ts
            stream_s += dt_stream
            if t0 is not None:
                stream_s_measured += dt_stream
            stream_updates += 1
        reqs = [sched.submit(q[j], kind="topk", topk=topk, metric=metric)
                for j in range(n)]
        sched.step()
        results = [r.result(timeout=0) for r in reqs]
        vals_out.append(np.stack([res.scores for res in results]))
        idx_out.append(np.stack([res.indices for res in results]))
        done += n
        if bi + 1 == warmup_batches:         # compile/warm caches absorbed
            t0 = time.perf_counter()
            served = 0
        elif warmup_batches == 0 or bi + 1 > warmup_batches:
            served += n
    dt = ((time.perf_counter() - t0 - stream_s_measured)
          if t0 is not None and served else float("nan"))
    qps = served / dt if served and dt > 0 else float("nan")
    tr = obs_trace.get_tracer()
    if tr:
        tr.count("serve.batches", n_batches)
        tr.count("serve.queries", R)
        tr.count("serve.stream_updates", stream_updates)
        if stream_s:
            tr.count("serve.stream_update_s", stream_s)
    return np.concatenate(vals_out), np.concatenate(idx_out), qps


def main(argv=None):
    """CLI: steady-state queries/sec + per-request p50/p99 report
    (see module doc)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4096, help="corpus rows")
    ap.add_argument("--d", type=int, default=64, help="embedding dim")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=32)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "batched", "overlap", "scan"])
    ap.add_argument("--metric", default="dot", choices=["dot", "l2"])
    ap.add_argument("--kernel", action="store_true",
                    help="route the batched local step through the B4 "
                         "kernel (query_topk) on the card")
    ap.add_argument("--stream-every", type=int, default=0,
                    help="re-stream a random block every N microbatches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--P", type=int, default=8,
                    help="simulated devices the corpus is spread over")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one process per device over torch.distributed "
                         "with this backend (start under torchrun with "
                         "--P processes)")
    args = ap.parse_args(argv)

    P = args.P
    if args.dist is None:
        return _serve(args, SingleProcessComm(P, resolve_device(args.device)))
    comm = DistributedComm.from_env(args.dist, args.device)
    try:
        if comm.P != P:
            raise ValueError(f"--P {P} but torchrun started {comm.P} "
                             "processes")
        return _serve(args, comm)
    finally:
        comm.close()


def _serve(args, comm):
    """The CLI's run on ``comm``: every process builds the same corpus;
    rank 0 (or the one process) serves and reports, the other ranks
    follow its launches."""
    P = comm.P
    rng = np.random.default_rng(args.seed)
    corpus = rng.normal(size=(args.n, args.d)).astype(np.float32)
    queries = rng.normal(size=(args.requests, args.d)).astype(np.float32)

    sc = ServingCorpus.build(corpus, comm)
    if isinstance(comm, DistributedComm) and comm.rank != 0:
        n = follow_launches(sc)
        print(f"rank {comm.rank}: followed {n} launches")
        return None
    plan = sc.plan
    print(f"corpus N={args.n} d={args.d} -> P={P} blocks of {sc.block} "
          f"(quorum k={plan.k}, cover {plan.n_cover}/{P} devices)")
    sched = BatchScheduler(sc, max_batch=args.microbatch, mode=args.mode,
                           use_kernel=args.kernel,
                           pad_queries_to=args.microbatch)
    t_start = time.perf_counter()
    try:
        vals, idx, qps = serve_queries(
            sc, queries, microbatch=args.microbatch, topk=args.topk,
            mode=args.mode, metric=args.metric, use_kernel=args.kernel,
            stream_every=args.stream_every, rng=rng, scheduler=sched)
    finally:
        sched.close()
    wall = time.perf_counter() - t_start
    print(f"served {args.requests} requests in microbatches of "
          f"{args.microbatch}: {qps:.1f} queries/sec steady-state "
          f"(mode={args.mode} kernel={args.kernel})")
    lat = latency_summary(sched.latencies_s)
    if lat.get("n"):
        print(f"per-request latency: p50={lat['p50_s'] * 1e3:.2f}ms "
              f"p99={lat['p99_s'] * 1e3:.2f}ms over {int(lat['n'])} "
              f"requests ({wall:.2f}s wall)")
    if args.stream_every:
        tr = obs_trace.get_tracer()
        detail = (f" ({tr.counter_total('serve.stream_update_s'):.3f}s "
                  "total)" if tr else "")
        print(f"stream updates: every {args.stream_every} batches, timed "
              f"separately and excluded from the qps window{detail}")
    print(f"first request top-{args.topk}: ids={idx[0].tolist()} "
          f"scores={np.round(vals[0], 3).tolist()}")
    return vals, idx


if __name__ == "__main__":
    main()
