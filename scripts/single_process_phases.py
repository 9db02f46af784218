#!/usr/bin/env python3
"""Time the single-process serving, join and k-NN phases of a checkout's
``chip_smoke.py`` on one GPU.

    python3 scripts/single_process_phases.py [--root DIR] [--label NAME]
                                             [--drains 3]

Imports ``chip_smoke.py`` and ``src/repro_torch`` from ``--root`` (default:
the checkout beside this script), builds its kernels, and runs its phases
8, 9, 12-15 and 20 (serving, join, k-NN graph, quantized join, quantized
k-NN graph, quantized serving, the batcher) on a ``SingleProcessComm``,
each printing its own line and then its wall time.  Then ``--drains``
more runs of phase 20's drain (40 microbatches of 256 l2 top-10 requests
through ``BatchScheduler`` with a stream update every 10), each with its
queries/s, p99 and the microbatches whose slowest request took over 20
ms.  To compare two checkouts, run the script once per checkout in turns
(A, B, B, A) within one call on one machine; every line carries the
label.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="run")
    ap.add_argument("--drains", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import _build
    from repro_torch.launch.query_serve import serve_queries
    from repro_torch.serving import ServingCorpus
    from repro_torch.serving.batching import BatchScheduler

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{args.label}]"
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"{tag} build {time.perf_counter() - t0:.1f} s", flush=True)
    report: dict = collections.defaultdict(dict)
    for name, fn in (("serving", cs.phase_serving), ("join", cs.phase_join),
                     ("knn", cs.phase_knn),
                     ("quant_join", cs.phase_quant_join),
                     ("quant_knn", cs.phase_quant_knn),
                     ("quant_serving", lambda r: cs.phase_quant_serving()),
                     ("batching", lambda r: cs.phase_batching())):
        t0 = time.perf_counter()
        fn(report)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"{tag} phase {name} {time.perf_counter() - t0:.2f} s",
              flush=True)

    X, queries, _fresh, _thr_q = cs.serving_data()
    sc = ServingCorpus.build(X, SingleProcessComm(cs.P, cs.DEVICE),
                             placement="cyclic")
    serve_queries(sc, queries[cs.SERVE_BATCHES], microbatch=cs.SERVE_Q,
                  topk=cs.SERVE_TOPK, metric="l2", use_kernel=True)
    torch.cuda.synchronize()
    drain_q = queries[:cs.SERVE_BATCHES].reshape(-1, cs.SERVE_D)
    for rep in range(args.drains):
        sched = BatchScheduler(sc, max_batch=cs.SERVE_Q,
                               pad_queries_to=cs.SERVE_Q, use_kernel=True)
        t0 = time.perf_counter()
        _v, _i, qps = serve_queries(
            sc, drain_q, microbatch=cs.SERVE_Q, topk=cs.SERVE_TOPK,
            metric="l2", use_kernel=True,
            stream_every=cs.BATCH_STREAM_EVERY,
            rng=np.random.default_rng(20), scheduler=sched)
        wall = time.perf_counter() - t0
        lat = np.array(sched.latencies_s) * 1e3
        worst = lat.reshape(-1, cs.SERVE_Q).max(axis=1)
        slow = [(i, round(float(v), 1)) for i, v in enumerate(worst)
                if v > 20]
        print(f"{tag} drain {rep}: wall {wall:.3f} s, {qps:.1f} queries/s, "
              f"p99 {np.percentile(lat, 99):.2f} ms, median microbatch's "
              f"slowest request {np.median(worst):.2f} ms, microbatches "
              f"over 20 ms {slow}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
