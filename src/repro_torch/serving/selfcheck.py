"""Self-check of the port's online query serving subsystem.

Run as ``python -m repro_torch.serving.selfcheck [P] [modes] [placement]
[--device cpu] [--dist gloo|nccl]`` (counterpart of
``repro/serving/selfcheck.py``; with ``--dist`` each of P processes
started by torchrun is one device, ``DistributedComm``, and every rank
checks the same answers).
``modes`` is a comma-separated subset of the engine modes plus ``kernel``
(the batched path through the B4 hook; default: all of batched, overlap,
scan, kernel); ``placement`` is a placement spec (unset defers to
``REPRO_PLACEMENT``).  It runs on the CUDA device unless ``--device cpu``
is given.

Checks, against a brute-force oracle on the host (same score formula and
(-score, index) tie order; indices are global row ids in the P*block slot
numbering, restricted to valid rows):
  1. cover-routed top-k matches the oracle exactly (indices) / to float
     tolerance (scores) in every mode, for both metrics, including a
     partially filled corpus,
  2. after a streamed ``replace_block`` and an ``append_block`` the results
     track the updated corpus,
  3. the thresholded range query returns exactly the oracle's passing
     index set per query in every engine mode, for both metrics, through
     the same updates, including a capacity-escalation pass from a tiny
     starting capacity.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.comm import Comm, DistributedComm, SingleProcessComm, run_main
from ..core.placement import placement_from_env, resolve_placement
from ..core.sparse import threshold_with_gap
from ..core.sweep import ENGINE_MODES
from .engine import IDX_SENTINEL, ServingCorpus

CHECK_MODES = ENGINE_MODES + ("kernel",)


def _require(cond, *what) -> None:
    if not cond:
        raise AssertionError(" ".join(map(str, what)))


def _host_scores(full: np.ndarray, valid: np.ndarray, queries: np.ndarray,
                 metric: str):
    """(valid row ids, [Q, n_valid] float32 scores) with the engine's
    formula."""
    rows = np.nonzero(valid)[0]
    c = full[rows].astype(np.float32)
    q = queries.astype(np.float32)
    s = q @ c.T
    if metric == "l2":
        s = 2.0 * s - (c * c).sum(-1)[None, :] - (q * q).sum(-1)[:, None]
    return rows, s


def oracle_topk(full: np.ndarray, valid: np.ndarray, queries: np.ndarray,
                topk: int, metric: str):
    """Brute force on the host over the valid rows of the [P*block, d]
    slot-numbered corpus, same score formula and tie order as the engine."""
    rows, s = _host_scores(full, valid, queries, metric)
    vals = np.empty((len(queries), topk), np.float32)
    idx = np.empty((len(queries), topk), np.int32)
    for r in range(len(queries)):
        order = np.lexsort((rows, -s[r]))[:topk]   # by -score, then row id
        vals[r] = s[r, order]
        idx[r] = rows[order]
    return vals, idx


def check(full: np.ndarray, valid: np.ndarray, sc: ServingCorpus,
          queries: np.ndarray, topk: int, modes, label: str) -> None:
    """Top-k under every requested mode vs the brute-force oracle."""
    for metric in ("dot", "l2"):
        want_v, want_i = oracle_topk(full, valid, queries, topk, metric)
        for m in modes:
            mode, uk = ("batched", True) if m == "kernel" else (m, False)
            got_v, got_i = sc.query(queries, topk=topk, mode=mode,
                                    metric=metric, use_kernel=uk)
            got_v, got_i = got_v.cpu().numpy(), got_i.cpu().numpy()
            _require(not (got_i == IDX_SENTINEL).any(), label, m, metric)
            np.testing.assert_array_equal(
                got_i, want_i, err_msg=f"{label} mode={m} metric={metric}")
            np.testing.assert_allclose(
                got_v, want_v, rtol=1e-5, atol=1e-5,
                err_msg=f"{label} mode={m} metric={metric}")


def oracle_threshold(full: np.ndarray, valid: np.ndarray,
                     queries: np.ndarray, threshold: float, metric: str):
    """Brute force range query: per query, the valid rows scoring >=
    threshold, sorted by ascending row id (the engine's canonical
    order)."""
    rows, s = _host_scores(full, valid, queries, metric)
    out = []
    for r in range(len(queries)):
        keep = s[r] >= threshold
        out.append((rows[keep], s[r][keep]))
    return out


def check_threshold(full: np.ndarray, valid: np.ndarray, sc: ServingCorpus,
                    queries: np.ndarray, modes, label: str) -> None:
    """Thresholded range query (DESIGN.md 11.4) vs the brute-force
    oracle: exact index sets per query, counts, sentinels, and a
    capacity-escalation pass."""
    engine_modes = [m for m in modes if m != "kernel"]
    for metric in ("dot", "l2"):
        # a gap-placed threshold so membership is float-rounding-proof
        _rows, s = _host_scores(full, valid, queries, metric)
        thr = threshold_with_gap(s, 0.1)
        want = oracle_threshold(full, valid, queries, thr, metric)
        for m in engine_modes:
            got_v, got_i, got_c = (t.cpu().numpy() for t in sc.query_threshold(
                queries, threshold=thr, mode=m, metric=metric))
            for r, (wi, wv) in enumerate(want):
                n = int(got_c[r])
                _require(n == len(wi), label, m, metric, r, n, len(wi))
                np.testing.assert_array_equal(
                    got_i[r, :n], wi,
                    err_msg=f"{label} mode={m} metric={metric} q={r}")
                _require((got_i[r, n:] == IDX_SENTINEL).all(), label, m, r)
                np.testing.assert_allclose(
                    got_v[r, :n], wv, rtol=1e-5, atol=1e-5,
                    err_msg=f"{label} mode={m} metric={metric} q={r}")
    # escalation: a tiny starting capacity must double up to the same
    # exact answer
    want = oracle_threshold(full, valid, queries, thr, "l2")
    _got_v, got_i, _got_c = sc.query_threshold(queries, threshold=thr,
                                               capacity=2, metric="l2")
    got_i = got_i.cpu().numpy()
    _require(got_i.shape[1] >= max(len(w[0]) for w in want), got_i.shape)
    for r, (wi, _) in enumerate(want):
        np.testing.assert_array_equal(got_i[r, :len(wi)], wi)


def main(nblocks: int = 8, modes: tuple[str, ...] = CHECK_MODES,
         placement: str | None = None, device=None,
         comm: Comm | None = None) -> None:
    """Run the serving selfcheck (see the module docstring) on ``comm``
    (default: a ``SingleProcessComm`` of ``nblocks`` devices on
    ``device``)."""
    Pn = int(nblocks)
    comm = SingleProcessComm(Pn, device) if comm is None else comm
    if comm.P != Pn:
        raise ValueError(f"the comm has P={comm.P} devices, not {Pn}")
    plc = (placement_from_env(Pn) if placement is None
           else resolve_placement(placement, Pn))
    block, d, Q, topk = 16, 24, 12, 8
    rng = np.random.default_rng(0)
    # leave one block's worth of rows empty: exercises validity masking
    # at build time and gives append_block somewhere to land (degenerate
    # small P keeps at least half a block of corpus and skips the append)
    N = max(block // 2, Pn * block - block)
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    queries = rng.normal(size=(Q, d)).astype(np.float32)

    sc = ServingCorpus.build(corpus, comm, block=block, placement=plc)
    # host mirror in the global P*block slot numbering
    full = np.zeros((Pn * block, d), np.float32)
    full[:N] = corpus
    valid = np.arange(Pn * block) < N
    check(full, valid, sc, queries, topk, modes, "static")
    check_threshold(full, valid, sc, queries, modes, "static")

    # streamed replace: block 0 gets fewer, fresh vectors
    fresh = rng.normal(size=(block - 3, d)).astype(np.float32)
    sc.replace_block(0, fresh)
    full[:block] = 0.0
    full[:len(fresh)] = fresh
    valid[:block] = np.arange(block) < len(fresh)
    check(full, valid, sc, queries, topk, modes, "replace")
    check_threshold(full, valid, sc, queries, modes, "replace")

    # streamed append into the empty tail block
    if (sc.filled == 0).any():
        extra = rng.normal(size=(block, d)).astype(np.float32)
        b = sc.append_block(extra)
        _require(b == Pn - 1, b, Pn)
        full[b * block:(b + 1) * block] = extra
        valid[b * block:(b + 1) * block] = True
        check(full, valid, sc, queries, topk, modes, "append")

    plan = sc.plan
    where = (f" rank={comm.rank} transport={comm.transport}"
             if isinstance(comm, DistributedComm) else "")
    print(f"serving selfcheck OK: P={Pn} placement={plc.describe()} "
          f"k={plan.k} cover={plan.n_cover}/{Pn} modes={','.join(modes)} "
          f"device={comm.device}{where} topk={topk} "
          f"N_valid={int(valid.sum())}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("P", nargs="?", type=int, default=8)
    ap.add_argument("modes", nargs="?", default=",".join(CHECK_MODES))
    ap.add_argument("placement", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one process per device over torch.distributed "
                         "with this backend (start under torchrun)")
    args = ap.parse_args()
    run_main(main, args.P, tuple(args.modes.split(",")), args.placement,
             device=args.device, dist=args.dist)
