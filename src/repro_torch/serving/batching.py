"""Continuous-batching front end for the online serving tier (counterpart
of ``repro/serving/batching.py``, DESIGN.md section 15).

An iteration-level scheduler (the Orca engine-loop shape) in front of
:class:`serving.engine.ServingCorpus`, for ragged, bursty, mixed traffic:
different ``topk`` per request, range queries with different thresholds
and capacities, both metrics at once, per-request latency budgets.

  * **admission control** — a bounded FIFO request queue;
    :meth:`BatchScheduler.submit` raises :class:`AdmissionError` when the
    queue is full, so overload backpressures at the front door
    (DESIGN.md section 15.1),
  * **dynamic microbatch assembly** — each :meth:`BatchScheduler.step`
    pops up to ``max_batch`` waiting requests and packs them into one
    padded launch per *program key* (DESIGN.md section 15.2): top-k
    requests with heterogeneous ``k`` share a launch at the power-of-two
    bucket of the largest ``k`` (exact by the prefix property of the
    (-score, index) total order), range queries with different
    thresholds share a launch through a per-query threshold vector, and
    capacities sit on the pow2 ladder the escalation doubles along,
  * **deadlines with straggler preemption** — a request past its deadline
    at assembly time is *expired* (sentinel result, zero batch slots); a
    range query that overflows its capacity re-enters the queue head at
    double capacity unless its deadline has passed, in which case its
    truncated buffer returns as a *partial* result (DESIGN.md 15.3),
  * **latency accounting** — per-request submit-to-complete latency feeds
    :func:`latency_summary` (p50 / p99 via :func:`percentile`,
    steady-state qps; DESIGN.md section 15.4).

A launch's outputs reach the host in one device-to-host copy, from which
every request's row is sliced; queries stay where the caller made them
(a device tensor's rows are packed on the device).  ``use_kernel`` routes
the top-k launches through the B4 kernel on the card.  The scheduler is
deterministic given a deterministic clock, and every packed result is
bit-identical to issuing the request alone through ``ServingCorpus.query``
/ ``query_threshold``; the selfcheck at the bottom proves it.

Under ``DistributedComm`` (one process per device) every launch is a
collective, so the ranks must issue the same launches in the same order.
Rank 0 is the one controller: it owns ``submit``, admission, deadlines and
packing, and before each launch (and each streamed block update through
:meth:`BatchScheduler.replace_block`) broadcasts a :class:`LaunchChannel`
descriptor and the packed rows.  Every other rank runs
:func:`follow_launches`, which executes the same launches until rank 0's
:meth:`BatchScheduler.close` sends the stop; results resolve on rank 0.
A follower that is never stopped fails at the process group's timeout.

Run:  PYTHONPATH=src python -m repro_torch.serving.batching [P] [--device cpu]
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import env as env_mod
from ..core.comm import DistributedComm
from ..core.sparse import default_capacity as sparse_default_capacity
from ..core.sweep import ENGINE_MODES
from ..kernels.ref import IDX_SENTINEL, NEG_INF, QUERY_METRICS as METRICS
from ..obs import trace as obs_trace
from .engine import ServingCorpus, quantize_pow2

__all__ = [
    "AdmissionError",
    "Request",
    "RequestResult",
    "BatchScheduler",
    "percentile",
    "latency_summary",
    "to_host",
    "LaunchChannel",
    "follow_launches",
    "main",
]

REQUEST_KINDS = ("topk", "threshold")
#: scheduler defaults, overridable per instance or via the env registry
DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_QUEUE = 1024


class AdmissionError(RuntimeError):
    """Raised by :meth:`BatchScheduler.submit` when the request queue is
    at ``max_queue`` — the admission-control backpressure signal
    (DESIGN.md section 15.1).  Callers shed load or retry later; the
    rejection is counted, never silently dropped."""


@dataclass
class RequestResult:
    """Terminal outcome of one request (DESIGN.md section 15.3).

    status    : ``"done"`` (complete result), ``"partial"`` (range query
                hit its deadline mid-escalation: ``indices``/``scores``
                hold a valid but truncated hit subset, ``count`` is the
                true total), or ``"expired"`` (deadline passed before
                any launch: sentinel payload).
    scores    : [k] (top-k) or [hits] (range) f32 scores.
    indices   : matching global corpus row ids (int32).
    count     : range queries: the true number of passing rows (may
                exceed ``len(indices)`` iff partial); None for top-k.
    latency_s : submit-to-completion wall time under the scheduler's
                clock.
    """

    status: str
    scores: np.ndarray
    indices: np.ndarray
    count: Optional[int]
    latency_s: float

    @property
    def ok(self) -> bool:
        """True iff the request produced its full result set."""
        return self.status == "done"


_RID = itertools.count()


@dataclass
class Request:
    """One admitted serving request (DESIGN.md section 15.1).

    Built by :meth:`BatchScheduler.submit`; host code holds it as a
    future — :meth:`result` blocks until the scheduler completes,
    expires, or partially returns it.  ``deadline_s`` is relative to
    submission; the absolute ``t_deadline`` is stamped under the
    scheduler clock at admission.
    """

    kind: str
    query: torch.Tensor       # [d] f32, where the caller made it
    metric: str = "dot"
    topk: Optional[int] = None
    threshold: Optional[float] = None
    capacity: Optional[int] = None
    deadline_s: Optional[float] = None
    rid: int = field(default_factory=lambda: next(_RID))
    t_submit: float = 0.0
    t_deadline: Optional[float] = None
    escalations: int = 0
    outcome: Optional[RequestResult] = None
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)

    def done(self) -> bool:
        """True once a terminal :class:`RequestResult` is attached."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until the scheduler resolves this request; raises
        ``TimeoutError`` after ``timeout`` seconds (None = wait
        forever).  See DESIGN.md section 15.1."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} unresolved after {timeout}s "
                "(is the scheduler loop running?)")
        assert self.outcome is not None
        return self.outcome


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile over ``values`` (numpy's default
    "linear" method, restated here so the serving metrics are
    stdlib-checkable): with the n sorted samples at ranks 0..n-1, the
    q-th percentile sits at fractional rank ``(n - 1) * q / 100`` and
    interpolates between its neighbors (DESIGN.md section 15.4)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty latency trace")
    pos = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latency_summary(latencies_s: Sequence[float],
                    span_s: Optional[float] = None) -> Dict[str, float]:
    """Tail-latency + throughput summary of a per-request latency trace
    (DESIGN.md section 15.4): ``n``, ``mean_s``, ``p50_s``, ``p99_s``,
    ``max_s``, and — when ``span_s`` (the wall-clock span the requests
    completed over) is given and positive — steady-state ``qps``."""
    xs = [float(v) for v in latencies_s]
    out = {"n": float(len(xs))}
    if xs:
        out.update(mean_s=sum(xs) / len(xs), p50_s=percentile(xs, 50.0),
                   p99_s=percentile(xs, 99.0), max_s=max(xs))
    if span_s is not None and span_s > 0 and xs:
        out["qps"] = len(xs) / span_s
    return out


def to_host(*outs: torch.Tensor) -> List[np.ndarray]:
    """A launch's [Q, ...] outputs as host arrays, in one device-to-host
    copy: their rows side by side as bytes, then split and viewed back
    into each output's dtype and shape."""
    flat = [t.reshape(t.shape[0], -1).contiguous() for t in outs]
    raw = torch.cat([f.view(torch.uint8) for f in flat], dim=1).cpu().numpy()
    host, at = [], 0
    for f, t in zip(flat, outs):
        width = f.shape[1] * f.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        host.append(np.ascontiguousarray(raw[:, at:at + width])
                    .view(dtype).reshape(tuple(t.shape)))
        at += width
    return host


#: the launch descriptor's opcodes (:class:`LaunchChannel`)
OP_STOP, OP_TOPK, OP_THRESHOLD, OP_REPLACE = range(4)
_ENGINE_MODES = ("auto",) + ENGINE_MODES


class LaunchChannel:
    """Rank 0's launches, broadcast to the other ranks of a
    ``DistributedComm`` (``comm.broadcast``).

    Each launch is one int64 descriptor ``[op, rows, d, k, metric, mode,
    kernel]`` (``k`` the top-k bucket's request, the range query's
    capacity or the replaced block id; ``metric`` and ``mode`` as
    indices), then its payload: the packed query rows ``[rows, d]``
    float32, a range query's per-query thresholds ``[rows]``, or a
    replaced block's data.  The stop is a descriptor alone.
    """

    WIDTH = 7

    def __init__(self, comm):
        self.comm = comm

    def _desc(self, *fields) -> None:
        d = torch.zeros(self.WIDTH, dtype=torch.int64)
        d[:len(fields)] = torch.tensor(fields, dtype=torch.int64)
        self.comm.broadcast(d.to(self.comm.device))

    def _rows(self, x: torch.Tensor) -> None:
        self.comm.broadcast(x.to(self.comm.device, torch.float32)
                            .contiguous())

    def topk(self, q, k: int, metric: str, mode: str, kernel: bool) -> None:
        """Announce a top-k launch of rows ``q`` [Q, d]."""
        self._desc(OP_TOPK, q.shape[0], q.shape[1], k,
                   METRICS.index(metric), _ENGINE_MODES.index(mode),
                   int(kernel))
        self._rows(q)

    def threshold(self, q, thr, capacity: int, metric: str,
                  mode: str) -> None:
        """Announce a range-query launch of rows ``q`` with thresholds
        ``thr`` [Q] at ``capacity``."""
        self._desc(OP_THRESHOLD, q.shape[0], q.shape[1], capacity,
                   METRICS.index(metric), _ENGINE_MODES.index(mode))
        self._rows(q)
        self._rows(torch.as_tensor(thr))

    def replace(self, b: int, data) -> None:
        """Announce a streamed replace of block ``b``."""
        data = torch.as_tensor(data, dtype=torch.float32)
        self._desc(OP_REPLACE, data.shape[0], data.shape[1], b)
        self._rows(data)

    def stop(self) -> None:
        """Release the followers."""
        self._desc(OP_STOP)

    def recv(self) -> tuple:
        """A follower's next launch: ``(op, fields, payloads)``."""
        d = self.comm.broadcast(torch.zeros(
            self.WIDTH, dtype=torch.int64, device=self.comm.device)).cpu()
        op, rows, dim = (int(v) for v in d[:3])
        if op == OP_STOP:
            return op, d, ()

        def recv_rows(*shape):
            return self.comm.broadcast(torch.empty(
                shape, dtype=torch.float32, device=self.comm.device))
        if op == OP_THRESHOLD:
            return op, d, (recv_rows(rows, dim), recv_rows(rows))
        return op, d, (recv_rows(rows, dim),)


def follow_launches(corpus: ServingCorpus) -> int:
    """A follower rank's loop under ``DistributedComm``: run every launch
    rank 0's :class:`BatchScheduler` broadcasts, with the same arguments
    on this rank's share of ``corpus``, until the stop.  Returns the
    number of launches run (replaces included).  Rank 0 never calls it."""
    comm = corpus.comm
    if not isinstance(comm, DistributedComm) or comm.rank == 0:
        raise ValueError("follow_launches runs on the ranks other than 0 of "
                         "a DistributedComm")
    channel = LaunchChannel(comm)
    n = 0
    while True:
        op, d, payload = channel.recv()
        if op == OP_STOP:
            return n
        k, metric, mode = int(d[3]), METRICS[int(d[4])], \
            _ENGINE_MODES[int(d[5])]
        if op == OP_TOPK:
            corpus.query(payload[0], topk=k, mode=mode, metric=metric,
                         use_kernel=bool(d[6]))
        elif op == OP_THRESHOLD:
            corpus.query_threshold(payload[0],
                                   threshold=payload[1].cpu().numpy(),
                                   capacity=k, mode=mode, metric=metric,
                                   escalate=False)
        elif op == OP_REPLACE:
            corpus.replace_block(k, payload[0])
        else:
            raise RuntimeError(f"unknown launch descriptor {d.tolist()}")
        n += 1


class BatchScheduler:
    """Iteration-level continuous batcher over a :class:`ServingCorpus`
    (DESIGN.md section 15).

    One :meth:`step` = one scheduler iteration: pop up to ``max_batch``
    admitted requests (expiring the dead ones), group them by program
    key — ``(kind, metric)`` picks the compiled program family, the
    pow2 parameter buckets pick the member — and run one padded launch
    per group.  Drive it synchronously (:meth:`step` / :meth:`drain`,
    the deterministic path tests and benchmarks use) or spin the
    background loop (:meth:`start` / :meth:`stop`) and treat
    :meth:`submit` as the async front door.

    ``pad_queries_to`` pins every launch's query width (the legacy
    fixed-microbatch shape ``launch/query_serve.py`` keeps for its
    drain contract); None (default) pads to the pow2 bucket of the
    group size.  ``max_batch``/``max_queue`` default from the
    ``REPRO_SERVE_MAX_BATCH`` / ``REPRO_SERVE_QUEUE_DEPTH`` env knobs.
    ``clock`` is injectable for deterministic deadline tests.

    Under ``DistributedComm`` the scheduler lives on rank 0 only: it
    broadcasts each launch (:class:`LaunchChannel`) before running it,
    the other ranks run :func:`follow_launches`, and :meth:`close` stops
    them.
    """

    def __init__(self, corpus: ServingCorpus, *,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 mode: str = "auto", use_kernel: bool = False,
                 pad_queries_to: Optional[int] = None,
                 max_escalations: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        self.corpus = corpus
        env_batch = env_mod.read_knob("REPRO_SERVE_MAX_BATCH")
        env_queue = env_mod.read_knob("REPRO_SERVE_QUEUE_DEPTH")
        self.max_batch = int(max_batch if max_batch is not None
                             else (env_batch or DEFAULT_MAX_BATCH))
        self.max_queue = int(max_queue if max_queue is not None
                             else (env_queue or DEFAULT_MAX_QUEUE))
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError(
                f"max_batch/max_queue must be >= 1, got "
                f"{self.max_batch}/{self.max_queue}")
        if pad_queries_to is not None and pad_queries_to < self.max_batch:
            raise ValueError(
                f"pad_queries_to={pad_queries_to} is narrower than "
                f"max_batch={self.max_batch}; launches could not hold a "
                "full batch")
        self.mode = mode
        self.use_kernel = use_kernel
        comm = getattr(corpus, "comm", None)   # stand-ins may have none
        self._channel = None
        if isinstance(comm, DistributedComm):
            if comm.rank != 0:
                raise ValueError(
                    f"rank {comm.rank} follows rank 0's launches: run "
                    "follow_launches(corpus) there, not a BatchScheduler")
            self._channel = LaunchChannel(comm)
        self.pad_queries_to = pad_queries_to
        self.max_escalations = max_escalations
        self._clock = clock
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.counters: Counter = Counter()
        self.program_keys: set = set()
        self.latencies_s: List[float] = []
        self._t_first_done: Optional[float] = None
        self._t_last_done: Optional[float] = None
        total = corpus.P * corpus.block
        self._default_capacity = min(sparse_default_capacity(total), total)

    # ------------------------------------------------------------- front door

    def submit(self, query, *, kind: str = "topk", topk: Optional[int] = None,
               threshold: Optional[float] = None,
               capacity: Optional[int] = None, metric: str = "dot",
               deadline_s: Optional[float] = None) -> Request:
        """Admit one request (DESIGN.md section 15.1) and return its
        :class:`Request` future.

        ``kind="topk"`` needs ``topk``; ``kind="threshold"`` needs
        ``threshold`` (``capacity`` optional — the escalation ladder
        starts from the sparse-engine default).  ``deadline_s`` is a
        relative latency budget; past it the request expires or returns
        partial (DESIGN.md section 15.3).  Raises
        :class:`AdmissionError` when the queue is at ``max_queue``.
        """
        if kind not in REQUEST_KINDS:
            raise ValueError(
                f"kind must be one of {REQUEST_KINDS}, got {kind!r}")
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, "
                             f"got {metric!r}")
        q = torch.as_tensor(query, dtype=torch.float32).reshape(-1)
        if q.shape[0] != self.corpus.d:
            raise ValueError(f"query must have {self.corpus.d} features, "
                             f"got shape {np.shape(query)}")
        if kind == "topk":
            if topk is None or topk < 1:
                raise ValueError(f"top-k request needs topk >= 1, "
                                 f"got {topk}")
        else:
            if threshold is None:
                raise ValueError("threshold request needs a threshold")
            if capacity is not None and capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
        now = self._clock()
        req = Request(kind=kind, query=q, metric=metric, topk=topk,
                      threshold=(None if threshold is None
                                 else float(threshold)),
                      capacity=capacity, deadline_s=deadline_s,
                      t_submit=now,
                      t_deadline=(None if deadline_s is None
                                  else now + float(deadline_s)))
        with self._lock:
            if len(self._queue) >= self.max_queue:
                self.counters["rejected"] += 1
                tr = obs_trace.get_tracer()
                if tr:
                    tr.count("serving.sched.rejected")
                raise AdmissionError(
                    f"request queue full ({self.max_queue} waiting); "
                    "shed load or raise REPRO_SERVE_QUEUE_DEPTH")
            self._queue.append(req)
            self.counters["admitted"] += 1
            self._wakeup.notify()
        tr = obs_trace.get_tracer()
        if tr:
            tr.count("serving.sched.admitted")
        return req

    @property
    def queue_depth(self) -> int:
        """Number of admitted requests waiting for a batch slot."""
        with self._lock:
            return len(self._queue)

    # ----------------------------------------------------------- batch engine

    def _q_width(self, n: int) -> int:
        """Launch query width for an ``n``-request group: the fixed
        ``pad_queries_to`` shape when pinned, else the pow2 bucket —
        either way a program-cache-friendly small set (DESIGN.md
        section 15.2)."""
        if self.pad_queries_to is not None:
            return self.pad_queries_to
        return quantize_pow2(n)

    def _resolve(self, req: Request, res: RequestResult, now: float) -> None:
        """Attach the terminal result, record latency + counters."""
        req.outcome = res
        self.counters[res.status] += 1
        self.latencies_s.append(res.latency_s)
        if self._t_first_done is None:
            self._t_first_done = now
        self._t_last_done = now
        tr = obs_trace.get_tracer()
        if tr:
            tr.count(f"serving.sched.{res.status}")
            tr.record("serving.request", dur_s=res.latency_s,
                      kind=req.kind, metric=req.metric, status=res.status,
                      rid=req.rid)
        req._event.set()

    def _expire(self, req: Request, now: float) -> None:
        """Deadline passed before any launch: sentinel payload, counted,
        zero batch slots (DESIGN.md section 15.3)."""
        k = req.topk or 0
        res = RequestResult(
            status="expired",
            scores=np.full((k,), NEG_INF, np.float32),
            indices=np.full((k,), IDX_SENTINEL, np.int32),
            count=None, latency_s=now - req.t_submit)
        self._resolve(req, res, now)

    def step(self) -> int:
        """Run one scheduler iteration (DESIGN.md section 15.2): expire
        dead requests, assemble up to ``max_batch`` live ones, one
        padded launch per (kind, metric) group, resolve or re-enqueue
        (capacity escalation) every popped request.  Returns the number
        of requests resolved this iteration."""
        now = self._clock()
        batch: List[Request] = []
        expired: List[Request] = []
        with self._lock:
            while self._queue and len(batch) < self.max_batch:
                req = self._queue.popleft()
                if req.t_deadline is not None and now > req.t_deadline:
                    expired.append(req)
                else:
                    batch.append(req)
            depth = len(self._queue)
        for req in expired:
            self._expire(req, now)
        if not batch:
            return len(expired)
        resolved = len(expired)
        self.counters["steps"] += 1
        self.counters["packed_requests"] += len(batch)
        groups: Dict[Tuple[str, str], List[Request]] = {}
        for req in batch:
            groups.setdefault((req.kind, req.metric), []).append(req)
        tr = obs_trace.get_tracer()
        span = tr.span("serving.sched.step", batch=len(batch),
                       groups=len(groups), queue_depth=depth) if tr \
            else obs_trace.NOOP.span("")
        with span:
            for (kind, metric), reqs in groups.items():
                self.counters["launches"] += 1
                if tr:
                    tr.count("serving.sched.launches")
                if kind == "topk":
                    resolved += self._launch_topk(reqs, metric)
                else:
                    resolved += self._launch_threshold(reqs, metric)
        return resolved

    def _pack_queries(self, reqs: List[Request]) -> torch.Tensor:
        """[Q_width, d] launch payload: the group's queries stacked where
        they live (one copy to the corpus's device), zero-padded."""
        q = torch.stack([r.query for r in reqs])
        q = q.to(self.corpus.comm.device)
        pad = self._q_width(len(reqs)) - len(reqs)
        return torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q

    def _launch_topk(self, reqs: List[Request], metric: str) -> int:
        """One padded top-k launch at the pow2 bucket of the largest
        requested k; per-request rows sliced back to their own k —
        exact by the total-order prefix property (DESIGN.md 15.2)."""
        kmax = max(r.topk for r in reqs)
        self.program_keys.add(
            ("topk", metric, self.mode, quantize_pow2(kmax),
             self.use_kernel))
        q = self._pack_queries(reqs)
        if self._channel is not None:
            self._channel.topk(q, kmax, metric, self.mode, self.use_kernel)
        vals, idx = to_host(*self.corpus.query(
            q, topk=kmax, mode=self.mode, metric=metric,
            use_kernel=self.use_kernel))
        now = self._clock()
        for i, r in enumerate(reqs):
            self._resolve(r, RequestResult(
                status="done", scores=vals[i, :r.topk].copy(),
                indices=idx[i, :r.topk].copy(), count=None,
                latency_s=now - r.t_submit), now)
        return len(reqs)

    def _launch_threshold(self, reqs: List[Request], metric: str) -> int:
        """One padded range-query launch: per-query threshold vector
        (padding rows get +inf, matching nothing), capacity = the
        group max on the pow2 ladder.  Overflowing requests re-enter
        the queue head at double capacity unless their deadline passed,
        in which case the truncated buffer returns as a partial result
        (DESIGN.md sections 15.2, 15.3)."""
        cap_req = max(r.capacity or self._default_capacity for r in reqs)
        q = self._pack_queries(reqs)
        thr = np.full((q.shape[0],), np.inf, np.float32)
        for i, r in enumerate(reqs):
            thr[i] = r.threshold
        if self._channel is not None:
            self._channel.threshold(q, thr, cap_req, metric, self.mode)
        vals, idx, cnt = to_host(*self.corpus.query_threshold(
            q, threshold=thr, capacity=cap_req, mode=self.mode,
            metric=metric, escalate=False))
        cap_used = vals.shape[1]
        self.program_keys.add(("threshold", metric, self.mode, cap_used))
        now = self._clock()
        total = self.corpus.P * self.corpus.block
        resolved = 0
        requeue: List[Request] = []
        tr = obs_trace.get_tracer()
        for i, r in enumerate(reqs):
            n = int(cnt[i])
            if n <= cap_used:
                self._resolve(r, RequestResult(
                    status="done", scores=vals[i, :n].copy(),
                    indices=idx[i, :n].copy(), count=n,
                    latency_s=now - r.t_submit), now)
                resolved += 1
                continue
            # overflow: escalate along the pow2 ladder, deadline allowing
            out_of_time = (r.t_deadline is not None and now > r.t_deadline)
            if (not out_of_time and cap_used < total
                    and r.escalations < self.max_escalations):
                r.escalations += 1
                r.capacity = min(2 * cap_used, total)
                self.counters["escalations"] += 1
                if tr:
                    tr.count("serving.sched.escalations")
                requeue.append(r)
                continue
            self._resolve(r, RequestResult(
                status="partial", scores=vals[i].copy(),
                indices=idx[i].copy(), count=n,
                latency_s=now - r.t_submit), now)
            resolved += 1
        if requeue:
            with self._lock:
                self._queue.extendleft(reversed(requeue))
        return resolved

    def replace_block(self, b: int, data) -> None:
        """Stream a block replace into the corpus between launches (on
        every rank: broadcast to the followers first)."""
        if self._channel is not None:
            self._channel.replace(b, data)
        self.corpus.replace_block(b, data)

    def close(self) -> None:
        """Release the follower ranks (``DistributedComm``); a no-op in
        one process."""
        if self._channel is not None:
            self._channel.stop()
            self._channel = None

    # -------------------------------------------------------------- lifecycle

    def drain(self, max_steps: int = 10_000) -> int:
        """Step until the queue is empty (synchronous callers); returns
        requests resolved.  ``max_steps`` guards against a pathological
        escalation livelock (DESIGN.md section 15.3)."""
        resolved = 0
        for _ in range(max_steps):
            if not self.queue_depth:
                return resolved
            resolved += self.step()
        raise RuntimeError(f"queue not drained after {max_steps} steps")

    def start(self) -> None:
        """Spin the background engine loop: steps whenever requests are
        waiting, sleeps on the queue condition otherwise (DESIGN.md
        section 15.1)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopping = False

        def loop():
            while True:
                with self._lock:
                    while not self._queue and not self._stopping:
                        self._wakeup.wait(timeout=0.05)
                    if self._stopping and not self._queue:
                        return
                self.step()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="repro-batch-scheduler")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the background loop after the queue drains."""
        if self._thread is None:
            return
        with self._lock:
            self._stopping = True
            self._wakeup.notify_all()
        self._thread.join(timeout)
        self._thread = None

    def stats(self) -> Dict[str, float]:
        """Counter snapshot + latency/throughput summary (DESIGN.md
        section 15.4): admitted/rejected/expired/partial/done totals,
        launches, escalations, distinct compiled program keys, and the
        :func:`latency_summary` of every resolved request."""
        span = None
        if (self._t_first_done is not None
                and self._t_last_done is not None
                and len(self.latencies_s) > 1):
            span = self._t_last_done - self._t_first_done
        out: Dict[str, float] = dict(self.counters)
        out["programs"] = float(len(self.program_keys))
        out.update(latency_summary(self.latencies_s, span))
        return out


# ---------------------------------------------------------------- selfcheck

def _oracle_topk(sc: ServingCorpus, req: Request):
    """The solo per-request oracle: the same request issued alone
    through ``ServingCorpus.query`` (DESIGN.md section 15.5)."""
    v, i = sc.query(req.query[None], topk=req.topk, metric=req.metric)
    return v[0].cpu().numpy(), i[0].cpu().numpy()


def _oracle_threshold(sc: ServingCorpus, req: Request):
    """The solo range-query oracle: issued alone with full escalation
    through ``ServingCorpus.query_threshold`` (DESIGN.md 15.5)."""
    v, i, c = sc.query_threshold(req.query[None], threshold=req.threshold,
                                 metric=req.metric)
    n = int(c[0])
    return v[0, :n].cpu().numpy(), i[0, :n].cpu().numpy(), n


def _check_heterogeneous_pack(sc: ServingCorpus, rng) -> dict:
    """Packed heterogeneous batch == per-request oracles, bit-exact
    (DESIGN.md section 15.5): mixed k, mixed thresholds/capacities,
    both metrics, one drain."""
    sched = BatchScheduler(sc, max_batch=64)
    d = sc.d
    reqs: List[Request] = []
    # thresholds near the upper score range so counts are small but
    # nonzero; capacity=1 on some forces the escalation ladder
    for metric in METRICS:
        for k in (1, 3, 5, 8):
            reqs.append(sched.submit(rng.normal(size=(d,)), kind="topk",
                                     topk=k, metric=metric))
        for thr, cap in ((2.0, None), (4.0, 1), (-1e9, 2)):
            reqs.append(sched.submit(
                rng.normal(size=(d,)), kind="threshold", threshold=thr,
                capacity=cap, metric=metric))
    n_res = sched.drain()
    assert n_res == len(reqs), (n_res, len(reqs))
    for req in reqs:
        res = req.result(timeout=0)
        assert res.ok, (req.rid, res.status)
        if req.kind == "topk":
            ov, oi = _oracle_topk(sc, req)
            np.testing.assert_array_equal(res.indices, oi)
            assert np.array_equal(res.scores, ov), (req.rid, "scores")
        else:
            ov, oi, on = _oracle_threshold(sc, req)
            assert res.count == on, (req.rid, res.count, on)
            np.testing.assert_array_equal(res.indices, oi)
            assert np.array_equal(res.scores, ov), (req.rid, "scores")
    st = sched.stats()
    # program-key taxonomy: the mixed batch stays on a handful of
    # compiled programs (pow2 buckets), escalation included
    assert st["programs"] <= 12, st
    assert all(isinstance(key[3], int) and key[3] & (key[3] - 1) == 0
               or key[3] == sc.P * sc.block
               for key in sched.program_keys), sched.program_keys
    return st


def _check_escalation(sc: ServingCorpus, rng) -> int:
    """Capacity escalation walks the pow2 program-key ladder (every
    relaunch doubles onto the next bucket, never a fresh raw-capacity
    key) and converges to the oracle hit set (DESIGN.md sections 15.2,
    15.3)."""
    sched = BatchScheduler(sc, max_batch=8)
    reqs = [sched.submit(rng.normal(size=(sc.d,)), kind="threshold",
                         threshold=-1e9, capacity=1) for _ in range(2)]
    sched.drain()
    assert sched.counters["escalations"] > 0, sched.counters
    for req in reqs:
        res = req.result(0)
        assert res.ok and res.count == sc.n_valid, (res.status, res.count)
        ov, oi, _n = _oracle_threshold(sc, req)
        np.testing.assert_array_equal(res.indices, oi)
        assert np.array_equal(res.scores, ov)
    total = sc.P * sc.block
    caps = sorted(key[3] for key in sched.program_keys)
    assert all(c == total or (c & (c - 1)) == 0 for c in caps), caps
    return int(sched.counters["escalations"])


def _check_deadlines(sc: ServingCorpus, rng) -> None:
    """Deadline semantics under a manual clock (DESIGN.md 15.3): expiry
    before launch -> sentinel; overflow past deadline -> partial; live
    requests in the same batch are unaffected."""
    t = [0.0]
    sched = BatchScheduler(sc, max_batch=8, clock=lambda: t[0])
    d = sc.d
    live = sched.submit(rng.normal(size=(d,)), kind="topk", topk=4)
    dead = sched.submit(rng.normal(size=(d,)), kind="topk", topk=4,
                        deadline_s=1.0)
    t[0] = 2.0                                    # dead expires unlaunched
    sched.drain()
    res_live, res_dead = live.result(0), dead.result(0)
    assert res_live.ok and not (res_live.indices == IDX_SENTINEL).any()
    assert res_dead.status == "expired"
    assert (res_dead.indices == IDX_SENTINEL).all()
    assert (res_dead.scores == NEG_INF).all()
    ov, oi = _oracle_topk(sc, live)
    np.testing.assert_array_equal(res_live.indices, oi)

    # a range query that still overflows when its budget runs out
    # returns the truncated buffer as partial (true count preserved).
    # The stepping clock advances 0.4s per read: submitted at 0.4
    # (deadline 0.9), popped alive at 0.8, launch resolves at 1.2 —
    # past deadline exactly when the overflow wants to escalate.
    t2 = [0.0]

    def stepping_clock():
        t2[0] += 0.4
        return t2[0]

    sched2 = BatchScheduler(sc, max_batch=8, clock=stepping_clock)
    part = sched2.submit(rng.normal(size=(d,)), kind="threshold",
                         threshold=-1e9, capacity=1, deadline_s=0.5)
    sched2.step()
    res = part.result(0)
    assert res.status == "partial", res.status
    assert res.count == sc.n_valid, (res.count, sc.n_valid)
    assert len(res.indices) < res.count
    _, oi, _ = _oracle_threshold(sc, part)
    np.testing.assert_array_equal(res.indices, oi[:len(res.indices)])


def _check_admission(sc: ServingCorpus, rng) -> None:
    """Backpressure: the (max_queue + 1)-th waiting request is rejected
    with :class:`AdmissionError`; draining reopens admission
    (DESIGN.md section 15.1)."""
    sched = BatchScheduler(sc, max_batch=4, max_queue=3)
    d = sc.d
    for _ in range(3):
        sched.submit(rng.normal(size=(d,)), kind="topk", topk=2)
    try:
        sched.submit(rng.normal(size=(d,)), kind="topk", topk=2)
    except AdmissionError:
        pass
    else:
        raise AssertionError("no AdmissionError at max_queue")
    assert sched.counters["rejected"] == 1
    sched.drain()
    sched.submit(rng.normal(size=(d,)), kind="topk", topk=2)   # reopened
    sched.drain()


def _check_async_loop(sc: ServingCorpus, rng) -> None:
    """The background engine loop resolves requests submitted from the
    host thread (DESIGN.md section 15.1)."""
    sched = BatchScheduler(sc, max_batch=8)
    sched.start()
    try:
        reqs = [sched.submit(rng.normal(size=(sc.d,)), kind="topk", topk=3)
                for _ in range(10)]
        results = [r.result(timeout=120) for r in reqs]
        assert all(r.ok for r in results)
        for req, res in zip(reqs, results):
            _, oi = _oracle_topk(sc, req)
            np.testing.assert_array_equal(res.indices, oi)
    finally:
        sched.stop()


def main(nblocks: int = 8, device=None) -> None:
    """Scheduler selfcheck (DESIGN.md section 15.5), on the CUDA device
    unless ``device`` says otherwise: heterogeneous packed batches
    bit-exact against the per-request oracles, deadline expiry / partial
    semantics, admission backpressure, and the async loop."""
    from ..core.comm import SingleProcessComm, resolve_device
    P = nblocks
    comm = SingleProcessComm(P, resolve_device(device))
    block, d = 16, 24
    rng = np.random.default_rng(0)
    N = P * block - block // 2          # ragged tail: validity masking on
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    sc = ServingCorpus.build(corpus, comm, block=block)

    st = _check_heterogeneous_pack(sc, rng)
    n_esc = _check_escalation(sc, rng)
    _check_deadlines(sc, rng)
    _check_admission(sc, rng)
    _check_async_loop(sc, rng)
    print(f"batching selfcheck OK: P={P} N={N} "
          f"requests={int(st['admitted'])} launches={int(st['launches'])} "
          f"escalations={n_esc} "
          f"programs={int(st['programs'])} p50={st['p50_s']:.4f}s "
          f"p99={st['p99_s']:.4f}s")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="continuous-batching selfcheck")
    ap.add_argument("P", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    main(args.P, device=args.device)
