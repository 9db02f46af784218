"""Online all-pairs query serving over quorum-replicated corpora
(counterpart of ``repro/serving``).

  * ``cover``  — route a query to a ~ceil(P/k)-device set whose quorums
    cover all blocks, with a dedup mask so replicas score once,
  * ``engine`` — the query program: local top-k scoring (the B4 kernel on
    the card) plus a shift tree merge (``ServingCorpus`` is the host
    handle), and the thresholded range query,
  * ``stream`` — streamed corpus updates (replace / append a block) over
    the existing cyclic shifts, no global reshuffle,
  * ``batching`` — the continuous-batching front end: admission queue,
    heterogeneous packing, deadlines, capacity escalation, the async loop
    and p50 / p99 accounting (``BatchScheduler``; the CLI front end is
    ``launch/query_serve.py``).
"""

from .cover import CoverPlan, build_cover
from .engine import ServingCorpus, quorum_query_threshold, quorum_query_topk
from .stream import ServingState, build_state, replace_block

__all__ = [
    "CoverPlan",
    "build_cover",
    "ServingCorpus",
    "quorum_query_topk",
    "quorum_query_threshold",
    "ServingState",
    "build_state",
    "replace_block",
    "AdmissionError",
    "BatchScheduler",
    "Request",
    "RequestResult",
    "latency_summary",
    "percentile",
]

# the front end loads on first use, so ``python -m
# repro_torch.serving.batching`` runs the module once
_BATCHING = ("AdmissionError", "BatchScheduler", "Request", "RequestResult",
             "latency_summary", "percentile")


def __getattr__(name):
    if name in _BATCHING:
        from . import batching
        return getattr(batching, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
