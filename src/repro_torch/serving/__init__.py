"""Online all-pairs query serving over quorum-replicated corpora
(counterpart of ``repro/serving``).

  * ``cover``  — route a query to a ~ceil(P/k)-device set whose quorums
    cover all blocks, with a dedup mask so replicas score once,
  * ``engine`` — the query program: local top-k scoring (the B4 kernel on
    the card) plus a shift tree merge (``ServingCorpus`` is the host
    handle), and the thresholded range query,
  * ``stream`` — streamed corpus updates (replace / append a block) over
    the existing cyclic shifts, no global reshuffle.

The reference's continuous-batching front end (``serving/batching.py``) is
not ported yet (ROADMAP A.12).
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
]
