"""Observability for the port's pair-sweep runtime (DESIGN.md section 14).

  * ``obs.trace``    — the :class:`Tracer`: spans, counters, Chrome-trace
    export, the ``REPRO_TRACE`` / ``REPRO_METRICS`` knobs.
  * ``obs.comm``     — the analytical comm-volume predictor and its
    check against the traced counters (``python -m repro_torch.obs.comm``).
  * ``obs.report``   — ``python -m repro_torch.obs.report trace.json``:
    validate a trace file and render its span and counter tables.
  * ``obs.feedback`` — per-device throughput from sweep metrics, fed back
    as ownership weights (``python -m repro_torch.obs.feedback``).

Only ``obs.trace`` is imported here: ``obs.feedback`` imports
``core.faults`` (which itself imports ``obs.trace``), so the package root
must stay cycle-free.
"""

from .trace import NoopTracer, Tracer, configure, get_tracer, nbytes_of, reset

__all__ = [
    "Tracer",
    "NoopTracer",
    "get_tracer",
    "configure",
    "reset",
    "nbytes_of",
]
