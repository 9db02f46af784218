"""Observability for the port's pair-sweep runtime (``obs.trace``)."""

from .trace import NoopTracer, Tracer, configure, get_tracer, nbytes_of, reset

__all__ = [
    "Tracer",
    "NoopTracer",
    "get_tracer",
    "configure",
    "reset",
    "nbytes_of",
]
