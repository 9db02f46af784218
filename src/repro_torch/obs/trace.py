"""Structured tracing + metrics for the sweep runtime (DESIGN.md
section 14).

One :class:`Tracer` collects two kinds of records:

  * **spans** — named, nested wall-clock intervals with attributes
    (mode, placement, P, round id, ...).  Two families by *when* the
    code runs: trace-time spans (inside a jit trace — they measure the
    Python tracing of a program, and their counters are exact because
    collective shapes are static) and host-side runtime spans (the
    fault-tolerant driver's rounds, serving per-query latency).
  * **counters** — a monotonic value per (name, device) key; the
    comm-volume counters (``comm.ppermute.*``, ``comm.allgather.*``)
    record **bytes per device** (the SPMD programs are symmetric), the
    driver counters record cluster totals.  The taxonomy is DESIGN.md
    section 14.2.

Activation (read through the ``core.env`` registry at call time, cached
on the raw environment values):

  * ``REPRO_TRACE=0`` / unset — off: :func:`get_tracer` returns the
    falsy :data:`NOOP` singleton and instrumented call sites early-out
    (zero-cost: no span objects, no attribute dicts).
  * ``REPRO_TRACE=1`` — on; the Chrome-trace JSON is written to
    ``repro_trace.json`` in the working directory at process exit.
  * ``REPRO_TRACE=<path>`` — on; written to ``<path>`` at exit.
  * ``REPRO_METRICS=<n>=1`` — counters only: no span events, no file
    unless exported explicitly.

The exported file is Chrome-trace format (``{"traceEvents": [...]}``
with ``ph="X"`` complete events and ``ph="C"`` counter samples —
loadable in Perfetto / chrome://tracing) plus a ``repro`` section
carrying the raw counter totals for exact predictor comparison
(``obs.comm``).

A copy of ``repro/obs/trace.py`` for the PyTorch port.  Two changes:
:func:`nbytes_of` counts ``numel() * element_size()`` of a tensor, and the
optional profiler hook wraps each span in
``torch.profiler.record_function`` instead of a ``jax.profiler``
annotation.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import env as env_mod

__all__ = [
    "Tracer",
    "NoopTracer",
    "NOOP",
    "get_tracer",
    "configure",
    "reset",
    "nbytes_of",
    "DEFAULT_TRACE_PATH",
    "TRACE_FORMAT_VERSION",
]

DEFAULT_TRACE_PATH = "repro_trace.json"
TRACE_FORMAT_VERSION = 1


def nbytes_of(x: Any) -> int:
    """Byte size of a tensor (or a numpy array-like)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * int(np.dtype(x.dtype).itemsize)


class _NoopSpan:
    """The shared do-nothing context manager disabled span sites get."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The disabled tracer: falsy, so instrumented sites guard with
    ``tr = get_tracer(); if tr: ...`` and pay nothing when tracing is
    off (DESIGN.md section 14.1)."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **attrs) -> _NoopSpan:
        """No-op span: returns the shared singleton context manager."""
        return _NOOP_SPAN

    def record(self, name: str, dur_s: float = 0.0, **attrs) -> None:
        """No-op completed-span record."""

    def count(self, name: str, value: Union[int, float] = 1, *,
              device: int = -1) -> None:
        """No-op counter increment."""


NOOP = NoopTracer()


class _Span:
    """One live span interval (context manager); appended to the owning
    tracer's event list on exit.  ``attrs`` is stored by reference, so
    code inside the ``with`` block may add result attributes."""

    __slots__ = ("tracer", "name", "device", "attrs", "start", "depth",
                 "_ann")

    def __init__(self, tracer: "Tracer", name: str, device: int,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.device = device
        self.attrs = attrs
        self._ann = None

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.depth = len(tr._stack)
        if tr._stack:
            self.attrs.setdefault("parent", tr._stack[-1])
        tr._stack.append(self.name)
        if tr.profiler:  # optional torch.profiler annotation hook
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.start = tr._now_us()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        end = tr._now_us()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._stack.pop()
        attrs = dict(self.attrs)
        attrs["depth"] = self.depth
        tr.events.append({
            "name": self.name, "ph": "X", "ts": self.start,
            "dur": max(0.0, end - self.start),
            "pid": self.device if self.device >= 0 else 0,
            "tid": 0, "cat": "repro", "args": attrs,
        })
        return False


class Tracer:
    """The enabled tracer: span + counter collection and Chrome-trace
    export (DESIGN.md section 14.1).

    ``path`` is where :meth:`export` writes by default (the env-driven
    tracer flushes there at process exit).  ``metrics_only`` drops span
    events (the ``REPRO_METRICS`` mode).  ``profiler`` additionally
    wraps every span in ``torch.profiler.record_function`` so spans
    land in a PyTorch profile too.
    """

    enabled = True

    def __init__(self, path: Optional[Union[str, Path]] = None,
                 metrics_only: bool = False, profiler: bool = False):
        self.path = Path(path) if path is not None else None
        self.metrics_only = metrics_only
        self.profiler = profiler
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[Tuple[str, int], float] = {}
        self.meta: Dict[str, Any] = {}
        self._stack: List[str] = []
        self._t0 = time.perf_counter()

    def __bool__(self) -> bool:
        return True

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- recording --------------------------------------------------------
    def span(self, name: str, *, device: int = -1, **attrs):
        """Open a nested span context manager (``with tr.span(...):``).

        ``device`` tags the span's pid lane (-1 = host / all devices);
        remaining keyword arguments become span attributes.  In
        ``metrics_only`` mode spans are skipped entirely."""
        if self.metrics_only:
            return _NOOP_SPAN
        return _Span(self, name, device, dict(attrs))

    def record(self, name: str, dur_s: float = 0.0, *, device: int = -1,
               **attrs) -> None:
        """Append an already-timed span of ``dur_s`` seconds ending now
        (for call sites that measured themselves)."""
        if self.metrics_only:
            return
        attrs = dict(attrs)
        attrs["depth"] = len(self._stack)
        end = self._now_us()
        self.events.append({
            "name": name, "ph": "X",
            "ts": max(0.0, end - dur_s * 1e6), "dur": dur_s * 1e6,
            "pid": device if device >= 0 else 0, "tid": 0,
            "cat": "repro", "args": attrs,
        })

    def count(self, name: str, value: Union[int, float] = 1, *,
              device: int = -1) -> None:
        """Add ``value`` to counter ``name`` for ``device`` (-1 = the
        per-device SPMD value / cluster scope, per the DESIGN.md 14.2
        taxonomy)."""
        key = (name, int(device))
        self.counters[key] = self.counters.get(key, 0) + value

    # -- reading ----------------------------------------------------------
    def counter_total(self, name: str) -> float:
        """Sum of ``name`` across all device keys."""
        return sum(v for (n, _d), v in self.counters.items() if n == name)

    def counters_by_device(self, name: str) -> Dict[int, float]:
        """``{device: value}`` for counter ``name``."""
        return {d: v for (n, d), v in self.counters.items() if n == name}

    def counter_names(self) -> List[str]:
        """Sorted distinct counter names."""
        return sorted({n for (n, _d) in self.counters})

    # -- export -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The collected data as a Chrome-trace dict: span events plus
        one ``ph="C"`` counter sample per (name, device), and the raw
        totals under the ``repro`` key for exact comparison."""
        now = self._now_us()
        events = list(self.events)
        for (name, dev), val in sorted(self.counters.items()):
            events.append({
                "name": name, "ph": "C", "ts": now,
                "pid": dev if dev >= 0 else 0, "cat": "repro",
                "args": {"value": val},
            })
        counters: Dict[str, Dict[str, float]] = {}
        for (name, dev), val in sorted(self.counters.items()):
            counters.setdefault(name, {})[str(dev)] = val
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "repro": {
                "version": TRACE_FORMAT_VERSION,
                "clock": "relative-us",
                "counters": counters,
                "meta": dict(self.meta),
            },
        }

    def export(self, path: Optional[Union[str, Path]] = None) -> Path:
        """Write the Chrome-trace JSON to ``path`` (default: the
        tracer's configured path) and return the written path."""
        out = Path(path) if path is not None else self.path
        if out is None:
            raise ValueError("no export path: pass one or construct the "
                             "Tracer with path=...")
        out.write_text(json.dumps(self.chrome_trace(), indent=1) + "\n")
        return out


# ---------------------------------------------------------------------------
# Activation: env knobs + programmatic override
# ---------------------------------------------------------------------------

_forced: Optional[Tracer] = None
_env_key: Optional[Tuple[str, str]] = None
_env_tracer: Union[Tracer, NoopTracer] = NOOP
_atexit_registered = False


def _flush_env_tracer() -> None:
    t = _env_tracer
    if isinstance(t, Tracer) and t.path is not None and (
            t.events or t.counters):
        t.export()


def _build_env_tracer() -> Union[Tracer, NoopTracer]:
    global _atexit_registered
    trace = env_mod.read_knob("REPRO_TRACE")
    metrics = env_mod.read_knob("REPRO_METRICS")
    if trace in (None, "0"):
        if not metrics:
            return NOOP
        return Tracer(metrics_only=True)
    path = DEFAULT_TRACE_PATH if trace == "1" else trace
    if not _atexit_registered:
        atexit.register(_flush_env_tracer)
        _atexit_registered = True
    return Tracer(path=path)


def get_tracer() -> Union[Tracer, NoopTracer]:
    """The active tracer (DESIGN.md section 14.1): a :func:`configure`d
    one if set, else the ``REPRO_TRACE`` / ``REPRO_METRICS`` selection
    (cached on the raw environment values, so the disabled fast path is
    two environment reads and a tuple compare).  Falsy when disabled —
    instrumented sites guard with ``if tr:``."""
    if _forced is not None:
        return _forced
    global _env_key, _env_tracer
    key = (os.environ.get("REPRO_TRACE") or "",
           os.environ.get("REPRO_METRICS") or "")
    if key != _env_key:
        _env_tracer = _build_env_tracer()
        _env_key = key
    return _env_tracer


def configure(path: Optional[Union[str, Path]] = None,
              metrics_only: bool = False,
              profiler: bool = False) -> Tracer:
    """Programmatically activate a fresh :class:`Tracer` (overriding the
    environment selection) and return it — the test / selfcheck entry
    point (DESIGN.md section 14.1).  Pair with :func:`reset`."""
    global _forced
    _forced = Tracer(path=path, metrics_only=metrics_only,
                     profiler=profiler)
    return _forced


def reset() -> None:
    """Drop any :func:`configure`d tracer and the environment cache, so
    the next :func:`get_tracer` re-reads ``REPRO_TRACE`` /
    ``REPRO_METRICS`` (DESIGN.md section 14.1)."""
    global _forced, _env_key, _env_tracer
    _forced = None
    _env_key = None
    _env_tracer = NOOP
