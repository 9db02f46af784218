"""Trace-file reporting: validate and render a ``Tracer`` export
(port of ``repro/obs/report.py``, DESIGN.md section 14.4).

``python -m repro_torch.obs.report trace.json`` loads a Chrome-trace JSON
written by :meth:`obs.trace.Tracer.export` (or any conforming file),
validates its structure, and renders two plain-text tables:

  * **spans** — per span name: count, total / mean / max duration in
    milliseconds (host wall-clock).
  * **counters** — per counter name: per-device values and the total,
    read from the ``repro`` section when present (exact raw totals), else
    reconstructed from ``ph="C"`` samples.

Exit status is 0 for a valid file and 1 for a structurally invalid one,
so a CI job can gate on it.  The module uses the standard library only
(no torch, no numpy): it must run anywhere a trace file lands.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Union

__all__ = [
    "load_trace",
    "validate_chrome_trace",
    "span_summary",
    "counter_summary",
    "render",
]


def load_trace(path: Union[str, Path]) -> Dict[str, Any]:
    """Load and validate a Chrome-trace JSON file; raises ValueError on
    a structurally invalid trace (DESIGN.md section 14.4)."""
    obj = json.loads(Path(path).read_text())
    errors = validate_chrome_trace(obj)
    if errors:
        raise ValueError(
            f"{path}: invalid Chrome trace:\n  " + "\n  ".join(errors))
    return obj


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural checks on a parsed Chrome-trace object; returns a list
    of problems (empty == valid).  Checks the envelope (``traceEvents``
    list), each event's required fields (``name``/``ph``/``ts``; ``dur
    >= 0`` for ``ph="X"``; ``args.value`` for ``ph="C"``), and — when
    the ``repro`` section is present — its version and counter shape
    (DESIGN.md section 14.4)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["top level is not an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is missing or not a list"]
    for n, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {n}: not an object")
            continue
        for fld in ("name", "ph", "ts"):
            if fld not in ev:
                errors.append(f"event {n}: missing {fld!r}")
        ph = ev.get("ph")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {n} ({ev.get('name')!r}): ph=X "
                              f"needs dur >= 0, got {dur!r}")
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or "value" not in args:
                errors.append(f"event {n} ({ev.get('name')!r}): ph=C "
                              f"needs args.value")
    repro = obj.get("repro")
    if repro is not None:
        if not isinstance(repro, dict):
            errors.append("repro section is not an object")
        else:
            if not isinstance(repro.get("version"), int):
                errors.append("repro.version missing or not an int")
            counters = repro.get("counters", {})
            if not isinstance(counters, dict):
                errors.append("repro.counters is not an object")
            else:
                for name, per_dev in counters.items():
                    if not isinstance(per_dev, dict):
                        errors.append(
                            f"repro.counters[{name!r}] is not an object")
    return errors


def span_summary(obj: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Aggregate ``ph="X"`` events per span name: ``{name: {count,
    total_ms, mean_ms, max_ms}}`` sorted by total descending
    (DESIGN.md section 14.4)."""
    acc: Dict[str, List[float]] = {}
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") == "X":
            acc.setdefault(ev["name"], []).append(float(ev.get("dur", 0.0)))
    out = {
        name: {
            "count": float(len(durs)),
            "total_ms": sum(durs) / 1e3,
            "mean_ms": (sum(durs) / len(durs)) / 1e3,
            "max_ms": max(durs) / 1e3,
        }
        for name, durs in acc.items()
    }
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


def counter_summary(obj: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-counter ``{name: {device: value, ..., "total": sum}}``; reads
    the exact ``repro.counters`` section when present, else falls back
    to the last ``ph="C"`` sample per (name, pid) (DESIGN.md section
    14.4)."""
    counters: Dict[str, Dict[str, float]] = {}
    repro = obj.get("repro") or {}
    raw = repro.get("counters")
    if isinstance(raw, dict) and raw:
        for name, per_dev in raw.items():
            counters[name] = {str(d): float(v) for d, v in per_dev.items()}
    else:
        for ev in obj.get("traceEvents", []):
            if ev.get("ph") == "C":
                dev = str(ev.get("pid", 0))
                counters.setdefault(ev["name"], {})[dev] = float(
                    ev.get("args", {}).get("value", 0.0))
    for per_dev in counters.values():
        per_dev["total"] = sum(per_dev.values())
    return dict(sorted(counters.items()))


def _fmt_val(v: float) -> str:
    return f"{v:.0f}" if float(v).is_integer() else f"{v:.3f}"


def render(obj: Dict[str, Any]) -> str:
    """Render a validated trace object into the plain-text span +
    counter tables the CLI prints (DESIGN.md section 14.4)."""
    lines: List[str] = []
    repro = obj.get("repro") or {}
    meta = repro.get("meta") or {}
    n_ev = len(obj.get("traceEvents", []))
    lines.append(f"trace: {n_ev} events"
                 + (f", version {repro['version']}" if "version" in repro
                    else "")
                 + (f", meta={meta}" if meta else ""))

    spans = span_summary(obj)
    if spans:
        lines.append("")
        lines.append(f"{'span':32s} {'count':>7s} {'total_ms':>10s} "
                     f"{'mean_ms':>10s} {'max_ms':>10s}")
        for name, s in spans.items():
            lines.append(f"{name:32s} {int(s['count']):7d} "
                         f"{s['total_ms']:10.3f} {s['mean_ms']:10.3f} "
                         f"{s['max_ms']:10.3f}")
    else:
        lines.append("(no span events)")

    counters = counter_summary(obj)
    if counters:
        lines.append("")
        lines.append(f"{'counter':36s} {'per-device':28s} {'total':>14s}")
        for name, per_dev in counters.items():
            devs = {d: v for d, v in per_dev.items() if d != "total"}
            if set(devs) == {"-1"}:
                dev_str = "(program-wide)"
            else:
                dev_str = " ".join(
                    f"{d}:{_fmt_val(v)}" for d, v in sorted(
                        devs.items(), key=lambda kv: int(kv[0])))
            if len(dev_str) > 28:
                dev_str = dev_str[:25] + "..."
            lines.append(f"{name:36s} {dev_str:28s} "
                         f"{_fmt_val(per_dev['total']):>14s}")
    else:
        lines.append("(no counters)")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.obs.report trace.json`` — validate the
    trace file and print the summary tables; returns nonzero on an
    invalid file (the CI trace-smoke gate; DESIGN.md section 14.4)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="validate + summarize a repro Chrome-trace JSON")
    ap.add_argument("trace", help="path to a Tracer-exported JSON file")
    args = ap.parse_args(argv)
    try:
        obj = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"INVALID: {e}")
        return 1
    print(render(obj))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
