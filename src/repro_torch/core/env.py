"""The single registry of ``REPRO_*`` environment knobs (DESIGN.md
section 12.4).

Every runtime override the repo honors is declared here — name, type,
valid values, and the one-line description the README env-var table
mirrors.  The readers that used to be scattered across the engines
(``core.sweep.env_mode_override`` / ``auto_batch_bytes``,
``core.placement.placement_from_env``, ``core.sparse.default_capacity``)
all route through :func:`read_knob`, so validation, error wording, and
typo detection live in exactly one place.

Contract shared by every knob:

  * read at **selection time** (each heuristic consult / placement
    resolution), never at import — setting a variable after ``import
    repro`` works; already-compiled programs keep their baked-in choice;
  * an unset or empty variable means "no override" (``read_knob``
    returns None and the caller's default applies);
  * an invalid value **raises** ``ValueError`` — never a silent
    fallthrough to the default;
  * an environment variable starting with ``REPRO_`` that matches no
    registered knob triggers a one-time ``RuntimeWarning`` naming the
    closest registered knob (typo detection — ``REPRO_ALLPAIRS_MODES=``
    silently doing nothing is the failure mode this kills).

A copy of ``repro/core/env.py`` for the PyTorch port, which must import
nothing of the JAX package; keep the two in step (the port's tests
hold them equal).
"""

from __future__ import annotations

import dataclasses
import difflib
import os
import warnings
from typing import Callable, Optional, Tuple, Union

__all__ = [
    "EnvKnob",
    "ENV_KNOBS",
    "QUANT_MODES",
    "read_knob",
    "check_unknown_knobs",
    "describe_knobs",
]


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One registered ``REPRO_*`` environment variable (DESIGN.md
    section 12.4).

    ``kind`` is ``"choice"`` (valid values from the ``choices`` thunk,
    lowercased before matching), ``"int"`` (integer with an inclusive
    ``minimum``), or ``"str"`` (any non-empty value passes through
    verbatim — e.g. a trace-file path).  ``description`` is the
    README-table one-liner.
    """

    name: str
    kind: str                                   # "choice" | "int" | "str"
    description: str
    choices: Optional[Callable[[], Tuple[str, ...]]] = None
    minimum: Optional[int] = None

    def parse(self, raw: str) -> Union[str, int]:
        """Validate and convert ``raw`` (non-empty, stripped); raises
        ``ValueError`` with the knob's canonical message on bad values
        (DESIGN.md section 12.4)."""
        if self.kind == "str":
            return raw
        if self.kind == "choice":
            val = raw.lower()
            valid = self.choices()
            if val not in valid:
                raise ValueError(
                    f"{self.name} must be one of {valid}, got {val!r}")
            return val
        try:
            val = int(raw)
        except ValueError:
            raise ValueError(
                f"{self.name} must be an integer, got {raw!r}") from None
        if self.minimum is not None and val < self.minimum:
            raise ValueError(
                f"{self.name} must be >= {self.minimum}, got {val}")
        return val


def _mode_choices() -> Tuple[str, ...]:
    from .sweep import ENGINE_MODES
    return ENGINE_MODES


def _placement_choices() -> Tuple[str, ...]:
    from .placement import registered_placements
    return ("auto", "plane") + tuple(sorted(registered_placements()))


#: valid values of ``REPRO_QUANT`` (core/quant.py; DESIGN.md section 17)
QUANT_MODES: Tuple[str, ...] = ("off", "int8", "bf16")


ENV_KNOBS = {
    "REPRO_ALLPAIRS_MODE": EnvKnob(
        name="REPRO_ALLPAIRS_MODE", kind="choice", choices=_mode_choices,
        description="force the execution mode everywhere mode='auto' is "
                    "consulted (batch engine, PCIT tiles, serving scoring, "
                    "sparse join, k-NN)"),
    "REPRO_PLACEMENT": EnvKnob(
        name="REPRO_PLACEMENT", kind="choice", choices=_placement_choices,
        description="select the block placement everywhere one is chosen "
                    "implicitly"),
    "REPRO_BATCH_BYTES_LIMIT": EnvKnob(
        name="REPRO_BATCH_BYTES_LIMIT", kind="int", minimum=1,
        description="auto-mode working-set byte budget shared by every "
                    "engine heuristic (default 2^28)"),
    "REPRO_SPARSE_CAPACITY": EnvKnob(
        name="REPRO_SPARSE_CAPACITY", kind="int", minimum=1,
        description="starting per-device buffer capacity of the sparse "
                    "join / range query before overflow escalation"),
    "REPRO_CKPT_EVERY": EnvKnob(
        name="REPRO_CKPT_EVERY", kind="int", minimum=1,
        description="rounds between mid-sweep partial checkpoints in the "
                    "fault-tolerant driver (default 1: every round is "
                    "durable)"),
    "REPRO_FAULT_KILL_EVERY": EnvKnob(
        name="REPRO_FAULT_KILL_EVERY", kind="int", minimum=1,
        description="chaos selfcheck: kill a random live device every N "
                    "sweep rounds (default 2)"),
    "REPRO_FAULT_SEED": EnvKnob(
        name="REPRO_FAULT_SEED", kind="int", minimum=0,
        description="chaos selfcheck: seed of the deterministic fault "
                    "plan RNG (default 0)"),
    "REPRO_DELTA_UPDATES": EnvKnob(
        name="REPRO_DELTA_UPDATES", kind="int", minimum=1,
        description="churn selfcheck: random replace/append updates "
                    "applied per case (default 3)"),
    "REPRO_DELTA_SEED": EnvKnob(
        name="REPRO_DELTA_SEED", kind="int", minimum=0,
        description="churn selfcheck: seed of the deterministic update "
                    "RNG (default 0)"),
    "REPRO_DELTA_MAX_DIRTY_PCT": EnvKnob(
        name="REPRO_DELTA_MAX_DIRTY_PCT", kind="int", minimum=0,
        description="delta index: dirty-block percentage above which an "
                    "update falls back to a full rebuild instead of a "
                    "dirty-tile sweep (default 50)"),
    "REPRO_SERVE_MAX_BATCH": EnvKnob(
        name="REPRO_SERVE_MAX_BATCH", kind="int", minimum=1,
        description="continuous batcher: max requests packed per "
                    "scheduler iteration (default 32)"),
    "REPRO_SERVE_QUEUE_DEPTH": EnvKnob(
        name="REPRO_SERVE_QUEUE_DEPTH", kind="int", minimum=1,
        description="continuous batcher: admission-control bound on "
                    "waiting requests before submits are rejected "
                    "(default 1024)"),
    "REPRO_QUANT": EnvKnob(
        name="REPRO_QUANT", kind="choice", choices=lambda: QUANT_MODES,
        description="quantized scoring path with error-bounded exact "
                    "rescoring: off (default, pure f32), int8 (per-block "
                    "symmetric int8), bf16"),
    "REPRO_TRACE": EnvKnob(
        name="REPRO_TRACE", kind="str",
        description="structured tracing: 0/unset off, 1 on (Chrome-trace "
                    "JSON to repro_trace.json at exit), any other value "
                    "is the output path"),
    "REPRO_METRICS": EnvKnob(
        name="REPRO_METRICS", kind="int", minimum=0,
        description="counters-only tracing (no span events, no trace "
                    "file): 1 on, 0/unset off"),
}

_warned_unknown: set = set()
_seen_env_keys: frozenset = frozenset()


def check_unknown_knobs() -> None:
    """Warn (once per variable per process) about ``REPRO_*`` variables
    in the environment that match no registered knob, suggesting the
    closest registered name — the typo detector (DESIGN.md section
    12.4).  Warn-once is keyed on the variable *name* (not warning
    machinery state, so it survives ``warnings.simplefilter('always')``),
    and an unchanged ``REPRO_*`` keyset skips the environment scan
    entirely — every knob read pays one frozenset compare."""
    global _seen_env_keys
    keys = frozenset(k for k in os.environ if k.startswith("REPRO_"))
    if keys == _seen_env_keys:
        return
    _seen_env_keys = keys
    for key in sorted(keys):
        if key in ENV_KNOBS or key in _warned_unknown:
            continue
        _warned_unknown.add(key)
        hint = difflib.get_close_matches(key, ENV_KNOBS, n=1)
        suggest = f"; did you mean {hint[0]}?" if hint else ""
        warnings.warn(
            f"environment variable {key} matches no registered REPRO_* "
            f"knob and is ignored{suggest} (known: "
            f"{tuple(sorted(ENV_KNOBS))})", RuntimeWarning, stacklevel=3)


def read_knob(name: str) -> Union[str, int, None]:
    """Read and validate one registered knob (DESIGN.md section 12.4).

    Returns None when the variable is unset or empty (caller default
    applies); raises ``ValueError`` on invalid values; also runs the
    unknown-variable typo check as a side effect.
    """
    knob = ENV_KNOBS[name]
    check_unknown_knobs()
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    return knob.parse(raw)


def describe_knobs() -> str:
    """The registry rendered one knob per line (debug / docs aid;
    DESIGN.md section 12.4)."""
    return "\n".join(f"{k.name}: {k.description}"
                     for k in ENV_KNOBS.values())
