"""Registry: arch id -> (full config, reduced smoke config), shape cells
(port of ``repro/configs/registry.py``; :func:`shape_cells` gates the
long-context cell as the reference does).

Every architecture of the reference is listed, and each resolves.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterator, List, Tuple

from ..models.config import ModelConfig

ARCHS: List[str] = [
    "mamba2_130m",
    "starcoder2_3b",
    "deepseek_coder_33b",
    "qwen3_14b",
    "h2o_danube_1_8b",
    "jamba_v0_1_52b",
    "whisper_large_v3",
    "llama4_scout_17b_a16e",
    "llama4_maverick_400b_a17b",
    "qwen2_vl_72b",
]

# the configs whose model family the port runs: all of them
PORTED = tuple(ARCHS)

# canonical ids with dashes also accepted
_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class Shape:
    """A benchmark cell shape: run kind, sequence length, batch."""
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# archs allowed to run the sub-quadratic long-context cell
LONG_OK = {"mamba2_130m", "jamba_v0_1_52b", "h2o_danube_1_8b"}


def _module(arch: str):
    arch = _ALIAS.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCHS}")
    return importlib.import_module(f".{arch}", package=__package__)


def get_config(arch: str) -> ModelConfig:
    """The full-scale ModelConfig registered under ``arch``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """The tiny smoke-test variant of ``arch`` (same topology)."""
    return _module(arch).SMOKE


def shape_cells(arch: str) -> Iterator[Shape]:
    """The benchmark shapes ``arch`` runs: every shape, except long_500k
    for an arch outside :data:`LONG_OK` (pure full attention)."""
    arch = _ALIAS.get(arch, arch)
    for s in SHAPES.values():
        if s.name == "long_500k" and arch not in LONG_OK:
            continue
        yield s


def all_cells() -> List[Tuple[str, Shape]]:
    """Every (arch, shape) benchmark cell in the matrix."""
    return [(a, s) for a in ARCHS for s in shape_cells(a)]
