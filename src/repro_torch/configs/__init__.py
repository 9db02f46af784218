"""Architecture configs (one module per ported arch) and the shape cells."""

from .registry import ARCHS, SHAPES, get_config, get_smoke_config  # noqa: F401
