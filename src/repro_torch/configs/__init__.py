"""Architecture configs (one module per ported arch) and the shape cells."""

from .registry import (ARCHS, SHAPES, all_cells, get_config,  # noqa: F401
                       get_smoke_config, shape_cells)
