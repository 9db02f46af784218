"""Token data pipeline of the port (counterpart of ``repro/data``)."""

from .pipeline import (DataConfig, make_batch, make_pipeline,  # noqa: F401
                       synthetic_batches)
