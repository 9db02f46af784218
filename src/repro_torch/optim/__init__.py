"""Optimizer of the port (counterpart of ``repro/optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    cosine_lr)
