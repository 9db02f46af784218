import os
import sys
from pathlib import Path

# tests run against src/ without installation
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device.  Distributed tests spawn subprocesses with their
# own XLA_FLAGS (see tests/test_distributed.py).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (from a fixture) elsewhere")
