"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped inside the test where there is none")
