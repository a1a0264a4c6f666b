"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root.  Tests marked ``gpu`` need a CUDA card and skip
without one (decided inside the test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips cleanly without one")
