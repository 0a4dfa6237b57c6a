"""CPU tests of the benchmark (``PYTHONPATH=src python -m pytest -q
portbench/tests``).  Tests that need a CUDA card carry the ``card``
marker and skip, with a reason, where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")
