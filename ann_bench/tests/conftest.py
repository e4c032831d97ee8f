"""The benchmark's own tests: `python -m pytest ann_bench/tests -q` from the
root of the checkout. They run on the CPU; a test marked `card` needs a CUDA
device and skips without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
