"""Tests of the benchmark. ``python -m pytest caption_bench/tests -q`` from
the root of the repository; the tests marked ``cuda`` skip without a card
and run on it with the same command."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where torch.cuda.is_available() is false)")
