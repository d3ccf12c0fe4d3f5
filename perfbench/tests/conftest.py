"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests``
from the root of the checkout).  ``card`` marks a test that needs the
NVIDIA card; it looks for one inside the test and skips without it."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA card (skips without CUDA)")
