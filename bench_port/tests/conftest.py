"""The benchmark's own tests. Run from the repository's root:

    python -m pytest bench_port/tests -q

Tests marked `card` need a CUDA device and skip without one (the test
decides inside its body)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
