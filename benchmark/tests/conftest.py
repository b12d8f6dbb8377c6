"""The benchmark's own tests (``python -m pytest benchmark/tests -q`` from the
root of the repository). They import no JAX: the tests that need the card
carry the ``cuda`` marker, decide inside the test whether one is present,
and run there as

    python -m pytest benchmark/tests -m cuda -q
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips with a reason elsewhere")
