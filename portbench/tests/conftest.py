"""The benchmark's own tests: on the CPU at tiny sizes (the fixture cells
under ``fixtures/tiny``), and on the card where marked ``cuda``.

    python -m pytest portbench/tests -q            # the CPU tests
    python -m pytest portbench/tests -q -m cuda    # on the card
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "tiny"


@pytest.fixture
def tiny():
    """The fixture cells: a Bench over ``fixtures/tiny``."""
    from portbench import harness
    return harness.Bench(FIXTURE / "BENCHMARK.json", [FIXTURE])


@pytest.fixture
def card():
    """The card; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
