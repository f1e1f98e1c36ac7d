"""CPU tests of the benchmark: `python -m pytest hbench/tests -q` from the
root of the checkout. Cases marked `cuda` run on a card and skip without
one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


@pytest.fixture
def cpu():
    return torch.device("cpu")
