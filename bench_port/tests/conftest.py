"""The benchmark's own tests: run from the repository's root with
``python -m pytest bench_port/tests``.  They import the harness and the
reference from ``bench_port/`` and, where they drive the program, the
port from the root; never JAX."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")
