"""Tests of the benchmark harness (gpubench/).  They run on the CPU at
tiny sizes; those marked `gpu` need a card and skip without one.

    python -m pytest gpubench/tests -q          # here: the CPU tests
    python -m pytest gpubench/tests -q -m gpu   # on the card
"""

import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip without one (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_cell():
    """make(args, n_ind, n_sites): a cell at a size the CPU runs in a
    fraction of a second, with the traffic's modules and the limits of
    n1092.boot8."""
    from gpubench import cells

    m = cells.manifest()
    big = cells.load("n1092.boot8")

    def make(args=("--probs", "--n_boot_rep", "3", "--boot_block_size", "5"),
             n_ind=12, n_sites=403):
        return cells.Cell(
            name="tiny", chips=1,
            config={**big.config, "n_ind": n_ind, "n_sites": n_sites},
            traffic={**big.traffic, "args": list(args)}, limits=big.limits,
            end_to_end=m["end_to_end"], per_layer=m["per_layer"])

    return make
