"""On the card: the control of the serving and the offline cell at their
own size (a short window at the cell's load), the program's numbers under
the cell's limits and the control's over one of them. Skips without a CUDA
device. Run it on the card with ``python -m pytest portbench/tests -m cuda``."""

import _paths  # noqa: F401
import pytest
import torch

import control
import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-0.6b", "batch-0.6b"])
def test_control_at_the_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    own, ctl, codes = control.readings(cell, 2 ** 31 + 99, 10.0, torch.device("cuda"))
    limits = harness.context(cell, 0, torch.device("cuda")).limits
    assert codes > 1000
    assert all(own[k] <= limits[k] for k in limits), own
    assert any(ctl[k] > limits[k] for k in limits), ctl
