"""Helpers shared by the PyTorch port's tests (tests/test_torch_*.py)."""

import math

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on one host. The port's tests
    use tiny shapes that gain nothing from intra-op threads, which would only
    contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tame_codec(tree):
    """Scale every conv weight [K, Cin, Cout] of a codec parameter tree
    (JAX or torch leaves) by 1/sqrt(Cin). The fixture's random convs gain
    ~sqrt(Cin) each, which saturates the [-1, 1] clamp everywhere and would
    make a waveform comparison vacuous."""
    if isinstance(tree, dict):
        return {k: (v / math.sqrt(v.shape[1])
                    if k.endswith("_w") and getattr(v, "ndim", 0) == 3 else tame_codec(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tame_codec(v) for v in tree]
    return tree
