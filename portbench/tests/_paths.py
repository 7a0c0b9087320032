"""Puts the benchmark's folder and the checkout's root on ``sys.path`` and
makes a registry root of the tiny CPU pieces beside the real drivers and
metric readers."""

import os
import shutil
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_root(tmp_path) -> str:
    """A registry root: the tiny configuration, mixes and cells, with the
    benchmark's own drivers and metric readers."""
    root = str(tmp_path / "bench")
    shutil.copytree(os.path.join(TESTS, "tiny"), root)
    for kind in ("drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(root, kind))
    return root
