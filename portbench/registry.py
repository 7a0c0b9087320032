"""Finding a benchmark's pieces by name. Each lives in a file of its own, so
a later change adds a configuration, a traffic mix, a cell, a driver or a
per-layer metric by adding a file:

* ``configs/<config>.json``: the model's widths, ids and provenance;
* ``traffic/<traffic>.json``: a traffic mix (its driver and parameters);
* ``workloads/<cell>.json``: a cell (configuration, traffic mix, an open
  loop's rate, chips, the check's limits);
* ``drivers/<driver>.py``: the entry point a window drives (``Driver``);
* ``metrics/<metric>.py``: the reader of one per-layer metric (``read``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _path(kind: str, name: str, ext: str, root: str = HERE) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    path = os.path.join(root, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def _json(kind: str, name: str, root: str = HERE) -> dict:
    with open(_path(kind, name, ".json", root), encoding="utf-8") as f:
        return json.load(f)


def config(name: str, root: str = HERE) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: str = HERE) -> dict:
    return _json("traffic", name, root)


def workload(name: str, root: str = HERE) -> dict:
    return _json("workloads", name, root)


def _module(kind: str, name: str, root: str = HERE) -> ModuleType:
    path = _path(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, root: str = HERE) -> ModuleType:
    return _module("drivers", name, root)


def names(kind: str, root: str = HERE) -> List[str]:
    """The names of every piece of ``kind`` (a folder) present."""
    folder = os.path.join(root, kind)
    return sorted(os.path.splitext(f)[0] for f in os.listdir(folder)
                  if f.endswith((".json", ".py")) and not f.startswith("_"))


def metric_readers(root: str = HERE) -> Dict[str, ModuleType]:
    """Every per-layer metric's reader, by metric name."""
    return {n: _module("metrics", n, root) for n in names("metrics", root)}
