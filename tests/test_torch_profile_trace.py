"""The port's ``utils.profile_trace`` (the counterpart of
tests/test_profile_trace.py): a Chrome trace file is written under the
directory, and ``None`` / ``""`` do nothing."""

import json
import os

import torch

from qwen_tts_tpu_torch.utils import profile_trace


def _traces(d):
    return [os.path.join(r, fn) for r, _dirs, fns in os.walk(d) for fn in fns
            if fn.endswith(".pt.trace.json")]


def test_profile_trace_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    x = torch.ones((64, 64))
    with profile_trace(d) as prof:
        torch.sin(x) @ x
    found = _traces(d)
    assert len(found) == 1, f"no profiler trace under {d}"
    with open(found[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::sin", "aten::mm"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_profile_trace_none_is_noop(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(""):
        pass
    assert not os.listdir(tmp_path)
