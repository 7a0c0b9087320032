"""BENCHMARK.json against the files the harness finds by name, and a new
cell, traffic mix and metric found without an edit."""

import json
import os
import re
import shutil

import _paths  # noqa: F401
import pytest

import harness
import registry
from reference import check

BENCHMARK = os.path.join(_paths.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    with open(BENCHMARK, encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(BENCHMARK) <= 64 * 1024


def test_every_config_found(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_every_cell_found_with_its_mix_and_driver(bench):
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], 1)
        assert set(cell["limits"]) == set(check.NAMES)
        assert all(isinstance(v, float) and v > 0 for v in cell["limits"].values())
        mix = registry.traffic(w["traffic"])
        assert hasattr(registry.driver(mix["driver"]), "Driver")


def test_every_metric_found_and_reported_with_its_moves(bench):
    readers = registry.metric_readers()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        moved = e2e[m["moves"]]
        # Every cell that reports the metric reports what it moves.
        assert set(m["workloads"]) <= set(moved.get("workloads", [w["name"] for w in
                                                                    bench["workloads"]]))
    assert set(readers) == {m["name"] for m in bench["per_layer"]}


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")


def test_new_cell_mix_and_metric_found_without_an_edit(tmp_path):
    root = str(tmp_path / "portbench")
    shutil.copytree(_paths.BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "traffic", "stream-open-loop.json")) as f:
        mix = json.load(f)
    mix["ramp_s"] = 20
    with open(os.path.join(root, "traffic", "stream-long-ramp.json"), "w") as f:
        json.dump(mix, f)
    limits = {k: 1.0 for k in check.NAMES}
    for cell, traffic in (("serve-0.6b-slow", "stream-open-loop"),
                          ("serve-0.6b-long-ramp", "stream-long-ramp")):
        with open(os.path.join(root, "workloads", cell + ".json"), "w") as f:
            json.dump({"config": "qwen3-tts-12hz-0.6b", "traffic": traffic, "rate": 1.5,
                       "chips": 1, "why": "a later cell", "limits": limits}, f)
    with open(os.path.join(root, "metrics", "queue_len.serve.py"), "w") as f:
        f.write("UNIT = 'requests'\n\n\ndef read(layer):\n    return None\n")
    assert "serve-0.6b-slow" in registry.names("workloads", root)
    ctx = harness.context("serve-0.6b-slow", 7, "cpu", root)
    assert ctx.mix["rate"] == 1.5 and ctx.tts.talker.num_hidden_layers == 28
    ctx = harness.context("serve-0.6b-long-ramp", 7, "cpu", root)
    assert ctx.mix["rate"] == 1.5 and ctx.mix["ramp_s"] == 20
    assert "queue_len.serve" in registry.metric_readers(root)


def test_serving_cells_give_their_rate():
    for name in registry.names("workloads"):
        cell = registry.workload(name)
        if registry.traffic(cell["traffic"])["driver"] == "engine_stream":
            assert isinstance(cell["rate"], float) and cell["rate"] > 0
            assert "rate" not in registry.traffic(cell["traffic"])


def test_unknown_names_refused():
    with pytest.raises(FileNotFoundError):
        registry.workload("no-such-cell")
    with pytest.raises(ValueError):
        registry.workload("../BENCHMARK")
