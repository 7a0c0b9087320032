"""One run of one cell: set-up, the measured window, the per-layer
readings, the check against the plain reference and the result line.

``run.py`` is the command; this module holds the steps, so that the tests
can drive a run on the CPU at a tiny size (``run_cell``) without the look
for a card that the command makes first.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional

import registry

# Top-level module names no process of the benchmark may hold: the JAX
# package that the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen_tts_tpu")


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    mix: dict
    cfg: dict
    tts: object
    seed: int
    device: object
    limits: dict
    root: str = registry.HERE


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``qwen_tts_tpu_torch`` is the port, not the JAX package)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def context(workload: str, seed: int, device, root: str = registry.HERE) -> Context:
    import sut

    cell = registry.workload(workload, root)
    mix = registry.traffic(cell["traffic"], root)
    if "rate" in cell:  # an open loop's rate is the cell's, laid over its mix
        mix["rate"] = cell["rate"]
    cfg = registry.config(cell["config"], root)
    return Context(workload, cell, mix, cfg, sut.tts_config(cfg), seed, device,
                   cell.get("limits", {}), root)


def listed(ctx: Context, kind: str) -> Optional[set]:
    """The names of ``BENCHMARK.json``'s ``kind`` metrics that list the
    cell (or list no cells), where the run's root is the checkout's
    benchmark; None elsewhere (every reader found is reported)."""
    path = os.path.join(os.path.dirname(registry.HERE), "BENCHMARK.json")
    if ctx.root != registry.HERE or not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        bench = json.load(f)
    return {m["name"] for m in bench[kind] if ctx.name in m.get("workloads", [ctx.name])}


def _finite(x: float) -> float:
    return float(x) if math.isfinite(x) else 1e9


def run_cell(ctx: Context, seconds: float, trace: bool, started: float) -> dict:
    """Set up, measure, read and check one run; returns the result line's
    object (and, under ``_diag``, what the stderr lines print)."""
    import torch

    import reference.check as check
    import sut

    cuda = ctx.device.type == "cuda"
    driver = registry.driver(ctx.mix["driver"], ctx.root).Driver(ctx)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        import subwindow

        subwindow.warm_up()
    rec = driver.run(seconds, trace)
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = driver.metrics(rec)
    attempted, failed = driver.attempted_failed(rec)
    layer = driver.layer(rec)
    sample = driver.served_sample(rec)
    missing = driver.missing_greedy(rec)
    driver.release()
    del driver, rec

    t_check = time.perf_counter()
    weights = sut.cell_weights(ctx)
    mode = {"int8": ctx.mix["int8"], "codec_dtype": ctx.mix["codec_dtype"]}
    numbers = check.readings(weights, ctx.cfg, sample, mode) if sample else {}
    check_s = time.perf_counter() - t_check
    tokens = sum(int(r["codes"].size) for r in sample)
    greedy = sum(1 for r in sample if r["greedy"])
    halves = sorted({r["half"] for r in sample if r.get("half") is not None})
    print(f"check: {greedy} greedy and {len(sample) - greedy} sampled requests, {tokens} served "
          f"codes, from halves {halves} of the pool or batch, reference {check_s:.1f} s; "
          f"greedy requests of the window never finished: {missing}", file=sys.stderr)
    checks = {}
    # Both kinds of request and both halves of the slots or rows are read.
    correct = 0 < greedy < len(sample) and halves == [0, 1] and missing == 0
    for name in check.NAMES:
        value = _finite(numbers.get(name, float("inf")))
        limit = ctx.limits.get(name)
        ok = limit is not None and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}

    if trace:
        metrics = {}
        readers = registry.metric_readers(ctx.root)
        wanted = listed(ctx, "per_layer")
        for name, reader in readers.items():
            if wanted is not None and name not in wanted:
                continue
            value = reader.read(layer)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
    else:
        metrics = {k: {"value": float(v), "unit": u} for k, (v, u) in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    sub = layer.get("trace")
    if trace and sub is not None and "red" in sub:
        red = sub["red"]
        device["busy_s"] = red.busy_s
        device["window_s"] = red.window_s
        result["breakdown"] = red.breakdown()
    result["checks"] = checks
    return result


def main(argv, started: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    ctx = context(args.workload, args.seed, torch.device("cuda"))
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ctx, args.seconds, bool(args.trace), started)
    found = forbidden_modules()
    if found:
        print(f"the process holds forbidden modules: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
