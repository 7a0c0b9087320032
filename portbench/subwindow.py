"""Reading a ``torch.profiler`` sub-window of a traced run, in memory.

A sub-window is opened and closed by the driver (``Profile.start`` /
``Profile.stop``) around a steady part of its measured window. Its kernels
are the device's work; the union of their intervals is the busy time, the
rest of the sub-window's wall is idle. Kernels that a CUDA graph replay
launched share the correlation id of that replay's ``cudaGraphLaunch``, so
each replay's kernels can be counted on their own.

The profiler can drop kernel events. A reading by kernel name is used only
where the sub-window kept every launch that the program's own counters
(``.launches`` of each kernel wrapper: captured launches x replays) say ran;
the caller checks that through ``Reduction.count``, and a driver that finds
a shortfall takes the sub-window again.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

# The hand-written kernels by the name of their wrapper's counter.
KERNELS = {
    "int8_matmul": "int8_matmul_kernel",
    "subtalker_step": "subtalker_step_kernel",
    "decode_attention": "decode_attention_kernel",
    "decode_attention_int8": "decode_attention_kernel",
    "vocoder_block": "vocoder_block_kernel",
}
START, STOP = "portbench.subwindow.start", "portbench.subwindow.stop"
_TEMPLATE = re.compile(r"<.*")


def short_name(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = _TEMPLATE.sub("", name)
    name = name.split("(")[0]
    return name[:80]


class Spans:
    """Host spans that the benchmark's own code records around its calls
    into the program's layers (``perf_counter_ns``), so that an idle gap on
    the card can be named by what the host was doing."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[int, int, str]] = []

    def wrap(self, label: str, fn):
        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                self.items.append((t0, time.perf_counter_ns(), label))
        return wrapped


def warm_up() -> None:
    """One empty profile in the calling (main) thread: the profiler's
    library sets itself up in the first thread that uses it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        pass


class Profile:
    """One profiled sub-window: CPU and CUDA activity between two markers.
    ``start`` and ``stop`` run in one thread (the profiler's rule); kernels
    and runtime calls of every thread are recorded, torch ops only of that
    thread, so the host's side is named by ``Spans``."""

    def __init__(self, spans: Optional[Spans] = None):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self.spans = spans
        self._t0 = None

    def start(self) -> Dict[str, int]:
        """Open the sub-window; returns the launch counters read as it
        opens (a replay launched before the read lies before the sub-window,
        one launched after it inside)."""
        self._prof.start()
        before = counters()
        with torch.profiler.record_function(START):
            self._t0 = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.items.clear()
            self.spans.on = True
        return before

    def stop(self) -> None:
        """Close the sub-window (cheap: the caller may hold the device)."""
        with torch.profiler.record_function(STOP):
            pass
        self._prof.stop()
        if self.spans is not None:
            self.spans.on = False

    def reduce(self) -> "Reduction":
        """Read the closed sub-window (seconds for a busy one)."""
        spans = list(self.spans.items) if self.spans is not None else []
        return Reduction(self._prof.profiler.kineto_results.events(), self._t0, spans)


class Reduction:
    """What a sub-window holds: the kernels, the busy union, the idle gaps
    and the host's activity beside them."""

    def __init__(self, events, t0_host: int = 0, spans=()):
        self.kernels: List[Tuple[int, int, str, int]] = []  # (start, end, name, correlation)
        self.host: List[Tuple[int, int, str]] = []
        self.launch_of: Dict[int, Tuple[str, int]] = {}  # correlation -> (runtime call, start)
        start = end = None
        for e in events:
            name = e.name()
            s = e.start_ns()
            d = e.duration_ns()
            if e.is_user_annotation():
                if name == START and e.device_type() == torch.autograd.DeviceType.CPU:
                    start = s
                elif name == STOP and e.device_type() == torch.autograd.DeviceType.CPU:
                    end = s
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if d > 0:  # kernels, copies and fills: the device's work
                    self.kernels.append((s, s + d, name, e.correlation_id()))
                continue
            self.host.append((s, s + d, name))
            if name.startswith(("cuda", "cu")) and "Launch" in name:
                self.launch_of[e.correlation_id()] = (name, s)
        if start is None or end is None:
            raise RuntimeError("the profile holds no sub-window markers")
        # The benchmark's own spans, moved onto the profiler's clock.
        offset = start - t0_host
        self.host += [(a + offset, b + offset, "span: " + label) for a, b, label in spans]
        self.t0, self.t1 = start, end
        self.kernels = [k for k in self.kernels if k[1] > start and k[0] < end]
        self.kernels.sort()
        self.window_s = (end - start) * 1e-9
        self.intervals = self._union()
        self.busy_s = sum(b - a for a, b in self.intervals) * 1e-9
        self._replays = None

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e, _, _ in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    # -- kernels by name ---------------------------------------------------

    def named(self, wrapper: str) -> List[Tuple[int, int, str, int]]:
        key = KERNELS[wrapper]
        return [k for k in self.kernels if key in k[2]]

    def count(self, wrapper: str) -> int:
        return len(self.named(wrapper))

    def seconds(self, wrapper: str) -> float:
        return sum(e - s for s, e, _, _ in self.named(wrapper)) * 1e-9

    def graph_replays(self) -> List[List[Tuple[int, int, str, int]]]:
        """The kernels of each CUDA graph replay launched inside the
        sub-window, in launch order (grouped by the correlation id of their
        ``cudaGraphLaunch``)."""
        if self._replays is None:
            groups = collections.defaultdict(list)
            for k in self.kernels:
                groups[k[3]].append(k)
            self._replays = [groups.get(corr, []) for corr, (call, at) in
                             sorted(self.launch_of.items(), key=lambda x: x[1][1])
                             if "Graph" in call and at >= self.t0]
        return self._replays

    # -- the breakdown -----------------------------------------------------

    def device_ops(self, top: int = 10) -> List[list]:
        total = collections.Counter()
        for s, e, name, _ in self.kernels:
            total[short_name(name)] += (min(e, self.t1) - max(s, self.t0)) * 1e-9
        return [[n, t] for n, t in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The idle time between kernels, summed by what the host was doing
        when each gap began: the innermost of the benchmark's spans and the
        host events (runtime calls) that cover the gap's start."""
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(h for h in self.host if h[2].startswith("span: "))
        calls = sorted(h for h in self.host if not h[2].startswith("span: "))
        starts = [c[0] for c in calls]
        total = collections.Counter()
        for a, b in gaps:
            best = None
            # Host events are short: the one covering ``a`` starts shortly before.
            i = bisect.bisect_right(starts, a) - 1
            for s, e, name in calls[max(0, i - 64): i + 1]:
                if e >= a and (best is None or s >= best[0]):
                    best = (s, name)
            for s, e, name in spans:
                if s > a:
                    break
                if e >= a and (best is None or s >= best[0]):
                    best = (s, name)
            total[best[1][:80] if best else "host: no span or runtime call"] += (b - a) * 1e-9
        return [[n, t] for n, t in total.most_common(top)]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def counters() -> Dict[str, int]:
    """The program's launch counters now, by wrapper name."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_int8
    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block

    return {f.__name__: f.launches for f in (decode_attention, decode_attention_int8,
                                              int8_matmul, subtalker_step, vocoder_block)}


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def complete(red: Reduction, launched: Dict[str, int], wrappers) -> Optional[str]:
    """None when the sub-window kept every launch of ``wrappers`` that the
    counters say ran (the two attention variants share a kernel name); else
    what is missing."""
    short = []
    for w in wrappers:
        names = [x for x in KERNELS if KERNELS[x] == KERNELS[w]]
        want = sum(launched.get(x, 0) for x in names)
        got = red.count(w)
        if got != want:
            short.append(f"{w} {got} of {want}")
    return "; ".join(short) or None
