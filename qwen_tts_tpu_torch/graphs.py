"""CUDA graphs: work captured once on the card and replayed on its own
buffers, the port's counterpart of the JAX package's compiled programs
(``qwen_tts_tpu/generate.py`` ``_segment_loop``, ``qwen_tts_tpu/pipeline.py``
``_first_packet_program_jit``).

On the card the decode runs as replays: one captured frame of the decode loop
(``generate.py``), the stream's first packet as one graph and its codec
windows as another (``pipeline.py``). A ``Graph`` runs its function once on a
side stream (the kernels' one-time set-up, library workspaces, first-use
allocations), captures it, and from then on only replays it. What the
function reads and what must outlive a replay lives in buffers its owner
allocated before the capture and writes in place; what the function
allocates while captured lives in one memory pool, which every graph alive
at once shares (a pool whose graphs are all gone is released). Graphs replay on the current stream, one after another, so a graph's
temporaries are dead between its replays and the pool is safe to share; an
output made under capture is read right after its own replay, before any
other graph replays.

Captured programs live in one registry, keyed by what their capture baked
in: shapes, dtypes, sampling configs and the identity of the parameter
trees. An entry holds its trees, so their ids stay unique while it lives. At
most ``MAX_PROGRAMS`` live at once, the least recently used dropped first;
``drop(tree)`` drops every program captured on a tree, as
``Qwen3TTSModel.quantize_for_serving`` does for the trees it replaces. A
capture that fails raises: nothing falls back to eager work on the card.

Launch counts. Each kernel wrapper counts its launches (``.launches``; decode
attention also by n_split, ``.splits``). While a function is captured its
wrappers run once and launch nothing: ``Graph`` takes back what they counted
then, keeps it as the graph's captured launches, and adds it again at every
replay. So the counters count what the card runs, launches captured times
replays; the warm-up run launches for real and counts as such.

Sampling. A program that samples draws from a generator of its own,
registered with its graph; ``Graph.drawing_from(generator)`` hands the
caller's generator state to it around the replays and back, so the draws
continue the caller's stream as eager calls would.

Threads. ``device_lock`` serialises the port's card work across threads. A
capture holds it (PyTorch captures in the global mode, where a CUDA call of
another thread, a ``cudaMalloc`` of the caching allocator say, fails the
capture), and so does a program's run from loading its buffers to copying
its outputs out (two threads replaying one program would write each other's
buffers); so does the registry. The serving engines hold it around each
admission, segment and codec decode of their worker thread, and a thread
that does card work beside them (a prompt built on the card, a voice
cloned) holds it for that work. It is reentrant and granted in turn
(``FairLock``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

import torch

from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_int8
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block

# Programs alive at once. A stream uses three (first packet, frame, codec
# window), a batch one frame per (B, S_max, ...); eight leave room for a few
# shapes of each while bounding the buffers they hold (a frame program keeps
# its own copy of the KV cache).
MAX_PROGRAMS = 8
_WRAPPERS = (decode_attention, decode_attention_int8, subtalker_step, vocoder_block, int8_matmul)
_programs: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_live: "weakref.WeakSet[Graph]" = weakref.WeakSet()  # the captured graphs alive


class FairLock:
    """A reentrant lock granted in the order threads asked for it. A thread
    that releases it and asks again queues behind the threads already
    waiting, so an engine's worker, which takes it for each segment, cannot
    starve a request thread that needs the card for a moment."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._owner: Optional[int] = None
        self._depth = 0
        self._waiting: "collections.deque[int]" = collections.deque()

    def acquire(self) -> bool:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += 1
                return True
            self._waiting.append(me)
            while self._owner is not None or self._waiting[0] != me:
                self._cond.wait()
            self._waiting.popleft()
            self._owner, self._depth = me, 1
            return True

    def release(self) -> None:
        with self._cond:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of a FairLock this thread does not hold")
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cond.notify_all()

    def __enter__(self) -> "FairLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


device_lock = FairLock()

T = TypeVar("T")


def _counts() -> Dict[Callable, Tuple[int, Dict[int, int]]]:
    return {fn: (fn.launches, dict(getattr(fn, "splits", {}))) for fn in _WRAPPERS}


def _take_back(before: dict) -> dict:
    """Reset the wrappers' counters to ``before``; returns what was counted
    since, per wrapper: (launches, {n_split: launches})."""
    taken = {}
    for fn, (launches, splits) in before.items():
        now = dict(getattr(fn, "splits", {}))
        delta = {k: v - splits.get(k, 0) for k, v in now.items() if v != splits.get(k, 0)}
        if fn.launches != launches or delta:
            taken[fn] = (fn.launches - launches, delta)
        fn.launches = launches
        if hasattr(fn, "splits"):
            fn.splits.clear()
            fn.splits.update(splits)
    return taken


class Graph:
    """``fn`` captured as one CUDA graph on the current device. ``fn`` takes
    no arguments: it reads and writes buffers that exist before the capture.
    ``outputs`` is what the captured call returned; ``launches`` the kernel
    launches it captured (wrapper name -> count); ``capture_s`` the host
    seconds of warm-up and capture. ``generator``, if given, is the one
    generator ``fn`` draws from."""

    def __init__(self, fn: Callable, generator: Optional[torch.Generator] = None):
        with device_lock:
            self._capture(fn, generator)

    def _capture(self, fn: Callable, generator: Optional[torch.Generator]) -> None:
        t0 = time.perf_counter()
        self.generator = generator
        self._fn = fn  # keeps what the graph reads alive
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        # The pool of a graph alive now: a pool whose graphs are all gone is
        # released and must not be named again.
        pool = next(iter(_live), None)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(self.graph, pool=None if pool is None else pool.graph.pool()):
                self.outputs = fn()
        finally:
            self._captured = _take_back(before)
        _live.add(self)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.launches = {fn.__name__: n for fn, (n, _) in self._captured.items()}

    def replay(self) -> None:
        self.graph.replay()
        for fn, (n, splits) in self._captured.items():
            fn.launches += n
            for k, v in splits.items():
                fn.splits[k] = fn.splits.get(k, 0) + v

    @contextlib.contextmanager
    def drawing_from(self, source: Optional[torch.Generator]):
        """Replays inside draw where ``source`` (None: the device's default
        generator) stands, and leave it where they stopped."""
        if self.generator is None:
            yield
            return
        if source is None:
            source = torch.cuda.default_generators[self.generator.device.index or 0]
        self.generator.set_state(source.get_state())
        try:
            yield
        finally:
            source.set_state(self.generator.get_state())


def read_flag(flag: torch.Tensor, host: torch.Tensor) -> bool:
    """The device bool ``flag`` on the host: a non-blocking copy into the
    pinned ``host``, then a wait for the work queued before it."""
    host.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(host)


def cached(key: tuple, trees: Sequence[dict], build: Callable[[], T]) -> T:
    """The program of ``key`` captured on ``trees`` (parameter dicts),
    built by ``build`` on first use."""
    full = (tuple(id(t) for t in trees),) + tuple(key)
    with device_lock:
        entry = _programs.get(full)
        if entry is None:
            entry = (build(), tuple(trees))
            _programs[full] = entry
            while len(_programs) > MAX_PROGRAMS:
                _programs.popitem(last=False)
        else:
            _programs.move_to_end(full)
        return entry[0]


def drop(*trees: dict) -> None:
    """Drop every program captured on any of ``trees``."""
    ids = {id(t) for t in trees}
    with device_lock:
        for key in [k for k in _programs if ids & set(k[0])]:
            del _programs[key]
        gc.collect()  # a program and its captured function refer to each other


def clear() -> None:
    """Drop every program."""
    with device_lock:
        _programs.clear()
        gc.collect()


def programs() -> list:
    """The live programs, least recently used first, as (kind, program)."""
    with device_lock:
        return [(key[1], entry[0]) for key, entry in _programs.items()]
