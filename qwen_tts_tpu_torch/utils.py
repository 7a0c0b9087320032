"""Device selection for the port's entry points, f32 without TF32, the
profiler trace, and the random initialisers' normal draw."""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Optional, Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card and no device given it raises rather than quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 arithmetic on the card: cuDNN convolutions and cuBLAS matmuls
    without TF32, so that an f32 model computes in f32 (TF32 keeps 10 bits of
    mantissa). The matmul setting is restored on exit."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = before


def profile_trace(trace_dir: Optional[str]):
    """Context manager: a ``torch.profiler.profile`` whose trace is written
    into ``trace_dir`` on exit, as a Chrome trace (``*.pt.trace.json``)
    through ``tensorboard_trace_handler``, which TensorBoard's profiler
    plugin and ``chrome://tracing`` / Perfetto read. No-op
    (``contextlib.nullcontext()``) when ``trace_dir`` is falsy.

    It records CPU activity always and CUDA activity when a card is present.
    On the card the trace holds every kernel by name with its device start
    and duration (a replayed CUDA graph's kernels one by one), the host's
    launch calls and the torch operators that issued them; on the CPU it
    holds the torch operators and their host times only. ``as`` gives the
    profiler, so ``key_averages()`` reads the same events."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir))


def normal_init(shape, fan_in, generator: torch.Generator, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) drawn in f32 on ``generator``'s device (the JAX
    initialisers' distribution), cast to ``dtype`` on ``device`` (the
    generator's unless given). On the ``meta`` device nothing is drawn: the
    tensor has the shape and dtype only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)
    return w.to(device=device if device is not None else generator.device, dtype=dtype)
