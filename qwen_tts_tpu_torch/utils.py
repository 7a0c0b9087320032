"""Device selection for the port's entry points, f32 without TF32, and the
random initialisers' normal draw."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Union

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


def normal_init(shape, fan_in, generator: torch.Generator, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) drawn in f32 on ``generator``'s device (the JAX
    initialisers' distribution), cast to ``dtype`` on ``device`` (the
    generator's unless given)."""
    w = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)
    return w.to(device=device if device is not None else generator.device, dtype=dtype)
