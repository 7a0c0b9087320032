"""SnakeBeta activation of the codec's vocoder (PyTorch counterpart of
``qwen_tts_tpu/ops/snake.py``).

``snake(x) = x + sin(x * alpha)^2 / (beta + 1e-9)`` with per-channel
``alpha``/``beta`` already exponentiated by the loader. This is the exact-sin
path that the f32 codec takes; the JAX package's polynomial sin^2 for bf16
activations comes with the bf16 codec.
"""

from __future__ import annotations

import torch

_NO_DIV_BY_ZERO = 1e-9


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x: [..., C] float32; alpha/beta: [C] already exponentiated."""
    if x.dtype != torch.float32:
        raise TypeError(f"snake_beta takes float32 activations, got {x.dtype}")
    s = torch.sin(x * alpha.float())
    return x + s * s / (beta.float() + _NO_DIV_BY_ZERO)
