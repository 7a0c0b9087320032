"""SnakeBeta activation of the codec's vocoder (PyTorch counterpart of
``qwen_tts_tpu/ops/snake.py``).

``snake(x) = x + sin(x * alpha)^2 / (beta + 1e-9)`` with per-channel
``alpha``/``beta`` already exponentiated by the loader.

f32 activations (the parity default) take the exact ``sin``. bf16 activations
(the bf16 codec) take the JAX package's polynomial sin^2: reduce mod pi with a
round-half-to-even, clip to [-pi/2, pi/2], a degree-9 odd polynomial, squared.
Either way the arithmetic runs in f32 and the result is cast back to the
input dtype. Each operation rounds on its own, in the JAX package's order, so
the vocoder kernel (``csrc/vocoder_block.cu``), which repeats these steps
without fused multiply-adds, gets the same bits.
"""

from __future__ import annotations

import torch

_NO_DIV_BY_ZERO = 1e-9

# Taylor coefficients of sin on [-pi/2, pi/2] (max abs error ~8e-7).
_S3 = -1.0 / 6.0
_S5 = 1.0 / 120.0
_S7 = -1.0 / 5040.0
_S9 = 1.0 / 362880.0
_INV_PI = 0.3183098861837907
_PI = 3.141592653589793
_HALF_PI = 1.5707964


def _sin_squared(u: torch.Tensor) -> torch.Tensor:
    """sin(u)^2 for f32 ``u``: sin(u) = ±sin(u - pi * round(u / pi)) and the
    sign squares away."""
    r = u - _PI * torch.round(u * _INV_PI)
    r = r.clamp(-_HALF_PI, _HALF_PI)
    r2 = r * r
    s = r * (1.0 + r2 * (_S3 + r2 * (_S5 + r2 * (_S7 + r2 * _S9))))
    return s * s


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x: [..., C] float32 or bfloat16; alpha/beta: [C] already exponentiated."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"snake_beta takes float32 or bfloat16 activations, got {x.dtype}")
    x32 = x.float()
    u = x32 * alpha.float()
    if x.dtype == torch.bfloat16:
        s2 = _sin_squared(u)
    else:
        s = torch.sin(u)
        s2 = s * s
    return (x32 + s2 / (beta.float() + _NO_DIV_BY_ZERO)).to(x.dtype)
