"""Causal 1-D convolutions for the codec decoder (PyTorch counterpart of
``qwen_tts_tpu/ops/convs.py``).

The public layout stays the JAX package's: activations channels-last
``[B, T, C]`` and weights ``[K, C_in // groups, C_out]``; the functions move to
PyTorch's channels-first layout around each ``F.conv1d`` call.

* ``causal_conv1d``: left pad ``k_eff - stride`` plus the extra right pad that
  makes the last window whole (0 for stride 1, every conv of the decoder).
* ``causal_conv_transpose1d``: full transposed conv, then the causal right
  trim of ``kernel - stride`` samples, leaving ``T * stride``.
* ``causal_conv1d_cf``: ``causal_conv1d``'s channels-first twin on
  ``[B, C, T]`` with ``[C_out, C_in, K]`` weights.

The first two round where the JAX package's do (``preferred_element_type=float32``):
products sum in f32, the f32 bias is added, and the result is cast once to
the input dtype. A bf16 input is therefore convolved as f32 (its values, and
the bf16 weights', are exact in f32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _causal_pads(length: int, k: int, dilation: int, stride: int) -> Tuple[int, int]:
    """(left, right) pads of a causal conv over ``length`` samples."""
    k_eff = (k - 1) * dilation + 1
    pad_left = k_eff - stride
    n_frames = (length - k_eff + pad_left) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_left)
    return pad_left, max(ideal_length - length, 0)


def causal_conv1d_cf(
    x: torch.Tensor,       # [B, C_in, T]
    weight: torch.Tensor,  # [C_out, C_in // groups, K]
    bias: Optional[torch.Tensor] = None,  # [C_out]
    *,
    dilation: int = 1,
    stride: int = 1,
) -> torch.Tensor:
    """``causal_conv1d`` on channels-first tensors with PyTorch's weight
    layout (the 25 Hz vocoder's AMP blocks): the same pads, no transposes.
    The conv runs in ``x``'s dtype; a bf16 one sums in f32 and rounds once."""
    pads = _causal_pads(x.shape[-1], weight.shape[-1], dilation, stride)
    return F.conv1d(F.pad(x, pads), weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), stride=stride,
                    dilation=dilation)


def causal_conv1d(
    x: torch.Tensor,       # [B, T, C_in]
    weight: torch.Tensor,  # [K, C_in // groups, C_out]
    bias: Optional[torch.Tensor] = None,  # [C_out]
    *,
    dilation: int = 1,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    pads = _causal_pads(x.shape[1], weight.shape[0], dilation, stride)
    xc = F.pad(x.transpose(1, 2).float(), pads)
    w = weight.to(x.dtype).float().permute(2, 1, 0)  # [C_out, C_in // groups, K]
    out = F.conv1d(xc, w, None if bias is None else bias.float(),
                   stride=stride, dilation=dilation, groups=groups)
    return out.transpose(1, 2).to(x.dtype)


def causal_conv_transpose1d(
    x: torch.Tensor,       # [B, T, C_in]
    weight: torch.Tensor,  # [K, C_in, C_out] — flipped-tap layout
    bias: Optional[torch.Tensor] = None,  # [C_out]
    *,
    stride: int,
) -> torch.Tensor:
    """Causal transposed conv with output length ``T * stride``.

    ``weight`` is the loader's flipped-tap layout W'[j, i, o] =
    W_torch[i, o, K-1-j]; flipping it back gives ``F.conv_transpose1d``'s
    [C_in, C_out, K] weight."""
    k = weight.shape[0]
    w = torch.flip(weight.to(x.dtype).float(), dims=(0,)).permute(1, 2, 0)
    out = F.conv_transpose1d(x.transpose(1, 2).float(), w,
                             None if bias is None else bias.float(), stride=stride)
    trim = k - stride
    if trim > 0:
        out = out[..., : out.shape[-1] - trim]
    return out.transpose(1, 2).to(x.dtype)
