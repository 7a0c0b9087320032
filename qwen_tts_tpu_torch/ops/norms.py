"""Normalization ops (PyTorch counterpart of ``qwen_tts_tpu/ops/norms.py``).

Both norms compute their statistics in float32 whatever the input dtype and
cast back before the learned scale, as the JAX version does.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis: normalize in f32, cast back to the input
    dtype, then multiply by the weight."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return weight.to(x.dtype) * normed


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis (the codec's ConvNeXt block norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
