"""Rotary position embeddings: 1D RoPE and 3-section M-RoPE.

PyTorch counterpart of ``qwen_tts_tpu/ops/rope.py``: ``freqs = pos *
inv_freq``, ``emb = concat(freqs, freqs)``, the rotate-half convention, tables
in float32 and cast to the activation dtype when applied.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim // 2] inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape [..., head_dim] for integer positions [...]."""
    inv_freq = rope_inv_freq(head_dim, theta, positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding. x: [..., head_dim]; cos/sin broadcastable to x."""
    x32 = x.float()
    out = x32 * cos.float() + _rotate_half(x32) * sin.float()
    return out.to(x.dtype)


def merge_mrope_sections(
    cos3: torch.Tensor, sin3: torch.Tensor, sections: Sequence[int],
    interleaved: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge 3-stream cos/sin [3, ..., head_dim] into one table by channel
    sections (sections sum to head_dim // 2).

    Plain form: chunk i of the doubled section list takes stream i % 3.
    Interleaved form: within the half-dim, channel c belongs to stream c % 3
    up to per-stream extents ``sections[s] * 3``; stream 0 is the base."""
    if interleaved:
        half = cos3.shape[-1] // 2
        modality_num = len(sections)
        idx = torch.arange(half, device=cos3.device)

        def merge(t: torch.Tensor) -> torch.Tensor:
            th = t[..., :half]
            out = th[0]
            for s in range(1, modality_num):
                sel = (idx % modality_num == s % modality_num) & (
                    idx >= s) & (idx < sections[s] * modality_num)
                out = torch.where(sel, th[s], out)
            return torch.cat([out, out], dim=-1)

        return merge(cos3), merge(sin3)

    doubled = list(sections) + list(sections)

    def merge(t: torch.Tensor) -> torch.Tensor:
        pieces = []
        offset = 0
        for i, size in enumerate(doubled):
            pieces.append(t[i % 3, ..., offset : offset + size])
            offset += size
        return torch.cat(pieces, dim=-1)

    return merge(cos3), merge(sin3)
