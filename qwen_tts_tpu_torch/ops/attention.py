"""Attention primitives: batched prefill and single-token cached decode.

PyTorch counterpart of ``qwen_tts_tpu/ops/attention.py`` with the same
layouts: queries ``[B, S, H, hd]``, GQA expressed over a ``[B, S, KV, G, hd]``
view (no repeated K/V), a fixed-shape KV cache masked by position, scores and
softmax in float32.

Masked scores are filled with a *finite* -1e9: a left-pad query row is fully
masked in prefill, and with -inf its softmax would be NaN, land in the KV cache
and poison later steps through ``0 * NaN``.

``attention_decode_step`` here is the plain version for array caches; the
trunk calls the hand-written CUDA kernel through
``ops/cuda/decode_attention.py`` instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def attention_prefill(
    q: torch.Tensor,  # [B, S, H, hd] (post-RoPE, post-QK-norm)
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd]
    *,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = real token
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention over a full (left-padded) sequence.

    Returns [B, S, H, hd]. With ``sliding_window`` w, position i attends to
    j in (i-w, i]."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    groups = h // kv
    if scale is None:
        scale = hd ** -0.5

    qg = q.reshape(b, s, kv, groups, hd).float()
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k.float()) * scale

    idx = torch.arange(s, device=q.device)
    allowed = idx[None, :] <= idx[:, None]
    if sliding_window is not None:
        allowed = allowed & (idx[None, :] > idx[:, None] - sliding_window)
    mask = allowed[None, None, None]
    if pad_mask is not None:
        mask = mask & pad_mask[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgij,bjkd->bikgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_decode_step(
    q: torch.Tensor,        # [B, H, hd] single new token (post-RoPE)
    k_cache: torch.Tensor,  # [B, S_max, KV, hd] (already contains the new k)
    v_cache: torch.Tensor,  # [B, S_max, KV, hd]
    *,
    cur_len: torch.Tensor,  # int [B] (or scalar): row b's valid region is [0, cur_len_b)
    valid_from: Optional[torch.Tensor] = None,  # [B] first real position (left pad)
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token GQA attention against a fixed-shape cache. Returns [B, H, hd].

    Masked, not sliced: every position of the cache is scored and the ones
    outside ``[valid_from, cur_len)`` (and the window) get the -1e9 fill.
    Probabilities are cast to the value dtype before the PV product, as in the
    JAX version."""
    b, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    if scale is None:
        scale = hd ** -0.5

    qg = q.reshape(b, kv, groups, hd).float()
    scores = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float()) * scale

    cur_len_b = torch.as_tensor(cur_len, device=q.device).expand(b)
    pos = torch.arange(s_max, device=q.device)
    mask = pos[None, :] < cur_len_b[:, None]
    if valid_from is not None:
        mask = mask & (pos[None, :] >= valid_from[:, None])
    if sliding_window is not None:
        mask = mask & (pos[None, :] > cur_len_b[:, None] - 1 - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, NEG_INF))

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def update_kv_cache(
    k_cache: torch.Tensor,  # [B, S_max, KV, hd]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [B, T, KV, hd]
    v_new: torch.Tensor,
    start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V at [start, start+T). In place: the caches are updated
    and returned."""
    t = k_new.shape[1]
    k_cache[:, start:start + t] = k_new.to(k_cache.dtype)
    v_cache[:, start:start + t] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
