"""Attention primitives: batched prefill and single-token cached decode.

PyTorch counterpart of ``qwen_tts_tpu/ops/attention.py`` with the same
layouts: queries ``[B, S, H, hd]``, GQA expressed over a ``[B, S, KV, G, hd]``
view (no repeated K/V), a fixed-shape KV cache masked by position, scores and
softmax in float32.

Masked scores are filled with a *finite* -1e9: a left-pad query row is fully
masked in prefill, and with -inf its softmax would be NaN, land in the KV cache
and poison later steps through ``0 * NaN``.

A KV cache is a tensor ``[..., S, KV, hd]`` or an int8 dict
``{"i8": int8 [..., S, KV, hd], "s": f32 [..., S, KV]}`` with one symmetric
scale per token and head (``quantize_kv``). ``attention_decode_step`` here is
the plain version for both; the trunk calls the hand-written CUDA kernels
through ``ops/cuda/decode_attention.py`` instead.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e9

KVCache = Union[torch.Tensor, dict]


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 scale ``max(amax / 127, 1e-8)`` in f32, with a true
    division on every device. On CUDA, PyTorch divides by a Python scalar by
    multiplying with its reciprocal, which is an ulp off at times; the int8
    values would then round differently from the CPU's and the JAX
    package's."""
    amax = amax.float()
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the last (head_dim) axis:
    x [..., hd] → (int8 [..., hd], f32 scale [...]). ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = int8_scale(xf.abs().amax(dim=-1))
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


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
    q: torch.Tensor,   # [B, H, hd] single new token (post-RoPE)
    k_cache: KVCache,  # [B, S_max, KV, hd] (already contains the new k)
    v_cache: KVCache,  # [B, S_max, KV, hd]
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
    JAX version.

    With int8 dict caches the scales fold into the dots:
    ``q·k = (q·k_i8)·k_s`` and ``Σ_j p_j v_j = Σ_j (p_j v_s_j) v_i8_j``; the
    scaled probabilities are cast to q's dtype before the PV product."""
    kv_int8 = isinstance(k_cache, dict)
    k_raw = k_cache["i8"] if kv_int8 else k_cache
    b, h, hd = q.shape
    s_max, kv = k_raw.shape[1], k_raw.shape[2]
    groups = h // kv
    if scale is None:
        scale = hd ** -0.5

    qg = q.reshape(b, kv, groups, hd).float()
    scores = torch.einsum("bkgd,bjkd->bkgj", qg, k_raw.float()) * scale
    if kv_int8:
        scores = scores * k_cache["s"].transpose(1, 2)[:, :, None, :]  # [B, KV, 1, S]

    cur_len_b = torch.as_tensor(cur_len, device=q.device).expand(b)
    pos = torch.arange(s_max, device=q.device)
    mask = pos[None, :] < cur_len_b[:, None]
    if valid_from is not None:
        mask = mask & (pos[None, :] >= valid_from[:, None])
    if sliding_window is not None:
        mask = mask & (pos[None, :] > cur_len_b[:, None] - 1 - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, NEG_INF))

    probs = torch.softmax(scores, dim=-1)
    if kv_int8:
        probs = (probs * v_cache["s"].transpose(1, 2)[:, :, None, :]).to(q.dtype)
        v_raw = v_cache["i8"]
    else:
        probs, v_raw = probs.to(v_cache.dtype), v_cache
    out = torch.einsum("bkgj,bjkd->bkgd", probs.float(), v_raw.float())
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
