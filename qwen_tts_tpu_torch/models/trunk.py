"""GQA transformer trunk shared by the talker, the sub-talker and the codec's
pre-transformer (PyTorch counterpart of ``qwen_tts_tpu/models/trunk.py``).

Per layer: RMSNorm → Q/K/V → per-head QK-RMSNorm → RoPE → GQA attention →
o_proj (+ LayerScale) → residual → RMSNorm → SwiGLU (+ LayerScale) →
residual. Parameters are the JAX package's layout: a dict of tensors stacked
over a leading [L] axis, projections stored [in, out] so each is ``x @ w``.

The decode step writes the new token's K/V into a fixed-shape
``[L, B, S_max, KV, hd]`` cache **in place** and attends through the
hand-written decode-attention kernel (``ops/cuda/decode_attention.py``) for
CUDA tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.ops.attention import attention_prefill
from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import apply_rope


class TrunkDims(NamedTuple):
    num_layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    intermediate: int
    eps: float
    qk_norm: bool = True


def _layer(params: dict, l: int) -> dict:
    return {k: v[l] for k, v in params.items()}


def _project_qkv(layer: dict, x: torch.Tensor, dims: TrunkDims):
    """x: [..., D] → q [..., H, hd], k/v [..., KV, hd] with QK-RMSNorm."""
    q = (x @ layer["wq"]).unflatten(-1, (dims.heads, dims.head_dim))
    k = (x @ layer["wk"]).unflatten(-1, (dims.kv_heads, dims.head_dim))
    v = (x @ layer["wv"]).unflatten(-1, (dims.kv_heads, dims.head_dim))
    if dims.qk_norm:
        q = rms_norm(q, layer["q_norm"], dims.eps)
        k = rms_norm(k, layer["k_norm"], dims.eps)
    return q, k, v


def _mlp(layer: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ layer["gate"]) * (x @ layer["up"])) @ layer["down"]


def _maybe_scale(layer: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """LayerScale on a residual branch (codec pre-transformer only)."""
    if key in layer:
        return x * layer[key].to(x.dtype)
    return x


def trunk_prefill(
    params: dict,
    dims: TrunkDims,
    hidden: torch.Tensor,  # [B, S, D]
    cos: torch.Tensor,     # [B, S, hd] (already M-RoPE-merged if applicable)
    sin: torch.Tensor,
    *,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = real
    sliding_window: Optional[int] = None,
    layer_windows: Optional[Sequence[int]] = None,  # per-layer window
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B,S,D], k [L,B,S,KV,hd], v).

    ``sliding_window`` applies one window to every layer (codec transformer);
    ``layer_windows`` gives one per layer (talker sliding-window option, with a
    huge sentinel on full-attention layers). Mutually exclusive."""
    if sliding_window is not None and layer_windows is not None:
        raise ValueError("pass sliding_window or layer_windows, not both")
    cos4, sin4 = cos[:, :, None, :], sin[:, :, None, :]
    ks, vs = [], []
    for l in range(dims.num_layers):
        layer = _layer(params, l)
        window = sliding_window if layer_windows is None else int(layer_windows[l])
        x = rms_norm(hidden, layer["input_norm"], dims.eps)
        q, k, v = _project_qkv(layer, x, dims)
        q = apply_rope(q, cos4, sin4)
        k = apply_rope(k, cos4, sin4)
        attn = attention_prefill(q, k, v, pad_mask=pad_mask, sliding_window=window)
        hidden = hidden + _maybe_scale(layer, "attn_scale", attn.flatten(-2) @ layer["wo"])
        hidden = hidden + _maybe_scale(
            layer, "mlp_scale", _mlp(layer, rms_norm(hidden, layer["post_attn_norm"], dims.eps)))
        ks.append(k)
        vs.append(v)
    return hidden, torch.stack(ks), torch.stack(vs)


def trunk_decode_step(
    params: dict,
    dims: TrunkDims,
    hidden: torch.Tensor,   # [B, D] — the new token's embedding
    cos: torch.Tensor,      # [B, hd]
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, S_max, KV, hd], updated in place
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,  # int32 [B] — length *including* this token
    *,
    valid_from: Optional[torch.Tensor] = None,  # int32 [B]
    sliding_window: Optional[int] = None,
    layer_windows: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token forward across all layers. Returns (hidden, k_cache,
    v_cache); the caches are the ones passed in, written at ``cur_len - 1``
    of each row."""
    if sliding_window is not None and layer_windows is not None:
        raise ValueError("pass sliding_window or layer_windows, not both")
    b = hidden.shape[0]
    rows = torch.arange(b, device=hidden.device)
    write_pos = cur_len.long() - 1
    if valid_from is None:
        valid_from = torch.zeros_like(cur_len)
    cos3, sin3 = cos[:, None, :], sin[:, None, :]
    for l in range(dims.num_layers):
        layer = _layer(params, l)
        x = rms_norm(hidden, layer["input_norm"], dims.eps)
        q, k, v = _project_qkv(layer, x, dims)
        q = apply_rope(q, cos3, sin3)
        k = apply_rope(k, cos3, sin3)
        k_cache[l, rows, write_pos] = k.to(k_cache.dtype)
        v_cache[l, rows, write_pos] = v.to(v_cache.dtype)
        window = sliding_window if layer_windows is None else int(layer_windows[l])
        attn = decode_attention(q, k_cache[l], v_cache[l], cur_len, valid_from, window)
        hidden = hidden + _maybe_scale(layer, "attn_scale", attn.flatten(-2) @ layer["wo"])
        hidden = hidden + _maybe_scale(
            layer, "mlp_scale", _mlp(layer, rms_norm(hidden, layer["post_attn_norm"], dims.eps)))
    return hidden, k_cache, v_cache
