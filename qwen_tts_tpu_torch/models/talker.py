"""Talker: the autoregressive codec-token LM (PyTorch counterpart of
``qwen_tts_tpu/models/talker.py``).

Separate codec and text embedding tables, a 2-layer SiLU text projection, a
GQA trunk with QK-RMSNorm and 3-section M-RoPE, a final RMSNorm and the codec
head. The post-norm last hidden state feeds the sub-talker at the next step.
The KV cache is a tensor or, with ``kv_int8``, an int8 dict (``ops/attention.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import TalkerConfig
from qwen_tts_tpu_torch.models.trunk import (
    TrunkDims,
    init_trunk_params,
    trunk_decode_step,
    trunk_prefill,
)
from qwen_tts_tpu_torch.ops.attention import KVCache, quantize_kv
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import merge_mrope_sections, rope_cos_sin
from qwen_tts_tpu_torch.utils import normal_init


def talker_dims(cfg: TalkerConfig) -> TrunkDims:
    return TrunkDims(
        num_layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate=cfg.intermediate_size,
        eps=cfg.rms_norm_eps,
        qk_norm=True,
    )


def init_talker_params(generator: torch.Generator, cfg: TalkerConfig, dtype=torch.float32,
                       device=None) -> dict:
    """Random talker weights (training and tests without a checkpoint):
    matrices N(0, 1/fan_in), biases zeros, the final norm ones; the JAX
    package's keys, shapes and dtypes."""
    d, td = cfg.hidden_size, cfg.text_hidden_size

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    device = device if device is not None else generator.device
    return {
        "codec_embedding": w((cfg.vocab_size, d), d),
        "text_embedding": w((cfg.text_vocab_size, td), td),
        "text_proj_fc1": w((td, td), td),
        "text_proj_fc1_b": torch.zeros((td,), dtype=dtype, device=device),
        "text_proj_fc2": w((td, d), td),
        "text_proj_fc2_b": torch.zeros((d,), dtype=dtype, device=device),
        "trunk": init_trunk_params(generator, talker_dims(cfg), dtype, device),
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "codec_head": w((d, cfg.vocab_size), d),
    }


def text_project(params: dict, text_hidden: torch.Tensor) -> torch.Tensor:
    """ResizeMLP: fc2(silu(fc1(x))) with biases."""
    h = F.silu(text_hidden @ params["text_proj_fc1"] + params["text_proj_fc1_b"])
    return h @ params["text_proj_fc2"] + params["text_proj_fc2_b"]


def embed_text(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    """text_projection(text_embedding(ids)) — the text-track embedding."""
    return text_project(params, params["text_embedding"][token_ids])


def embed_codec(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    return params["codec_embedding"][token_ids]


def _mrope_cos_sin(cfg: TalkerConfig, positions: torch.Tensor):
    """positions: [...]; merged cos/sin [..., head_dim]. Text-only TTS
    carries three identical position streams; the full section merge runs."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos3 = cos[None].expand((3,) + cos.shape)
    sin3 = sin[None].expand((3,) + sin.shape)
    return merge_mrope_sections(cos3, sin3, cfg.mrope_section,
                                interleaved=cfg.mrope_interleaved)


class TalkerPrefillOut(NamedTuple):
    logits: torch.Tensor       # [B, V] f32 at the last position
    last_hidden: torch.Tensor  # [B, D] post-final-norm
    k_cache: KVCache           # [L, B, S_max, KV, hd]
    v_cache: KVCache


def _prefill_cache_write(cache: KVCache, new: torch.Tensor) -> None:
    """Write the prefill's K or V block [L, B, S, KV, hd] at position 0, in
    place; an int8 dict cache quantizes it per token and head."""
    s = new.shape[2]
    if isinstance(cache, dict):
        q8, scale = quantize_kv(new)
        cache["i8"][:, :, :s] = q8
        cache["s"][:, :, :s] = scale.to(cache["s"].dtype)
    else:
        cache[:, :, :s] = new.to(cache.dtype)


def talker_prefill(
    params: dict,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D], left-padded
    pad_mask: torch.Tensor,       # [B, S] True = real token
    k_cache: KVCache,             # [L, B, S_max, KV, hd] preallocated, written in place
    v_cache: KVCache,
) -> TalkerPrefillOut:
    s = inputs_embeds.shape[1]
    # Rope positions cumsum(mask) - 1; pad slots get a dummy 0 and are masked.
    positions = (torch.cumsum(pad_mask.int(), dim=-1) - 1).clamp(min=0)
    cos, sin = _mrope_cos_sin(cfg, positions)
    hidden, ks, vs = trunk_prefill(
        params["trunk"], talker_dims(cfg), inputs_embeds, cos, sin,
        pad_mask=pad_mask, layer_windows=cfg.layer_windows(),
    )
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    last_hidden = hidden[:, -1, :]
    logits = (last_hidden @ params["codec_head"]).float()
    _prefill_cache_write(k_cache, ks)
    _prefill_cache_write(v_cache, vs)
    return TalkerPrefillOut(logits, last_hidden, k_cache, v_cache)


def talker_decode_step(
    params: dict,
    cfg: TalkerConfig,
    input_embed: torch.Tensor,  # [B, D]
    rope_pos: torch.Tensor,     # [B] rotary position of this token
    k_cache: KVCache,
    v_cache: KVCache,
    cur_len: torch.Tensor,      # int32 [B], includes this token
    valid_from: torch.Tensor,   # int32 [B] first valid cache index (left-pad count)
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, KVCache]:
    """Returns (logits [B,V] f32, last_hidden [B,D] post-norm, k_cache, v_cache)."""
    cos, sin = _mrope_cos_sin(cfg, rope_pos)
    hidden, k_cache, v_cache = trunk_decode_step(
        params["trunk"], talker_dims(cfg), input_embed, cos, sin,
        k_cache, v_cache, cur_len, valid_from=valid_from,
        layer_windows=cfg.layer_windows(),
    )
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    logits = (hidden @ params["codec_head"]).float()
    return logits, hidden, k_cache, v_cache


def alloc_kv_cache(
    cfg: TalkerConfig, batch: int, max_len: int, dtype=torch.float32, device=None,
    *, kv_int8: bool = False,
) -> Tuple[KVCache, KVCache]:
    """Preallocate the fixed-shape talker KV cache [L, B, max_len, KV, hd];
    ``kv_int8`` makes each an int8 dict with f32 scales [L, B, max_len, KV]
    (initial scale 1e-8, as in the JAX package)."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    if kv_int8:
        return tuple({"i8": torch.zeros(shape, dtype=torch.int8, device=device),
                      "s": torch.full(shape[:-1], 1e-8, dtype=torch.float32, device=device)}
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
