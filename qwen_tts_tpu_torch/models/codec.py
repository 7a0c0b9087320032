"""12 Hz codec decoder: [B, T, Q] codes → 24 kHz waveform (PyTorch counterpart
of ``qwen_tts_tpu/models/codec.py``).

1. RVQ dequantize: one gather per quantizer into codebooks that the loader
   folded through the bias-free output projections, summed.
2. Causal pre-conv (codebook_dim → latent, k=3).
3. Sliding-window (72) pre-transformer with LayerScale and latent↔hidden
   projections.
4. Upsample stages: causal transposed conv + ConvNeXt block.
5. Vocoder: initial conv, decoder blocks (SnakeBeta → transposed conv → 3
   residual units with dilations 1/3/9), final SnakeBeta + conv to one
   channel, clamp to [-1, 1].

Channels-last ``[B, T, C]`` throughout, as in the JAX package. With bf16
parameters the whole decoder runs in bf16, as the JAX codec does with bf16
params: activations are stored bf16, convs and matmuls accumulate in f32, and
SnakeBeta takes its polynomial sin^2 (``ops/snake.py``). The vocoder blocks
that ``uses_vocoder_kernel`` picks then run as one fused kernel launch each
(``ops/cuda/vocoder_block.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import CodecDecoderConfig
from qwen_tts_tpu_torch.models.trunk import TrunkDims, trunk_prefill
from qwen_tts_tpu_torch.ops.convs import causal_conv1d, causal_conv_transpose1d
from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
    MAX_C_IN, vocoder_block, vocoder_block_plain)
from qwen_tts_tpu_torch.ops.norms import layer_norm, rms_norm
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin
from qwen_tts_tpu_torch.ops.snake import snake_beta


def codec_transformer_dims(cfg: CodecDecoderConfig) -> TrunkDims:
    return TrunkDims(
        num_layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate=cfg.intermediate_size,
        eps=cfg.rms_norm_eps,
        qk_norm=False,
    )


def rvq_dequantize(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, Q] (>= 0) → latent [B, T, codebook_dim]."""
    books = params["codebooks"]  # [Q, size, dim]
    q = books.shape[0]
    ids = torch.arange(q, device=codes.device)[:, None, None]
    return books[ids, codes.permute(2, 0, 1).long()].sum(dim=0)


def codec_transformer(params: dict, cfg: CodecDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Sliding-window pre-transformer. x: [B, T, latent] → [B, T, latent]."""
    h = x @ params["input_proj_w"] + params["input_proj_b"]
    positions = torch.arange(h.shape[1], device=h.device)[None].expand(h.shape[:2])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    h, _, _ = trunk_prefill(
        params["trunk"], codec_transformer_dims(cfg), h, cos, sin,
        sliding_window=cfg.sliding_window,
    )
    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    return h @ params["output_proj_w"] + params["output_proj_b"]


def _convnext_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    dim = x.shape[-1]
    h = causal_conv1d(x, p["dw_w"], p["dw_b"], groups=dim)
    h = layer_norm(h, p["ln_w"], p["ln_b"], eps=1e-6)
    h = h @ p["pw1_w"] + p["pw1_b"]
    h = F.gelu(h)
    h = h @ p["pw2_w"] + p["pw2_b"]
    return x + p["gamma"].to(h.dtype) * h


def uses_vocoder_kernel(block: dict, x: torch.Tensor) -> bool:
    """The one routing rule of the vocoder: a block goes to the fused
    ``vocoder_block`` (the kernel for CUDA tensors, its plain version for CPU
    ones) when its activations are bf16 and its input width is at most
    ``MAX_C_IN`` (384) channels. At the flagship dims (1536 → 768 → 384 →
    192 → 96) those are blocks 2 and 3; blocks 0 and 1, and every block of
    the f32 codec, run as composed torch ops."""
    return x.dtype == torch.bfloat16 and block["tconv_w"].shape[1] <= MAX_C_IN


def codec_decode(params: dict, cfg: CodecDecoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, Q] → waveform [B, T * total_upsample] float32."""
    h = rvq_dequantize(params, codes.clamp(min=0))
    h = causal_conv1d(h, params["pre_conv_w"], params["pre_conv_b"])
    h = codec_transformer(params["transformer"], cfg, h)

    for stage, factor in zip(params["upsample"], cfg.upsampling_ratios):
        h = causal_conv_transpose1d(h, stage["tconv_w"], stage["tconv_b"], stride=factor)
        h = _convnext_block(stage["convnext"], h)

    h = causal_conv1d(h, params["vocoder_pre_w"], params["vocoder_pre_b"])
    for block, rate in zip(params["blocks"], cfg.upsample_rates):
        if uses_vocoder_kernel(block, h):
            h = vocoder_block(h.contiguous(), block, rate)
        else:
            h = vocoder_block_plain(h, block, rate)

    h = snake_beta(h, params["final_alpha"], params["final_beta"])
    wav = causal_conv1d(h, params["final_conv_w"], params["final_conv_b"])
    return wav[..., 0].float().clamp(-1.0, 1.0)


def chunked_decode(
    params: dict,
    cfg: CodecDecoderConfig,
    codes: torch.Tensor,  # [B, T, Q]
    chunk_size: int = 300,
    left_context_size: int = 25,
    max_batch: int = 0,
) -> torch.Tensor:
    """Decode ``chunk_size`` frames at a time, re-decoding
    ``left_context_size`` frames of context whose audio is discarded.
    ``max_batch`` > 0 also splits the batch into slices of at most that size."""
    b = codes.shape[0]
    if max_batch and b > max_batch:
        return torch.cat([
            chunked_decode(params, cfg, codes[i : i + max_batch], chunk_size,
                           left_context_size)
            for i in range(0, b, max_batch)
        ], dim=0)
    total_upsample = cfg.total_upsample
    t = codes.shape[1]
    wavs = []
    start = 0
    while start < t:
        end = min(start + chunk_size, t)
        ctx = left_context_size if start - left_context_size > 0 else start
        wav = codec_decode(params, cfg, codes[:, start - ctx : end])
        wavs.append(wav[:, ctx * total_upsample :])
        start = end
    return torch.cat(wavs, dim=-1)
