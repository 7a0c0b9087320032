"""The Mimi encoder, the 12 Hz speech tokenizer's encode path (PyTorch
counterpart of ``qwen_tts_tpu/models/mimi_encoder.py``, its native path):

  SEANet conv encoder (causal convs, ELU residual blocks, strided downsampling)
  → causal sliding-window transformer (LayerNorm, LayerScale, exact GELU,
    standard RoPE)
  → stride-2 downsample conv (replicate padding) to the 12.5 Hz frame rate
  → split residual VQ encode (one semantic quantizer, then the acoustic
    residual quantizers; nearest neighbour in the effective codebooks
    ``embed_sum / clip(cluster_usage, 1e-5)``).

Layout: the convs run channels-first ``[B, C, T]`` on ``[C_out, C_in, K]``
weights, as the checkpoint stores them; the transformer and the quantizer run
channels-last ``[B, T, D]`` with linears ``[in, out]`` (``x @ w``). Only the
native checkpoint layout loads: a layout it does not recognise raises
(``KeyError`` naming the missing tensor).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import MimiEncoderConfig
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.ops.attention import attention_prefill
from qwen_tts_tpu_torch.ops.norms import layer_norm
from qwen_tts_tpu_torch.ops.rope import apply_rope, rope_cos_sin


def _mimi_causal_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                      stride: int = 1, dilation: int = 1,
                      pad_mode: str = "constant") -> torch.Tensor:
    """MimiConv1d, causal: left pad ``k_eff - stride``, then the extra right
    pad that makes the last window whole. x: [B, C_in, T]; w: [C_out, C_in, K];
    ``pad_mode`` "constant" (zeros) or "replicate"."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    padding_total = k_eff - stride
    length = x.shape[-1]
    n_frames = math.ceil((length - k_eff + padding_total) / stride + 1) - 1
    ideal_length = n_frames * stride + k_eff - padding_total
    extra = max(ideal_length - length, 0)
    x = F.pad(x, (padding_total, extra), mode=pad_mode)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def seanet_encode(params: dict, cfg: MimiEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 1, T] waveform → [B, hidden_size, T']. Strides and dilations
    follow ``cfg``: a stage's stride is its downsampling ratio, a residual
    block's first conv dilates by growth_rate ** block index."""
    h = _mimi_causal_conv(x, params["init_w"], params["init_b"])
    ratios = tuple(reversed(cfg.upsampling_ratios))
    for si, stage in enumerate(params["stages"]):
        for j, block in enumerate(stage["blocks"]):
            r = h
            for ci, conv in enumerate(block):
                dil = cfg.dilation_growth_rate ** j if ci == 0 else 1
                r = _mimi_causal_conv(F.elu(r), conv["w"], conv["b"], dilation=dil)
            h = h + r
        h = _mimi_causal_conv(F.elu(h), stage["down_w"], stage["down_b"], stride=ratios[si])
    return _mimi_causal_conv(F.elu(h), params["final_w"], params["final_b"])


def mimi_transformer(params: dict, cfg: MimiEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Causal sliding-window transformer (MimiTransformerLayer). x: [B, T, D]."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None], sin[:, :, None]
    h = x
    for layer in params["layers"]:
        normed = layer_norm(h, layer["ln1_w"], layer["ln1_b"], cfg.norm_eps)
        q = (normed @ layer["wq"]).reshape(b, t, cfg.num_attention_heads, cfg.head_dim)
        k = (normed @ layer["wk"]).reshape(b, t, cfg.num_key_value_heads, cfg.head_dim)
        v = (normed @ layer["wv"]).reshape(b, t, cfg.num_key_value_heads, cfg.head_dim)
        attn = attention_prefill(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                                 sliding_window=cfg.sliding_window)
        h = h + (attn.reshape(b, t, -1) @ layer["wo"]) * layer["attn_scale"]
        normed = layer_norm(h, layer["ln2_w"], layer["ln2_b"], cfg.norm_eps)
        mlp = F.gelu(normed @ layer["fc1"]) @ layer["fc2"]
        h = h + mlp * layer["mlp_scale"]
    return h


def _rvq_encode(proj_w: Optional[torch.Tensor], codebooks: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Iterative residual VQ encode. x: [B, T, D_hidden]; codebooks
    [Q, size, vq_dim]. Returns [Q, B, T] indices. The distance is
    ``|r|² - 2 r·e + |e|²`` summed in that order (not ``torch.cdist``, whose
    other algorithm can flip near-ties): each codebook's pick sets the
    residual of every later one."""
    residual = x if proj_w is None else x @ proj_w
    out = []
    for embed in codebooks:
        dist = ((residual * residual).sum(-1, keepdim=True)
                - (2.0 * residual) @ embed.T
                + (embed * embed).sum(-1)[None, None])
        idx = torch.argmin(dist, dim=-1)
        out.append(idx)
        residual = residual - embed[idx]
    return torch.stack(out)


def mimi_latents(params: dict, cfg: MimiEncoderConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav: [B, T] → the quantizers' input [B, T_frames, hidden_size]. On the
    card cuDNN's convolutions run without TF32: the codes are those of f32
    arithmetic."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        h = seanet_encode(params, cfg, wav.float()[:, None])
        h = mimi_transformer(params["transformer"], cfg, h.transpose(1, 2))
        if "down_w" in params:
            h = _mimi_causal_conv(h.transpose(1, 2), params["down_w"], None, stride=2,
                                  pad_mode="replicate").transpose(1, 2)
    return h


def _branches(params: dict, cfg: MimiEncoderConfig, nq: int):
    """(input projection, codebooks) of the semantic and acoustic quantizers,
    the latter cut so that both hold ``nq`` codebooks together."""
    yield params["semantic_proj"], params["semantic_books"]
    if nq > cfg.num_semantic_quantizers:
        n_acoustic = nq - cfg.num_semantic_quantizers
        yield params["acoustic_proj"], params["acoustic_books"][:n_acoustic]


def mimi_encode(params: dict, cfg: MimiEncoderConfig, wav: torch.Tensor,
                num_quantizers: Optional[int] = None) -> torch.Tensor:
    """wav: [B, T] → codes [B, Q, T_frames] int64 (``MimiModel.encode``)."""
    h = mimi_latents(params, cfg, wav)
    nq = num_quantizers or cfg.num_quantizers
    codes = torch.cat([_rvq_encode(proj, books, h)
                       for proj, books in _branches(params, cfg, nq)], dim=0)
    return codes.permute(1, 0, 2)


# --------------------------------------------------------------------------
# Loading (the reference checkpoint layout: tensors under "encoder.")
# --------------------------------------------------------------------------

def load_mimi_encoder(st: MultiSafeTensors, cfg: MimiEncoderConfig, device: torch.device,
                      prefix: str = "encoder.") -> dict:
    """The encode path's weights, float32 on ``device``. The effective
    codebooks are computed in numpy float32, as the JAX loader does."""

    def put(t) -> torch.Tensor:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(device=device, dtype=torch.float32, copy=True).contiguous()

    def conv(name: str, bias: bool = True):
        b = prefix + name + ".bias"
        return (put(st.get_f32(prefix + name + ".weight")),
                put(st.get_f32(b)) if bias and b in st else None)

    def lin(name: str) -> torch.Tensor:
        return put(st.get_f32(prefix + name).t())

    # SEANet stack, in MimiEncoder's layer numbering.
    idx = 0
    init_w, init_b = conv(f"encoder.layers.{idx}.conv")
    idx += 1
    stages = []
    for _ in cfg.upsampling_ratios:
        blocks = []
        for _ in range(cfg.num_residual_layers):
            convs = []
            for bi in (1, 3):
                w, b = conv(f"encoder.layers.{idx}.block.{bi}.conv")
                convs.append({"w": w, "b": b})
            blocks.append(convs)
            idx += 1
        idx += 1  # ELU
        down_w, down_b = conv(f"encoder.layers.{idx}.conv")
        idx += 1
        stages.append({"blocks": blocks, "down_w": down_w, "down_b": down_b})
    idx += 1  # ELU
    final_w, final_b = conv(f"encoder.layers.{idx}.conv")

    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"encoder_transformer.layers.{i}."
        layers.append({
            "ln1_w": put(st.get_f32(prefix + b + "input_layernorm.weight")),
            "ln1_b": put(st.get_f32(prefix + b + "input_layernorm.bias")),
            "wq": lin(b + "self_attn.q_proj.weight"),
            "wk": lin(b + "self_attn.k_proj.weight"),
            "wv": lin(b + "self_attn.v_proj.weight"),
            "wo": lin(b + "self_attn.o_proj.weight"),
            "ln2_w": put(st.get_f32(prefix + b + "post_attention_layernorm.weight")),
            "ln2_b": put(st.get_f32(prefix + b + "post_attention_layernorm.bias")),
            "fc1": lin(b + "mlp.fc1.weight"),
            "fc2": lin(b + "mlp.fc2.weight"),
            "attn_scale": put(st.get_f32(prefix + b + "self_attn_layer_scale.scale")),
            "mlp_scale": put(st.get_f32(prefix + b + "mlp_layer_scale.scale")),
        })

    params = {"init_w": init_w, "init_b": init_b, "stages": stages,
              "final_w": final_w, "final_b": final_b, "transformer": {"layers": layers}}
    if (prefix + "downsample.conv.weight") in st:
        params["down_w"], _ = conv("downsample.conv", bias=False)

    def books(branch: str, n: int) -> torch.Tensor:
        eff = []
        for q in range(n):
            base = f"{prefix}quantizer.{branch}.layers.{q}.codebook."
            usage = st.get_f32(base + "cluster_usage").numpy()
            esum = st.get_f32(base + "embed_sum").numpy()
            eff.append(esum / np.clip(usage, 1e-5, None)[:, None])
        return put(np.stack(eff))

    def in_proj(branch: str) -> Optional[torch.Tensor]:
        name = f"{prefix}quantizer.{branch}.input_proj.weight"
        return put(st.get_f32(name)[:, :, 0].t()) if name in st else None

    semantic, acoustic = ("semantic_residual_vector_quantizer",
                          "acoustic_residual_vector_quantizer")
    params["semantic_books"] = books(semantic, cfg.num_semantic_quantizers)
    params["semantic_proj"] = in_proj(semantic)
    params["acoustic_books"] = books(acoustic, cfg.num_quantizers - cfg.num_semantic_quantizers)
    params["acoustic_proj"] = in_proj(acoustic)
    return params
