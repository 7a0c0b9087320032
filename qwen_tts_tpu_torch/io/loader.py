"""Checkpoint → parameter dictionaries (PyTorch counterpart of
``qwen_tts_tpu/io/loader.py``), with the same layouts as the JAX package:

* Linear weights transpose [out, in] → [in, out] (``x @ w``).
* Per-layer tensors stack into a leading [L, ...] axis.
* The sub-talker's group embedding tables and LM heads stack into [G-1, ...].
* Load-time precomputes: VQ codebooks ``embedding_sum / clamp(usage)`` folded
  through the bias-free output projections into [Q, size, codebook_dim];
  SnakeBeta alpha/beta pre-exponentiated; conv weights [K, Cin, Cout];
  transposed-conv weights with flipped taps (see ``ops/convs.py``). These
  precomputes run in numpy float32, as in the JAX loader, so both packages
  hold the same numbers.

Talker and sub-talker default to bf16, the codec to f32. Shapes are checked
against the config.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from qwen_tts_tpu_torch.config import CodecDecoderConfig, TalkerConfig, TTSConfig
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models.speaker import load_speaker_encoder
from qwen_tts_tpu_torch.utils import Device, resolve_device


class _Reader:
    """Reads tensors from a checkpoint onto one device in one dtype."""

    def __init__(self, st: MultiSafeTensors, device: torch.device, dtype: torch.dtype):
        self.st, self.device, self.dtype = st, device, dtype

    def put(self, t) -> torch.Tensor:
        if isinstance(t, np.ndarray):
            # A copy: a flipped axis of length 1 (a one-tap transposed conv)
            # passes as contiguous with a negative stride, which torch refuses.
            t = torch.from_numpy(np.array(t, order="C"))
        return t.to(device=self.device, dtype=self.dtype, copy=True).contiguous()

    def vec(self, name: str) -> torch.Tensor:
        return self.put(self.st.get(name))

    def lin(self, name: str, expect: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """A Linear weight, transposed to [in, out]."""
        w = self.st.get(name)
        if expect is not None and tuple(w.shape) != expect:
            raise ValueError(f"{name}: expected shape {expect}, got {tuple(w.shape)}")
        return self.put(w).t().contiguous()

    def stack(self, fmt: str, num_layers: int, load) -> torch.Tensor:
        return torch.stack([load(fmt % l) for l in range(num_layers)])

    def f32(self, name: str) -> np.ndarray:
        return self.st.get_f32(name).numpy()

    def conv(self, name: str) -> torch.Tensor:
        """torch Conv1d [out, in/groups, K] → [K, in/groups, out]."""
        return self.put(self.f32(name).transpose(2, 1, 0))

    def tconv(self, name: str) -> torch.Tensor:
        """torch ConvTranspose1d [in, out, K] → flipped-tap [K, in, out]."""
        return self.put(np.flip(self.f32(name).transpose(2, 0, 1), axis=0))

    def snake(self, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pre-exponentiated SnakeBeta parameters."""
        return (self.put(np.exp(self.f32(prefix + "alpha"))),
                self.put(np.exp(self.f32(prefix + "beta"))))


def _trunk(r: _Reader, pre: str, num_layers: int, d: int, qd: int, kvd: int,
           inter: int, qk_norm: bool) -> dict:
    def lin(expect):
        return lambda n: r.lin(n, expect)

    trunk = {
        "wq": r.stack(pre + "self_attn.q_proj.weight", num_layers, lin((qd, d))),
        "wk": r.stack(pre + "self_attn.k_proj.weight", num_layers, lin((kvd, d))),
        "wv": r.stack(pre + "self_attn.v_proj.weight", num_layers, lin((kvd, d))),
        "wo": r.stack(pre + "self_attn.o_proj.weight", num_layers, lin((d, qd))),
        "input_norm": r.stack(pre + "input_layernorm.weight", num_layers, r.vec),
        "post_attn_norm": r.stack(pre + "post_attention_layernorm.weight", num_layers, r.vec),
        "gate": r.stack(pre + "mlp.gate_proj.weight", num_layers, lin((inter, d))),
        "up": r.stack(pre + "mlp.up_proj.weight", num_layers, lin((inter, d))),
        "down": r.stack(pre + "mlp.down_proj.weight", num_layers, lin((d, inter))),
    }
    if qk_norm:
        trunk["q_norm"] = r.stack(pre + "self_attn.q_norm.weight", num_layers, r.vec)
        trunk["k_norm"] = r.stack(pre + "self_attn.k_norm.weight", num_layers, r.vec)
    return trunk


def load_talker(st: MultiSafeTensors, cfg: TalkerConfig, dtype=torch.bfloat16,
                device: Device = None) -> dict:
    r = _Reader(st, resolve_device(device), dtype)
    d, td = cfg.hidden_size, cfg.text_hidden_size
    return {
        "codec_embedding": r.vec("talker.model.codec_embedding.weight"),
        "text_embedding": r.vec("talker.model.text_embedding.weight"),
        "text_proj_fc1": r.lin("talker.text_projection.linear_fc1.weight", (td, td)),
        "text_proj_fc1_b": r.vec("talker.text_projection.linear_fc1.bias"),
        "text_proj_fc2": r.lin("talker.text_projection.linear_fc2.weight", (d, td)),
        "text_proj_fc2_b": r.vec("talker.text_projection.linear_fc2.bias"),
        "trunk": _trunk(r, "talker.model.layers.%d.", cfg.num_hidden_layers, d,
                        cfg.q_dim, cfg.kv_dim, cfg.intermediate_size, qk_norm=True),
        "norm": r.vec("talker.model.norm.weight"),
        "codec_head": r.lin("talker.codec_head.weight", (cfg.vocab_size, d)),
    }


def load_subtalker(st: MultiSafeTensors, cfg: TalkerConfig, dtype=torch.bfloat16,
                   device: Device = None) -> dict:
    r = _Reader(st, resolve_device(device), dtype)
    cp = cfg.code_predictor
    d = cp.hidden_size
    g1 = cp.num_code_groups - 1
    pre = "talker.code_predictor."
    params = {
        "embeds": torch.stack([
            r.vec(f"{pre}model.codec_embedding.{i}.weight") for i in range(g1)]),
        "trunk": _trunk(r, pre + "model.layers.%d.", cp.num_hidden_layers, d,
                        cp.num_attention_heads * cp.head_dim,
                        cp.num_key_value_heads * cp.head_dim, cp.intermediate_size,
                        qk_norm=True),
        "norm": r.vec(pre + "model.norm.weight"),
        "lm_heads": torch.stack([
            r.lin(f"{pre}lm_head.{i}.weight", (cp.vocab_size, d)) for i in range(g1)]),
    }
    if pre + "small_to_mtp_projection.weight" in st:
        params["input_proj"] = r.lin(pre + "small_to_mtp_projection.weight",
                                     (d, cfg.hidden_size))
        params["input_proj_b"] = r.vec(pre + "small_to_mtp_projection.bias")
    return params


def load_codec(st: MultiSafeTensors, cfg: CodecDecoderConfig, dtype=torch.float32,
               device: Device = None) -> dict:
    r = _Reader(st, resolve_device(device), dtype)

    # RVQ: fold the output projections into effective codebooks.
    def folded(prefix: str, idx: int, proj: np.ndarray) -> np.ndarray:
        usage = r.f32(f"{prefix}.vq.layers.{idx}._codebook.cluster_usage")
        emb_sum = r.f32(f"{prefix}.vq.layers.{idx}._codebook.embedding_sum")
        emb = emb_sum / np.clip(usage, cfg.vq_epsilon, None)[:, None]
        return emb @ proj.T

    sem_proj = r.f32("decoder.quantizer.rvq_first.output_proj.weight")[:, :, 0]
    ac_proj = r.f32("decoder.quantizer.rvq_rest.output_proj.weight")[:, :, 0]
    books = [folded("decoder.quantizer.rvq_first", 0, sem_proj)]
    for i in range(cfg.num_quantizers - 1):
        books.append(folded("decoder.quantizer.rvq_rest", i, ac_proj))

    d = cfg.hidden_size
    trunk = _trunk(r, "decoder.pre_transformer.layers.%d.", cfg.num_hidden_layers, d,
                   cfg.num_attention_heads * cfg.head_dim,
                   cfg.num_key_value_heads * cfg.head_dim, cfg.intermediate_size,
                   qk_norm=False)
    pre = "decoder.pre_transformer.layers.%d."
    trunk["attn_scale"] = r.stack(pre + "self_attn_layer_scale.scale",
                                  cfg.num_hidden_layers, r.vec)
    trunk["mlp_scale"] = r.stack(pre + "mlp_layer_scale.scale", cfg.num_hidden_layers, r.vec)
    transformer = {
        "input_proj_w": r.lin("decoder.pre_transformer.input_proj.weight",
                              (d, cfg.latent_dim)),
        "input_proj_b": r.vec("decoder.pre_transformer.input_proj.bias"),
        "trunk": trunk,
        "norm": r.vec("decoder.pre_transformer.norm.weight"),
        "output_proj_w": r.lin("decoder.pre_transformer.output_proj.weight",
                               (cfg.latent_dim, d)),
        "output_proj_b": r.vec("decoder.pre_transformer.output_proj.bias"),
    }

    upsample = []
    for i in range(len(cfg.upsampling_ratios)):
        b = f"decoder.upsample.{i}."
        upsample.append({
            "tconv_w": r.tconv(b + "0.conv.weight"),
            "tconv_b": r.vec(b + "0.conv.bias"),
            "convnext": {
                "dw_w": r.conv(b + "1.dwconv.conv.weight"),
                "dw_b": r.vec(b + "1.dwconv.conv.bias"),
                "ln_w": r.vec(b + "1.norm.weight"),
                "ln_b": r.vec(b + "1.norm.bias"),
                "pw1_w": r.lin(b + "1.pwconv1.weight"),
                "pw1_b": r.vec(b + "1.pwconv1.bias"),
                "pw2_w": r.lin(b + "1.pwconv2.weight"),
                "pw2_b": r.vec(b + "1.pwconv2.bias"),
                "gamma": r.vec(b + "1.gamma"),
            },
        })

    # decoder.decoder.0 = initial conv; .1-.4 = blocks; .5 = final snake;
    # .6 = final conv.
    blocks = []
    for i in range(len(cfg.upsample_rates)):
        b = f"decoder.decoder.{i + 1}.block."
        alpha, beta = r.snake(b + "0.")
        resunits = []
        for u in range(3):
            p = f"{b}{u + 2}."
            a1, b1 = r.snake(p + "act1.")
            a2, b2 = r.snake(p + "act2.")
            resunits.append({
                "alpha1": a1, "beta1": b1,
                "conv1_w": r.conv(p + "conv1.conv.weight"),
                "conv1_b": r.vec(p + "conv1.conv.bias"),
                "alpha2": a2, "beta2": b2,
                "conv2_w": r.conv(p + "conv2.conv.weight"),
                "conv2_b": r.vec(p + "conv2.conv.bias"),
            })
        blocks.append({
            "alpha": alpha, "beta": beta,
            "tconv_w": r.tconv(b + "1.conv.weight"),
            "tconv_b": r.vec(b + "1.conv.bias"),
            "resunits": resunits,
        })

    n_blocks = len(cfg.upsample_rates)
    final_alpha, final_beta = r.snake(f"decoder.decoder.{n_blocks + 1}.")
    return {
        "codebooks": r.put(np.stack(books)),
        "pre_conv_w": r.conv("decoder.pre_conv.conv.weight"),
        "pre_conv_b": r.vec("decoder.pre_conv.conv.bias"),
        "transformer": transformer,
        "upsample": upsample,
        "vocoder_pre_w": r.conv("decoder.decoder.0.conv.weight"),
        "vocoder_pre_b": r.vec("decoder.decoder.0.conv.bias"),
        "blocks": blocks,
        "final_alpha": final_alpha,
        "final_beta": final_beta,
        "final_conv_w": r.conv(f"decoder.decoder.{n_blocks + 2}.conv.weight"),
        "final_conv_b": r.vec(f"decoder.decoder.{n_blocks + 2}.conv.bias"),
    }


def load_checkpoint(
    model_dir: str,
    cfg: Optional[TTSConfig] = None,
    *,
    talker_dtype=torch.bfloat16,
    codec_dtype=torch.float32,
    device: Device = None,
):
    """Load a checkpoint directory onto ``device`` (CUDA unless given).

    Returns (cfg, talker, subtalker, codec, speaker). The codec lives under
    ``speech_tokenizer/``; a missing codec is tolerated (codec is None). The
    speaker encoder (float32) is present on Base checkpoints only; elsewhere
    speaker is None. The Mimi encoder is not read here: the model reads it
    when it first encodes reference audio."""
    device = resolve_device(device)
    if cfg is None:
        cfg = TTSConfig.from_pretrained(model_dir)
    st = MultiSafeTensors(model_dir)
    try:
        talker = load_talker(st, cfg.talker, talker_dtype, device)
        subtalker = load_subtalker(st, cfg.talker, talker_dtype, device)
        speaker = None
        if "speaker_encoder.blocks.0.conv.weight" in st:
            speaker = load_speaker_encoder(st, cfg.speaker_encoder, device)
    finally:
        st.close()
    codec = None
    codec_dir = os.path.join(model_dir, "speech_tokenizer")
    if os.path.isdir(codec_dir) and any(
            f.endswith(".safetensors") for f in os.listdir(codec_dir)):
        st_codec = MultiSafeTensors(codec_dir)
        try:
            codec = load_codec(st_codec, cfg.codec.decoder, codec_dtype, device)
        finally:
            st_codec.close()
    return cfg, talker, subtalker, codec, speaker
