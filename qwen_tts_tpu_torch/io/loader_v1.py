"""25 Hz (V1) codec decoder weights (PyTorch counterpart of
``qwen_tts_tpu/io/loader_v1.py``).

Maps the reference tensor names (``decoder.dit.*`` / ``decoder.bigvgan.*``)
onto the trees of ``models/codec_v1.py``: the DiT's linears as ``[in, out]``
(``x @ w``), BigVGAN's convs in PyTorch's layout as stored (``[C_out, C_in,
K]``, transposed convs ``[C_in, C_out, K]``), SnakeBeta alpha/beta
exponentiated in numpy float32 (as the JAX loader does), the shared
anti-aliasing filters as ``_filters``. The DiT's ECAPA-TDNN loads through
``load_speaker_encoder`` and stays float32 whatever ``dtype`` is.
"""

from __future__ import annotations

import torch

from qwen_tts_tpu_torch.config import BigVGANConfig, CodecV1Config, DiTConfig
from qwen_tts_tpu_torch.io.loader import _Reader
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models.codec_v1 import make_aa_filters
from qwen_tts_tpu_torch.models.speaker import load_speaker_encoder
from qwen_tts_tpu_torch.utils import Device, resolve_device


def load_dit(st: MultiSafeTensors, cfg: DiTConfig, dtype=torch.float32,
             device: Device = None) -> dict:
    r = _Reader(st, resolve_device(device), dtype)
    p = "decoder.dit."
    names = (("ada_w", "ada_b", "attn_norm.linear"), ("wq", "bq", "attn.to_q"),
             ("wk", "bk", "attn.to_k"), ("wv", "bv", "attn.to_v"),
             ("wo", "bo", "attn.to_out.0"), ("ff1_w", "ff1_b", "ff.ff.0"),
             ("ff2_w", "ff2_b", "ff.ff.3"))
    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"{p}transformer_blocks.{i}."
        layer = {}
        for w_key, b_key, name in names:
            layer[w_key] = r.lin(b + name + ".weight")
            layer[b_key] = r.vec(b + name + ".bias")
        layers.append(layer)
    return {
        "time_w1": r.lin(p + "time_embed.time_mlp.0.weight"),
        "time_b1": r.vec(p + "time_embed.time_mlp.0.bias"),
        "time_w2": r.lin(p + "time_embed.time_mlp.2.weight"),
        "time_b2": r.vec(p + "time_embed.time_mlp.2.bias"),
        "codec_embed": r.vec(p + "text_embed.codec_embed.weight"),
        "in_proj_w": r.lin(p + "input_embed.proj.weight"),
        "in_proj_b": r.vec(p + "input_embed.proj.bias"),
        "spk_encoder": load_speaker_encoder(st, cfg.spk_encoder_config(), r.device,
                                            prefix=p + "input_embed.spk_encoder."),
        "layers": layers,
        "out_ada_w": r.lin(p + "norm_out.linear.weight"),
        "out_ada_b": r.vec(p + "norm_out.linear.bias"),
        "out_proj_w": r.lin(p + "proj_out.weight"),
        "out_proj_b": r.vec(p + "proj_out.bias"),
    }


def load_bigvgan(st: MultiSafeTensors, cfg: BigVGANConfig, dtype=torch.float32,
                 device: Device = None) -> dict:
    r = _Reader(st, resolve_device(device), dtype)
    p = "decoder.bigvgan."
    n_res = len(cfg.resblock_kernel_sizes)
    ups_w, ups_b, resblocks = [], [], []
    for li in range(len(cfg.upsample_rates)):
        ups_w.append(r.vec(f"{p}ups.{li}.0.weight"))
        ups_b.append(r.vec(f"{p}ups.{li}.0.bias"))
        for bi in range(n_res):
            rb = f"{p}resblocks.{li * n_res + bi}."
            n_dil = len(cfg.resblock_dilation_sizes[bi])
            acts = [r.snake(rb + f"activations.{j}.act.") for j in range(2 * n_dil)]
            blk = {
                f"conv{c}_{k}": torch.stack([r.vec(rb + f"convs{c}.{j}.{name}")
                                            for j in range(n_dil)])
                for c in (1, 2) for k, name in (("w", "weight"), ("b", "bias"))
            }
            blk["act_alpha"] = torch.stack([a for a, _ in acts])
            blk["act_beta"] = torch.stack([b for _, b in acts])
            if li <= 1:  # causal type "2" blocks carry a pre-conv and a pre-activation
                blk["pre_conv_w"] = r.vec(rb + "pre_conv.weight")
                blk["pre_conv_b"] = r.vec(rb + "pre_conv.bias")
                blk["pre_alpha"], blk["pre_beta"] = r.snake(rb + "pre_act.act.")
            resblocks.append(blk)
    post_alpha, post_beta = r.snake(p + "activation_post.act.")
    return {
        "pre_w": r.vec(p + "conv_pre.weight"),
        "pre_b": r.vec(p + "conv_pre.bias"),
        "ups_w": ups_w,
        "ups_b": ups_b,
        "resblocks": resblocks,
        "post_alpha": post_alpha,
        "post_beta": post_beta,
        "post_w": r.vec(p + "conv_post.weight"),
        "_filters": {k: torch.as_tensor(v, device=r.device)
                     for k, v in make_aa_filters().items()},
    }


def load_codec_v1(model_dir: str, cfg: CodecV1Config, dtype=torch.float32,
                  device: Device = None) -> dict:
    """The DiT and BigVGAN of a 25 Hz tokenizer directory on ``device``
    (CUDA unless given), in ``dtype``."""
    device = resolve_device(device)
    st = MultiSafeTensors(model_dir)
    try:
        return {"dit": load_dit(st, cfg.dit, dtype, device),
                "bigvgan": load_bigvgan(st, cfg.bigvgan, dtype, device)}
    finally:
        st.close()
