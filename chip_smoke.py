#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qwen_tts_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: needs CUDA; prints the card's name and power limit; TF32 off for
   matmuls and cuDNN (the f32 codec comparison needs full f32 convs);
2. build: compiles the hand-written kernels from ``qwen_tts_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main path's
   shapes (both dtypes, ragged rows, with and without a window), then its
   time beside the plain version, a library yardstick and the byte bound;
4. path: writes a random-weight checkpoint at the flagship 12 Hz dims,
   loads it with ``Qwen3TTSModel.from_pretrained`` and runs
   ``generate_custom_voice`` for a batch of 4 (talker bf16, codec f32,
   sampled, fixed length); the kernel's launch count must be exactly
   frames x (talker layers + groups x sub-talker layers);
5. parity: the same checkpoint in f32 on the card and on the CPU must give
   the same greedy codes.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``qwen_tts_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# Main-path run: 4 texts, EOS banned (min_new_tokens > max_new_tokens), so
# every row runs MAX_NEW frames and the budget trim keeps MAX_NEW - 1 = 64.
MAX_NEW = 65
FRAMES = MAX_NEW - 1
TEXTS = [
    "Hello, this is a smoke test of the port.",
    "Short one.",
    "A medium length sentence for the third row of the batch.",
    "The fourth row speaks a little longer than the second, to keep the pads ragged.",
]
# Kernel tolerance: f32 differs in summation order only; bf16 output rounds
# to 8 mantissa bits on values of magnitude ~1.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12         # non-tensor-core f32, same source


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# --------------------------------------------------------------------------
# Checkpoint at the flagship dims
# --------------------------------------------------------------------------

def flagship_config():
    """12 Hz flagship dims (talker 20x1024, 16/2 heads; sub-talker 5x1024,
    16/8 heads, hd 128; codec defaults) with 16 code groups and a
    flagship-style vocab layout: the special, speaker and language ids lie in
    the banned band [2048, 3072) of the 3072-row codec vocab."""
    import dataclasses

    from qwen_tts_tpu_torch.config import (
        CodePredictorConfig, TalkerConfig, TTSConfig)

    talker = dataclasses.replace(
        TalkerConfig(), num_code_groups=16,
        codec_pad_id=2148, codec_bos_id=2149, codec_eos_token_id=2150,
        codec_think_id=2154, codec_nothink_id=2155,
        codec_think_bos_id=2156, codec_think_eos_id=2157,
        spk_id=(("aiden", 2900), ("serena", 2901)),
        spk_is_dialect=(("aiden", ""), ("serena", "")),
        codec_language_id=(("chinese", 2950), ("english", 2951)),
        code_predictor=dataclasses.replace(CodePredictorConfig(), num_code_groups=16),
    )
    return TTSConfig(talker=talker, tts_model_type="custom_voice")


def _trunk_specs(prefix, layers, d, qd, kvd, inter, hd, qk_norm=True, layer_scale=False):
    specs = []
    for l in range(layers):
        p = f"{prefix}.layers.{l}."
        specs += [
            (p + "self_attn.q_proj.weight", (qd, d), d),
            (p + "self_attn.k_proj.weight", (kvd, d), d),
            (p + "self_attn.v_proj.weight", (kvd, d), d),
            (p + "self_attn.o_proj.weight", (d, qd), qd),
            (p + "input_layernorm.weight", (d,), "ones"),
            (p + "post_attention_layernorm.weight", (d,), "ones"),
            (p + "mlp.gate_proj.weight", (inter, d), d),
            (p + "mlp.up_proj.weight", (inter, d), d),
            (p + "mlp.down_proj.weight", (d, inter), inter),
        ]
        if qk_norm:
            specs += [(p + "self_attn.q_norm.weight", (hd,), "ones"),
                      (p + "self_attn.k_norm.weight", (hd,), "ones")]
        if layer_scale:
            specs += [(p + "self_attn_layer_scale.scale", (d,), 0.01),
                      (p + "mlp_layer_scale.scale", (d,), 0.01)]
    return specs


def talker_specs(cfg):
    tk, cp = cfg.talker, cfg.talker.code_predictor
    d, td = tk.hidden_size, tk.text_hidden_size
    specs = [
        ("talker.model.codec_embedding.weight", (tk.vocab_size, d), d),
        ("talker.model.text_embedding.weight", (tk.text_vocab_size, td), td),
        ("talker.text_projection.linear_fc1.weight", (td, td), td),
        ("talker.text_projection.linear_fc1.bias", (td,), "zeros"),
        ("talker.text_projection.linear_fc2.weight", (d, td), td),
        ("talker.text_projection.linear_fc2.bias", (d,), "zeros"),
        ("talker.model.norm.weight", (d,), "ones"),
        ("talker.codec_head.weight", (tk.vocab_size, d), d),
        ("talker.code_predictor.model.norm.weight", (cp.hidden_size,), "ones"),
    ]
    specs += _trunk_specs("talker.model", tk.num_hidden_layers, d, tk.q_dim, tk.kv_dim,
                          tk.intermediate_size, tk.head_dim)
    specs += _trunk_specs("talker.code_predictor.model", cp.num_hidden_layers,
                          cp.hidden_size, cp.num_attention_heads * cp.head_dim,
                          cp.num_key_value_heads * cp.head_dim, cp.intermediate_size,
                          cp.head_dim)
    for i in range(cp.num_code_groups - 1):
        specs += [
            (f"talker.code_predictor.model.codec_embedding.{i}.weight",
             (cp.vocab_size, d), d),
            (f"talker.code_predictor.lm_head.{i}.weight",
             (cp.vocab_size, cp.hidden_size), cp.hidden_size),
        ]
    return specs


def codec_specs(cfg):
    dec = cfg.codec.decoder
    cbd, lat, hid, vq = dec.codebook_dim, dec.latent_dim, dec.hidden_size, dec.codebook_dim // 2
    specs = []
    for branch, n in (("rvq_first", 1), ("rvq_rest", dec.num_quantizers - 1)):
        p = f"decoder.quantizer.{branch}."
        specs.append((p + "output_proj.weight", (cbd, vq, 1), vq))
        for i in range(n):
            specs += [(f"{p}vq.layers.{i}._codebook.cluster_usage", (dec.codebook_size,), "usage"),
                      (f"{p}vq.layers.{i}._codebook.embedding_sum",
                       (dec.codebook_size, vq), 1)]
    specs += [
        ("decoder.pre_conv.conv.weight", (lat, cbd, 3), 3 * cbd),
        ("decoder.pre_conv.conv.bias", (lat,), "zeros"),
        ("decoder.pre_transformer.input_proj.weight", (hid, lat), lat),
        ("decoder.pre_transformer.input_proj.bias", (hid,), "zeros"),
        ("decoder.pre_transformer.output_proj.weight", (lat, hid), hid),
        ("decoder.pre_transformer.output_proj.bias", (lat,), "zeros"),
        ("decoder.pre_transformer.norm.weight", (hid,), "ones"),
    ]
    qd = dec.num_attention_heads * dec.head_dim
    specs += _trunk_specs("decoder.pre_transformer", dec.num_hidden_layers, hid, qd, qd,
                          dec.intermediate_size, dec.head_dim, qk_norm=False,
                          layer_scale=True)
    for i, factor in enumerate(dec.upsampling_ratios):
        p = f"decoder.upsample.{i}."
        specs += [
            (p + "0.conv.weight", (lat, lat, factor), lat),
            (p + "0.conv.bias", (lat,), "zeros"),
            (p + "1.dwconv.conv.weight", (lat, 1, 7), 7),
            (p + "1.dwconv.conv.bias", (lat,), "zeros"),
            (p + "1.norm.weight", (lat,), "ones"),
            (p + "1.norm.bias", (lat,), "zeros"),
            (p + "1.pwconv1.weight", (4 * lat, lat), lat),
            (p + "1.pwconv1.bias", (4 * lat,), "zeros"),
            (p + "1.pwconv2.weight", (lat, 4 * lat), 4 * lat),
            (p + "1.pwconv2.bias", (lat,), "zeros"),
            (p + "1.gamma", (lat,), 1e-6),
        ]
    specs += [("decoder.decoder.0.conv.weight", (dec.decoder_dim, lat, 7), 7 * lat),
              ("decoder.decoder.0.conv.bias", (dec.decoder_dim,), "zeros")]
    for i, rate in enumerate(dec.upsample_rates):
        cin, cout = dec.decoder_dim // 2 ** i, dec.decoder_dim // 2 ** (i + 1)
        p = f"decoder.decoder.{i + 1}.block."
        specs += [(p + "0.alpha", (cin,), "snake"), (p + "0.beta", (cin,), "snake"),
                  (p + "1.conv.weight", (cin, cout, 2 * rate), 2 * cin),
                  (p + "1.conv.bias", (cout,), "zeros")]
        for r in range(3):
            u = f"{p}{r + 2}."
            specs += [
                (u + "act1.alpha", (cout,), "snake"), (u + "act1.beta", (cout,), "snake"),
                (u + "conv1.conv.weight", (cout, cout, 7), 7 * cout),
                (u + "conv1.conv.bias", (cout,), "zeros"),
                (u + "act2.alpha", (cout,), "snake"), (u + "act2.beta", (cout,), "snake"),
                (u + "conv2.conv.weight", (cout, cout, 1), cout),
                (u + "conv2.conv.bias", (cout,), "zeros"),
            ]
    n = len(dec.upsample_rates)
    out_dim = dec.decoder_dim // 2 ** n
    specs += [(f"decoder.decoder.{n + 1}.alpha", (out_dim,), "snake"),
              (f"decoder.decoder.{n + 1}.beta", (out_dim,), "snake"),
              (f"decoder.decoder.{n + 2}.conv.weight", (1, out_dim, 7), 7 * out_dim),
              (f"decoder.decoder.{n + 2}.conv.bias", (1,), "zeros")]
    return specs


def make_tensors(specs, dtype, gen):
    """Random tensors made on ``gen``'s device: weights N(0, 1/fan_in), norms
    ones, biases zeros, SnakeBeta log-params N(0, 0.1^2)."""
    import torch

    dev = gen.device
    out = {}
    for name, shape, init in specs:
        if init == "ones":
            t = torch.ones(shape, device=dev)
        elif init == "zeros":
            t = torch.zeros(shape, device=dev)
        elif init == "usage":
            t = torch.randn(shape, generator=gen, device=dev).abs() + 0.5
        elif init == "snake":
            t = 0.1 * torch.randn(shape, generator=gen, device=dev)
        elif isinstance(init, float):
            t = torch.full(shape, init, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) / math.sqrt(init)
        out[name] = t.to(dtype).cpu()
    return out


def write_checkpoint(model_dir: str, cfg, seed: int, device: str = "cuda") -> None:
    import torch

    from qwen_tts_tpu_torch.io.safetensors import save_file

    gen = torch.Generator(device=device).manual_seed(seed)
    tk, cp, dec = cfg.talker, cfg.talker.code_predictor, cfg.codec.decoder
    save_file(make_tensors(talker_specs(cfg), torch.bfloat16, gen),
              os.path.join(model_dir, "model.safetensors"))
    talker_cfg = {
        k: getattr(tk, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps",
            "rope_theta", "num_code_groups", "text_hidden_size", "text_vocab_size",
            "codec_eos_token_id", "codec_think_id", "codec_nothink_id",
            "codec_think_bos_id", "codec_think_eos_id", "codec_pad_id", "codec_bos_id")
    }
    talker_cfg.update(
        rope_scaling={"mrope_section": list(tk.mrope_section), "interleaved": False},
        spk_id=dict(tk.spk_id), spk_is_dialect={k: False for k, _ in tk.spk_is_dialect},
        codec_language_id=dict(tk.codec_language_id),
        code_predictor_config={k: getattr(cp, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "num_code_groups")},
    )
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"tts_model_type": cfg.tts_model_type, "talker_config": talker_cfg,
                   **{k: getattr(cfg, k) for k in (
                       "im_start_token_id", "im_end_token_id", "tts_pad_token_id",
                       "tts_bos_token_id", "tts_eos_token_id")}}, f)
    st_dir = os.path.join(model_dir, "speech_tokenizer")
    os.makedirs(st_dir)
    save_file(make_tensors(codec_specs(cfg), torch.float32, gen),
              os.path.join(st_dir, "model.safetensors"))
    dec_cfg = {k: getattr(dec, k) for k in (
        "codebook_size", "codebook_dim", "hidden_size", "latent_dim", "num_attention_heads",
        "num_key_value_heads", "sliding_window", "intermediate_size", "num_hidden_layers",
        "num_quantizers", "decoder_dim")}
    dec_cfg.update(upsample_rates=list(dec.upsample_rates),
                   upsampling_ratios=list(dec.upsampling_ratios))
    with open(os.path.join(st_dir, "config.json"), "w") as f:
        json.dump({"decoder_config": dec_cfg}, f)


class ChatTemplateTokenizer:
    """Stand-in for the Qwen tokenizer: the real ids of the chat template's
    special tokens, role names and newline; one deterministic id per other
    character."""

    SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645, "\n": 198,
               "assistant": 77091, "user": 872}

    def __call__(self, text):
        ids = []
        for piece in re.split(r"(<\|im_start\|>|<\|im_end\|>|\n|assistant|user)", text):
            if piece in self.SPECIAL:
                ids.append(self.SPECIAL[piece])
            else:
                ids += [1000 + (ord(c) * 7919) % 100000 for c in piece]
        return {"input_ids": ids}


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | nvidia-smi: {smi}")
    return smi


def phase_build():
    from qwen_tts_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load_library("decode_attention")
    log(f"build: decode_attention.cu in {time.perf_counter() - t0:.2f} s")
    for line in build.build_logs.get("decode_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _time_ms(fn, iters=200, warmup=20):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_inputs(gen, b, h, kv, hd, s_max, cur_len, valid_from, dtype):
    import torch

    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s_max, kv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s_max, kv, hd, generator=gen, device="cuda").to(dtype)
    as_t = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return q, k, v, as_t(cur_len), as_t(valid_from)


def phase_kernels(talker_s_max: int):
    """decode_attention against its plain version, then timed at the path's
    two shapes. Returns the JSON record (talker shape, B=4, bf16)."""
    import torch
    import torch.nn.functional as F

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    shapes = {"talker": (16, 2, 64, talker_s_max), "subtalker": (16, 8, 128, 16)}
    for name, (h, kv, hd, s_max) in shapes.items():
        for b in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (None, 13):
                    cur_len = [s_max - 3 * i for i in range(b)]
                    valid_from = [min(5 * i, cl - 1) for i, cl in enumerate(cur_len)]
                    args = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len,
                                             valid_from, dtype)
                    got = decode_attention(*args, window)
                    torch.cuda.synchronize()
                    want = decode_attention_plain(*args, window)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = KERNEL_TOL[str(dtype).split(".")[1]]
                    worst = max(worst, err)
                    log(f"kernel check: decode_attention {name} B={b} H{h}/KV{kv} hd{hd} "
                        f"S_max={s_max} {dtype} window={window}: max_abs_err={err:.3g} "
                        f"(tol {tol})")
                    if not err <= tol:
                        fail(f"decode_attention disagrees with its plain version: {err}")

    records = {}
    for name, (h, kv, hd, s_max) in shapes.items():
        b, dtype = 4, torch.bfloat16
        # Mid-generation rows: the talker at 33 frames past a 32-slot prefix
        # with ragged left pads; the sub-talker at micro-step 8 of 16.
        cur_len = [65] * b if name == "talker" else [8] * b
        valid_from = [0, 5, 10, 20] if name == "talker" else [0] * b
        q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len,
                                            valid_from, dtype)
        kernel_ms = _time_ms(lambda: decode_attention(q, k, v, cl, vf))
        plain_ms = _time_ms(lambda: decode_attention_plain(q, k, v, cl, vf))
        pos = torch.arange(s_max, device="cuda")
        mask = ((pos[None] < cl[:, None]) & (pos[None] >= vf[:, None]))[:, None, None, :]
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        n_valid = sum(c - f for c, f in zip(cur_len, valid_from))
        itemsize = q.element_size()
        bytes_moved = n_valid * kv * hd * 2 * itemsize + 2 * b * h * hd * itemsize + 8 * b
        flops = 4 * n_valid * (h // kv) * kv * hd
        bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
        flops_ms = flops / H100_F32_FLOPS * 1e3
        rec = {
            "name": "decode_attention", "route": "cuda",
            "source": "qwen_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "qwen_tts_tpu/ops/pallas/decode_attention.py:74",
            "shape": f"{name} B={b} H{h}/KV{kv} hd{hd} S_max={s_max} n_valid={n_valid} bf16",
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        }
        records[name] = rec
        log(f"kernel time: {json.dumps(rec)}")
    return records["talker"], worst


def phase_path(model_dir: str, smi: str):
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(model_dir)
    log(f"path: from_pretrained (bf16 talker, f32 codec) on {model.device} in "
        f"{time.perf_counter() - t0:.1f} s; tokenizer loaded: {model.tokenizer is not None}")
    model.tokenizer = ChatTemplateTokenizer()
    tk = model.cfg.talker
    kw = dict(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1, seed=0)
    speakers = ["aiden", "serena", "aiden", "serena"]
    languages = ["english", "auto", "chinese", "english"]

    model.generate_custom_voice(TEXTS, speakers, languages, max_new_tokens=3)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = 0
    t0 = time.perf_counter()
    wavs, sr = model.generate_custom_voice(TEXTS, speakers, languages, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    expected = MAX_NEW * per_frame
    log(f"path: decode_attention launches {launches}, expected {MAX_NEW} frames x "
        f"{per_frame} = {expected}")
    if launches != expected:
        fail("the main path did not launch the decode-attention kernel as expected")
    want_len = FRAMES * model.cfg.codec.decode_upsample_rate
    for i, w in enumerate(wavs):
        if w.shape != (want_len,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            fail(f"waveform {i}: shape {w.shape}, finite {np.isfinite(w).all()}, "
                 f"max |x| {np.abs(w).max()}")
    audio_s = len(wavs) * want_len / sr
    log(f"path: generate_custom_voice B={len(wavs)} frames={FRAMES} ({MAX_NEW} decode "
        f"steps) wall {wall:.3f} s, {wall / MAX_NEW * 1e3:.2f} ms/step, "
        f"audio {audio_s:.2f} s, RTF(audio/wall) {audio_s / wall:.3f}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"unclipped share {np.mean(np.abs(np.concatenate(wavs)) < 1):.3f} | {smi}")

    # The same request split into its two stages (not counted above).
    from qwen_tts_tpu_torch.generate import build_prompt

    prompts = [build_prompt(model.talker_params, model.cfg,
                            model._tokenize(model.build_assistant_text(t)),
                            language=lang, speaker=spk)
               for t, spk, lang in zip(TEXTS, speakers, languages)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, _ = model.generate_codes_from_prompts(prompts, model._merge_params(**kw))
    t_codes = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.decode_codes(codes)
    t_codec = time.perf_counter() - t0
    log(f"path split: decode loop {t_codes:.3f} s ({t_codes / MAX_NEW * 1e3:.2f} ms/step), "
        f"codec {t_codec:.3f} s | {smi}")
    profile_decode(model, prompts, dict(kw, max_new_tokens=9, min_new_tokens=10), smi)
    del model
    torch.cuda.empty_cache()
    return launches


def profile_decode(model, prompts, kw, smi: str) -> None:
    """Where the decode loop's time goes: torch.profiler over a short run;
    device busy time by kernel against the host's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate_codes_from_prompts(prompts, model._merge_params(**kw))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    steps = kw["max_new_tokens"]
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile: decode loop {steps} steps B={len(prompts)}: wall {wall_ms:.1f} ms "
        f"(profiler on), device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {launches / steps:.0f} kernel launches/step | {smi}")
    for e in device[:12]:
        log(f"  profile kernel: {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def phase_parity(model_dir: str):
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=9, min_new_tokens=10)
    texts, speakers = TEXTS[:2], ["aiden", "serena"]
    results = {}
    margins = {}
    for device in ("cuda", "cpu"):
        model = Qwen3TTSModel.from_pretrained(model_dir, talker_dtype=torch.float32,
                                              device=device, load_tokenizer=False)
        model.tokenizer = ChatTemplateTokenizer()
        recorded = []
        originals = (gen_mod.sample_token, st_mod.sample_token)

        def recording(logits, cfg, generator, _orig=originals[0]):
            top2 = torch.topk(logits, 2, dim=-1).values
            recorded.append((top2[:, 0] - top2[:, 1]).min().item())
            return _orig(logits, cfg, generator)

        gen_mod.sample_token = st_mod.sample_token = recording
        try:
            t0 = time.perf_counter()
            prompts = [gen_mod.build_prompt(
                model.talker_params, model.cfg,
                model._tokenize(model.build_assistant_text(t)), speaker=s)
                for t, s in zip(texts, speakers)]
            codes, info = model.generate_codes_from_prompts(
                prompts, model._merge_params(**kw))
        finally:
            gen_mod.sample_token, st_mod.sample_token = originals
        results[device] = np.stack(codes)
        margins[device] = recorded
        log(f"parity: f32 greedy on {device}: codes {results[device].shape} in "
            f"{time.perf_counter() - t0:.1f} s")
        del model
    a, b = results["cuda"], results["cpu"]
    if a.shape != (2, 8, 16):
        fail(f"parity: unexpected code shape {a.shape}")
    if a.shape != b.shape or not (a == b).all():
        diff = np.argwhere(a != b)
        fail(f"parity: card and CPU greedy codes differ at (row, frame, group) "
             f"{diff[:5].tolist()}; smallest top-1/top-2 logit margin "
             f"{min(margins['cuda']):.3g} (card), {min(margins['cpu']):.3g} (CPU)")
    log(f"parity: card == CPU greedy codes for {a.shape[0]} rows x {a.shape[1]} frames x "
        f"{a.shape[2]} groups; smallest logit margin {min(margins['cuda']):.3g}")


def main() -> int:
    smi = phase_device()
    import torch

    phase_build()
    prefill_bucket = 32
    kernel_rec, worst = phase_kernels(prefill_bucket + MAX_NEW)
    model_dir = tempfile.mkdtemp(prefix="qtts_smoke_")
    try:
        cfg = flagship_config()
        t0 = time.perf_counter()
        write_checkpoint(model_dir, cfg, seed=1234)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(model_dir) for f in fs)
        log(f"checkpoint: random weights at flagship dims, {size / 2**30:.2f} GiB, "
            f"written in {time.perf_counter() - t0:.1f} s")
        launches = phase_path(model_dir, smi)
        phase_parity(model_dir)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    kernel_rec.update(launches=launches, max_abs_err=worst)
    print(json.dumps({"kernels": [kernel_rec]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
