#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qwen_tts_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: needs CUDA; prints the card's name and power limit; TF32 off for
   matmuls and cuDNN (the f32 codec comparison needs full f32 convs);
2. build: compiles the hand-written kernels from ``qwen_tts_tpu_torch/csrc``,
   one ``nvcc`` per source, all at once;
3. kernels: each kernel against its plain PyTorch version at the main path's
   shapes (decode attention over float and int8 caches: both dtypes, ragged
   rows, with and without a window, and long talker caches of 2080 slots at
   B 1/4/32 with edge rows and two launches bit-identical, timed there over
   20 caches; the sub-talker micro-step: B 1/4/32,
   both dtypes, every position, the cache rows it wrote included, two
   launches bit-identical, timed at B=4 and B=32 with its grid barrier; the
   vocoder block: both geometries, B 1/4, ragged and sub-tile lengths, the
   stream's first packet and windows), then its time beside the plain
   version, a library yardstick where one exists and the bound (the vocoder
   block is held against its plain version at its timed shapes too);
4. path: writes a random-weight checkpoint at the flagship 12 Hz dims,
   loads it with ``Qwen3TTSModel.from_pretrained`` and runs
   ``generate_custom_voice`` for a batch of 4 (talker bf16, codec f32,
   sampled, fixed length); the decode-attention launch count must be exactly
   frames x (talker layers + groups x sub-talker layers);
5. parity: the same checkpoint in f32 on the card and on the CPU must give
   the same greedy codes;
6. serving: the same checkpoint and texts after
   ``quantize_for_serving(talker=True, kv=True)``; the micro-step kernel must
   launch exactly frames x groups times, the int8-cache attention frames x
   talker layers times, the float-cache attention not at all;
7. serving parity: phase 5 with int8 weights (``quantize_for_serving(
   talker=True)``, codes equal), then with the int8 KV cache as well
   (``kv=True``), compared teacher-forced (see ``KV_INT8_LOGIT_RTOL``);
8. bf16 codec: ``from_pretrained(codec_dtype=torch.bfloat16)`` and
   ``decode_codes`` of the path phase's codes; the fused vocoder-block kernel
   must launch twice per codec call (blocks 2 and 3) and the whole decode,
   before the clamp, must lie within ``BF16_CODEC_REL_L2`` of the same decode
   with the block's plain version; the f32 codec of phase 4 launches it not
   at all;
9. streaming: ``stream_custom_voice`` (bf16 talker, bf16 codec, B=1, greedy,
   EOS banned): first-packet latency, each chunk's wall time, the RTF; the
   chunks must hold frames x 1920 samples, the kernels must launch exactly as
   the chunk schedule predicts, and the streamed codes must equal
   ``generate_codes`` at the stream's prompt bucket (16).

The line before the last holds the kernels' JSON records; the last line is
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
import threading
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
# Decode attention over long caches, bf16: the outputs average many cache
# rows (|out| ~ 0.04 at 2080 positions of randn), so KERNEL_TOL's absolute
# 2e-2 alone is loose there. Each check also holds the error within this
# share of the largest reference value: the f32 results of kernel and plain
# version round to bf16 at most one ulp (2^-7 relative at worst) apart.
ATTN_LONG_REL = 2 ** -7
# The micro-step kernel against its plain version, relative to the largest
# reference value. f32: summation order only, through 5 layers. bf16: both
# round at the same points, but a sum in another order can move a value by
# one bf16 ulp (2^-8 relative), and that carries on through later layers and
# through the cache rows each side attends over.
STEP_TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12         # non-tensor-core f32, same source
H100_BF16_FLOPS = 989e12       # dense bf16 tensor cores, same source
KERNEL_SOURCES = ("decode_attention", "subtalker_step", "vocoder_block")
PORT_KERNELS = tuple(f"{n}_kernel" for n in KERNEL_SOURCES)
# The vocoder-block kernel against its plain version, relative to the
# largest reference value: both round at the same points, but the f32 sums
# run in another order, so an intermediate can land one bf16 ulp (2^-8) apart
# and carry through the later convs of the block.
VOCODER_TOL = 2 ** -6
# The whole bf16 decode through the kernel against the same decode with the
# block's plain version, relative L2 over the flagship random codec's
# waveforms before the clamp (see phase_codec_bf16): the one-ulp differences
# above, carried through block 3 and the final conv. Measured 0.01562 on an
# NVIDIA H100 80GB HBM3 (700 W); the limit is twice that. The sharp check of
# the decode is teacher-forced: each launch in it is held to VOCODER_TOL.
BF16_CODEC_REL_L2 = 0.03
# The stream's schedule: a 2-frame first packet, then 25-frame chunks, each
# decoded in a window with 25 frames of left context.
STREAM_FIRST, STREAM_CHUNK, STREAM_CONTEXT = 2, 25, 25


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


def phase_build(sources=KERNEL_SOURCES):
    """One nvcc per source, all started together; fails if any fails."""
    from qwen_tts_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    errors, seconds = {}, {}

    def one(name):
        start = time.perf_counter()
        try:
            build.load_library(name)
        except Exception as e:  # reported below; the phase fails on any
            errors[name] = e
        seconds[name] = time.perf_counter() - start

    threads = [threading.Thread(target=one, args=(n,)) for n in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors}")
    log(f"build: {', '.join(f'{n}.cu {seconds[n]:.2f} s' for n in sources)}; "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")


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


def _int8_caches(k, v):
    """Float K/V [B, S, KV, hd] -> the int8 dict caches of the serving mode."""
    from qwen_tts_tpu_torch.ops.attention import quantize_kv

    return tuple(dict(zip(("i8", "s"), quantize_kv(t))) for t in (k, v))


def phase_kernels(talker_s_max: int):
    """Each kernel against its plain version, then timed at the path's
    shapes. Returns the JSON records of the three kernels."""
    bf16_rec, worst = phase_kernels_decode_attention(talker_s_max)
    bf16_rec["max_abs_err"] = worst
    int8_rec = phase_kernels_int8_attention(talker_s_max)
    step_rec = phase_kernels_subtalker_step()
    return [bf16_rec, int8_rec, step_rec]


# Long talker caches: the smoke's 32-slot prefill bucket + 2048 new tokens
# (the default max_new_tokens), timed at two lengths and two batches.
ATTN_LONG_S_MAX = 32 + 2048
ATTN_LONG_SHAPES = ((4, 1056), (4, 2080), (32, 1056), (32, 2080))  # (B, cur_len)
# A long cache timed 200 times back to back would sit in the 50 MB L2; the
# timing rotates over one cache per talker layer, as the path does.
ATTN_ROTATE = 20
ATTN_TALKER = (16, 2, 64)  # H, KV, hd
# The bf16 path's profile (profile_decode: 9 steps): S_max 32 + 9, prompts of
# 9-10 rows left-padded into the 32-slot bucket, cur_len 33..41 over the steps.
ATTN_PROFILE_S_MAX = 41
ATTN_PROFILE_VALID_FROM = (22, 23, 22, 22)


def _n_split(s_max: int, b: int, kv: int):
    """The split count the wrapper picks (None for a kernel without splits)."""
    from qwen_tts_tpu_torch.ops.cuda import decode_attention as mod

    choose = getattr(mod, "choose_split", None)
    return choose(s_max, b * kv) if choose else None


def _long_rows(b: int, s_max: int):
    """(cur_len, valid_from) per row of the long-cache checks: ragged rows,
    with rows 1..4 the edge cases (one valid position; 5 valid positions,
    fewer than the splits; a fully masked row; the whole cache)."""
    rows = [(s_max - 61 * i, (7 * i) % 32) for i in range(b)]
    edges = [(1056, 1055), (40, 35), (300, 300), (s_max, 0)]
    for i, e in enumerate(edges[: b - 1]):
        rows[i + 1] = e
    return [c for c, _ in rows], [f for _, f in rows]


def _attention_bytes(b, h, kv, hd, n_valid, q_item, cache_item, scales=False):
    """Bytes the function must move: the valid K/V rows (and their f32
    scales), q in, the output back, cur_len and valid_from."""
    per_row = kv * (hd * cache_item + (4 if scales else 0)) * 2
    return n_valid * per_row + 2 * b * h * hd * q_item + 8 * b


def _bound(bytes_moved, flops):
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def _rotating(fn, runs):
    """fn(*run) over the runs in turn, one per call."""
    state = {"i": 0}

    def call():
        run = runs[state["i"] % len(runs)]
        state["i"] += 1
        return fn(*run)
    return call


def time_attention(kernel, plain, q, runs, vf, int8: bool, label: str):
    """One timed shape: the kernel by CUDA events over 200 launches and by
    profiler device time, its plain version, SDPA as the library yardstick
    (float caches only) and the bound (mean over the runs), taking the runs
    ``(k, v, cur_len)`` in turn."""
    import torch
    import torch.nn.functional as F

    b, h, hd = q.shape
    k0 = runs[0][0]["i8"] if int8 else runs[0][0]
    s_max, kv = k0.shape[1], k0.shape[2]
    call = _rotating(lambda k, v, cl: kernel(q, k, v, cl, vf), runs)
    kernel_ms = _time_ms(call)
    device_ms = _device_us(call, "decode_attention_kernel", iters=max(50, 2 * len(runs))) / 1e3
    plain_ms = _time_ms(_rotating(lambda k, v, cl: plain(q, k, v, cl, vf), runs),
                        iters=40, warmup=5)
    library_ms = None
    if not int8:
        pos = torch.arange(s_max, device="cuda")
        masked = [(k.transpose(1, 2), v.transpose(1, 2),
                   ((pos[None] < cl[:, None]) & (pos[None] >= vf[:, None]))[:, None, None, :])
                  for k, v, cl in runs]
        qs = q[:, :, None, :]
        library_ms = _time_ms(_rotating(lambda k, v, mask: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True), masked))
    vfl = vf.tolist()
    n_valid = sum(max(0, min(c, s_max) - max(f, 0)) for _, _, cl in runs
                  for c, f in zip(cl.tolist(), vfl)) / len(runs)
    cache_item = 1 if int8 else k0.element_size()
    bound_ms, bound_by = _bound(
        _attention_bytes(b, h, kv, hd, n_valid, q.element_size(), cache_item, int8),
        4 * n_valid * h * hd)
    rec = {"shape": f"{label} B={b} H{h}/KV{kv} hd{hd} S_max={s_max} n_valid={n_valid:g} "
                    f"{'bf16 q, int8 KV' if int8 else str(q.dtype).split('.')[1]}",
           "n_split": _n_split(s_max, b, kv), "runs": len(runs),
           "ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"kernel time: {json.dumps(rec)}")
    return rec


def _hold(got, want, dtype, what: str, rel=None) -> float:
    """got against want within KERNEL_TOL and, for bf16 with ``rel``, also
    within rel x max|want|. Returns the largest absolute error."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[str(dtype).split(".")[1]]
    limit = tol
    note = f"tol {tol}"
    if rel is not None and dtype == torch.bfloat16:
        rel_limit = rel * want.float().abs().max().item()
        limit = min(tol, rel_limit)
        note += f" and {rel_limit:.3g} = {rel} x max|ref|"
    log(f"kernel check: {what} {dtype}: max_abs_err={err:.3g} ({note})")
    if not err <= limit:
        fail(f"{what.split()[0]} disagrees with its plain version: {err} ({note})")
    return err


def check_long_attention(gen, int8: bool) -> float:
    """The kernel against its plain version at S_max = ATTN_LONG_S_MAX, the
    talker's heads, B 1/4/32, both dtypes, no window and two windows (edges
    inside the splits), the edge rows of _long_rows, bf16 also within
    ATTN_LONG_REL x max|ref|; then two launches must give the same bits.
    Returns the largest error."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8, decode_attention_int8_plain,
        decode_attention_plain)

    kernel = decode_attention_int8 if int8 else decode_attention
    plain = decode_attention_int8_plain if int8 else decode_attention_plain
    name = kernel.__name__
    h, kv, hd = ATTN_TALKER
    s_max, worst = ATTN_LONG_S_MAX, 0.0
    for b in (1, 4, 32):
        cur_len, valid_from = _long_rows(b, s_max)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len, valid_from,
                                                torch.float32 if int8 else dtype)
            if int8:
                k, v = _int8_caches(k, v)
                q = q.to(dtype)
            for window in (None, 100, 1000):
                got = kernel(q, k, v, cl, vf, window)
                torch.cuda.synchronize()
                worst = max(worst, _hold(
                    got, plain(q, k, v, cl, vf, window), dtype,
                    f"{name} long B={b} H{h}/KV{kv} hd{hd} S_max={s_max} "
                    f"n_split={_n_split(s_max, b, kv)} window={window} rows "
                    f"{list(zip(cur_len, valid_from))[:5]}", rel=ATTN_LONG_REL))
            first = kernel(q, k, v, cl, vf)
            second = kernel(q, k, v, cl, vf)
            torch.cuda.synchronize()
            same = torch.equal(first, second)
            log(f"kernel check: {name} long B={b} {dtype}: two launches "
                f"{'give the same bits' if same else 'DIFFER'}")
            if not same:
                fail(f"{name}: two launches on the same inputs differ")
    return worst


def time_long_attention(gen, int8: bool):
    """The long talker shapes, each over ATTN_ROTATE distinct caches."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8, decode_attention_int8_plain,
        decode_attention_plain)

    kernel = decode_attention_int8 if int8 else decode_attention
    plain = decode_attention_int8_plain if int8 else decode_attention_plain
    h, kv, hd = ATTN_TALKER
    s_max, recs = ATTN_LONG_S_MAX, []
    for b, length in ATTN_LONG_SHAPES:
        q = torch.randn(b, h, hd, generator=gen, device="cuda").bfloat16()
        cl, vf = (torch.tensor(x, dtype=torch.int32, device="cuda")
                  for x in ([length] * b, [(7 * i) % 32 for i in range(b)]))
        caches = []
        for _ in range(ATTN_ROTATE):
            k, v = (torch.randn(b, s_max, kv, hd, generator=gen, device="cuda")
                    for _ in range(2))
            caches.append((*(_int8_caches(k, v) if int8 else (k.bfloat16(), v.bfloat16())), cl))
            del k, v
        recs.append(time_attention(kernel, plain, q, caches, vf, int8, "talker long"))
        del caches
        torch.cuda.empty_cache()
    return recs


def phase_kernels_decode_attention(talker_s_max: int):
    """decode_attention against its plain version (the path's two shapes,
    then the long talker caches with their edge rows and a bit-identity
    check), then timed at the path's two shapes, the bf16 path profile's
    talker shape and the long shapes. Returns the JSON record (talker
    shape, B=4, bf16; every timed shape under "shapes") and the largest
    error."""
    import torch

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
                    worst = max(worst, _hold(
                        got, want, dtype, f"decode_attention {name} B={b} H{h}/KV{kv} hd{hd} "
                        f"S_max={s_max} n_split={_n_split(s_max, b, kv)} window={window}"))
    worst = max(worst, check_long_attention(gen, int8=False))

    records = {}
    for name, (h, kv, hd, s_max) in shapes.items():
        b, dtype = 4, torch.bfloat16
        # Mid-generation rows: the talker at 33 frames past a 32-slot prefix
        # with ragged left pads; the sub-talker at micro-step 8 of 16.
        cur_len = [65] * b if name == "talker" else [8] * b
        valid_from = [0, 5, 10, 20] if name == "talker" else [0] * b
        q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len,
                                            valid_from, dtype)
        records[name] = time_attention(decode_attention, decode_attention_plain, q,
                                       [(k, v, cl)], vf, False, name)
    records["profile"] = time_profile_attention(gen)
    long_recs = time_long_attention(gen, int8=False)
    rec = dict(records["talker"], name="decode_attention", route="cuda",
               source="qwen_tts_tpu_torch/csrc/decode_attention.cu",
               replaces="qwen_tts_tpu/ops/pallas/decode_attention.py:74",
               kernel_ms=records["talker"]["ms"],
               shapes=[records["subtalker"], records["profile"], *long_recs])
    return rec, worst


def time_profile_attention(gen):
    """The talker launches of the bf16 path's profile: B=4, S_max 41, the
    profiled steps' cur_len 33..41 in turn."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_plain)

    h, kv, hd = ATTN_TALKER
    b, s_max = len(ATTN_PROFILE_VALID_FROM), ATTN_PROFILE_S_MAX
    q, k, v, _, vf = _attention_inputs(gen, b, h, kv, hd, s_max, [s_max] * b,
                                       list(ATTN_PROFILE_VALID_FROM), torch.bfloat16)
    runs = [(k, v, torch.full((b,), 32 + i, dtype=torch.int32, device="cuda"))
            for i in range(1, 10)]
    return time_attention(decode_attention, decode_attention_plain, q, runs, vf, False,
                          "talker profile")


def phase_kernels_int8_attention(s_max: int):
    """decode_attention_int8 against its plain version at the talker shape
    (the only path that runs it) and the long talker caches, then timed at
    the talker shape and the long shapes."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kv, hd = ATTN_TALKER
    worst = 0.0
    for b in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for window in (None, 13):
                cur_len = [s_max - 3 * i for i in range(b)]
                valid_from = [min(5 * i, cl - 1) for i, cl in enumerate(cur_len)]
                q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len,
                                                    valid_from, torch.float32)
                kc, vc = _int8_caches(k, v)
                q = q.to(dtype)
                got = decode_attention_int8(q, kc, vc, cl, vf, window)
                torch.cuda.synchronize()
                want = decode_attention_int8_plain(q, kc, vc, cl, vf, window)
                worst = max(worst, _hold(
                    got, want, dtype, f"decode_attention_int8 talker B={b} H{h}/KV{kv} hd{hd} "
                    f"S_max={s_max} n_split={_n_split(s_max, b, kv)} window={window}"))
    worst = max(worst, check_long_attention(gen, int8=True))

    b = 4
    cur_len, valid_from = [65] * b, [0, 5, 10, 20]
    q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, cur_len, valid_from,
                                        torch.float32)
    kc, vc = _int8_caches(k, v)
    q = q.to(torch.bfloat16)
    talker = time_attention(decode_attention_int8, decode_attention_int8_plain, q,
                            [(kc, vc, cl)], vf, True, "talker")
    rec = dict(talker, name="decode_attention_int8", route="cuda",
               source="qwen_tts_tpu_torch/csrc/decode_attention.cu",
               replaces="qwen_tts_tpu/ops/pallas/decode_attention.py:74",
               kernel_ms=talker["ms"], max_abs_err=worst,
               shapes=time_long_attention(gen, int8=True))
    return rec


def random_subtalker_packed(gen, dtype):
    """The micro-step kernel's operands for a random int8 trunk at the dims it
    is built for: weights N(0, 1/fan_in), norms 1 + N(0, 0.1^2)."""
    import torch

    from qwen_tts_tpu_torch.models.trunk import quantize_trunk_int8
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import KERNEL_DIMS, pack_subtalker_weights

    n_layers, d, h, kv, hd, inter = KERNEL_DIMS

    def w(*shape):
        return torch.randn(*shape, generator=gen, device="cuda") / math.sqrt(shape[-2])

    def norm(*shape):
        return 1 + 0.1 * torch.randn(*shape, generator=gen, device="cuda")

    trunk = {"wq": w(n_layers, d, h * hd), "wk": w(n_layers, d, kv * hd),
             "wv": w(n_layers, d, kv * hd), "wo": w(n_layers, h * hd, d),
             "gate": w(n_layers, d, inter), "up": w(n_layers, d, inter),
             "down": w(n_layers, inter, d), "input_norm": norm(n_layers, d),
             "post_attn_norm": norm(n_layers, d), "q_norm": norm(n_layers, hd),
             "k_norm": norm(n_layers, hd)}
    return pack_subtalker_weights(quantize_trunk_int8({k: v.to(dtype) for k, v in trunk.items()}))


def subtalker_step_bound(packed, b: int, pos: int, item: int):
    """The least time the card could take for one micro-step at batch ``b``
    and position ``pos``: the int8 weights, scales and norms read once, x in
    and out, the cache rows 0..pos-1 read and row pos written, against the
    products at the bf16 tensor-core rate. Returns (bound_ms, bound_by)."""
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import KERNEL_DIMS

    n_layers, d, h, kv, hd, _ = KERNEL_DIMS
    weights = sum(packed[k].numel() for k in ("wqkv", "wo", "wgu", "down"))
    scales = 4 * sum(packed[k].numel() for k in ("qkv_s", "wo_s", "gu_s", "down_s"))
    norms = item * sum(packed[k].numel()
                       for k in ("input_norm", "post_attn_norm", "q_norm", "k_norm"))
    cache_read = 2 * n_layers * b * pos * kv * hd * item   # rows 0..pos-1 of K and V
    cache_write = 2 * n_layers * b * kv * hd * item        # row pos of K and V
    bytes_moved = weights + scales + norms + 2 * b * d * item + 2 * hd * 4 + cache_read \
        + cache_write
    flops = 2 * weights * b + 4 * n_layers * b * h * (pos + 1) * hd
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_BF16_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def subtalker_breakdown(step, launches: int):
    """The mean of ``phase_breakdown`` over timed launches of ``step`` (a
    micro-step closure taking ``timeline=``), rounded to 0.01 us."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
        TIMELINE_SLOTS, launch_shape, phase_breakdown)

    timeline = torch.zeros(launch_shape(torch.bfloat16, 1)[0], TIMELINE_SLOTS,
                           dtype=torch.int64, device="cuda")
    step(timeline=timeline)  # warm-up
    parts = []
    for _ in range(launches):
        step(timeline=timeline)
        torch.cuda.synchronize()
        parts.append(phase_breakdown(timeline))
    return {k: round(sum(p[k] for p in parts) / launches, 2) for k in parts[0]}


def time_subtalker_step(packed, b: int, gen, groups: int = 16, eps: float = 1e-6):
    """One micro-step at batch ``b``, bf16, mid-frame (pos = groups / 2):
    CUDA events over back-to-back launches (host launch cost included), the
    profiler's device time of the kernel, the plain version's time and the
    bound. Returns the row."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
        KERNEL_DIMS, subtalker_step, subtalker_step_plain)
    from qwen_tts_tpu_torch.ops.rope import rope_cos_sin

    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    dtype, pos = torch.bfloat16, groups // 2
    cos, sin = rope_cos_sin(torch.arange(groups, device="cuda"), hd, 10000.0)
    kc, vc = (torch.randn(n_layers, b, groups, kv, hd, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)

    def step(timeline=None):
        return subtalker_step(packed, x, cos[pos], sin[pos], kc, vc, pos, eps, timeline)

    kernel_ms = _time_ms(step)
    device_ms = _device_us(step, "subtalker_step_kernel", iters=20) / 1e3
    plain_ms = _time_ms(lambda: subtalker_step_plain(packed, x, cos[pos], sin[pos], kc, vc, pos,
                                                     eps), iters=20, warmup=3)
    bound_ms, bound_by = subtalker_step_bound(packed, b, pos, 2)
    row = {"B": b, "pos": pos, "groups": groups, "dtype": "bfloat16", "ms": kernel_ms,
           "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "breakdown_us": subtalker_breakdown(step, 10)}
    log(f"kernel time: subtalker_step {json.dumps(row)}")
    return row


def time_grid_barrier(packed, n: int = 2000) -> float:
    """The micro-step kernel's grid barrier alone: us per barrier, from CUDA
    events around one cooperative launch of ``n`` barriers less one of none,
    each the best of 5."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import barrier_bench

    scratch = packed.scratch(1)

    def best_ms(count):
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            barrier_bench(count, scratch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    best_ms(10)  # warm-up
    return (best_ms(n) - best_ms(0)) / n * 1e3


def phase_kernels_subtalker_step(groups: int = 16):
    """subtalker_step against its plain version at the flagship sub-talker
    dims: B 1/4/32, bf16/f32, every position of a frame, the hidden state
    and the K/V rows each wrote; two launches on the same inputs give the
    same bits. Then timed at B=4 and B=32, bf16, mid-frame, by events and by
    the profiler's device time, beside the bound, with the cost of one grid
    barrier."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
        KERNEL_DIMS, launch_shape, subtalker_step, subtalker_step_rows,
        unpack_subtalker_weights)
    from qwen_tts_tpu_torch.ops.rope import rope_cos_sin

    n_layers, d, h, kv, hd, inter = KERNEL_DIMS
    eps = 1e-6
    gen = torch.Generator(device="cuda").manual_seed(3)
    cos, sin = rope_cos_sin(torch.arange(groups, device="cuda"), hd, 10000.0)
    worst = 0.0
    packs = {}
    for dtype in (torch.bfloat16, torch.float32):
        packs[dtype] = packed = random_subtalker_packed(gen, dtype)
        rows = unpack_subtalker_weights(packed)  # the plain version's weights
        tol = STEP_TOL[str(dtype).split(".")[1]]
        for b in (1, 4, 32):
            grid, threads, smem = launch_shape(dtype, b)
            shape = (n_layers, b, groups, kv, hd)
            kc, vc = (torch.zeros(shape, dtype=dtype, device="cuda") for _ in range(2))
            kc_p, vc_p = kc.clone(), vc.clone()
            errs = []
            before = subtalker_step.launches
            for pos in range(groups):
                x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)
                got, _, _ = subtalker_step(packed, x, cos[pos], sin[pos], kc, vc, pos, eps)
                torch.cuda.synchronize()
                want, _, _ = subtalker_step_rows(rows, x, cos[pos], sin[pos], kc_p, vc_p, pos, eps)
                for a, ref in ((got, want), (kc[:, :, pos], kc_p[:, :, pos]),
                               (vc[:, :, pos], vc_p[:, :, pos])):
                    err = (a.float() - ref.float()).abs().max().item()
                    limit = tol * ref.float().abs().max().item()
                    errs.append(err)
                    if not err <= limit:
                        fail(f"subtalker_step B={b} {dtype} pos={pos} disagrees with its plain "
                             f"version: {err} > {limit}")
            if subtalker_step.launches != before + groups:
                fail("subtalker_step did not count its launches")
            # Two launches on the same inputs: the same bits, output and rows.
            pos = groups // 2
            x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)
            runs = []
            for _ in range(2):
                k2, v2 = kc.clone(), vc.clone()
                out, _, _ = subtalker_step(packed, x, cos[pos], sin[pos], k2, v2, pos, eps)
                runs.append((out, k2, v2))
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(*runs))
            worst = max(worst, *errs)
            log(f"kernel check: subtalker_step B={b} {dtype} positions 0..{groups - 1}: "
                f"max_abs_err={max(errs):.3g} (tol {tol} x max|ref|); two launches on the same "
                f"inputs {'bit-identical' if same else 'DIFFER'}; cooperative launch "
                f"grid {grid} x {threads} threads, {smem} B dynamic shared")
            if not same:
                fail(f"subtalker_step B={b} {dtype}: two launches on the same inputs differ")
            if b == 32:  # rows do not mix: the first 4 rows alone give the same bits
                k4, v4 = kc[:, :4].clone(), vc[:, :4].clone()
                out4, _, _ = subtalker_step(packed, x[:4].contiguous(), cos[pos], sin[pos], k4,
                                            v4, pos, eps)
                torch.cuda.synchronize()
                rows_same = all(torch.equal(a, c) for a, c in (
                    (out4, runs[0][0][:4]), (k4, runs[0][1][:, :4]), (v4, runs[0][2][:, :4])))
                log(f"kernel check: subtalker_step {dtype} rows 0..3 of B=32 "
                    f"{'equal' if rows_same else 'DIFFER FROM'} the same rows at B=4")
                if not rows_same:
                    fail(f"subtalker_step {dtype}: B=32 rows differ from the same rows at B=4")
        del rows

    packed = packs[torch.bfloat16]
    barrier_us = time_grid_barrier(packed)
    log(f"kernel time: subtalker_step grid barrier {barrier_us:.3f} us each (events, "
        f"{launch_shape(torch.bfloat16, 4)[0]} blocks)")
    rows = {b: time_subtalker_step(packed, b, gen, groups, eps) for b in (4, 32)}
    path = rows[4]
    weights = sum(packed[k].numel() for k in ("wqkv", "wo", "wgu", "down"))
    rec = {
        "name": "subtalker_step", "route": "cuda",
        "source": "qwen_tts_tpu_torch/csrc/subtalker_step.cu",
        "replaces": "scripts/exp_pallas_subtalker_step.py:299",
        "shape": f"flagship sub-talker B=4 pos={path['pos']} of {groups} bf16, "
                 f"{weights / 1e6:.2f} M int8 weights; B=32 in 'b32'",
        "ms": path["ms"], "kernel_ms": path["ms"], "device_ms": path["device_ms"],
        "plain_ms": path["plain_ms"], "library_ms": None, "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"], "max_abs_err": worst, "barrier_us": barrier_us,
        "b32": rows[32],
    }
    log(f"kernel time: {json.dumps(rec)}")
    return rec


# scripts/exp_pallas_vocoder.py `BLOCKS` (c_in, c_out, rate, T_in at 128
# frames for batch 32): the codec's blocks 2 and 3, the two geometries the
# TPU kernel was written for. Kept here as numbers: this script imports
# nothing of JAX.
VOCODER_BLOCKS = {"b2": (384, 192, 4, 20480), "b3": (192, 96, 3, 81920)}
VOCODER_FRAMES = 128  # T_in above is 160 (b2) / 640 (b3) rows per frame
VOCODER_BATCH = 32
# The codec's residual units convolve 7 taps (its checkpoint's conv1
# weights, `codec_specs`); the TPU kernel was written for 3.
CODEC_RESUNIT_TAPS = 7


def vocoder_block_bound(b: int, t_in: int, c_in: int, c_out: int, rate: int, taps: int):
    """The least time the card could take for one vocoder block on these
    inputs: the bf16 input read once, the output written once, the weights
    (bf16) and per-channel vectors (f32) read once, against the transposed
    conv (2 taps of c_in x c_out per output row) and the 3 residual units
    (``taps``-tap and 1x1 convs, c_out x c_out) at the bf16 tensor-core rate.
    The SnakeBeta polynomials run beside them on the CUDA cores and are not
    counted. Returns (bound_ms, bound_by, bytes, flops)."""
    t_out = t_in * rate
    weights = 2 * (2 * rate * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    vectors = 4 * (2 * c_in + 19 * c_out)
    moved = 2 * b * (t_in * c_in + t_out * c_out) + weights + vectors
    flops = 2 * b * t_out * (2 * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_BF16_FLOPS * 1e3
    return (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations",
            moved, flops)


def random_vocoder_block(gen, c_in: int, c_out: int, rate: int, taps: int):
    """A bf16 codec block in the loader's layouts on ``gen``'s device: weights
    N(0, 1/fan_in), SnakeBeta alpha/beta exp(N(0, 0.1^2)), biases N(0, 0.01^2)."""
    import torch

    dev = gen.device

    def w(*shape, fan):
        return (torch.randn(*shape, generator=gen, device=dev) / math.sqrt(fan)).bfloat16()

    def snake(c):
        return (0.1 * torch.randn(c, generator=gen, device=dev)).exp().bfloat16()

    def bias(c):
        return (0.01 * torch.randn(c, generator=gen, device=dev)).bfloat16()

    units = [{"alpha1": snake(c_out), "beta1": snake(c_out),
              "conv1_w": w(taps, c_out, c_out, fan=taps * c_out), "conv1_b": bias(c_out),
              "alpha2": snake(c_out), "beta2": snake(c_out),
              "conv2_w": w(1, c_out, c_out, fan=c_out), "conv2_b": bias(c_out)}
             for _ in range(3)]
    return {"alpha": snake(c_in), "beta": snake(c_in),
            "tconv_w": w(2 * rate, c_in, c_out, fan=2 * c_in), "tconv_b": bias(c_out),
            "resunits": units}


def vocoder_block_library(x, block: dict, rate: int):
    """The library yardstick of ``vocoder_block``: the same block as a bf16
    composition of cuDNN convs (bias added by PyTorch, so it rounds twice
    where the kernel rounds once) and eager SnakeBeta passes, in PyTorch's
    channels-first layout. No single PyTorch call computes a fused block;
    this is timed here and used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    from qwen_tts_tpu_torch.ops.snake import snake_beta

    def snake(h, a, b):  # channels-first h [B, C, T]
        return snake_beta(h.transpose(1, 2), a, b).transpose(1, 2)

    h = snake(x.transpose(1, 2), block["alpha"], block["beta"])
    w = torch.flip(block["tconv_w"], dims=(0,)).permute(1, 2, 0)
    h = F.conv_transpose1d(h, w, block["tconv_b"], stride=rate)[..., : x.shape[1] * rate]
    for unit, d in zip(block["resunits"], (1, 3, 9)):
        a = snake(h, unit["alpha1"], unit["beta1"])
        reach = (unit["conv1_w"].shape[0] - 1) * d
        a = F.conv1d(F.pad(a, (reach, 0)), unit["conv1_w"].permute(2, 1, 0), unit["conv1_b"],
                     dilation=d)
        a = snake(a, unit["alpha2"], unit["beta2"])
        h = h + F.conv1d(a, unit["conv2_w"].permute(2, 1, 0), unit["conv2_b"])
    return h.transpose(1, 2)


def _device_us(fn, name: str, iters: int = 5) -> float:
    """Mean device time (us) of the kernels whose name holds ``name`` over
    ``iters`` calls, from torch.profiler; 0.0 if it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key)
    return total / iters


def hold_vocoder_block(x, block: dict, rate: int, label: str) -> float:
    """One counted launch of vocoder_block on x against vocoder_block_plain
    on the same input, within VOCODER_TOL x max |ref|. Returns (max |err|,
    the kernel's output)."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block, vocoder_block_plain

    before = vocoder_block.launches
    got = vocoder_block(x, block, rate)
    torch.cuda.synchronize()
    if vocoder_block.launches != before + 1:
        fail("vocoder_block did not count its launch")
    want = vocoder_block_plain(x, block, rate)
    if got.shape != want.shape or got.dtype != torch.bfloat16:
        fail(f"vocoder_block {label}: {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} bfloat16")
    err = (got.float() - want.float()).abs().max().item()
    limit = VOCODER_TOL * want.float().abs().max().item()
    log(f"kernel check: vocoder_block {label}: max_abs_err={err:.3g} (tol {limit:.3g} = "
        f"{VOCODER_TOL} x max|ref|)")
    if not err <= limit:
        fail(f"vocoder_block {label} disagrees with its plain version: {err} > {limit}")
    return err, got


def phase_kernels_vocoder_block():
    """vocoder_block against its plain version on the card (both geometries,
    the codec's 7-tap residual convs and the TPU kernel's 3-tap ones, B 1/4,
    a ragged last tile and a length shorter than one tile; the stream's first
    packet and windows at B=1), then timed, and held against the plain
    version again, at the TPU kernel's shapes (B=32, 128 frames; 3 and 7
    taps) and the path's (B=4, 64 frames, 7 taps). Returns the JSON record:
    its times are those of the two launches of one bf16 codec_decode at the
    path's shapes."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
        kernel_tile, vocoder_block, vocoder_block_plain)

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for taps in (CODEC_RESUNIT_TAPS, 3):
        for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
            block = random_vocoder_block(gen, c_in, c_out, rate, taps)
            l_ext, halo, smem = kernel_tile(c_in, c_out, rate, taps)
            t_tile = l_ext - halo
            # < one tile, a ragged last tile, exactly two tiles' inputs.
            cases = [(b, t_in) for t_in in (t_tile // rate - 5, 3 * t_tile // rate + 7,
                                            2 * t_tile // rate) for b in (1, 4)]
            if taps == CODEC_RESUNIT_TAPS:  # the stream's first packet and its windows
                cases += [(1, frames * t_in_128 // VOCODER_FRAMES)
                          for frames in (STREAM_FIRST, STREAM_CONTEXT + STREAM_CHUNK)]
            for b, t_in in cases:
                x = (0.5 * torch.randn(b, t_in, c_in, generator=gen, device="cuda")).bfloat16()
                err, _ = hold_vocoder_block(
                    x, block, rate, f"{name} {c_in}->{c_out} s={rate} K={taps} B={b} "
                    f"T_in={t_in} (T_out {t_in * rate}, tile {t_tile} + halo {halo}, "
                    f"{smem} B shared)")
                worst = max(worst, err)
    blocks = {(name, taps): random_vocoder_block(gen, c_in, c_out, rate, taps)
              for name, (c_in, c_out, rate, _) in VOCODER_BLOCKS.items()
              for taps in (3, CODEC_RESUNIT_TAPS)}

    rows = []
    # The TPU kernel's shapes with its own 3-tap units and with the codec's,
    # then the path's shapes with the codec's.
    for b, frames, taps in ((VOCODER_BATCH, VOCODER_FRAMES, 3),
                            (VOCODER_BATCH, VOCODER_FRAMES, CODEC_RESUNIT_TAPS),
                            (4, FRAMES, CODEC_RESUNIT_TAPS)):
        for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
            t_in = t_in_128 // VOCODER_FRAMES * frames
            block = blocks[name, taps]
            x = (0.5 * torch.randn(b, t_in, c_in, generator=gen, device="cuda")).bfloat16()
            iters = 5 if b == VOCODER_BATCH else 20
            kernel_ms = _time_ms(lambda: vocoder_block(x, block, rate), iters=iters, warmup=2)
            device_ms = _device_us(lambda: vocoder_block(x, block, rate),
                                   "vocoder_block_kernel") / 1e3
            plain_ms = _time_ms(lambda: vocoder_block_plain(x, block, rate), iters=3, warmup=1)
            library_ms = _time_ms(lambda: vocoder_block_library(x, block, rate), iters=iters,
                                  warmup=2)
            bound_ms, bound_by, moved, flops = vocoder_block_bound(b, t_in, c_in, c_out, rate,
                                                                   taps)
            row = {"block": name, "K": taps, "B": b, "frames": frames, "T_in": t_in,
                   "ms": kernel_ms,
                   "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "GB": moved / 1e9, "GFLOP": flops / 1e9}
            rows.append(row)
            log(f"kernel time: vocoder_block {json.dumps(row)}")
            err, _ = hold_vocoder_block(x, block, rate,
                                        f"{name} K={taps} B={b} T_in={t_in} (timed shape)")
            worst = max(worst, err)
            torch.cuda.empty_cache()
    path = [r for r in rows if r["B"] == 4]  # b2, then b3
    rec = {
        "name": "vocoder_block", "route": "cuda",
        "source": "qwen_tts_tpu_torch/csrc/vocoder_block.cu",
        "replaces": "scripts/exp_pallas_vocoder.py:138",
        "shape": f"blocks 2+3 of one bf16 codec_decode, B=4, {FRAMES} frames, 7-tap units "
                 f"(2 launches: b2 384->192 s=4 T_in {path[0]['T_in']}, b3 192->96 s=3 "
                 f"T_in {path[1]['T_in']}); per-block rows (B=4; B=32 x 128 frames with 3 "
                 f"and 7 taps) in 'blocks'",
        "ms": sum(r["ms"] for r in path), "plain_ms": sum(r["plain_ms"] for r in path),
        "library_ms": sum(r["library_ms"] for r in path),
        "bound_ms": sum(r["bound_ms"] for r in path), "bound_by": path[0]["bound_by"],
        "max_abs_err": worst, "blocks": rows,
    }
    return rec


def _counters():
    """The launch counters of the four kernel wrappers."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8)
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block

    return {"decode_attention": decode_attention, "decode_attention_int8": decode_attention_int8,
            "subtalker_step": subtalker_step, "vocoder_block": vocoder_block}


def _attention_splits():
    """Clear the attention wrappers' launch counts by n_split; returns a
    function that reads them."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8)

    for fn in (decode_attention, decode_attention_int8):
        fn.splits.clear()
    return lambda: {fn.__name__: dict(sorted(fn.splits.items()))
                    for fn in (decode_attention, decode_attention_int8) if fn.splits}


def phase_path(model_dir: str, smi: str, serving: bool = False):
    """``generate_custom_voice`` at the flagship dims, bf16 talker (phase 4)
    or, with ``serving``, after ``quantize_for_serving(talker=True, kv=True)``
    (phase 6). Returns each kernel's launches in the timed run."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    name = "serving" if serving else "path"
    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(model_dir)
    if serving:
        model.quantize_for_serving(talker=True, kv=True)
    log(f"{name}: from_pretrained (bf16 talker, f32 codec){' + int8 serving mode' * serving} "
        f"on {model.device} in {time.perf_counter() - t0:.1f} s; tokenizer loaded: "
        f"{model.tokenizer is not None}")
    model.tokenizer = ChatTemplateTokenizer()
    tk = model.cfg.talker
    g, talker_layers = tk.num_code_groups, tk.num_hidden_layers
    kw = dict(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1, seed=0)
    speakers = ["aiden", "serena", "aiden", "serena"]
    languages = ["english", "auto", "chinese", "english"]

    model.generate_custom_voice(TEXTS, speakers, languages, max_new_tokens=3)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    attention = _attention_splits()
    t0 = time.perf_counter()
    wavs, sr = model.generate_custom_voice(TEXTS, speakers, languages, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{name}: decode-attention launches by n_split {attention()} (the talker's "
        f"{MAX_NEW} x {model.cfg.talker.num_hidden_layers} over S_max = prompt bucket + "
        f"{MAX_NEW}; the sub-talker's over 16-17 slots)")
    if serving:
        expected = {"decode_attention": 0, "decode_attention_int8": MAX_NEW * talker_layers,
                    "subtalker_step": MAX_NEW * g, "vocoder_block": 0}
        how = (f"int8 attention {MAX_NEW} frames x {talker_layers} talker layers, "
               f"micro-step {MAX_NEW} frames x {g} groups, float attention and the f32 "
               f"codec's vocoder blocks 0")
    else:
        per_frame = talker_layers + g * tk.code_predictor.num_hidden_layers
        expected = {"decode_attention": MAX_NEW * per_frame, "decode_attention_int8": 0,
                    "subtalker_step": 0, "vocoder_block": 0}
        how = f"decode_attention {MAX_NEW} frames x {per_frame}, the others 0"
    log(f"{name}: launches {launches}, expected {expected} ({how})")
    if launches != expected:
        fail(f"the {name} phase did not launch the kernels as expected")
    want_len = FRAMES * model.cfg.codec.decode_upsample_rate
    for i, w in enumerate(wavs):
        if w.shape != (want_len,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            fail(f"waveform {i}: shape {w.shape}, finite {np.isfinite(w).all()}, "
                 f"max |x| {np.abs(w).max()}")
    audio_s = len(wavs) * want_len / sr
    log(f"{name}: generate_custom_voice B={len(wavs)} frames={FRAMES} ({MAX_NEW} decode "
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
    codec_wavs = model.decode_codes(codes)
    t_codec = time.perf_counter() - t0
    log(f"{name} split: decode loop {t_codes:.3f} s ({t_codes / MAX_NEW * 1e3:.2f} ms/step), "
        f"codec (f32) {t_codec:.3f} s | {smi}")
    profile_decode(model, prompts, dict(kw, max_new_tokens=9, min_new_tokens=10), smi, name)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "codes": codes, "wavs": codec_wavs, "codec_s": t_codec}


def profile_decode(model, prompts, kw, smi: str, name: str) -> None:
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
        log(f"{name} profile: the profiler saw no device time (not measured)")
        return
    log(f"{name} profile: decode loop {steps} steps B={len(prompts)}: wall {wall_ms:.1f} ms "
        f"(profiler on), device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {launches / steps:.0f} kernel launches/step | {smi}")
    for e in device[:12]:
        log(f"  {name} profile kernel: {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    for e in device:  # the port's own kernels, each per launch
        if any(k in e.key for k in PORT_KERNELS):
            log(f"  {name} profile port kernel: {e.self_device_time_total / e.count:.2f} us "
                f"device per launch, {e.count} launches: {e.key[:70]} | {smi}")


def _greedy_codes(model, device, texts, speakers, kw, forced=None):
    """f32 greedy codes [rows, frames, groups], every sampling call's logits
    (on the CPU) and token, and the talker KV caches as the run left them.
    With ``forced``, another run's tokens are taken at each call instead of
    this run's own (teacher forcing), so both runs see the same contexts."""
    import numpy as np

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod

    calls, caches = [], []
    originals = (gen_mod.sample_token, st_mod.sample_token, gen_mod.talker_mod.alloc_kv_cache)

    def recording(logits, cfg, generator, _orig=originals[0]):
        token = _orig(logits, cfg, generator)
        calls.append((logits.float().cpu(), token.cpu()))
        if forced is not None:
            token = forced[len(calls) - 1][1].to(token.device)
        return token

    def keeping(*args, _orig=originals[2], **kwargs):
        caches.append(_orig(*args, **kwargs))
        return caches[-1]

    gen_mod.sample_token = st_mod.sample_token = recording
    gen_mod.talker_mod.alloc_kv_cache = keeping
    try:
        t0 = time.perf_counter()
        prompts = [gen_mod.build_prompt(
            model.talker_params, model.cfg,
            model._tokenize(model.build_assistant_text(t)), speaker=s)
            for t, s in zip(texts, speakers)]
        codes, _ = model.generate_codes_from_prompts(prompts, model._merge_params(**kw))
    finally:
        gen_mod.sample_token, st_mod.sample_token, gen_mod.talker_mod.alloc_kv_cache = originals
    codes = np.stack(codes)
    log(f"parity: f32 greedy on {device}{' (teacher-forced)' * (forced is not None)}: "
        f"codes {codes.shape} in {time.perf_counter() - t0:.1f} s")
    return codes, calls, caches[-1]


def _min_margin(calls):
    import torch

    return min((torch.topk(lg, 2, dim=-1).values.diff(dim=-1).abs().min().item()
                for lg, _ in calls), default=float("inf"))


# Parity with the int8 KV cache. The talker quantizes every K/V row as it
# writes it, so where card and CPU differ by an f32 ulp (their sums run in
# another order) a value can sit on a rounding boundary and its int8 entry
# move by one step, 1/127 of its row's largest value; what follows moves with
# it. Codes are then compared teacher-forced (the CPU follows the card's
# tokens): int8 entries may differ by one step and no more, the logits of
# every call must agree within one such step of the largest logit, and every
# card token must be the CPU's argmax unless the CPU's top two logits lie
# within that.
KV_INT8_LOGIT_RTOL = 1 / 127


def phase_parity(model_dir: str, mode: str = "float"):
    """Greedy codes in f32 on the card and on the CPU. ``mode`` "float"
    (phase 5) and "int8" (phase 7, ``quantize_for_serving(talker=True)``):
    the free-running codes must be equal. "int8+kv" (phase 7,
    ``quantize_for_serving(talker=True, kv=True)``): compared teacher-forced,
    as ``KV_INT8_LOGIT_RTOL`` says. Every mode logs how far the logits of a
    teacher-forced CPU run lie from the card's."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=9, min_new_tokens=10)
    texts, speakers = TEXTS[:2], ["aiden", "serena"]
    name = f"parity [{mode}]"
    models = {}
    for device in ("cuda", "cpu"):
        model = Qwen3TTSModel.from_pretrained(model_dir, talker_dtype=torch.float32,
                                              device=device, load_tokenizer=False)
        if mode != "float":
            model.quantize_for_serving(talker=True, kv=mode == "int8+kv")
        model.tokenizer = ChatTemplateTokenizer()
        models[device] = model
    splits = _attention_splits()
    a, card_calls, card_cache = _greedy_codes(models["cuda"], "cuda", texts, speakers, kw)
    log(f"{name}: decode-attention launches on the card by n_split {splits()}")
    b, cpu_calls, _ = _greedy_codes(models["cpu"], "cpu", texts, speakers, kw)
    _, forced_calls, cpu_cache = _greedy_codes(models["cpu"], "cpu", texts, speakers, kw,
                                               forced=card_calls)
    if a.shape != (2, 8, 16):
        fail(f"{name}: unexpected code shape {a.shape}")
    if len(forced_calls) != len(card_calls):
        fail(f"{name}: {len(card_calls)} sampling calls on the card, {len(forced_calls)} on "
             f"the CPU")
    equal = a.shape == b.shape and bool((a == b).all())
    worst, scale = 0.0, 0.0
    for (lg_card, _), (lg_cpu, _) in zip(card_calls, forced_calls):
        live = lg_cpu > -1e8  # suppressed entries hold the same fill on both
        worst = max(worst, (lg_card - lg_cpu)[live].abs().max().item())
        scale = max(scale, lg_cpu[live].abs().max().item())
    log(f"{name}: free-running codes "
        f"{'equal' if equal else f'first differ at {np.argwhere(a != b)[:1].tolist()}'} for "
        f"{a.shape[0]} rows x {a.shape[1]} frames x {a.shape[2]} groups; smallest top-1/top-2 "
        f"logit margin {_min_margin(card_calls):.3g} (card), {_min_margin(cpu_calls):.3g} "
        f"(CPU); teacher-forced over {len(card_calls)} sampling calls: max |logit card - CPU| "
        f"{worst:.3g}, largest |logit| {scale:.3g}")
    if mode != "int8+kv":
        if not equal:
            fail(f"{name}: card and CPU greedy codes differ at (row, frame, group) "
                 f"{np.argwhere(a != b)[:5].tolist()}")
        return

    flips, entries, step = 0, 0, 0
    for kc_card, kc_cpu in zip(card_cache, cpu_cache):  # K, then V
        delta = (kc_card["i8"].cpu().int() - kc_cpu["i8"].int()).abs()
        flips += int((delta > 0).sum())
        entries += delta.numel()
        step = max(step, int(delta.max()))
    tol = KV_INT8_LOGIT_RTOL * scale
    ties, mismatched = 0, []
    for i, ((_, tok), (lg_cpu, _)) in enumerate(zip(card_calls, forced_calls)):
        top2 = torch.topk(lg_cpu, 2, dim=-1)
        for row in range(lg_cpu.shape[0]):
            if tok[row] == top2.indices[row, 0]:
                continue
            if top2.values[row, 0] - top2.values[row, 1] <= tol:
                ties += 1
            else:
                mismatched.append((i, row))
    log(f"{name}: teacher-forced: talker int8 KV entries that differ {flips} of {entries} "
        f"(largest step {step}); max |logit card - CPU| {worst:.3g} (tol {tol:.3g} = "
        f"largest |logit| / 127); card token != CPU argmax at {ties} near-tie(s) and "
        f"{len(mismatched)} other position(s)")
    if mismatched or step > 1 or not worst <= tol:
        fail(f"{name}: card and CPU disagree: calls/rows {mismatched[:5]}, int8 KV step "
             f"{step}, max logit diff {worst:.3g}")


def phase_codec_bf16(model_dir: str, smi: str, path: dict) -> None:
    """The bf16 codec on the path phase's codes: the vocoder-block kernel
    launches twice per codec_decode call; the waveforms are finite, in
    [-1, 1] and 1920 samples per frame. Teacher-forced, each launch in a
    decode is held against the plain version on its own input. Before the
    clamp the waveforms lie within BF16_CODEC_REL_L2 of the same decode
    through the block's plain version. (The random codec drives ~99% of its
    samples into the clamp, where a sign flip of a large value reads as a
    difference of 2, so that comparison scales the final conv, the last op
    before the clamp, by 2^-20: exact in bf16, it gives the unclamped
    waveform x 2^-20.)"""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.models import codec as codec_mod
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block, vocoder_block_plain
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    log(f"codec bf16: from_pretrained (bf16 talker, bf16 codec) in "
        f"{time.perf_counter() - t0:.1f} s")
    codes = path["codes"]
    model.decode_codes(codes)  # warm-up
    torch.cuda.synchronize()
    calls = []
    original = codec_mod.codec_decode

    def counting(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    codec_mod.codec_decode = counting
    try:
        for fn in _counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        wavs = model.decode_codes(codes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        codec_mod.codec_decode = original
    launches = {k: fn.launches for k, fn in _counters().items()}
    expected = {"decode_attention": 0, "decode_attention_int8": 0, "subtalker_step": 0,
                "vocoder_block": 2 * len(calls)}
    log(f"codec bf16: launches {launches}, expected {expected} (2 vocoder blocks x "
        f"{len(calls)} codec_decode call(s))")
    if launches != expected or not calls:
        fail("the bf16 codec did not launch the vocoder-block kernel as expected")
    want_len = [c.shape[0] * model.cfg.codec.decode_upsample_rate for c in codes]
    for i, (w, n) in enumerate(zip(wavs, want_len)):
        if w.shape != (n,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            fail(f"bf16 codec waveform {i}: shape {w.shape} (want {n}), finite "
                 f"{np.isfinite(w).all()}, max |x| {np.abs(w).max()}")

    a = np.concatenate(wavs)
    f32 = np.concatenate(path["wavs"])
    rel_f32 = float(np.linalg.norm(a - f32) / np.linalg.norm(f32))
    log(f"codec bf16: bf16 vs f32 codec (not asserted): relative L2 {rel_f32:.4g}, max |diff| "
        f"{np.abs(a - f32).max():.4g}, unclipped share {np.mean(np.abs(a) < 1):.4f}")

    def holding(x, block, rate):
        return hold_vocoder_block(x, block, rate, f"in codec_decode, C_in={x.shape[2]} "
                                  f"B={x.shape[0]} T_in={x.shape[1]} (teacher-forced)")[1]

    full = model.codec_params
    model.codec_params = dict(full, final_conv_w=full["final_conv_w"] * 2.0 ** -20,
                              final_conv_b=full["final_conv_b"] * 2.0 ** -20)
    try:
        codec_mod.vocoder_block = holding
        model.decode_codes(codes)
        codec_mod.vocoder_block = vocoder_block
        kernel = np.concatenate(model.decode_codes(codes))
        codec_mod.vocoder_block = vocoder_block_plain
        plain = np.concatenate(model.decode_codes(codes))
    finally:
        codec_mod.vocoder_block = vocoder_block
        model.codec_params = full
    if not np.abs(plain).max() < 1:
        fail(f"bf16 codec: the scaled final conv still reaches the clamp ({np.abs(plain).max()})")
    rel = float(np.linalg.norm(kernel - plain) / np.linalg.norm(plain))
    log(f"codec bf16: kernel route vs plain route on the card, before the clamp: relative L2 "
        f"{rel:.4g} (tol {BF16_CODEC_REL_L2}), max |diff| "
        f"{np.abs(kernel - plain).max() * 2 ** 20:.4g} of max |ref| "
        f"{np.abs(plain).max() * 2 ** 20:.4g}")
    if not rel <= BF16_CODEC_REL_L2:
        fail(f"bf16 codec through the kernel disagrees with the plain route: {rel}")
    audio_s = sum(want_len) / model.sample_rate
    log(f"codec bf16: decode_codes B={len(codes)} frames={codes[0].shape[0]} wall "
        f"{wall:.4f} s (f32 codec in the path phase {path['codec_s']:.4f} s), audio "
        f"{audio_s:.2f} s | {smi}")
    del model
    torch.cuda.empty_cache()


def _recording_segments(pipeline_mod, frames: list):
    """Wrap the pipeline's first-packet program and decode_segment so every
    frame the stream generates is appended to ``frames`` (row 0's num_gen
    delta of each call). Returns the originals."""
    originals = (pipeline_mod._first_packet_program, pipeline_mod.decode_segment)

    def recording(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            n = int(out[0].num_gen[0])
            frames.extend(out[1][0, : n - len(frames)].cpu().numpy())
            return out
        return wrapped

    pipeline_mod._first_packet_program = recording(originals[0])
    pipeline_mod.decode_segment = recording(originals[1])
    return originals


def phase_stream(model_dir: str, smi: str):
    """``stream_custom_voice`` at the flagship dims, bf16 talker and codec,
    B=1, greedy, EOS banned. Returns the kernels' launches in the timed
    stream."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import pipeline as pipeline_mod
    from qwen_tts_tpu_torch.generate import batch_prompts, build_prompt, generate_codes
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    model.tokenizer = ChatTemplateTokenizer()
    text, speaker, language = TEXTS[0], "aiden", "english"
    kw = dict(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1, do_sample=False,
              subtalker_dosample=False, repetition_penalty=1.0)
    first, chunk, ctx = STREAM_FIRST, STREAM_CHUNK, STREAM_CONTEXT
    for _ in model.stream_custom_voice(text, speaker, language, **dict(kw, max_new_tokens=4)):
        pass  # warm-up
    torch.cuda.synchronize()

    frames = []
    originals = _recording_segments(pipeline_mod, frames)
    for fn in _counters().values():
        fn.launches = 0
    try:
        chunks, stamps = [], []
        t0 = time.perf_counter()
        for wav, sr in model.stream_custom_voice(text, speaker, language,
                                                 first_chunk_frames=first, chunk_frames=chunk,
                                                 left_context_frames=ctx, **kw):
            stamps.append(time.perf_counter() - t0)
            chunks.append(wav)
        wall = time.perf_counter() - t0
    finally:
        pipeline_mod._first_packet_program, pipeline_mod.decode_segment = originals
    launches = {k: fn.launches for k, fn in _counters().items()}

    up = model.cfg.codec.decode_upsample_rate
    sizes = [c.shape[0] // up for c in chunks]
    # MAX_NEW frames generated, the budget-exhausted last one dropped.
    schedule = [first] + [chunk] * ((FRAMES - first) // chunk)
    if (FRAMES - first) % chunk:
        schedule.append((FRAMES - first) % chunk)
    tk = model.cfg.talker
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    expected = {"decode_attention": MAX_NEW * per_frame, "decode_attention_int8": 0,
                "subtalker_step": 0, "vocoder_block": 2 * len(schedule)}
    gaps = np.diff([0.0] + stamps)
    audio_s = sum(c.shape[0] for c in chunks) / model.sample_rate
    log(f"stream: B=1 first_chunk {first}, chunk {chunk}, left context {ctx} frames: "
        f"{len(chunks)} chunks of {sizes} frames, {sum(c.shape[0] for c in chunks)} samples; "
        f"first-packet latency {stamps[0] * 1e3:.2f} ms; chunk wall times (ms) "
        f"{[round(float(g) * 1e3, 2) for g in gaps]}; wall {wall:.3f} s, audio {audio_s:.2f} s, "
        f"RTF(audio/wall) {audio_s / wall:.3f} | {smi}")
    log(f"stream: launches {launches}, expected {expected} (decode_attention {MAX_NEW} frames "
        f"x {per_frame}; vocoder_block 2 per codec window, {len(schedule)} windows)")
    if sizes != schedule or sum(c.shape[0] for c in chunks) != FRAMES * up:
        fail(f"stream: chunks of {sizes} frames, want {schedule} ({FRAMES} x {up} samples)")
    for i, c in enumerate(chunks):
        if not np.isfinite(c).all() or np.abs(c).max() > 1:
            fail(f"stream chunk {i}: finite {np.isfinite(c).all()}, max |x| {np.abs(c).max()}")
    if launches != expected:
        fail("the stream did not launch the kernels as its chunk schedule predicts")

    prompt = build_prompt(model.talker_params, model.cfg,
                          model._tokenize(model.build_assistant_text(text)),
                          language=language, speaker=speaker)
    embeds, mask, trailing, _ = batch_prompts([prompt], bucket=16)
    params = model._merge_params(**kw)
    dtype = model.talker_params["norm"].dtype
    out = generate_codes(model.talker_params, model.subtalker_params, tk, embeds.to(dtype),
                         mask, trailing.to(dtype), sampling=params.talker_sampling(),
                         st_sampling=params.subtalker_sampling(), max_new_tokens=MAX_NEW,
                         generator=None)
    oneshot = out.codes[0, : int(out.num_gen[0])].cpu().numpy()
    streamed = np.stack(frames)[:FRAMES]
    equal = streamed.shape == oneshot.shape and bool((streamed == oneshot).all())
    log(f"stream: greedy codes {streamed.shape} "
        f"{'equal' if equal else 'differ from'} generate_codes at prompt bucket 16 "
        f"{oneshot.shape}")
    if not equal:
        fail("streamed codes differ from the one-shot codes")
    del model
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    smi = phase_device()
    import torch

    phase_build()
    prefill_bucket = 32
    records = phase_kernels(prefill_bucket + MAX_NEW)
    records.append(phase_kernels_vocoder_block())
    model_dir = tempfile.mkdtemp(prefix="qtts_smoke_")
    try:
        cfg = flagship_config()
        t0 = time.perf_counter()
        write_checkpoint(model_dir, cfg, seed=1234)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(model_dir) for f in fs)
        log(f"checkpoint: random weights at flagship dims, {size / 2**30:.2f} GiB, "
            f"written in {time.perf_counter() - t0:.1f} s")
        path = phase_path(model_dir, smi)
        phase_parity(model_dir)
        serving = phase_path(model_dir, smi, serving=True)
        phase_parity(model_dir, "int8")
        phase_parity(model_dir, "int8+kv")
        phase_codec_bf16(model_dir, smi, path)
        stream = phase_stream(model_dir, smi)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    # Each kernel's launches come from the run of the path that uses it.
    records[0]["launches"] = path["launches"]["decode_attention"]
    records[1]["launches"] = serving["launches"]["decode_attention_int8"]
    records[2]["launches"] = serving["launches"]["subtalker_step"]
    records[3]["launches"] = stream["vocoder_block"]
    print(json.dumps({"kernels": records}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
