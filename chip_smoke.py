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
   vocoder block: both geometries, B 1/4, lengths one row under, at and over
   a tile and of several tiles, the stream's first packet and windows; the
   int8-weight GEMM: the talker layer's 4 launches (q|k|v and gate|up
   grouped, each grouped output the bits of its single launch) and the LM
   head, M 1/4/32/128, both dtypes), then its time beside the plain
   version, a library yardstick where one exists and the bound (the
   vocoder block is held against its plain version, and two launches
   against each other, at its timed shapes too; its bound counts the
   SnakeBeta instructions of the built kernel's SASS beside bytes and
   tensor-core operations; the int8 GEMM's launches are timed over 20
   layers' weights beside the same products as single launches, the cast +
   cuBLAS route and torch._weight_int8pack_mm, with a per-block timeline;
   its check also takes the sub-talker layer's launches, M 64 (the Jacobi
   forward's B x G) and the fused q|k|v and gate|up weights as one launch
   each, bit for bit the grouped launch);
3b. batch invariance: a row's bits alone and among others, on the card:
   decode attention (both caches; B 1/4/32; S_max 97 and 2080; moved by
   left padding), the micro-step (B 1/4/32) and the int8 GEMM's grouped and
   single launches (M 1/4/32); then, reported and not held, the plain bf16
   ops around them (the talker's LM head, the text projection, rms_norm,
   the sub-talker's f32 head product) at M 1/4/8/32;
4. path: writes a random-weight checkpoint at the flagship 12 Hz dims,
   loads it with ``Qwen3TTSModel.from_pretrained`` and runs
   ``generate_custom_voice`` for a batch of 4 (talker bf16, codec f32,
   sampled, fixed length); the decode replays one captured CUDA graph per
   frame (a warm-up call at the same shapes captures it); the
   decode-attention launch count, captured launches x replays, must be
   exactly frames x (talker layers + groups x sub-talker layers); then the
   decode loop and the whole call timed through the graphs and eagerly, two
   runs each in turns (ms/step, RTF, peak memory), and torch.profiler over a
   16-frame decode segment each way (device idle share against three
   unprofiled runs, host launch calls per frame), the replayed one through
   ``utils.profile_trace``, whose written trace must hold exactly the
   decode-attention launches the wrappers counted in it; then the native
   host runtime (``io/native.py``, built with g++): a flagship shard's bf16
   tensor through ``NativeMap.view`` and ``bf16_to_f32`` against the
   reader and torch's cast, bit for bit, and ``write_wav`` against
   ``io/wav.py`` (same header, samples by the runtime's rounding);
5. parity: the same checkpoint in f32 on the card and on the CPU must give
   the same greedy codes (the card's recorded run eager, its replayed codes
   equal to them); then ``validation.check_parity`` on the card at full
   depth, one prompt, ``ORACLE_TOKENS`` greedy tokens: the captured frames
   against the cache-free oracle token for token, the stop included, or
   apart only at a near tie (``ORACLE_NEAR_TIE_REL``);
6. serving: the same checkpoint and texts after
   ``quantize_for_serving(talker=True, kv=True)``; the micro-step kernel must
   launch exactly frames x groups times, the int8-cache attention frames x
   talker layers times, the int8 GEMM (prefill + frames) x talker layers x 4
   (q|k|v, o, gate|up, down) + frames x 15 LM heads, the float-cache
   attention not at all; no int8
   weight may be cast whole; each text's greedy codes alone against its row
   of the batch of 4 (reported as rows equal / 4); timed as phase 4;
7. serving parity: phase 5 with int8 weights (``quantize_for_serving(
   talker=True)``, codes equal), then with the int8 KV cache as well
   (``kv=True``), compared teacher-forced (see ``KV_INT8_LOGIT_RTOL``), then
   so again with the sub-talker's cache int8 too (``QTTS_ST_KV8=1``: its
   micro-decode layer by layer through the int8-cache attention kernel);
8. bf16 codec: ``from_pretrained(codec_dtype=torch.bfloat16)`` and
   ``decode_codes`` of the path phase's codes; the fused vocoder-block kernel
   must launch twice per codec call (blocks 2 and 3) and the whole decode,
   before the clamp, must lie within ``BF16_CODEC_REL_L2`` of the same decode
   with the block's plain version; the f32 codec of phase 4 launches it not
   at all; the bf16 and f32 codecs' decode walls, five calls each;
9. streaming: ``stream_custom_voice`` (bf16 talker, bf16 codec, B=1, greedy,
   EOS banned): the first packet one graph replay, the later segments
   replays of the captured frame, the later codec windows replays of one
   graph; first-packet latency, each chunk's wall time, the RTF; the chunks
   must hold frames x 1920 samples, the kernels must launch exactly as the
   chunk schedule predicts (with the frames replayed past the last row's end
   before the next flag read), and the streamed codes must equal
   ``generate_codes`` at the stream's prompt bucket (16); two streams each
   through the graphs and eagerly, in turns, and the eager first packet
   stage by stage (CUDA events); then the demo's custom-voice callback
   (``demo.py`` under a gradio stand-in, greedy controls) against the
   direct ``generate_custom_voice``, bit for bit;
10. graphs: the replayed decode against the eager frame loop, each through
   the module's own function, bit for bit (codes, buffer, state): bf16,
   serving and serving + int8 KV at B=4 and GRAPH_FRAMES frames, the talker
   cut to its first GRAPH_TALKER_LAYERS layers, with EOS banned
   and with EOS allowed (rows stop at different frames, frames run past the
   last row's end); sampled, one seed twice identical, another seed
   different, graph == eager; the B=1 first packet one graph replay, codes
   equal to the eager three-stage program's and its waveform within
   ``BF16_CODEC_REL_L2``. Each phase logs its graphs' capture cost; each
   mode times the replayed segment five times (ms a frame, median) and
   profiles one replay (device busy a frame, the int8 GEMM's device time a
   frame);
11. clone: a Base variant of the checkpoint (links to the talker and codec
   files, plus random ECAPA-TDNN and Mimi encoder weights at the published
   widths); ``create_voice_clone_prompt`` (ICL) of four ragged reference
   clips (2 and 3 s at 24 kHz, 4.5 and 6 s at 16 kHz, resampled), timed per
   clip and by stage (resample, Mimi encode, x-vector), and one
   x-vector-only prompt; the x-vectors finite, ``enc_dim`` long and apart;
   then ``generate_voice_clone`` for the batch of 4 (bf16 talker, f32 codec,
   EOS banned) through the graphs (the ICL prompts land in a new prompt
   bucket, captured anew): decode-attention launches exactly frames x
   (talker layers + groups x sub-talker layers), each waveform 64 x 1920
   samples once the reference frames are cut; both decode-attention kernels
   (float and int8 caches) held against their plain versions at the clone
   batch's talker cache (prompt bucket + MAX_NEW slots, a split no earlier
   phase holds), with the batch's own left pads; the decode loop and the whole
   call timed five runs each in turns; the x-vector-only prompt over the 4
   texts; the serving mode with phase 6's launch counts and no whole int8
   cast; the bf16 codec on the merged reference + generated codes (up to
   139 frames), held as phase 8 holds it; f32 card against CPU: the Mimi
   codes of the four clips agree at >= ``CLONE_CODE_AGREEMENT`` with
   near-ties only, the x-vectors within ``CLONE_XVEC_REL_L2``, and greedy
   clone codes from the card's prompt saved as a ``.pt`` voice file and
   loaded are equal; ``Qwen3TTSTokenizer`` on the Base checkpoint's speech
   tokenizer: its encode gives the prompt's Mimi codes and its decode the
   model's ``decode_codes``, bit for bit;
12. serving: the engines on the same checkpoint in the serving mode (int8
   weights and KV cache), f32 codec, EOS banned, greedy unless stated. The
   continuous engine (8 slots, 25-frame segments, ceiling 96, prefill
   bucket 32) takes 16 requests (the texts in 4 voices, budgets 32 / 48 /
   64 / 96, four each) from 4 client threads at once: a first run (its
   captures), then 2 runs each with double-buffered and synchronous
   dispatch in turns (wall, audio over wall, per-request latency, segments,
   stale skips, the engine's phase times, kernel launches); no capture
   after the first run, every run the first run's codes, no whole int8
   cast, each request's codes equal to the same request alone through
   ``generate_codes_from_prompts`` at the engine's ceiling (or first apart
   at a near tie, ``SERVING_NEAR_TIE``), and both decode-attention kernels
   held against their plain versions at the pool's real per-row depths.
   Four greedy and four sampled requests (per-row temperature, top-k,
   top-p, repetition penalty, sub-talker sampling) in one pool: the greedy
   rows' codes equal the all-greedy pool's, all codes in range. The window
   engine: two windows of 8 requests of 4 budgets on one frame program,
   codes equal alone. The frame programs' replays timed (events; the sorts'
   device share from a profile). HTTP over the continuous engine:
   /healthz, /tts (a 24 kHz WAV of its length), /stream (de-chunked PCM16 of
   its length, the first chunk's latency over 3 streams); on the Base
   checkpoint (prefill buckets 32 and 96) a /clone_voice from inline PCM,
   taken while another request decodes, and a /tts in that voice;
13. fast modes (``phase_fast_modes``, at the talker cut to
   ``FAST_TALKER_LAYERS`` layers): fused trunk projections (bf16 and
   the serving mode), the Jacobi sub-talker (B 4 and 8), the sub-talker int8
   KV cache and the sub-talker's gates in the captured programs' keys, on
   the same checkpoint: codes against the routes they replace (near ties
   allowed), launches exact, the captured Jacobi frame against the eager
   adaptive loop bit for bit, ms a frame, one capture per gate flip, and
   ``QTTS_ST_SPLIT`` bit-identical;
14. 25 Hz tokenizer (``phase_tokenizer_25hz``): a random checkpoint at the
   JAX package's 25 Hz widths (the DiT 22 x 1024, BigVGAN 1536 channels at
   rates 5·3·2·2·2·2, Whisper-VQ 16 x 1280, a CAM++-style ONNX graph);
   ``Qwen3TTSTokenizer`` f32 on the card against the CPU (the DiT's mel and
   the waveform before the clamp under one initial noise, Whisper-VQ codes
   with near ties only, reference mels, x-vectors), then the bf16 decode of
   8 rows x 250 codes timed (DiT against BigVGAN by events, RTF, peak
   memory) beside its compute bounds, the encode of phase 11's clips timed,
   and one decode profiled (top ops, idle share). No kernel of the port's
   is on this path;
15. training (``phase_training``): the port's SFT entry
   (``training/sft_12hz.py``'s ``train`` on its parsed flags) on phase 11's
   Base checkpoint in f32, 8 rows of 40-150 frames at B=2, one epoch, remat
   off (one step profiled) and on: losses finite and equal within
   ``TRAIN_REMAT_LOSS_RTOL``, step ms, tokens/s, the peak memory lower with
   remat, the export's and the snapshot's seconds; the snapshot restored at
   full width and a step timed with and without deterministic algorithms
   (the deterministic steps bit-identical); at the talker cut to 4 layers,
   card against CPU (loss, terms, every gradient leaf, the params after 2
   steps, each within a tolerance set before the first run) and resume (2
   steps, snapshot, restore into fresh state, 2 steps == 4 straight steps
   bit for bit); the export loaded by ``from_pretrained`` speaking 8 greedy
   frames in the new voice (its speaker row the baked embedding); the EMA
   VQ at the Whisper-VQ widths, 3 steps card against CPU (codes with near
   ties only, untouched codes' buffers), then one k-means-initialised step
   with dead-code expiry. No kernel of the port's is on the training path;
16. parallelism (``phase_parallel``), on the one card: (a) the two-stage
   talker | codec pipeline (``parallel/pipeline.py``) with both stages on
   cuda:0, two streams, bf16 talker and codec, B=1, greedy: codes equal to
   ``generate_codes`` at its prompt bucket, each chunk the bits of its
   window's ``codec_decode`` alone, the vocoder block's launches exact, the
   wall beside the two stages' device times; (b) a child with a one-rank
   NCCL group, tp 1, the bf16 path through the captured frames: codes equal
   to the run with no group, the NCCL kernels of a profiled replayed segment
   against the all-reduces the code issues a frame, ms a frame with and
   without the group, and the frame captured again with its all-reduces as
   averages (one kernel each on one rank): the same codes, one more kernel
   in the replay for each collective; (c) four children at dp 2 x tp 2 over
   gloo sharing the card, f32, B=4, 16 greedy frames (eager): codes equal on every rank
   of a dp shard and equal to the unsharded f32 run or first apart at a near
   tie, decode attention launched exactly per rank at the shard's heads, and
   one dp-2 EMA VQ step at the Whisper-VQ widths against the full-batch step;
   decode attention held against its plain version at the tp shard's
   shapes; (d) the SFT CLI's run with ``--dp 2 --tp 2`` in the four ranks of
   (c), as under a launcher, on the Base checkpoint with the talker cut to 4
   layers: the step-0 loss against one device's, the snapshot's tensors one
   device's names, shapes and dtypes; the tp serving engine
   (``continuous.py``): (c)'s ranks run two tp-2 engines at once, one per dp
   shard, f32, 3 greedy requests over 2 slots in segments of 2 frames, each
   led by its tp rank 0, the leaders' codes equal to the unsharded engine's
   on this process (or first apart at a near tie), each follower's segments
   equal to its leader's; (b)'s child runs the engine on its one-rank NCCL
   group (its own leader, bf16, captured frames), codes equal to the
   unsharded engine's; frames a second and launches of each. The children
   load the kernels phase 2 built.

Phase 7's ``QTTS_ST_KV8=1`` run also feeds the card's sub-talker int8 cache
to the CPU (``hold_fed_subtalker_kv``) and holds the logits within
``KV8_FED_LOGIT_RTOL``.

Each phase logs its seconds (``time: ...``). The line before the last holds
the kernels' JSON records; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or ``qwen_tts_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

# Deterministic cuBLAS, which the train step (phase 15) needs: read when the
# process first uses cuBLAS. On Hopper it is also the default workspace.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
KERNEL_SOURCES = ("decode_attention", "subtalker_step", "vocoder_block", "int8_matmul")
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
# The codec windows of a B=1 stream: its first packet, the second (the first
# packet's frames as context), and every later one.
STREAM_FRAMES = (STREAM_FIRST, STREAM_FIRST + STREAM_CHUNK, STREAM_CONTEXT + STREAM_CHUNK)

# Voice clone (phase 11): four reference clips, ragged, (seconds, sample
# rate); the last two at 16 kHz, so the resampler runs. Each has a text.
CLONE_CLIPS = ((2.0, 24000), (3.0, 24000), (4.5, 16000), (6.0, 16000))
CLONE_REF_TEXTS = [
    "This is the first reference voice.",
    "A second speaker reads a slightly longer line.",
    "The third clip was recorded at sixteen kilohertz.",
    "And the fourth, the longest of the four, at sixteen kilohertz as well.",
]
# Card against CPU on the clone's encoders, f32: the x-vectors within this
# relative L2 (the convs and FFT sum in other orders); the Mimi codes agree
# at least at CLONE_CODE_AGREEMENT, and where a quantizer branch of a frame
# first parts the two codes' distances lie within CLONE_NEAR_TIE_REL.
CLONE_XVEC_REL_L2 = 1e-4
CLONE_CODE_AGREEMENT = 0.99
CLONE_NEAR_TIE_REL = 1e-5


_STARTED = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout after the process's seconds so far (where a run's
    time goes)."""
    print(f"[{time.perf_counter() - _STARTED:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    """Logs ``msg`` as the run's failure, on stdout and on stderr (whose end a
    caller that keeps only that still sees), and exits 1."""
    log(f"FAIL: {msg}")
    print(f"FAIL: {msg[-4000:]}", file=sys.stderr, flush=True)
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


def speaker_specs(se):
    """ECAPA-TDNN tensors of a Base checkpoint (``speaker_encoder.*``, convs
    [C_out, C_in, K]) for the speaker-encoder config ``se``."""
    ch, ks = se.enc_channels, se.enc_kernel_sizes
    specs = []

    def conv(name, cin, cout, k):
        specs.extend([(f"speaker_encoder.{name}.weight", (cout, cin, k), cin * k),
                      (f"speaker_encoder.{name}.bias", (cout,), "zeros")])

    conv("blocks.0.conv", se.mel_dim, ch[0], ks[0])
    for i in range(1, len(ch) - 1):
        width = ch[i] // se.enc_res2net_scale
        conv(f"blocks.{i}.tdnn1.conv", ch[i - 1], ch[i], 1)
        for j in range(se.enc_res2net_scale - 1):
            conv(f"blocks.{i}.res2net_block.blocks.{j}.conv", width, width, ks[i])
        conv(f"blocks.{i}.tdnn2.conv", ch[i], ch[i], 1)
        conv(f"blocks.{i}.se_block.conv1", ch[i], se.enc_se_channels, 1)
        conv(f"blocks.{i}.se_block.conv2", se.enc_se_channels, ch[i], 1)
    conv("mfa.conv", sum(ch[1:-1]), ch[-1], ks[-1])
    conv("asp.tdnn.conv", ch[-1] * 3, se.enc_attention_channels, 1)
    conv("asp.conv", se.enc_attention_channels, ch[-1], 1)
    conv("fc", ch[-1] * 2, se.enc_dim, 1)
    return specs


def mimi_specs(mc):
    """The Mimi encoder's tensors (``encoder.*``, the transformers MimiModel
    names the port's loader reads) for the config ``mc``: SEANet, the
    transformer, the downsample conv and the split RVQ's codebooks (usage
    > 0)."""
    specs = []

    def conv(name, cin, cout, k, bias=True):
        specs.append((f"encoder.{name}.weight", (cout, cin, k), cin * k))
        if bias:
            specs.append((f"encoder.{name}.bias", (cout,), "zeros"))

    conv("encoder.layers.0.conv", mc.audio_channels, mc.num_filters, mc.kernel_size)
    idx, dim = 1, mc.num_filters
    for ratio in reversed(mc.upsampling_ratios):
        for j in range(mc.num_residual_layers):
            conv(f"encoder.layers.{idx}.block.1.conv", dim, dim // mc.compress,
                 mc.residual_kernel_size)
            conv(f"encoder.layers.{idx}.block.3.conv", dim // mc.compress, dim, 1)
            idx += 1
        conv(f"encoder.layers.{idx + 1}.conv", dim, 2 * dim, 2 * ratio)
        idx, dim = idx + 2, 2 * dim
    conv(f"encoder.layers.{idx + 1}.conv", dim, mc.hidden_size, mc.last_kernel_size)
    d, qd = mc.hidden_size, mc.num_attention_heads * mc.head_dim
    kvd = mc.num_key_value_heads * mc.head_dim
    for i in range(mc.num_hidden_layers):
        p = f"encoder.encoder_transformer.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (d,), "ones"),
            (p + "input_layernorm.bias", (d,), "zeros"),
            (p + "self_attn.q_proj.weight", (qd, d), d),
            (p + "self_attn.k_proj.weight", (kvd, d), d),
            (p + "self_attn.v_proj.weight", (kvd, d), d),
            (p + "self_attn.o_proj.weight", (d, qd), qd),
            (p + "post_attention_layernorm.weight", (d,), "ones"),
            (p + "post_attention_layernorm.bias", (d,), "zeros"),
            (p + "mlp.fc1.weight", (mc.intermediate_size, d), d),
            (p + "mlp.fc2.weight", (d, mc.intermediate_size), mc.intermediate_size),
            (p + "self_attn_layer_scale.scale", (d,), 0.01),
            (p + "mlp_layer_scale.scale", (d,), 0.01),
        ]
    conv("downsample.conv", d, d, 4, bias=False)
    # Codewords N(0, 1/16) per entry before the usage division: |e|² about
    # 16, the size of the residuals they quantize at these random weights,
    # so the codes change from frame to frame (N(0, 1) codewords, ~17x the
    # residuals, leave ~3 distinct codes a clip).
    vq = mc.vector_quantization_hidden_dimension
    for branch, n in (("semantic", mc.num_semantic_quantizers),
                      ("acoustic", mc.num_quantizers - mc.num_semantic_quantizers)):
        p = f"encoder.quantizer.{branch}_residual_vector_quantizer."
        specs.append((p + "input_proj.weight", (vq, d, 1), d))
        for q in range(n):
            specs += [(f"{p}layers.{q}.codebook.cluster_usage", (mc.codebook_size,), "usage"),
                      (f"{p}layers.{q}.codebook.embed_sum", (mc.codebook_size, mc.codebook_dim),
                       16)]
    return specs


def write_base_checkpoint(model_dir: str, base_dir: str, cfg, mimi_cfg, seed: int,
                          device: str = "cuda") -> None:
    """A Base checkpoint in ``base_dir`` beside the one ``write_checkpoint``
    put in ``model_dir``: its talker and codec files are links to those, and
    it adds the speaker encoder (``speaker_encoder.safetensors``), the Mimi
    encoder (``speech_tokenizer/encoder.safetensors``) and configs that say
    so (``tts_model_type`` "base", ``speaker_encoder_config``,
    ``encoder_config`` and the codec's rates from ``cfg``)."""
    import torch

    from qwen_tts_tpu_torch.io.safetensors import save_file

    gen = torch.Generator(device=device).manual_seed(seed)
    os.makedirs(os.path.join(base_dir, "speech_tokenizer"))
    for rel in ("model.safetensors", os.path.join("speech_tokenizer", "model.safetensors")):
        os.symlink(os.path.abspath(os.path.join(model_dir, rel)), os.path.join(base_dir, rel))
    save_file(make_tensors(speaker_specs(cfg.speaker_encoder), torch.float32, gen),
              os.path.join(base_dir, "speaker_encoder.safetensors"))
    save_file(make_tensors(mimi_specs(mimi_cfg), torch.float32, gen),
              os.path.join(base_dir, "speech_tokenizer", "encoder.safetensors"))
    for rel, extra in (
            ("config.json", {"tts_model_type": "base",
                             "speaker_encoder_config": dataclasses.asdict(cfg.speaker_encoder)}),
            (os.path.join("speech_tokenizer", "config.json"), {
                "encoder_config": dataclasses.asdict(mimi_cfg),
                **{k: getattr(cfg.codec, k) for k in (
                    "encoder_valid_num_quantizers", "input_sample_rate", "output_sample_rate",
                    "decode_upsample_rate", "encode_downsample_rate")}})):
        with open(os.path.join(model_dir, rel)) as f:
            config = json.load(f)
        with open(os.path.join(base_dir, rel), "w") as f:
            json.dump({**config, **extra}, f)


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
ATTN_SUBTALKER = (16, 8, 128)  # H, KV, hd; S_max G = 16, or G/2 under QTTS_ST_SPLIT
# The bf16 path's profile (profile_decode: 9 steps): S_max 32 + 9, prompts of
# 9-10 rows left-padded into the 32-slot bucket, cur_len 33..41 over the steps.
ATTN_PROFILE_S_MAX = 41
ATTN_PROFILE_VALID_FROM = (22, 23, 22, 22)


def _n_split(s_max: int):
    """The split count the wrapper picks for a cache of ``s_max`` slots."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import choose_split

    return choose_split(s_max)


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
    device_ms = _device_ms(call, "decode_attention_kernel", iters=max(50, 2 * len(runs)))
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
           "n_split": _n_split(s_max), "runs": len(runs),
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


def hold_attention_at(gen, shape, int8: bool, label: str, rows=()) -> float:
    """decode_attention (float cache) or decode_attention_int8 against its
    plain version at one cache shape ``(H, KV, hd, S_max)``: B 1 and 4, bf16
    and f32 queries, no window and a window of 13, rows ending 3 apart below
    S_max (at least 1) with left pads 5 apart; then each ``(cur_len,
    valid_from)`` of ``rows`` (B = their length) at both dtypes. Returns the
    largest error."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda import decode_attention as da

    h, kv, hd, s_max = shape
    name = "decode_attention_int8" if int8 else "decode_attention"
    kernel, plain = getattr(da, name), getattr(da, name + "_plain")
    cases = []
    for b in (1, 4):
        cur_len = [max(s_max - 3 * i, 1) for i in range(b)]
        cases.append((cur_len, [min(5 * i, cl - 1) for i, cl in enumerate(cur_len)]))
    worst = 0.0
    for cur_len, valid_from in [*cases, *rows]:
        for dtype in (torch.bfloat16, torch.float32):
            for window in ((None, 13) if (cur_len, valid_from) in cases else (None,)):
                q, k, v, cl, vf = _attention_inputs(
                    gen, len(cur_len), h, kv, hd, s_max, cur_len, valid_from,
                    torch.float32 if int8 else dtype)
                if int8:
                    k, v = _int8_caches(k, v)
                    q = q.to(dtype)
                got = kernel(q, k, v, cl, vf, window)
                torch.cuda.synchronize()
                want = plain(q, k, v, cl, vf, window)
                worst = max(worst, _hold(
                    got, want, dtype, f"{name} {label} B={len(cur_len)} H{h}/KV{kv} hd{hd} "
                    f"S_max={s_max} n_split={_n_split(s_max)} window={window} cur_len "
                    f"{cur_len} valid_from {valid_from}"))
    return worst


def micro_rows(s_max: int, b: int = 4) -> list:
    """The sub-talker micro-decode's rows over a cache of ``s_max`` slots:
    cur_len pos + 1 for every position, no left pad, B = ``b``."""
    return [([c] * b, [0] * b) for c in range(1, s_max + 1)]


def hold_subtalker_attention(gen, int8: bool) -> float:
    """The kernel at the sub-talker's heads, as the micro-decode launches it:
    S_max G = 16 (the layer-by-layer routes) and G/2 = 8 (``QTTS_ST_SPLIT``'s
    first half), every cur_len, against its plain version. Returns the
    largest error."""
    return max(hold_attention_at(gen, (*ATTN_SUBTALKER, s), int8, "subtalker", micro_rows(s))
               for s in (16, 8))


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
                    f"n_split={_n_split(s_max)} window={window} rows "
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
    shapes = {"talker": (*ATTN_TALKER, talker_s_max), "subtalker": (*ATTN_SUBTALKER, 16)}
    worst = max(hold_attention_at(gen, shapes["talker"], False, "talker"),
                hold_subtalker_attention(gen, int8=False))
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
    """decode_attention_int8 against its plain version at the talker shape,
    at the sub-talker's (the ``QTTS_ST_KV8`` route's micro-decode) and on
    the long talker caches, then timed at the talker shape and the long
    shapes."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kv, hd = ATTN_TALKER
    worst = max(hold_attention_at(gen, (h, kv, hd, s_max), True, "talker"),
                hold_subtalker_attention(gen, int8=True))
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
    device_ms = _device_ms(step, "subtalker_step_kernel", iters=20)
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


def snake_instructions() -> int:
    """SASS instructions of one SnakeBeta (the kernel's snake, compiled in
    the built library): those of ``vocoder_snake_probe`` less those of
    ``vocoder_copy_probe``, which has the same loads and store (cuobjdump
    -sass, the code up to the first EXIT: the true division's slow path, a
    subroutine after it that ordinary inputs never call, is not counted)."""
    from qwen_tts_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path("vocoder_block")],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for name in ("vocoder_snake_probe", "vocoder_copy_probe"):
        body = sass[sass.index(f"Function : {name}"):]
        body = body[:body.index(" EXIT ")]  # the straight line, not the subroutine after it
        counts[name] = len(re.findall(r"/\*[0-9a-f]{4}\*/\s+[A-Z@!]", body))
    return counts["vocoder_snake_probe"] - counts["vocoder_copy_probe"]


def lane_instructions_per_s() -> float:
    """The card's CUDA-core issue rate: SMs x 4 schedulers x 32 lanes at its
    largest SM clock (nvidia-smi clocks.max.sm), one warp instruction per
    scheduler per clock."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32 * mhz * 1e6


def vocoder_block_bound(b: int, t_in: int, c_in: int, c_out: int, rate: int, taps: int,
                        snake_instr: int = 0, lane_rate: float = 1.0, rows: int = None):
    """The least time the card could take for one vocoder block on these
    inputs: the largest of (1) bytes: the bf16 input read once, the output
    written once, the weights and per-channel vectors (bf16) read once, over
    3.35 TB/s; (2) tensor-core operations: the transposed conv (2 taps of
    c_in x c_out per output row) and the 3 residual units (``taps``-tap and
    1x1 convs, c_out x c_out) at the bf16 rate; (3) CUDA-core instructions:
    the SnakeBeta passes (c_in per input row, 6 c_out per output row),
    ``snake_instr`` lane instructions each, at ``lane_rate``. ``rows``: the
    output rows computed (default the function's own; the kernel's warm-up
    tiles add more). Returns (bound_ms, term, bytes, flops, snakes)."""
    t_out = t_in * rate
    rows = b * t_out if rows is None else rows
    weights = 2 * (2 * rate * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    vectors = 2 * (2 * c_in + 19 * c_out)
    moved = 2 * b * (t_in * c_in + t_out * c_out) + weights + vectors
    flops = 2 * rows * (2 * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    snakes = rows * (c_in // rate + 6 * c_out)
    terms = {"bytes": moved / H100_BYTES_PER_S * 1e3,
             "tensor": flops / H100_BF16_FLOPS * 1e3,
             "cuda_core": snakes * snake_instr / lane_rate * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], term, moved, flops, snakes, terms


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


def _device_us(fn, name: str, iters: int = 5, per_call: int = 1, merge: bool = False):
    """Mean device time (us) per call of the kernels whose name holds
    ``name`` over ``iters`` calls, from torch.profiler. Each such kernel is
    launched ``per_call`` times a call; with ``merge`` all kernels so named
    count as one, their launches in start order (a kernel whose template
    instances share a call). The profiler can miss the kernels of
    the first calls after it starts, so it records 2 x ``iters`` calls and
    counts each kernel's last ``iters`` x ``per_call`` launches. A profile
    that saw fewer launches of a kernel than that, or none, is never used:
    it is taken again, up to three times in all (on the H100 a full
    chip_smoke run has seen such a profile keep 18 and 25 of 100 launches,
    where the same launches profiled alone were all kept, and one profile
    of the plain int8 route keep no device event at all, and three profiles
    in a row keep none of the int8 GEMM's). Where none saw them all the time
    is not measured: it logs so and returns None (CUDA events still time
    every kernel)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = iters * per_call
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * iters):
                fn()
            torch.cuda.synchronize()
        launches = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and name in e.name:
                launches[name if merge else e.name].append(
                    (e.time_range.start, e.time_range.elapsed_us()))
        if not launches:
            log(f"profile {attempt + 1} of 3 saw no kernel named like {name!r}; taken again")
            continue
        short = {k: len(r) for k, r in launches.items() if len(r) < want}
        if not short:
            return sum(sum(us for _, us in sorted(runs)[-want:])
                       for runs in launches.values()) / iters
        log(f"profile {attempt + 1} of 3 kept too few launches ({list(short.values())} of the "
            f"{want} of the last {iters} calls: {[k[:60] for k in short]}); taken again")
    log(f"profiler: no profile of three saw all {want} launches of the last {iters} calls of "
        f"the kernels named like {name!r}; their device time is not measured")
    return None


def _device_ms(fn, name: str, scale: float = 1.0, **kw):
    """``_device_us`` in ms, times ``scale``; None where not measured."""
    us = _device_us(fn, name, **kw)
    return None if us is None else scale * us / 1e3


def _sum_measured(values):
    """The sum of times, None if any of them was not measured."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def hold_vocoder_block(x, block: dict, rate: int, label: str, split: int = 0) -> float:
    """One counted launch of vocoder_block on x (at ``split``, 0 for the
    plan's) against vocoder_block_plain on the same input, within
    VOCODER_TOL x max |ref|. Returns (max |err|, the kernel's output)."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block, vocoder_block_plain

    before = vocoder_block.launches
    got = vocoder_block(x, block, rate, split=split)
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


def time_vocoder_readings(fn, iters: int = 10) -> dict:
    """One kernel's time four ways (ms): CUDA events over ``iters`` launches
    back to back; events around each launch alone, synchronised between
    launches (median); the host clock around each launch and its
    synchronise (median); and the profiler's device time (mean)."""
    import torch

    back_to_back = _time_ms(fn, iters=iters, warmup=2)
    alone, host = [], []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        alone.append(start.elapsed_time(end))
    return {"events_ms": back_to_back, "events_alone_ms": statistics.median(alone),
            "host_ms": statistics.median(host),
            "device_ms": _device_ms(fn, "vocoder_block_kernel", iters=iters)}


def time_vocoder_path():
    """The vocoder block's four readings (``time_vocoder_readings``) at the
    path's shapes (B=4, 64 frames, 7 taps), blocks 2 and 3, on random
    blocks from a fixed seed. It uses only ``vocoder_block``, so it times any
    commit's kernel from that commit's tree with this script copied in."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block

    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
        block = random_vocoder_block(gen, c_in, c_out, rate, CODEC_RESUNIT_TAPS)
        t_in = t_in_128 // VOCODER_FRAMES * FRAMES
        x = (0.5 * torch.randn(4, t_in, c_in, generator=gen, device="cuda")).bfloat16()
        row = {"block": name, "B": 4, "T_in": t_in,
               **time_vocoder_readings(lambda: vocoder_block(x, block, rate), iters=20)}
        log(f"vocoder path timing: {json.dumps(row)}")


def time_vocoder_row(x, block: dict, rate: int, label: dict, iters: int, snake_instr: int,
                     lane_rate: float, splits: bool = False) -> dict:
    """One timed shape of vocoder_block: its four readings, the plain
    version, the library yardstick, the three-term bound (and the same with
    the rows the kernel computes, its warm-up tiles included), the plan, a
    timed launch's phase shares (``timeline_breakdown``) and, with
    ``splits``, the events' time at every column split the kernel takes."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
        TIMELINE_SLOTS, column_splits, kernel_plan, timeline_breakdown, vocoder_block,
        vocoder_block_plain)

    b, t_in, c_in = x.shape
    c_out, taps = block["tconv_b"].shape[0], block["resunits"][0]["conv1_w"].shape[0]
    readings = time_vocoder_readings(lambda: vocoder_block(x, block, rate), iters)
    plain_ms = _time_ms(lambda: vocoder_block_plain(x, block, rate), iters=3, warmup=1)
    library_ms = _time_ms(lambda: vocoder_block_library(x, block, rate), iters=iters, warmup=2)
    plan = kernel_plan(c_in, c_out, rate, taps, b, t_in)
    bound_ms, term, moved, flops, snakes, terms = vocoder_block_bound(
        b, t_in, c_in, c_out, rate, taps, snake_instr, lane_rate)
    computed = b * plan["tile"] * (
        -(-t_in * rate // plan["tile"]) + (plan["segments"] - 1) * plan["warm_tiles"])
    with_warmup = vocoder_block_bound(b, t_in, c_in, c_out, rate, taps, snake_instr, lane_rate,
                                      rows=computed)
    timeline = torch.zeros(b * plan["segments"] * plan["split"], TIMELINE_SLOTS,
                           dtype=torch.int64, device="cuda")
    vocoder_block(x, block, rate, timeline=timeline)
    torch.cuda.synchronize()
    row = {**label, "K": taps, "B": b, "T_in": t_in, "ms": readings["events_ms"], **readings,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_term": term, "bound_terms_ms": terms, "bound_with_warmup_ms": with_warmup[0],
           "rows_computed_share": computed / (b * t_in * rate), "GB": moved / 1e9,
           "GFLOP": flops / 1e9, "G_snakes": snakes / 1e9, "plan": plan,
           "phases": timeline_breakdown(timeline)}
    if splits:
        row["split_ms"] = {n: _time_ms(lambda: vocoder_block(x, block, rate, split=n),
                                       iters=iters, warmup=2)
                           for n in column_splits(c_in, c_out)}
    log(f"kernel time: vocoder_block {json.dumps(row)}")
    return row


def sweep_vocoder_plans(iters: int = 10):
    """vocoder_block's events time at every tile and column split the kernel
    takes, at the stream's B=1 windows and the path's shape (7 taps): the
    data behind the plan's cost model (kFixedShare in the source). Not part
    of main(); run it alone after phase_device() and phase_build()."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
        column_splits, kernel_plan, vocoder_block)

    gen = torch.Generator(device="cuda").manual_seed(6)
    for b, frames in [(1, f) for f in STREAM_FRAMES] + [(4, FRAMES)]:
        for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
            block = random_vocoder_block(gen, c_in, c_out, rate, CODEC_RESUNIT_TAPS)
            t_in = t_in_128 // VOCODER_FRAMES * frames
            x = (0.5 * torch.randn(b, t_in, c_in, generator=gen, device="cuda")).bfloat16()
            chosen = kernel_plan(c_in, c_out, rate, CODEC_RESUNIT_TAPS, b, t_in)
            times = {}
            for tile in (48, 96, 144, 192):
                for n in column_splits(c_in, c_out):
                    try:
                        plan = kernel_plan(c_in, c_out, rate, CODEC_RESUNIT_TAPS, b, t_in,
                                           tile=tile, split=n)
                    except RuntimeError:
                        continue
                    ms = _time_ms(lambda: vocoder_block(x, block, rate, tile=tile, split=n),
                                  iters=iters if b == 1 else 3, warmup=2)
                    times[f"{tile}/{n}"] = {"ms": ms, "segments": plan["segments"],
                                            "seg_tiles": plan["seg_tiles"],
                                            "warm_tiles": plan["warm_tiles"]}
            log(f"vocoder plan sweep: {json.dumps({'block': name, 'B': b, 'frames': frames, 'chosen': chosen, 'tile/split': times})}")
            torch.cuda.empty_cache()


def check_vocoder_splits(x, block: dict, rate: int, label: str) -> float:
    """vocoder_block at every column split the kernel takes, each against
    the plain version and bit for bit against no split. Returns the largest
    error."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import column_splits

    c_in, c_out = x.shape[2], block["tconv_b"].shape[0]
    worst, unsplit = hold_vocoder_block(x, block, rate, f"{label} split 1", split=1)
    for n in column_splits(c_in, c_out)[1:]:
        err, got = hold_vocoder_block(x, block, rate, f"{label} split {n}", split=n)
        if not torch.equal(got, unsplit):
            fail(f"vocoder_block {label}: split {n} changes the bits of split 1")
        worst = max(worst, err)
    log(f"kernel check: vocoder_block {label}: splits {column_splits(c_in, c_out)} give the "
        f"bits of split 1")
    return worst


def phase_kernels_vocoder_block():
    """vocoder_block against its plain version on the card (both geometries,
    the codec's 7-tap residual convs and the TPU kernel's 3-tap ones; B 1/4;
    a length one row under, at and over a tile, several tiles, the stream's
    first packet and windows at B=1; every column split at the first packet
    and one row over a tile, bit for bit against no split), then timed, and
    held against the plain version again, at the TPU kernel's shapes (B=32,
    128 frames; 3 and 7 taps), the path's (B=4, 64 frames, 7 taps) and the
    stream's (B=1; 2, 27 and 50 frames), beside the three-term bound (bytes,
    tensor-core operations, SnakeBeta instructions on the CUDA cores, whose
    count comes from the built kernel's SASS). Returns the JSON record: its
    times are those of the two launches of one bf16 codec_decode at the
    path's shapes."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import kernel_plan, vocoder_block

    snake_instr = snake_instructions()
    lane_rate = lane_instructions_per_s()
    log(f"vocoder_block bound: one SnakeBeta is {snake_instr} SASS instructions "
        f"(cuobjdump of the built library); CUDA-core rate {lane_rate / 1e12:.2f} T lane "
        f"instructions/s (SMs x 4 x 32 at nvidia-smi clocks.max.sm)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for taps in (CODEC_RESUNIT_TAPS, 3):
        for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
            block = random_vocoder_block(gen, c_in, c_out, rate, taps)
            tile = kernel_plan(c_in, c_out, rate, taps, 1, 64)["tile"]
            # One row under, at and over a tile; several tiles; the stream's
            # first packet and its windows.
            cases = [(b, t_in) for t_in in (tile // rate - 1, tile // rate, tile // rate + 1,
                                            3 * tile // rate + 7) for b in (1, 4)]
            if taps == CODEC_RESUNIT_TAPS:
                cases += [(1, frames * t_in_128 // VOCODER_FRAMES) for frames in STREAM_FRAMES]
            for b, t_in in cases:
                plan = kernel_plan(c_in, c_out, rate, taps, b, t_in)
                x = (0.5 * torch.randn(b, t_in, c_in, generator=gen, device="cuda")).bfloat16()
                err, _ = hold_vocoder_block(
                    x, block, rate, f"{name} {c_in}->{c_out} s={rate} K={taps} B={b} "
                    f"T_in={t_in} (T_out {t_in * rate}; plan {plan})")
                worst = max(worst, err)
            if taps == CODEC_RESUNIT_TAPS:
                for t_in in (tile // rate + 1, STREAM_FIRST * t_in_128 // VOCODER_FRAMES):
                    x = (0.5 * torch.randn(1, t_in, c_in, generator=gen,
                                           device="cuda")).bfloat16()
                    worst = max(worst, check_vocoder_splits(
                        x, block, rate, f"{name} K={taps} B=1 T_in={t_in}"))
    blocks = {(name, taps): random_vocoder_block(gen, c_in, c_out, rate, taps)
              for name, (c_in, c_out, rate, _) in VOCODER_BLOCKS.items()
              for taps in (3, CODEC_RESUNIT_TAPS)}

    rows = []
    # The TPU kernel's shapes with its own 3-tap units and with the codec's,
    # the path's shapes with the codec's, then the stream's codec windows.
    shapes = ([(VOCODER_BATCH, VOCODER_FRAMES, 3), (VOCODER_BATCH, VOCODER_FRAMES,
                                                    CODEC_RESUNIT_TAPS),
               (4, FRAMES, CODEC_RESUNIT_TAPS)]
              + [(1, frames, CODEC_RESUNIT_TAPS) for frames in STREAM_FRAMES])
    for b, frames, taps in shapes:
        for name, (c_in, c_out, rate, t_in_128) in VOCODER_BLOCKS.items():
            t_in = t_in_128 // VOCODER_FRAMES * frames
            block = blocks[name, taps]
            x = (0.5 * torch.randn(b, t_in, c_in, generator=gen, device="cuda")).bfloat16()
            rows.append(time_vocoder_row(
                x, block, rate, {"block": name, "frames": frames},
                iters=5 if b == VOCODER_BATCH else 20, snake_instr=snake_instr,
                lane_rate=lane_rate, splits=b == 1))
            err, _ = hold_vocoder_block(x, block, rate,
                                        f"{name} K={taps} B={b} T_in={t_in} (timed shape)")
            worst = max(worst, err)
            first = vocoder_block(x, block, rate)
            second = vocoder_block(x, block, rate)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                fail(f"vocoder_block {name} K={taps} B={b}: two launches differ")
            torch.cuda.empty_cache()
    log("kernel check: vocoder_block: two launches give the same bits at every timed shape")
    path = [r for r in rows if r["B"] == 4]  # b2, then b3
    rec = {
        "name": "vocoder_block", "route": "cuda",
        "source": "qwen_tts_tpu_torch/csrc/vocoder_block.cu",
        "replaces": "scripts/exp_pallas_vocoder.py:138",
        "shape": f"blocks 2+3 of one bf16 codec_decode, B=4, {FRAMES} frames, 7-tap units "
                 f"(2 launches: b2 384->192 s=4 T_in {path[0]['T_in']}, b3 192->96 s=3 "
                 f"T_in {path[1]['T_in']}); per-block rows (B=4; B=32 x 128 frames with 3 "
                 f"and 7 taps; B=1 stream windows of {STREAM_FRAMES} frames) in 'blocks'",
        "ms": sum(r["ms"] for r in path), "device_ms": _sum_measured(r["device_ms"] for r in path),
        "plain_ms": sum(r["plain_ms"] for r in path),
        "library_ms": sum(r["library_ms"] for r in path),
        "bound_ms": sum(r["bound_ms"] for r in path),
        "bound_by": "bytes" if all(r["bound_term"] == "bytes" for r in path) else "operations",
        "bound_terms": [r["bound_term"] for r in path], "snake_instructions": snake_instr,
        "max_abs_err": worst, "blocks": rows,
    }
    return rec


# The talker's int8 projections at the flagship dims, (name, K, N), and the
# sub-talker's int8 LM head (K, N; f32 logits).
TALKER_PROJECTIONS = (("wq", 1024, 1024), ("wk", 1024, 128), ("wv", 1024, 128),
                      ("wo", 1024, 1024), ("gate", 1024, 2048), ("up", 1024, 2048),
                      ("down", 2048, 1024))
LM_HEAD = (1024, 2048)
# The sub-talker layer's projections (the Jacobi forward and the sub-talker
# int8 KV route run them through the int8 GEMM at M = B x G and B).
SUBTALKER_PROJECTIONS = (("wq", 1024, 2048), ("wk", 1024, 1024), ("wv", 1024, 1024),
                         ("wo", 2048, 1024), ("gate", 1024, 3072), ("up", 1024, 3072),
                         ("down", 3072, 1024))
# The fused weights of fuse_trunk_params: one launch each.
FUSED_LAUNCHES = (("wqkv", ("wq", "wk", "wv")), ("wgu", ("gate", "up")))
# A talker layer's int8 GEMM launches: the projections that read one x are
# one launch.
LAYER_LAUNCHES = (("qkv", ("wq", "wk", "wv")), ("o", ("wo",)), ("gate_up", ("gate", "up")),
                  ("down", ("down",)))
# bf16: the product rounds to bf16 after a sum in another order, one ulp
# (at most 2^-7 of the largest value), times the scale; f32: order only.
INT8_MATMUL_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
# One layer's weights per talker layer, so that the bytes come from HBM, as
# in a decode step (20 layers x 8.65 MB > the 50 MB L2).
INT8_ROTATE = 20


def _int8_layers(gen, count: int, projections=TALKER_PROJECTIONS):
    """``count`` layers' int8 weights (the talker's unless ``projections``
    says), {name: (w_i8 [K, N], s)}."""
    import torch

    from qwen_tts_tpu_torch.models.trunk import quantize_int8

    return [{name: quantize_int8(torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5)
             for name, k, n in projections} for _ in range(count)]


def _int8_bytes(x, weights, f32_out: bool) -> int:
    """Bytes one launch must move: x once, each int8 weight and its bf16
    scales once, each output once."""
    m = x.numel() // x.shape[-1]
    out_item = 4 if f32_out else x.element_size()
    return x.numel() * x.element_size() + sum(
        w.numel() + 2 * w.shape[1] + m * w.shape[1] * out_item for w, _ in weights)


def int8_timeline(layers, kind: str, names, m: int = 4) -> dict:
    """``kind``'s launch at M=``m`` bf16, timed (``timeline=``) over the
    layers' weights in turn, one launch each: the median over the launches of
    each field of ``timeline_breakdown`` (us)."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import (
        TIMELINE_SLOTS, int8_matmul_group, launch_blocks, timeline_breakdown)

    k = layers[0][names[0]][0].shape[0]
    x = torch.randn(m, k, device="cuda").bfloat16()
    weights = [[layer[n] for n in names] for layer in layers]
    timeline = torch.zeros(launch_blocks(x, weights[0]), TIMELINE_SLOTS, dtype=torch.int64,
                           device="cuda")
    int8_matmul_group(x, weights[0], timeline=timeline)  # warm-up
    parts = []
    for group in weights[1:] + weights[:1]:
        int8_matmul_group(x, group, timeline=timeline)
        torch.cuda.synchronize()
        parts.append(timeline_breakdown(timeline))
    return _median_breakdown(parts)


def _median_breakdown(parts) -> dict:
    out = {}
    for key, value in parts[0].items():
        if isinstance(value, dict):
            out[key] = {s: round(statistics.median(p[key][s] for p in parts), 3) for s in value}
        else:
            out[key] = round(statistics.median(p[key] for p in parts), 3)
    return out


def check_int8_matmul(layers, head, sub_layer) -> float:
    """Grouped and single launches at the talker layer's launches, the LM
    head's and the sub-talker layer's, M 1/4/32/64/128 (64: the Jacobi
    forward's B x G at B=4), f32 and bf16: one launch counted per call; each
    grouped output the bits of its single launch; each within
    INT8_MATMUL_TOL of the plain version. Then the fused weights of both
    layers (q|k|v and gate|up concatenated, as fuse_trunk_params makes them)
    as single launches: the bits of the grouped launch. Returns the largest
    error."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul, int8_matmul_group, int8_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = 0.0
    launches = [(f"{who} {kind}", [layer[n] for n in names], False)
                for who, layer in (("talker", layers[0]), ("sub-talker", sub_layer))
                for kind, names in LAYER_LAUNCHES]
    for kind, weights, f32_out in launches + [("lm_head", [head], True)]:
        k = weights[0][0].shape[0]
        for m in (1, 4, 32, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                before = int8_matmul.launches
                got = int8_matmul_group(x, weights, f32_out)
                torch.cuda.synchronize()
                if int8_matmul.launches != before + 1:
                    fail("int8_matmul_group did not count its one launch")
                alone = [int8_matmul(x, w, s, f32_out) for w, s in weights]
                same = all(torch.equal(a, b) for a, b in zip(got, alone))
                errs = []
                for (w, s), y in zip(weights, got):
                    want = int8_matmul_plain(x, w, s, f32_out)
                    err = (y.float() - want.float()).abs().max().item()
                    limit = INT8_MATMUL_TOL[str(dtype).split(".")[1]] * \
                        want.float().abs().max().item()
                    if not err <= limit or y.dtype != want.dtype or y.shape != want.shape:
                        fail(f"int8_matmul {kind} M={m} {dtype}: error {err:.3g} over {limit:.3g}")
                    errs.append(err)
                    worst = max(worst, err)
                log(f"kernel check: int8_matmul {kind} K={k} N={[w.shape[1] for w, _ in weights]}"
                    f" M={m} {dtype}{' f32 logits' * f32_out}: max_abs_err "
                    f"{max(errs):.3g} (tol {INT8_MATMUL_TOL[str(dtype).split('.')[1]]} x "
                    f"max|ref|); grouped == single launches: {same}")
                if not same:
                    fail(f"int8_matmul {kind} M={m} {dtype}: a grouped output differs from its "
                         f"single launch")
    fused = []
    for who, layer in (("talker", layers[0]), ("sub-talker", sub_layer)):
        for key, names in FUSED_LAUNCHES:
            weights = [layer[n] for n in names]
            w = torch.cat([w for w, _ in weights], dim=1)
            s = torch.cat([s for _, s in weights], dim=1)
            for m in (1, 4, 32, 64, 128):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(m, w.shape[0], generator=gen, device="cuda").to(dtype)
                    fused.append(torch.equal(int8_matmul(x, w, s),
                                             torch.cat(int8_matmul_group(x, weights), dim=1)))
    torch.cuda.synchronize()
    log(f"kernel check: int8_matmul fused q|k|v (N {TALKER_PROJECTIONS[0][2] + 2 * 128} / "
        f"4096) and gate|up (N 4096 / 6144) of the talker and sub-talker layers, M "
        f"1/4/32/64/128, f32 and bf16: one launch == the grouped launch, bit for bit, in "
        f"{sum(fused)} / {len(fused)}")
    if not all(fused):
        fail("int8_matmul: a fused weight's launch differs from the grouped launch")
    return worst


def _int8_library(x, w_nk, s_flat):
    """The library yardstick: torch._weight_int8pack_mm (bf16 x, the weight
    as an [N, K] int8 copy made outside the timed region, [N] scales)."""
    import torch

    return torch._weight_int8pack_mm(x, w_nk, s_flat)


def probe_int8_library(layers):
    """Whether torch._weight_int8pack_mm runs on the card: None, or its
    error."""
    import torch

    w, s = layers[0]["wq"]
    x = torch.randn(4, w.shape[0], device="cuda").bfloat16()
    try:
        y = _int8_library(x, w.t().contiguous(), s.reshape(-1).contiguous())
        torch.cuda.synchronize()
    except Exception as e:  # reported: the yardstick is then "none"
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    log(f"library: torch._weight_int8pack_mm runs on the card, {tuple(y.shape)} {y.dtype}")
    return None


def time_int8_matmul(layers, heads, library_error) -> dict:
    """The serving step's int8 GEMM launches timed over the 20 layers'
    weights in turn, bf16: each launch kind at M=4 (a decode step) and M=128
    (a prefill) by CUDA events over back-to-back launches and by the
    profiler's device time, beside its byte bound; each single projection
    the same way beside the plain cast + cuBLAS route and the library's
    torch._weight_int8pack_mm; then a whole layer, its 4 launches and the
    7 single launches of the same products back to back. Returns the rows
    and the step sums (20 layers)."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul, int8_matmul_group, int8_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {"per_launch": [], "projections": []}
    kinds = [(kind, names, False) for kind, names in LAYER_LAUNCHES] + [("lm_head", None, True)]
    heads = [(head,) for head in heads]
    for m in (4, 128):
        for kind, names, f32_out in kinds:
            groups = heads if names is None else [[layer[n] for n in names] for layer in layers]
            x = torch.randn(m, groups[0][0][0].shape[0], generator=gen, device="cuda").bfloat16()
            call = _rotating(lambda *ws: int8_matmul_group(x, ws, f32_out), groups)
            rec = {"launch": kind, "M": m, "N": [w.shape[1] for w, _ in groups[0]],
                   "ms": _time_ms(call),
                   "device_ms": _device_ms(call, "int8_matmul_kernel", iters=40, merge=True),
                   "bound_ms": _int8_bytes(x, groups[0], f32_out) / H100_BYTES_PER_S * 1e3}
            log(f"kernel time: int8_matmul launch {json.dumps(rec)}")
            rows["per_launch"].append(rec)
        for name, k, n in TALKER_PROJECTIONS + (("lm_head", *LM_HEAD),):
            f32_out = name == "lm_head"
            weights = heads if f32_out else [(layer[name],) for layer in layers]
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            kernel = _rotating(lambda ws: int8_matmul(x, *ws, f32_out), weights)
            plain = _rotating(lambda ws: int8_matmul_plain(x, *ws, f32_out), weights)
            rec = {"proj": name, "K": k, "N": n, "M": m, "ms": _time_ms(kernel),
                   "device_ms": _device_ms(kernel, "int8_matmul_kernel", iters=40, merge=True),
                   "plain_ms": _time_ms(plain),
                   # every kernel of the plain route: the cast, cuBLAS, the scale
                   "plain_device_ms": _device_ms(plain, "", iters=40),
                   "bound_ms": _int8_bytes(x, weights[0], f32_out) / H100_BYTES_PER_S * 1e3,
                   "library_ms": None, "library_device_ms": None}
            if library_error is None and not f32_out:
                packed = [(w.t().contiguous(), s.reshape(-1).contiguous()) for (w, s), in weights]
                lib = _rotating(lambda w, s: _int8_library(x, w, s), packed)
                rec["library_ms"] = _time_ms(lib)
                rec["library_device_ms"] = _device_ms(lib, "", iters=40)
                del packed
            log(f"kernel time: int8_matmul {json.dumps(rec)}")
            rows["projections"].append(rec)

    x = torch.randn(4, 1024, generator=gen, device="cuda").bfloat16()
    h = torch.randn(4, 2048, generator=gen, device="cuda").bfloat16()

    def layer_grouped(layer):  # the layer's 4 launches, each on a fixed input
        int8_matmul_group(x, [layer[n] for n in ("wq", "wk", "wv")])
        int8_matmul(x, *layer["wo"])
        int8_matmul_group(x, [layer["gate"], layer["up"]])
        int8_matmul(h, *layer["down"])

    def layer_single(layer):  # the same products, one launch each
        for name, k, _ in TALKER_PROJECTIONS:
            int8_matmul(x if k == 1024 else h, *layer[name])

    grouped = _rotating(layer_grouped, [(layer,) for layer in layers])
    single = _rotating(layer_single, [(layer,) for layer in layers])
    step = {"grouped_device_ms": _device_ms(grouped, "int8_matmul_kernel", INT8_ROTATE,
                                            iters=40, per_call=4, merge=True),
            "single_device_ms": _device_ms(single, "int8_matmul_kernel", INT8_ROTATE,
                                           iters=40, per_call=7, merge=True),
            "grouped_ms": INT8_ROTATE * _time_ms(grouped),
            "single_ms": INT8_ROTATE * _time_ms(single)}
    talker = [r for r in rows["projections"] if r["M"] == 4 and r["proj"] != "lm_head"]
    plain_device_ms = _sum_measured(r["plain_device_ms"] for r in talker)
    step["plain_device_ms"] = None if plain_device_ms is None else INT8_ROTATE * plain_device_ms
    step["plain_ms"] = INT8_ROTATE * sum(r["plain_ms"] for r in talker)
    library_device_ms = None if library_error else _sum_measured(
        r["library_device_ms"] for r in talker)
    step["library_device_ms"] = (None if library_device_ms is None else
                                 INT8_ROTATE * library_device_ms)
    step["library_ms"] = (None if library_error else
                          INT8_ROTATE * sum(r["library_ms"] for r in talker))
    step["bound_ms"] = INT8_ROTATE * sum(r["bound_ms"] for r in rows["per_launch"]
                                         if r["M"] == 4 and r["launch"] != "lm_head")
    return rows, step


def phase_kernels_int8_matmul():
    """int8_matmul: grouped and single launches against the plain version
    (check_int8_matmul); the timeline of the wq launch (1024 x 1024) and of
    q|k|v at M=4; the launches and projections timed (time_int8_matmul); the
    library yardstick probed. Returns the JSON record: the talker's 80 int8
    GEMM launches of one serving decode step (20 layers x 4, M=4, bf16)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    layers = _int8_layers(gen, INT8_ROTATE)
    from qwen_tts_tpu_torch.models.trunk import quantize_int8

    heads = [quantize_int8(torch.randn(*LM_HEAD, generator=gen, device="cuda") / LM_HEAD[0] ** 0.5)
             for _ in range(INT8_ROTATE)]
    worst = check_int8_matmul(layers, heads[0],
                              _int8_layers(gen, 1, SUBTALKER_PROJECTIONS)[0])
    timelines = {f"{kind}@{m}": int8_timeline(layers, kind, names, m)
                 for kind, names, m in (("wq", ("wq",), 4), ("qkv", ("wq", "wk", "wv"), 4),
                                        ("wq", ("wq",), 128))}
    for kind, rec in timelines.items():
        log(f"int8_matmul timeline, {kind} bf16, median of {INT8_ROTATE} launches: "
            f"{json.dumps(rec)}")
    library_error = probe_int8_library(layers)
    if library_error:
        log(f"library: torch._weight_int8pack_mm does not run on the card: {library_error}")
    rows, step = time_int8_matmul(layers, heads, library_error)
    log(f"int8_matmul: the talker's int8 GEMMs of one serving decode step (20 layers, M=4, "
        f"bf16): 80 grouped launches {step['grouped_device_ms']} ms device "
        f"({step['grouped_ms']:.4f} by events), the same products as 140 single launches "
        f"{step['single_device_ms']} ({step['single_ms']:.4f}), plain cast + cuBLAS route "
        f"{step['plain_device_ms']} ({step['plain_ms']:.4f}), torch._weight_int8pack_mm "
        f"{step['library_device_ms']}, byte bound {step['bound_ms']:.4f} ms")
    # Device times where the profiler measured both, else CUDA events.
    clock = ("device" if None not in (step["grouped_device_ms"], step["plain_device_ms"])
             else "events")
    key = "_device_ms" if clock == "device" else "_ms"
    if not 0 < step["grouped" + key] < step["plain" + key]:
        fail(f"int8_matmul: the projections take longer on the card than the cast + cuBLAS "
             f"route ({clock})")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "qwen_tts_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "qwen_tts_tpu/models/trunk.py:114 (_w_matmul, not a TPU kernel)",
            "shape": "the talker's 80 int8 GEMM launches of one serving decode step (20 layers "
                     "x q|k|v, o, gate|up, down; M=4, bf16); per-launch and per-projection "
                     "rows (M 4 and 128, and the sub-talker LM head) in 'per_launch' and "
                     "'projections'",
            "ms": step["grouped_ms"], "device_ms": step["grouped_device_ms"],
            "single_device_ms": step["single_device_ms"],
            "plain_ms": step["plain_ms"], "plain_device_ms": step["plain_device_ms"],
            "library_ms": step["library_ms"], "library_device_ms": step["library_device_ms"],
            "library_error": library_error,
            "bound_ms": step["bound_ms"], "bound_by": "bytes", "max_abs_err": worst,
            "timelines": timelines, **rows}


# Batch invariance: (B, S_max, row, left padding) placements of one row of
# `n` positions; each must give the first one's bits.
INVARIANT_PLACEMENTS = {
    60: [(1, 97, 0, 0), (4, 97, 2, 30), (32, 97, 17, 5), (1, 2080, 0, 0), (4, 2080, 3, 1900),
         (32, 2080, 31, 700)],
    1500: [(1, 2080, 0, 0), (4, 2080, 1, 570), (32, 2080, 9, 33), (1, 1600, 0, 100)],
}


def phase_batch_invariance():
    """A row's bits alone and beside other rows, bitwise, on the card:
    decode_attention (float and int8 caches) at B 1/4/32, S_max 97 and 2080,
    moved by left padding; subtalker_step at B 1/4/32 (f32 and bf16);
    int8_matmul at M 1/4/32 (the talker layer's launches, grouped as the path
    groups them, and the LM head; f32 and bf16). Then the plain ops around
    them, reported (``check_plain_ops_invariance``, returned)."""
    import torch

    from qwen_tts_tpu_torch.models.trunk import quantize_int8
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul_group
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import KERNEL_DIMS, subtalker_step
    from qwen_tts_tpu_torch.ops.rope import rope_cos_sin

    gen = torch.Generator(device="cuda").manual_seed(9)
    h, kv, hd = ATTN_TALKER
    checks = 0
    for int8 in (False, True):
        for n, placements in INVARIANT_PLACEMENTS.items():
            q_row = torch.randn(h, hd, generator=gen, device="cuda")
            k_row, v_row = (torch.randn(n, kv, hd, generator=gen, device="cuda") * 3
                            for _ in range(2))
            outs = []
            for b, s_max, row, at in placements:
                q, k, v, cl, vf = _attention_inputs(gen, b, h, kv, hd, s_max, [s_max] * b,
                                                    [0] * b, torch.float32)
                q[row], k[row, at:at + n], v[row, at:at + n] = q_row, k_row, v_row
                cl[row], vf[row] = at + n, at
                k, v = _int8_caches(k, v) if int8 else (k.bfloat16(), v.bfloat16())
                outs.append(decode_attention(q.bfloat16(), k, v, cl, vf)[row])
            torch.cuda.synchronize()
            same = [torch.equal(o, outs[0]) for o in outs[1:]]
            checks += len(same)
            log(f"batch invariance: decode_attention {'int8' if int8 else 'bf16'} cache, a row of "
                f"{n} positions at (B, S_max, row, left pad) {placements}, n_split "
                f"{[_n_split(s) for b, s, _, _ in placements]}: "
                f"{'the same bits' if all(same) else f'DIFFERS {same}'}")
            if not all(same):
                fail("decode_attention: a row's bits depend on the rows around it")

    n_layers, d, _, kv_st, hd_st, _ = KERNEL_DIMS
    cos, sin = rope_cos_sin(torch.arange(16, device="cuda"), hd_st, 10000.0)
    for dtype in (torch.float32, torch.bfloat16):
        packed = random_subtalker_packed(gen, dtype)
        x_row = torch.randn(d, generator=gen, device="cuda").to(dtype)
        kc_row, vc_row = (torch.randn(n_layers, 16, kv_st, hd_st, generator=gen,
                                      device="cuda").to(dtype) for _ in range(2))
        outs = []
        for b, row in ((1, 0), (4, 2), (32, 17)):
            x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)
            kc, vc = (torch.randn(n_layers, b, 16, kv_st, hd_st, generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            x[row], kc[:, row], vc[:, row] = x_row, kc_row, vc_row
            out, kc, vc = subtalker_step(packed, x, cos[9], sin[9], kc, vc, 9, 1e-6)
            outs.append((out[row], kc[:, row], vc[:, row]))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for other in outs[1:] for a, b in zip(other, outs[0]))
        checks += 2
        log(f"batch invariance: subtalker_step {dtype} a row at B 1/4/32 (output and the cache "
            f"rows it wrote): {'the same bits' if same else 'DIFFER'}")
        if not same:
            fail("subtalker_step: a row's bits depend on the rows around it")

    layer = _int8_layers(gen, 1)[0]
    head = quantize_int8(torch.randn(*LM_HEAD, generator=gen, device="cuda") / LM_HEAD[0] ** 0.5)
    launches = [(kind, [layer[n] for n in names], False) for kind, names in LAYER_LAUNCHES]
    for kind, weights, f32_out in launches + [("lm_head", [head], True)]:
        k = weights[0][0].shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(32, k, generator=gen, device="cuda").to(dtype)
            full = int8_matmul_group(x, weights, f32_out)
            four = int8_matmul_group(x[:4].contiguous(), weights, f32_out)
            one = int8_matmul_group(x[17:18].contiguous(), weights, f32_out)
            torch.cuda.synchronize()
            same = all(torch.equal(f4, f[:4]) and torch.equal(f1, f[17:18])
                       for f, f4, f1 in zip(full, four, one))
            checks += 2 * len(weights)
            if not same:
                fail(f"int8_matmul {kind} {dtype}: a row's bits depend on M")
    log(f"batch invariance: int8_matmul rows at M 1/4/32, the talker layer's 4 launches "
        f"(q|k|v and gate|up grouped) and the LM head, f32 and bf16: the same bits; {checks} "
        f"checks in all pass")
    return check_plain_ops_invariance()


def check_plain_ops_invariance() -> dict:
    """The plain bf16 ops around the kernels at the flagship widths (random
    weights): the talker's LM head, the text projection, ``rms_norm`` and the
    sub-talker's f32 head product. For M 1/4/8/32, rows 0 and M-1 computed
    alone against the same rows in the batch of M, bitwise. Reported, not
    held: a difference is a fault of the port for a later PR. Returns {op:
    {M: the same bits}}."""
    import torch

    from qwen_tts_tpu_torch.models.talker import text_project
    from qwen_tts_tpu_torch.ops.norms import rms_norm

    tk = flagship_config().talker
    cp = tk.code_predictor
    d, td = tk.hidden_size, tk.text_hidden_size
    gen = torch.Generator(device="cuda").manual_seed(23)

    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") / shape[0] ** 0.5).bfloat16()

    head, st_head = w(d, tk.vocab_size), w(cp.hidden_size, cp.vocab_size)
    text = {"text_proj_fc1": w(td, td), "text_proj_fc1_b": w(td), "text_proj_fc2": w(td, d),
            "text_proj_fc2_b": w(d)}
    norm = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    ops = {"talker LM head": (d, lambda x: (x @ head).float()),
           "text projection": (td, lambda x: text_project(text, x)),
           "rms_norm": (d, lambda x: rms_norm(x, norm, tk.rms_norm_eps)),
           "sub-talker f32 head": (cp.hidden_size, lambda x: (x @ st_head).float())}
    results = {}
    for name, (k, fn) in ops.items():
        x = torch.randn(32, k, generator=gen, device="cuda").bfloat16()
        results[name] = {m: all(torch.equal(fn(x[r:r + 1]), fn(x[:m])[r:r + 1])
                                for r in sorted({0, m - 1})) for m in (1, 4, 8, 32)}
        log(f"batch invariance (plain ops, reported): {name} [M, {k}] bf16: rows 0 and M-1 "
            f"alone == in the batch of M: {results[name]}")
    return results


def check_serving_rows_alone(model, smi: str) -> None:
    """The serving path's greedy codes for each text alone against the same
    text in the batch of 4 (EOS banned, 16 frames): reports rows equal / 4.
    Every op of the path takes part, the kernels and the plain PyTorch ones
    (the talker's LM head, norms, embeddings, sampling) alike."""
    import numpy as np

    from qwen_tts_tpu_torch.generate import build_prompt

    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=16, min_new_tokens=17)
    speakers = ["aiden", "serena", "aiden", "serena"]
    prompts = [build_prompt(model.talker_params, model.cfg,
                            model._tokenize(model.build_assistant_text(t)), speaker=spk)
               for t, spk in zip(TEXTS, speakers)]
    params = model._merge_params(**kw)
    both, _ = model.generate_codes_from_prompts(prompts, params)
    equal, first = 0, []
    for i, p in enumerate(prompts):
        solo, _ = model.generate_codes_from_prompts([p], params)
        same = solo[0].shape == both[i].shape and bool((solo[0] == both[i]).all())
        equal += same
        if not same:
            diff = np.argwhere(solo[0] != both[i]) if solo[0].shape == both[i].shape else [[-1]]
            first.append((i, [int(v) for v in diff[0]]))
    log(f"serving batch invariance: greedy codes ({both[0].shape[0]} frames x "
        f"{both[0].shape[1]} groups) of each text alone equal its row of the batch of 4 for "
        f"{equal} / 4 rows{f'; first (row, (frame, group)) that differ: {first}' if first else ''}"
        f" | {smi}")


def count_int8_weight_casts(model, prompts, kw) -> int:
    """Runs a short decode under a dispatch mode that counts the aten casts
    of an int8 tensor of at least 128 x 1024 elements (the talker's smallest
    projection) to a floating dtype: a whole int8 weight dequantized. (Writes
    into the int8 KV cache copy int8 to int8 and do not count.)"""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    big = 128 * 1024

    def is_weight_cast(func, args, kwargs):
        if func is torch.ops.aten._to_copy.default:
            src, dtype = args[0], kwargs.get("dtype")
            return (src.dtype == torch.int8 and src.numel() >= big and dtype is not None
                    and dtype.is_floating_point)
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
            return (isinstance(src, torch.Tensor) and src.dtype == torch.int8
                    and src.numel() >= big and dst.dtype.is_floating_point)
        return False

    class Casts(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if is_weight_cast(func, args, kwargs):
                Casts.count += 1
            return func(*args, **kwargs)

    with eager_decode(), Casts():  # the ops a captured frame replays, run as they come
        model.generate_codes_from_prompts(prompts, model._merge_params(**kw))
    return Casts.count


def _counters():
    """The launch counters of the five kernel wrappers."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8)
    from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block

    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul

    return {"decode_attention": decode_attention, "decode_attention_int8": decode_attention_int8,
            "subtalker_step": subtalker_step, "vocoder_block": vocoder_block,
            "int8_matmul": int8_matmul}


def _attention_splits():
    """Clear the attention wrappers' launch counts by n_split; returns a
    function that reads them."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8)

    for fn in (decode_attention, decode_attention_int8):
        fn.splits.clear()
    return lambda: {fn.__name__: dict(sorted(fn.splits.items()))
                    for fn in (decode_attention, decode_attention_int8) if fn.splits}


@contextlib.contextmanager
def eager_decode():
    """The port's decode run eagerly on the card: the frame loop, the
    stream's first packet and its codec windows through the modules' own
    eager functions (``_decode_eager``, ``_first_packet_eager``,
    ``codec_decode``) in place of their CUDA graphs. For the comparisons
    and timings of graph against eager only; no switch of the package."""
    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import pipeline as pipeline_mod
    from qwen_tts_tpu_torch.models import codec as codec_mod

    saved = (gen_mod._decode, pipeline_mod._first_packet_program, pipeline_mod._codec_window)
    gen_mod._decode = gen_mod._decode_eager
    pipeline_mod._first_packet_program = pipeline_mod._first_packet_eager
    pipeline_mod._codec_window = codec_mod.codec_decode
    try:
        yield
    finally:
        gen_mod._decode, pipeline_mod._first_packet_program, pipeline_mod._codec_window = saved


def _spread(values, fmt="{:.2f}") -> str:
    """median (min..max)"""
    return (f"{fmt.format(statistics.median(values))} ({fmt.format(min(values))}.."
            f"{fmt.format(max(values))})")


def graph_vs_eager(fn, runs: int = 2):
    """``fn`` timed ``runs`` times through the graphs and ``runs`` times
    eagerly, in turns (graph, eager, eager, graph, ...): per side the host
    wall seconds (each run ends in a synchronise), the peak device memory
    allocated in each run and ``fn``'s results."""
    import torch

    out = {"graph": {"wall": [], "peak": [], "result": []},
           "eager": {"wall": [], "peak": [], "result": []}}
    for i in range(2 * runs):
        side = "graph" if i % 4 in (0, 3) else "eager"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with eager_decode() if side == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[side]["wall"].append(wall)
        out[side]["peak"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        out[side]["result"].append(result)
    return out


def log_programs(tag: str, smi: str) -> None:
    """The captured programs alive: kind, one-time warm-up + capture cost,
    kernel launches captured."""
    from qwen_tts_tpu_torch import graphs

    for kind, program in graphs.programs():
        log(f"{tag} graph {kind}: capture (warm-up run + capture) "
            f"{program.graph.capture_s * 1e3:.1f} ms, captured launches "
            f"{dict(sorted(program.graph.launches.items()))} | {smi}")


def phase_path(model_dir: str, smi: str, serving: bool = False):
    """``generate_custom_voice`` at the flagship dims, bf16 talker (phase 4)
    or, with ``serving``, after ``quantize_for_serving(talker=True, kv=True)``
    (phase 6). The decode replays one captured frame; the warm-up call at the
    same shapes captures it, so the counted run only replays. Returns each
    kernel's launches in the counted run."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import graphs
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

    model.generate_custom_voice(TEXTS, speakers, languages, **kw)  # warm-up: the capture
    log_programs(name, smi)
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
        per_layer = len(LAYER_LAUNCHES)
        expected = {"decode_attention": 0, "decode_attention_int8": MAX_NEW * talker_layers,
                    "subtalker_step": MAX_NEW * g, "vocoder_block": 0,
                    "int8_matmul": (1 + MAX_NEW) * talker_layers * per_layer
                    + MAX_NEW * (g - 1)}
        how = (f"int8 attention {MAX_NEW} frames x {talker_layers} talker layers, "
               f"micro-step {MAX_NEW} frames x {g} groups, int8 GEMM (prefill + {MAX_NEW} "
               f"steps) x {talker_layers} layers x {per_layer} launches (q|k|v, o, gate|up, "
               f"down) + {MAX_NEW} frames x {g - 1} LM heads, float attention and the f32 "
               f"codec's vocoder blocks 0")
    else:
        per_frame = talker_layers + g * tk.code_predictor.num_hidden_layers
        expected = {"decode_attention": MAX_NEW * per_frame, "decode_attention_int8": 0,
                    "subtalker_step": 0, "vocoder_block": 0, "int8_matmul": 0}
        how = f"decode_attention {MAX_NEW} frames x {per_frame}, the others 0"
    log(f"{name}: launches {launches}, expected {expected} ({how}; the frames' launches "
        f"counted as captured launches x replays)")
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
    params = model._merge_params(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, _ = model.generate_codes_from_prompts(prompts, params)
    t_codes = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec_wavs = model.decode_codes(codes)
    t_codec = time.perf_counter() - t0
    codec_walls = decode_walls(model, codes)
    log(f"{name} split: decode loop {t_codes:.3f} s ({t_codes / MAX_NEW * 1e3:.2f} ms/step), "
        f"codec (f32) {t_codec:.3f} s | {smi}")

    # Graph against eager, in turns: the decode loop, then the whole call.
    loops = graph_vs_eager(lambda: model.generate_codes_from_prompts(prompts, params)[0])
    calls = graph_vs_eager(lambda: model.generate_custom_voice(TEXTS, speakers, languages,
                                                               **kw)[0], runs=1)
    for side in ("graph", "eager"):
        ms = [w / MAX_NEW * 1e3 for w in loops[side]["wall"]]
        rtf = [audio_s / w for w in calls[side]["wall"]]
        log(f"{name} {side}: over {len(ms)} runs, median (min..max): decode loop "
            f"{_spread(ms)} ms/step, peak mem allocated {_spread(loops[side]['peak'], '{:.3f}')}"
            f" GiB; generate_custom_voice {_spread(calls[side]['wall'], '{:.3f}')} s, "
            f"RTF(audio/wall) {_spread(rtf, '{:.3f}')}, peak mem allocated "
            f"{_spread(calls[side]['peak'], '{:.3f}')} GiB | {smi}")
    same = all(all((a == b).all() for a, b in zip(r, codes))
               for side in loops.values() for r in side["result"])
    log(f"{name}: graph and eager runs give the codes of the split's run: {same}")
    if not same:
        fail(f"the {name} phase's graph and eager decodes disagree")

    profile_decode(model, prompts, kw, smi, name)
    if not serving:
        check_native_runtime(model_dir, wavs, sr, smi)
    if serving:
        casts = count_int8_weight_casts(model, prompts, dict(kw, max_new_tokens=3,
                                                             min_new_tokens=4))
        log(f"serving: int8 weights cast whole in a 3-step decode (aten copies of int8 tensors "
            f">= 128 x 1024 elements): {casts}")
        if casts:
            fail("the serving path still casts int8 weights whole")
        check_serving_rows_alone(model, smi)
    log_programs(name, smi)
    del model
    graphs.clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "codes": codes, "wavs": codec_wavs, "codec_s": t_codec,
            "codec_walls": codec_walls}


def check_native_runtime(model_dir: str, wavs, sr: int, smi: str) -> None:
    """The native host runtime (``io/native.py``, built with g++ into
    ``build/host/``): the largest bf16 tensor of at most 2^25 elements of the
    flagship talker shard through ``NativeMap.view`` against the port's
    reader, and ``bf16_to_f32`` of it against torch's cast, both bit for bit;
    the path's first waveform through ``write_wav`` against ``io/wav.py``'s
    file: the same 44-byte header, each sample the runtime's rounding (x *
    32767 rounded half away from zero, in f32) and at most one step from
    ``io/wav.py``'s (which truncates toward zero)."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.io import native
    from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile
    from qwen_tts_tpu_torch.io.wav import write_wav as py_write

    t0 = time.perf_counter()
    if not native.available():
        fail("native runtime: g++ could not build qwen_tts_tpu_torch/csrc/host/qtts_runtime.cpp")
    build_s = time.perf_counter() - t0
    path = os.path.join(model_dir, "model.safetensors")
    reader = SafeTensorsFile(path)
    m = native.NativeMap(path, prefetch_threads=8)
    try:
        header = json.loads(m.header_bytes())
        name = max((k for k, v in header.items() if k != "__metadata__"
                    and v["dtype"] == "BF16" and math.prod(v["shape"]) <= 2 ** 25),
                   key=lambda k: math.prod(header[k]["shape"]))
        begin, end = header[name]["data_offsets"]
        view = m.view(begin, end)
        want = reader.get(name)
        same_bytes = view.tobytes() == want.view(torch.int16).numpy().tobytes()
        t1 = time.perf_counter()
        f32 = native.bf16_to_f32(view.view(np.uint16), n_threads=8)
        convert_ms = (time.perf_counter() - t1) * 1e3
        same_f32 = np.array_equal(f32.view(np.uint32),
                                  want.float().reshape(-1).numpy().view(np.uint32))
    finally:
        m.close()
        reader.close()
    work = tempfile.mkdtemp(prefix="qtts_wav_")
    try:
        x = np.asarray(wavs[0], np.float32)
        native.write_wav(os.path.join(work, "n.wav"), x, sr)
        py_write(os.path.join(work, "p.wav"), x, sr)
        with open(os.path.join(work, "n.wav"), "rb") as f:
            raw_n = f.read()
        with open(os.path.join(work, "p.wav"), "rb") as f:
            raw_p = f.read()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pcm_n, pcm_p = np.frombuffer(raw_n[44:], "<i2"), np.frombuffer(raw_p[44:], "<i2")
    s32 = np.clip(x, -1, 1) * np.float32(32767)
    rounded = np.where(s32 >= 0, s32 + np.float32(0.5), s32 - np.float32(0.5)).astype(np.int16)
    steps = np.abs(pcm_n.astype(np.int32) - pcm_p)
    log(f"native runtime: built and loaded in {build_s:.2f} s ({native.library_path()}); "
        f"{name} {header[name]['shape']} bf16 through NativeMap.view equal to the reader's "
        f"bytes: {same_bytes}; bf16_to_f32 equal to torch's cast bit for bit: {same_f32} "
        f"({f32.size} elements in {convert_ms:.1f} ms, 8 threads); write_wav of a "
        f"{x.size}-sample waveform: header equal to io/wav.py's {raw_n[:44] == raw_p[:44]}, "
        f"samples the runtime's rounding {np.array_equal(pcm_n, rounded)}, {int(steps.sum())} "
        f"of them one step from io/wav.py's truncation (max {int(steps.max())}) | {smi}")
    if not (same_bytes and same_f32 and raw_n[:44] == raw_p[:44]
            and np.array_equal(pcm_n, rounded) and steps.max() <= 1):
        fail("native runtime: a view, a conversion or a WAV file differs")


# Host calls that start device work, as the profiler names them: kernel
# launches (``cudaLaunch*``, ``cuLaunch*``: plain, cooperative, extended)
# and graph launches.
HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def trace_kernel_count(trace_dir: str, name: str) -> tuple:
    """(trace files, launches of the kernels whose name holds ``name``) in
    the Chrome trace(s) that ``profile_trace`` wrote under ``trace_dir``."""
    files = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir) for f in fs
             if f.endswith(".pt.trace.json")]
    n = 0
    for path in files:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        n += sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))
    return files, n


TRACE_ATTEMPTS = 5  # traces of a segment taken before a lossy profiler fails the phase


def traced_segment(model, inputs, params, frames: int, name: str):
    """The replayed segment under ``utils.profile_trace``: the written trace
    must hold exactly as many decode-attention launches (float and int8
    cache) as their wrappers counted in the segment (captured launches x
    replays). The card machine's profiler has lost device events in full
    runs, so a trace that holds fewer is taken again, up to TRACE_ATTEMPTS
    times in all; none holding them all fails the phase. Returns (state, buffer,
    wall, profiler) as ``_segment``."""
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_int8)
    from qwen_tts_tpu_torch.utils import profile_trace

    seen = []
    for attempt in range(TRACE_ATTEMPTS):
        trace_dir = tempfile.mkdtemp(prefix="qtts_trace_")
        t0 = time.perf_counter()
        try:
            before = decode_attention.launches + decode_attention_int8.launches
            out = _segment(model, inputs, params, False, frames=frames,
                           profiler=lambda: profile_trace(trace_dir))
            counted = decode_attention.launches + decode_attention_int8.launches - before
            written_s = time.perf_counter() - t0 - out[2]
            files, traced = trace_kernel_count(trace_dir, "decode_attention_kernel")
            size = sum(os.path.getsize(f) for f in files)
            read_s = time.perf_counter() - t0 - out[2] - written_s
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        seen.append(f"{traced} of {counted}")
        if len(files) == 1 and counted > 0 and traced == counted:
            log(f"{name} trace [graph]: profile_trace wrote {len(files)} Chrome trace "
                f"({size / 2**20:.1f} MiB; prefill, profiler start and stop and the write "
                f"{written_s:.1f} s, its read {read_s:.1f} s); decode_attention_kernel "
                f"launches in it {traced}, "
                f"counted by the wrappers in the segment {counted} ({frames} frames); traces "
                f"taken {attempt + 1} ({seen})")
            return out
    fail(f"{name} trace: no trace of {TRACE_ATTEMPTS} held the segment's counted "
         f"decode-attention launches (traced of counted: {seen})")


def profile_decode(model, prompts, kw, smi: str, name: str, frames: int = 16,
                   eager_frames: int = 2) -> None:
    """Where a decode segment's time goes: torch.profiler over ``frames``
    replayed frames and ``eager_frames`` eager ones at the path's shapes
    (the prefill before them, outside the profile): device busy time by
    kernel against the host's wall time, and the host calls that start
    device work (per frame; the eager side is shorter because its profile
    records ~100 times the host events a frame). The replayed segment runs
    under ``utils.profile_trace`` (``traced_segment``: its trace holds the
    counted decode-attention launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qwen_tts_tpu_torch.generate import batch_prompts

    params = model._merge_params(**kw)
    dtype = model.talker_params["norm"].dtype
    e, m, t, _ = batch_prompts(prompts)
    inputs = (e.to(dtype), m, t.to(dtype))
    walls = {"graph": [], "eager": []}
    n = {"graph": frames, "eager": eager_frames}
    for i in range(6):  # unprofiled, in turns: graph, eager, eager, graph, ...
        side = "graph" if i % 4 in (0, 3) else "eager"
        walls[side].append(_segment(model, inputs, params, side == "eager", frames=n[side])[2])
    for side in ("graph", "eager"):
        frames = n[side]
        if side == "graph":
            _, _, wall, prof = traced_segment(model, inputs, params, frames, name)
        else:
            _, _, wall, prof = _segment(
                model, inputs, params, True, frames=frames, profiler=lambda: profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        wall_ms = wall * 1e3
        events = prof.key_averages()
        device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        launches = {e.key: e.count for e in events if e.key.startswith(HOST_LAUNCHES)}
        if busy_ms == 0:
            log(f"{name} profile [{side}]: the profiler saw no device time (not measured)")
            continue
        plain_ms = statistics.median(walls[side]) * 1e3
        log(f"{name} profile [{side}]: decode segment of {frames} frames B={len(prompts)} "
            f"(prefill outside): wall {wall_ms:.1f} ms (profiler on), device busy "
            f"{busy_ms:.1f} ms ({busy_ms / frames:.2f} ms/frame), idle share "
            f"{1 - busy_ms / wall_ms:.3f}; wall without the profiler, median of "
            f"{len(walls[side])} {_spread([w * 1e3 for w in walls[side]])} ms, idle share "
            f"against it {1 - busy_ms / plain_ms:.3f}; {sum(launches.values()) / frames:.1f} "
            f"host launch calls/frame {launches} | {smi}")
        for e in device[:12]:
            log(f"  {name} profile [{side}] kernel: {e.self_device_time_total / 1e3:8.2f} ms "
                f"{e.count:6d}x  {e.key[:90]}")
        for e in device:  # the port's own kernels, each per launch
            if any(k in e.key for k in PORT_KERNELS):
                log(f"  {name} profile [{side}] port kernel: "
                    f"{e.self_device_time_total / e.count:.2f} us device per launch, {e.count} "
                    f"launches: {e.key[:70]} | {smi}")


@contextlib.contextmanager
def subtalker_kv_writes(entries: list, feed: bool, flips: list):
    """The sub-talker's int8 KV cache writes (``QTTS_ST_KV8=1``), in order:
    each write's int8 entries and scales recorded into ``entries`` (on the
    host); or, with ``feed``, ``entries`` written in place of this run's own,
    so that a CPU run reads the card's cache and no quantization flip between
    the two remains. Fed, ``flips`` collects (entries that differ from this
    run's own quantization, entries, largest step) per write."""
    from qwen_tts_tpu_torch.models import subtalker as st_mod
    from qwen_tts_tpu_torch.models import trunk as trunk_mod
    from qwen_tts_tpu_torch.ops.attention import quantize_kv

    inside = [False]
    step, write = st_mod.trunk_decode_step, trunk_mod._cache_write_token
    taken = iter(range(len(entries))) if feed else None

    def in_subtalker(*args, **kwargs):
        inside[0] = True
        try:
            return step(*args, **kwargs)
        finally:
            inside[0] = False

    def cache_write(cache, l, rows, write_pos, x):
        if not (inside[0] and isinstance(cache, dict)):
            return write(cache, l, rows, write_pos, x)
        if not feed:
            write(cache, l, rows, write_pos, x)
            entries.append((cache["i8"][l, rows, write_pos].cpu(),
                            cache["s"][l, rows, write_pos].cpu()))
            return None
        i = next(taken, None)
        if i is None:
            fail("parity: the CPU run writes more sub-talker cache entries than the card's")
        q8, scale = entries[i]
        own, _ = quantize_kv(x)
        delta = (own.int() - q8.int()).abs()
        flips.append((int((delta > 0).sum()), delta.numel(), int(delta.max())))
        cache["i8"][l, rows, write_pos] = q8.to(cache["i8"].device)
        cache["s"][l, rows, write_pos] = scale.to(cache["s"].device)
        return None

    st_mod.trunk_decode_step, trunk_mod._cache_write_token = in_subtalker, cache_write
    try:
        yield
    finally:
        st_mod.trunk_decode_step, trunk_mod._cache_write_token = step, write
    if feed and next(taken, None) is not None:
        fail("parity: the CPU run wrote fewer sub-talker cache entries than the card's")


def _greedy_codes(model, device, texts, speakers, kw, forced=None, st_kv=None):
    """f32 greedy codes [rows, frames, groups], every sampling call's logits
    (on the CPU) and token, and the talker KV caches as the run left them,
    from an eager run (on the card too: the recording reads every call).
    With ``forced``, another run's tokens are taken at each call instead of
    this run's own (teacher forcing), so both runs see the same contexts.
    ``st_kv``: ``subtalker_kv_writes``' arguments, to record or feed the
    sub-talker's int8 cache entries."""
    import numpy as np

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod

    calls, caches = [], []
    originals = (gen_mod.sample_token, st_mod.sample_token, gen_mod.talker_mod.alloc_kv_cache)

    def recording(logits, cfg, generator, race=None, _orig=originals[0]):
        token = _orig(logits, cfg, generator, race)
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
        with eager_decode(), (subtalker_kv_writes(*st_kv) if st_kv is not None
                              else contextlib.nullcontext()):
            # the recording reads every call on the host
            codes, _ = model.generate_codes_from_prompts(prompts, model._merge_params(**kw))
    finally:
        gen_mod.sample_token, st_mod.sample_token, gen_mod.talker_mod.alloc_kv_cache = originals
    codes = np.stack(codes)
    log(f"parity: f32 greedy on {device}{' (teacher-forced)' * (forced is not None)}: "
        f"codes {codes.shape} in {time.perf_counter() - t0:.1f} s")
    return codes, calls, caches[-1]


def card_prompt(model, text, speaker):
    from qwen_tts_tpu_torch.generate import build_prompt

    return build_prompt(model.talker_params, model.cfg,
                        model._tokenize(model.build_assistant_text(text)), speaker=speaker)


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
    as ``KV_INT8_LOGIT_RTOL`` says; "int8+kv+st-kv8" the same, run under
    ``QTTS_ST_KV8=1`` (set by the caller), so that every position of the
    sub-talker's int8-cache route is compared. Every mode logs how far the
    logits of a teacher-forced CPU run lie from the card's."""
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
            model.quantize_for_serving(talker=True, kv=mode.startswith("int8+kv"))
        model.tokenizer = ChatTemplateTokenizer()
        models[device] = model
    splits = _attention_splits()
    st_entries = [] if mode == "int8+kv+st-kv8" else None
    a, card_calls, card_cache = _greedy_codes(
        models["cuda"], "cuda", texts, speakers, kw,
        st_kv=None if st_entries is None else (st_entries, False, []))
    log(f"{name}: decode-attention launches on the card by n_split {splits()}")
    b, cpu_calls, _ = _greedy_codes(models["cpu"], "cpu", texts, speakers, kw)
    _, forced_calls, cpu_cache = _greedy_codes(models["cpu"], "cpu", texts, speakers, kw,
                                               forced=card_calls)
    if a.shape != (2, 8, 16):
        fail(f"{name}: unexpected code shape {a.shape}")
    card = models["cuda"]
    prompts = [card_prompt(card, t, s) for t, s in zip(texts, speakers)]
    graph = np.stack(card.generate_codes_from_prompts(prompts, card._merge_params(**kw))[0])
    graph_equal = graph.shape == a.shape and bool((graph == a).all())
    log(f"{name}: the card's codes from the captured frame equal its eager codes: "
        f"{graph_equal}")
    if not graph_equal:
        fail(f"{name}: replayed and eager greedy codes differ on the card")
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
    if not mode.startswith("int8+kv"):
        if not equal:
            fail(f"{name}: card and CPU greedy codes differ at (row, frame, group) "
                 f"{np.argwhere(a != b)[:5].tolist()}")
        if mode == "float":
            del models["cpu"]
            check_oracle(card)
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
    if st_entries is not None:
        hold_fed_subtalker_kv(name, models["cpu"], texts, speakers, kw, card_calls, st_entries,
                              scale)


# Phase 5's greedy parity gate (``validation.check_parity``) at full depth on
# the card: one prompt, ORACLE_TOKENS greedy tokens. The cached path (the
# captured frames, the decode-attention kernel) and the cache-free oracle
# (a whole prefill every step; the sub-talker step by step, through the
# kernel) must agree token for token, the stop included. Set before the
# first run: a divergence passes only as a near tie, where the oracle's
# top-two logit gap at the diverging step (its talker's, or the smallest of
# the sub-talker's in the frame before, whose codes feed that step) is at
# most ORACLE_NEAR_TIE_REL of that call's largest |logit|.
ORACLE_TOKENS = 24
ORACLE_NEAR_TIE_REL = 1e-4


class _ArgmaxGaps:
    """Stands in for ``torch`` in ``validation``: each ``argmax`` also
    records (top-two gap, largest |logit| over the unsuppressed entries) of
    its input, in call order (per step: the talker's, then the sub-talker's
    G - 1)."""

    def __init__(self, torch_mod, calls: list):
        self._torch, self.calls = torch_mod, calls

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def argmax(self, x, *args, **kwargs):
        lg = x.float().reshape(-1, x.shape[-1])[0]
        top2 = self._torch.topk(lg, 2).values
        self.calls.append(((top2[0] - top2[1]).item(), lg[lg > -1e8].abs().max().item()))
        return self._torch.argmax(x, *args, **kwargs)


def check_oracle(model) -> None:
    """``check_parity`` on the f32 card model at full depth (phase 5)."""
    import torch

    from qwen_tts_tpu_torch import validation
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention

    tk = model.cfg.talker
    g, st_layers = tk.num_code_groups, tk.code_predictor.num_hidden_layers
    prompt = card_prompt(model, TEXTS[0], "aiden")
    calls, launches, seconds = [], {}, {}
    t0 = time.perf_counter()
    validation.fast_greedy_trace(model.talker_params, model.subtalker_params, model.cfg,
                                 prompt, ORACLE_TOKENS)  # its frame's capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    traces = {name: getattr(validation, name)
              for name in ("fast_greedy_trace", "eager_greedy_trace")}

    def counting(name):
        def trace(*args):
            before, t = decode_attention.launches, time.perf_counter()
            out = traces[name](*args)
            torch.cuda.synchronize()
            launches[name] = decode_attention.launches - before
            seconds[name] = time.perf_counter() - t
            return out
        return trace

    for name in traces:
        setattr(validation, name, counting(name))
    validation.torch = _ArgmaxGaps(torch, calls)  # the oracle's argmax calls
    try:
        result = validation.check_parity(model.talker_params, model.subtalker_params,
                                         model.cfg, prompt, ORACLE_TOKENS)
    finally:
        validation.torch = torch
        for name, fn in traces.items():
            setattr(validation, name, fn)
    fast_launches, oracle_launches = (launches[n] for n in traces)
    want_fast = len(result.fast.tokens) * (tk.num_hidden_layers + g * st_layers)
    want_oracle = len(result.eager.tokens) * g * st_layers
    lines = result.report().replace("\n", "; ")
    log(f"parity oracle: check_parity f32 at full depth ({tk.num_hidden_layers} talker "
        f"layers), prompt of {prompt.embeds.shape[0]} positions, {ORACLE_TOKENS} greedy tokens: "
        f"{lines}; the fast trace's first run (its capture) {capture_s:.2f} s; in "
        f"check_parity the fast trace (replayed frames) {seconds['fast_greedy_trace']:.2f} s, "
        f"decode-attention launches {fast_launches} (predicted {want_fast} when no EOS cuts "
        f"the last flag read's frames), the oracle {seconds['eager_greedy_trace']:.2f} s, "
        f"launches (its sub-talker loop) {oracle_launches} (predicted {want_oracle} = "
        f"{len(result.eager.tokens)} frames x {g} positions x {st_layers} layers); smallest "
        f"top-two gap the oracle met "
        f"{min(gap / max(scale, 1e-30) for gap, scale in calls):.3g} of its call's largest "
        f"|logit|")
    if fast_launches <= 0 or oracle_launches != want_oracle:
        fail("parity oracle: decode attention did not launch as predicted")
    if result.ok:
        return
    i = result.first_divergence
    if i is None:  # the tokens agree and the stops differ: no tie to allow
        fail(f"parity oracle: the traces stop differently: {lines}")
    steps = [(i * g, "talker")] + [((i - 1) * g + k, f"sub-talker position {k}")
                                   for k in range(1, g) if i > 0]
    gaps = [(calls[j][0] / max(calls[j][1], 1e-30), calls[j][0], where)
            for j, where in steps if j < len(calls)]
    rel, gap, where = min(gaps)
    log(f"parity oracle: first divergence at step {i}; the oracle's smallest top-two gap "
        f"there {gap:.4g} ({where}), {rel:.3g} of its largest |logit| (near tie at most "
        f"{ORACLE_NEAR_TIE_REL})")
    if not rel <= ORACLE_NEAR_TIE_REL:
        fail(f"parity oracle: the cached path and the cache-free oracle diverge at step {i}, "
             f"not at a near tie: {lines}")


# The sub-talker int8 KV route with its quantization flips taken out: the
# CPU's teacher-forced run reads the card's sub-talker cache entries and
# scales (``subtalker_kv_writes``), so only the talker's int8 KV (whose gap
# alone, the "int8+kv" run, was 0.00359 of a largest |logit| ~5.4 on an
# NVIDIA H100 80GB HBM3 at 700 W) and f32 sums in other orders remain. Its logits must agree within a quarter of one
# int8 step of the largest logit, set before the first card run of the check.
KV8_FED_LOGIT_RTOL = 1 / (4 * 127)


def hold_fed_subtalker_kv(name, cpu_model, texts, speakers, kw, card_calls, entries,
                          scale: float) -> None:
    """Phase 7's flip-free check of ``QTTS_ST_KV8=1``: the CPU run
    teacher-forced on the card's tokens and fed the card's sub-talker int8
    cache; max |logit card - CPU| within KV8_FED_LOGIT_RTOL x the largest
    |logit|."""
    flips = []
    _, fed_calls, _ = _greedy_codes(cpu_model, "cpu", texts, speakers, kw, forced=card_calls,
                                    st_kv=(entries, True, flips))
    if len(fed_calls) != len(card_calls) or not flips:
        fail(f"{name}: the fed CPU run made {len(fed_calls)} sampling calls, the card "
             f"{len(card_calls)}; {len(flips)} sub-talker cache writes fed")
    gap = 0.0
    for (lg_card, _), (lg_cpu, _) in zip(card_calls, fed_calls):
        live = lg_cpu > -1e8  # suppressed entries hold the same fill on both
        gap = max(gap, ((lg_card - lg_cpu) * live).abs().max().item())
    tol = KV8_FED_LOGIT_RTOL * scale
    log(f"{name}: fed the card's sub-talker int8 cache ({len(flips)} writes; the CPU's own "
        f"quantization would differ at {sum(f[0] for f in flips)} of "
        f"{sum(f[1] for f in flips)} entries, largest step {max(f[2] for f in flips)}): max "
        f"|logit card - CPU| {gap:.3g} (tol {tol:.3g} = largest |logit| / {4 * 127})")
    if not gap <= tol:
        fail(f"{name}: with the card's sub-talker cache fed, the logits still differ by "
             f"{gap:.3g} (tol {tol:.3g})")


def decode_walls(model, codes, runs: int = 5) -> list:
    """Host wall seconds of ``runs`` calls of decode_codes, each ending in a
    synchronise."""
    import torch

    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_codes(codes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def hold_codec_bf16(model, codes, name: str):
    """``decode_codes`` of ``codes`` through a bf16 codec (``model``): the
    vocoder-block kernel launches twice per codec_decode call, nothing else
    of the port's kernels runs; the waveforms are finite, in [-1, 1] and 1920
    samples per frame. Teacher-forced, each launch in a decode is held
    against the plain version on its own input. Before the clamp the
    waveforms lie within BF16_CODEC_REL_L2 of the same decode through the
    block's plain version. (The random codec drives ~99% of its samples into
    the clamp, where a sign flip of a large value reads as a difference of
    2, so that comparison scales the final conv, the last op before the
    clamp, by 2^-20: exact in bf16, it gives the unclamped waveform x
    2^-20.) Returns (waveforms, wall seconds of the counted decode)."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.models import codec as codec_mod
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block, vocoder_block_plain

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
                "vocoder_block": 2 * len(calls), "int8_matmul": 0}
    log(f"{name}: launches {launches}, expected {expected} (2 vocoder blocks x "
        f"{len(calls)} codec_decode call(s); frames per row {[c.shape[0] for c in codes]})")
    if launches != expected or not calls:
        fail(f"{name}: the bf16 codec did not launch the vocoder-block kernel as expected")
    want_len = [c.shape[0] * model.cfg.codec.decode_upsample_rate for c in codes]
    for i, (w, n) in enumerate(zip(wavs, want_len)):
        if w.shape != (n,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            fail(f"{name}: waveform {i}: shape {w.shape} (want {n}), finite "
                 f"{np.isfinite(w).all()}, max |x| {np.abs(w).max()}")

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
        fail(f"{name}: the scaled final conv still reaches the clamp ({np.abs(plain).max()})")
    rel = float(np.linalg.norm(kernel - plain) / np.linalg.norm(plain))
    log(f"{name}: kernel route vs plain route on the card, before the clamp: relative L2 "
        f"{rel:.4g} (tol {BF16_CODEC_REL_L2}), max |diff| "
        f"{np.abs(kernel - plain).max() * 2 ** 20:.4g} of max |ref| "
        f"{np.abs(plain).max() * 2 ** 20:.4g}")
    if not rel <= BF16_CODEC_REL_L2:
        fail(f"{name}: bf16 codec through the kernel disagrees with the plain route: {rel}")
    return wavs, wall


def phase_codec_bf16(model_dir: str, smi: str, path: dict) -> None:
    """The bf16 codec on the path phase's codes (``hold_codec_bf16``),
    beside the f32 codec's waveforms and decode walls of phase 4."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    log(f"codec bf16: from_pretrained (bf16 talker, bf16 codec) in "
        f"{time.perf_counter() - t0:.1f} s")
    codes = path["codes"]
    wavs, wall = hold_codec_bf16(model, codes, "codec bf16")
    a = np.concatenate(wavs)
    f32 = np.concatenate(path["wavs"])
    rel_f32 = float(np.linalg.norm(a - f32) / np.linalg.norm(f32))
    log(f"codec bf16: bf16 vs f32 codec (not asserted): relative L2 {rel_f32:.4g}, max |diff| "
        f"{np.abs(a - f32).max():.4g}, unclipped share {np.mean(np.abs(a) < 1):.4f}")
    audio_s = sum(w.shape[0] for w in wavs) / model.sample_rate
    walls = decode_walls(model, codes)
    log(f"codec bf16: decode_codes B={len(codes)} frames={codes[0].shape[0]} wall "
        f"{wall:.4f} s (f32 codec in the path phase {path['codec_s']:.4f} s), audio "
        f"{audio_s:.2f} s | {smi}")
    log(f"codec bf16 vs f32: decode_codes wall over {len(walls)} calls each, median (min..max): "
        f"bf16 {statistics.median(walls):.4f} s ({min(walls):.4f}..{max(walls):.4f}), f32 "
        f"{statistics.median(path['codec_walls']):.4f} s ({min(path['codec_walls']):.4f}.."
        f"{max(path['codec_walls']):.4f}) | {smi}")
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


def replays(segment: int, frames: int) -> int:
    """Frames a decode of ``segment`` frames replays when its rows are done
    after ``frames``: the loop reads the flag every CHECK_EVERY frames."""
    from qwen_tts_tpu_torch.generate import CHECK_EVERY

    return min(segment, max(1, -(-frames // CHECK_EVERY)) * CHECK_EVERY)


def stream_schedule():
    """The stream's emitted chunk sizes and the frames its decode replays:
    MAX_NEW frames generated, the budget-exhausted last one dropped; the
    first packet's frames, then segments of STREAM_CHUNK."""
    chunks = [STREAM_FIRST] + [STREAM_CHUNK] * ((FRAMES - STREAM_FIRST) // STREAM_CHUNK)
    if (FRAMES - STREAM_FIRST) % STREAM_CHUNK:
        chunks.append((FRAMES - STREAM_FIRST) % STREAM_CHUNK)
    frames, left = STREAM_FIRST, MAX_NEW - STREAM_FIRST
    while left > 0:
        frames += replays(STREAM_CHUNK, left)
        left -= STREAM_CHUNK
    return chunks, frames


def _stream_once(model, kw, text, speaker, language):
    """One stream: (first-packet seconds, wall seconds, audio seconds,
    chunks, per-chunk arrival stamps)."""
    chunks, stamps = [], []
    t0 = time.perf_counter()
    for wav, _ in model.stream_custom_voice(text, speaker, language,
                                            first_chunk_frames=STREAM_FIRST,
                                            chunk_frames=STREAM_CHUNK,
                                            left_context_frames=STREAM_CONTEXT, **kw):
        stamps.append(time.perf_counter() - t0)
        chunks.append(wav)
    wall = time.perf_counter() - t0
    return stamps[0], wall, sum(c.shape[0] for c in chunks) / model.sample_rate, chunks, stamps


def first_packet_split(model, prompt, params, runs: int = 5):
    """The eager three-stage first packet timed stage by stage with CUDA
    events: prefill, the first frames, the codec decode of their window.
    Returns per stage the milliseconds of each run."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import codec as codec_mod

    dtype = model.talker_params["norm"].dtype
    embeds, mask, trailing, _ = gen_mod.batch_prompts([prompt], bucket=16)
    embeds, trailing = embeds.to(dtype), trailing.to(dtype)
    tk, dec = model.cfg.talker, model.cfg.codec.decoder
    limit = torch.full((1,), params.max_new_tokens, dtype=torch.int32, device=model.device)
    out = {"prefill": [], "frames": [], "codec": [], "total": []}
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        state = gen_mod._prefill(model.talker_params, tk, embeds, mask,
                                 sampling=params.talker_sampling(),
                                 max_cache_len=embeds.shape[1] + params.max_new_tokens,
                                 generator=None, kv_int8=model.kv_int8)
        ev[1].record()
        state, seg = gen_mod._decode_eager(model.talker_params, model.subtalker_params, tk,
                                           params.talker_sampling(),
                                           params.subtalker_sampling(), state, trailing,
                                           limit, STREAM_FIRST)
        ev[2].record()
        codec_mod.codec_decode(model.codec_params, dec,
                               seg[:, :, : dec.num_quantizers].clamp(min=0))
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(("prefill", "frames", "codec", "total"),
                             ((0, 1), (1, 2), (2, 3), (0, 3))):
            out[k].append(ev[a].elapsed_time(ev[b]))
    return out


# The demo's custom-voice callback (phase 9): greedy controls (top-k 1 for
# the talker and, through the demo's CLI defaults, for the sub-talker) and a
# few frames.
DEMO_FRAMES = 8


@contextlib.contextmanager
def gradio_stand_in(callbacks: list):
    """A ``gradio`` module of inert components whose buttons record the
    callbacks they are given (the stand-in of tests/test_demo_build.py),
    for ``demo.build_demo`` while gradio is not installed."""
    import types

    class Component:
        def __init__(self, *a, **k):
            pass

    class Button(Component):
        def click(self, fn, inputs, outputs):
            callbacks.append(fn)

    class Ctx(Component):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    gr = types.ModuleType("gradio")
    gr.Blocks = gr.Tab = gr.Tabs = gr.Row = gr.Column = Ctx
    for name in ("Markdown", "Textbox", "Dropdown", "Slider", "Checkbox", "Audio", "File"):
        setattr(gr, name, Component)
    gr.Button = Button
    saved = sys.modules.get("gradio")
    sys.modules["gradio"] = gr
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["gradio"]
        else:
            sys.modules["gradio"] = saved


def check_demo_callback(model, smi: str) -> None:
    """The demo's custom-voice tab on the stream phase's model (bf16 talker
    and codec): its callback's audio equals ``generate_custom_voice`` with
    the same arguments, bit for bit."""
    import numpy as np

    from qwen_tts_tpu_torch import demo

    callbacks = []
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, tts_model_type="custom_voice")
    try:
        with gradio_stand_in(callbacks):
            demo.build_demo(model, {"subtalker_top_k": 1})
        controls = (DEMO_FRAMES + 1, 0.9, 1, 1.0, 1.0)  # max_new_tokens, temp, top-k, top-p, rp
        t0 = time.perf_counter()
        out, status = callbacks[0](TEXTS[1], "Serena", "English", *controls)
        ui_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wavs, sr = model.generate_custom_voice(
            TEXTS[1], "serena", "english", max_new_tokens=DEMO_FRAMES + 1, temperature=0.9,
            top_k=1, top_p=1.0, repetition_penalty=1.0, subtalker_top_k=1)
        direct_s = time.perf_counter() - t0
    finally:
        model.cfg = saved
    if out is None:
        fail(f"demo: the custom-voice callback failed: {status}")
    equal = out[0] == sr and out[1].shape == wavs[0].shape and np.array_equal(out[1], wavs[0])
    log(f"demo: custom-voice callback under the gradio stand-in (display names 'Serena' / "
        f"'English'), top-k 1, {DEMO_FRAMES + 1} tokens: status {status!r}, {out[1].shape[0]} "
        f"samples at {out[0]} Hz in {ui_s:.2f} s (its capture included); the direct "
        f"generate_custom_voice {direct_s:.2f} s; the same bits: {equal} | {smi}")
    if not equal:
        fail("demo: the callback's audio differs from the direct call's")


def phase_stream(model_dir: str, smi: str):
    """``stream_custom_voice`` at the flagship dims, bf16 talker and codec,
    B=1, greedy, EOS banned: the first packet one graph replay, the later
    segments replays of the captured frame, the later codec windows replays
    of one graph. The warm-up stream at the same shapes captures them.
    Returns the kernels' launches in the counted stream."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import graphs
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
    _stream_once(model, kw, text, speaker, language)  # warm-up: the captures
    log_programs("stream", smi)
    torch.cuda.synchronize()

    frames = []
    originals = _recording_segments(pipeline_mod, frames)
    for fn in _counters().values():
        fn.launches = 0
    try:
        first_s, wall, audio_s, chunks, stamps = _stream_once(model, kw, text, speaker,
                                                              language)
    finally:
        pipeline_mod._first_packet_program, pipeline_mod.decode_segment = originals
    launches = {k: fn.launches for k, fn in _counters().items()}

    up = model.cfg.codec.decode_upsample_rate
    sizes = [c.shape[0] // up for c in chunks]
    schedule, replayed = stream_schedule()
    tk = model.cfg.talker
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    expected = {"decode_attention": replayed * per_frame, "decode_attention_int8": 0,
                "subtalker_step": 0, "vocoder_block": 2 * len(schedule), "int8_matmul": 0}
    gaps = np.diff([0.0] + stamps)
    log(f"stream: B=1 first_chunk {first}, chunk {chunk}, left context {ctx} frames: "
        f"{len(chunks)} chunks of {sizes} frames, {sum(c.shape[0] for c in chunks)} samples; "
        f"first-packet latency {first_s * 1e3:.2f} ms; chunk wall times (ms) "
        f"{[round(float(g) * 1e3, 2) for g in gaps]}; wall {wall:.3f} s, audio {audio_s:.2f} s, "
        f"RTF(audio/wall) {audio_s / wall:.3f} | {smi}")
    log(f"stream: launches {launches}, expected {expected} (decode_attention {replayed} "
        f"replayed frames x {per_frame}: {MAX_NEW} generated, the rest run past the last "
        f"row's end before the next flag read; vocoder_block 2 per codec window, "
        f"{len(schedule)} windows)")
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

    # Graph against eager, in turns, and the eager first packet stage by stage.
    runs = graph_vs_eager(lambda: _stream_once(model, kw, text, speaker, language)[:3], runs=1)
    for side, r in runs.items():
        firsts = [x[0] * 1e3 for x in r["result"]]
        rtf = [x[2] / x[1] for x in r["result"]]
        log(f"stream {side}: over {len(firsts)} streams, median (min..max): first-packet "
            f"latency {_spread(firsts)} ms, stream RTF(audio/wall) {_spread(rtf, '{:.3f}')}, "
            f"wall {_spread([x[1] for x in r['result']], '{:.3f}')} s, peak mem allocated "
            f"{_spread(r['peak'], '{:.3f}')} GiB | {smi}")
    split = first_packet_split(model, prompt, params)
    log(f"stream first packet, eager, by stage (CUDA events, {len(split['total'])} runs, "
        f"median (min..max) ms): prefill {_spread(split['prefill'])}, {first} frames "
        f"{_spread(split['frames'])}, codec decode of {first} frames {_spread(split['codec'])}, "
        f"total {_spread(split['total'])} | {smi}")
    check_demo_callback(model, smi)
    log_programs("stream", smi)
    del model
    graphs.clear()
    torch.cuda.empty_cache()
    return launches


def _eos_token(codes0, limits) -> int:
    """Of the codebook-0 tokens of an EOS-banned run [B, T], the one whose
    first frames differ over the most rows (none at frame 0) and leave the
    last row's end, each row's first frame or its budget, off a flag read."""
    import numpy as np

    from qwen_tts_tpu_torch.generate import CHECK_EVERY

    best, best_spread = None, -1
    for v in sorted(set(codes0[:, 1:].ravel().tolist())):
        firsts = [int(np.argmax(row == v)) if (row == v).any() else None for row in codes0]
        hits = [f for f in firsts if f is not None]
        ends = [min(f, n) if f is not None else n for f, n in zip(firsts, limits)]
        if 0 in hits or len(hits) < 2 or max(ends) % CHECK_EVERY == 0:
            continue
        if len(set(hits)) > best_spread:
            best, best_spread = v, len(set(hits))
    return best


# The graphs phase's depth: the talker's first GRAPH_TALKER_LAYERS layers
# (the sub-talker whole: its micro-step kernel is built for 5), GRAPH_FRAMES
# frames a run (four flag reads). Its checks are of the frame's capture and
# replay against the same frames run eagerly, which need neither the
# talker's full depth nor a long run; the path phases run both.
GRAPH_TALKER_LAYERS = 4
GRAPH_FRAMES = 33
# Per-row frame budgets of the graphs phase's EOS run: every row ends
# before GRAPH_FRAMES, the last of them off a flag read (29 = 3 x 8 + 5).
EOS_RUN_LIMITS = (29, 25, 21, 17)


def _segment(model, inputs, gp, eager: bool, seed=None, limits=None, frames=MAX_NEW,
             profiler=None):
    """Prefill, then ``frames`` frames from the module's own segment
    function: ``_decode`` (replays of the captured frame) or
    ``_decode_eager``; each row's budget ``limits`` (default MAX_NEW); the
    cache holds MAX_NEW frames. ``profiler`` (a context manager factory)
    wraps the frames alone; returns (state, buffer, host seconds of the
    frames, each ending in a synchronise)."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod

    e, m, t = inputs
    tk = model.cfg.talker
    generator = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
    state = gen_mod._prefill(model.talker_params, tk, e, m, sampling=gp.talker_sampling(),
                             max_cache_len=e.shape[1] + MAX_NEW, generator=generator,
                             kv_int8=model.kv_int8)
    limit = torch.tensor(limits or [MAX_NEW] * e.shape[0], dtype=torch.int32, device=e.device)
    fn = gen_mod._decode_eager if eager else gen_mod._decode
    torch.cuda.synchronize()
    with profiler() if profiler else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        state, buf = fn(model.talker_params, model.subtalker_params, tk, gp.talker_sampling(),
                        gp.subtalker_sampling(), state, t, limit, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return state, buf, wall, prof


def _same_decode(a, b) -> bool:
    """Two (state, buffer) results bit for bit: the buffer, the codes state
    and the hidden state."""
    import torch

    (sa, ba), (sb, bb) = a[:2], b[:2]
    return bool(torch.equal(ba, bb)) and all(
        torch.equal(getattr(sa, f), getattr(sb, f))
        for f in ("token", "hidden", "presence", "eos", "num_gen"))


# What phase_graphs' modes run; "serving+kv" is phase 6's serving path
# (quantize_for_serving(talker=True, kv=True)).
GRAPH_MODES = {"bf16": "bf16 weights and KV cache",
               "serving": "int8 weights, bf16 KV cache",
               "serving+kv": "int8 weights and KV cache, the serving path"}


def time_replayed_frames(model, inputs, gp, mode: str, smi: str, runs: int = 5) -> dict:
    """The replayed decode segment (B=4, GRAPH_FRAMES frames, prefill
    outside) timed ``runs`` times: ms a frame, median (min..max); then one
    profiled replay: device busy time a frame and the int8 GEMM's share of
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = GRAPH_FRAMES
    ms = [_segment(model, inputs, gp, eager=False, frames=n)[2] / n * 1e3 for _ in range(runs)]
    prof = _segment(model, inputs, gp, eager=False, frames=n, profiler=lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))[3]
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    int8 = [e for e in device if "int8_matmul_kernel" in e.key]
    int8_ms = sum(e.self_device_time_total for e in int8) / 1e3 / n
    launches = sum(e.count for e in int8) / n
    kernels = sum(e.count for e in device) / n
    log(f"graphs [{mode}]: {GRAPH_MODES[mode]}: replayed decode B=4, {n} frames "
        f"(prefill outside), {runs} runs: "
        f"{_spread(ms)} ms/frame; one profiled replay: device busy {busy:.3f} ms/frame in "
        f"{kernels:.1f} device ops/frame, int8_matmul {int8_ms:.4f} ms/frame in {launches:.1f} "
        f"launches/frame | {smi}")
    return {"ms": ms, "busy_ms": busy, "int8_ms": int8_ms}


def cut_talker_depth(model, layers: int) -> None:
    """The model's talker cut to its first ``layers`` layers, in place."""
    tk = model.cfg.talker
    model.cfg = dataclasses.replace(model.cfg, talker=dataclasses.replace(
        tk, num_hidden_layers=layers))
    model.talker_params = dict(model.talker_params, trunk={
        k: v[:layers] for k, v in model.talker_params["trunk"].items()})


def phase_graphs(model_dir: str, smi: str) -> None:
    """Phase 10: the replayed decode against the eager frame loop on the
    card, each through the module's own function (``_decode``,
    ``_decode_eager``), B=4 at the path's prompts, GRAPH_FRAMES frames at a
    talker of GRAPH_TALKER_LAYERS layers: bf16,
    serving and serving + int8 KV, greedy with EOS banned and with EOS
    allowed (the talker's EOS column set to 1.01 x the column of a token the
    rows first choose at different frames, so rows stop at different frames
    and frames run past the last row's end); bf16 sampled, one seed twice
    and another seed, and sampled graph against eager; the B=1 first packet
    as one graph replay against the eager three-stage program."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    speakers = ["aiden", "serena", "aiden", "serena"]
    languages = ["english", "auto", "chinese", "english"]
    n = GRAPH_FRAMES
    for mode in GRAPH_MODES:
        model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                              load_tokenizer=False)
        cut_talker_depth(model, GRAPH_TALKER_LAYERS)
        if mode != "bf16":
            model.quantize_for_serving(talker=True, kv=mode == "serving+kv")
        model.tokenizer = ChatTemplateTokenizer()
        dtype = model.talker_params["norm"].dtype
        prompts = [gen_mod.build_prompt(model.talker_params, model.cfg,
                                        model._tokenize(model.build_assistant_text(t)),
                                        language=lang, speaker=spk)
                   for t, spk, lang in zip(TEXTS, speakers, languages)]
        e, m, t, _ = gen_mod.batch_prompts(prompts)
        inputs = (e.to(dtype), m, t.to(dtype))
        banned = model._merge_params(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1,
                                     do_sample=False, subtalker_dosample=False,
                                     repetition_penalty=1.0)
        graph = _segment(model, inputs, banned, eager=False, frames=n)
        eager = _segment(model, inputs, banned, eager=True, frames=n)
        same = _same_decode(graph, eager)
        log(f"graphs [{mode}]: B=4, {n} frames, talker {GRAPH_TALKER_LAYERS} layers, greedy, "
            f"EOS banned: replayed == eager (buffer, token, hidden, presence, eos, num_gen bit "
            f"for bit): {same}; num_gen {graph[0].num_gen.tolist()}; frames "
            f"{graph[2] / n * 1e3:.2f} ms each replayed, {eager[2] / n * 1e3:.2f} eager (one "
            f"run each) | {smi}")
        if not same:
            fail(f"graphs [{mode}]: the replayed decode differs from the eager loop")
        time_replayed_frames(model, inputs, banned, mode, smi)

        x = _eos_token(graph[1][..., 0].cpu().numpy(), EOS_RUN_LIMITS)
        eos = model.cfg.talker.codec_eos_token_id
        head = model.talker_params["codec_head"].clone()
        head[:, eos] = head[:, x] * 1.01
        model.talker_params = dict(model.talker_params, codec_head=head)
        allowed = dataclasses.replace(banned, min_new_tokens=0)
        graph = _segment(model, inputs, allowed, eager=False, limits=EOS_RUN_LIMITS, frames=n)
        eager = _segment(model, inputs, allowed, eager=True, limits=EOS_RUN_LIMITS, frames=n)
        same = _same_decode(graph, eager)
        num_gen = graph[0].num_gen.tolist()
        done = max(num_gen)
        ran = replays(n, done)
        log(f"graphs [{mode}]: EOS allowed (EOS column = 1.01 x token {x}'s), budgets "
            f"{list(EOS_RUN_LIMITS)}: rows stop "
            f"after {num_gen} frames (EOS {graph[0].eos.tolist()}), the loop replays {ran} "
            f"frames ({ran - done} past the last row's end), replayed == eager: {same}; "
            f"buffer zero from frame {done}: {not bool(graph[1][:, done:].any())}")
        if not same or graph[1][:, done:].any() or len(set(num_gen)) < 2 or not ran > done:
            fail(f"graphs [{mode}]: the EOS run is not as the eager loop leaves it, or no "
                 f"frame ran past the rows' end")

        if mode == "bf16":
            sampled = model._merge_params(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1)
            runs = [_segment(model, inputs, sampled, eager=False, seed=s, frames=n)
                    for s in (0, 0, 1)]
            eager = _segment(model, inputs, sampled, eager=True, seed=0, frames=n)
            twice = _same_decode(runs[0], runs[1])
            other = not torch.equal(runs[0][1], runs[2][1])
            vs_eager = _same_decode(runs[0], eager)
            log(f"graphs [{mode}]: sampled (top-k 50, T 0.9, rep. penalty 1.05): seed 0 "
                f"twice identical {twice}, seed 1 differs {other}, replayed == eager at "
                f"seed 0 {vs_eager}")
            if not (twice and other and vs_eager):
                fail(f"graphs [{mode}]: sampled replays are not reproducible from the seed")
            check_first_packet_graph(model, prompts[0], banned, smi)
        log_programs(f"graphs [{mode}]", smi)
        del model
        graphs.clear()
        torch.cuda.empty_cache()


def check_first_packet_graph(model, prompt, params, smi: str) -> None:
    """The B=1 first packet (bf16 talker and codec, greedy, EOS banned):
    ``_first_packet_program`` is one graph replay; its codes and state equal
    the eager three-stage program's, its waveform lies within
    BF16_CODEC_REL_L2 of it."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch import pipeline as pipeline_mod

    dtype = model.talker_params["norm"].dtype
    embeds, mask, trailing, _ = gen_mod.batch_prompts([prompt], bucket=16)
    args = (model.talker_params, model.subtalker_params, model.codec_params, model.cfg.talker,
            model.cfg.codec.decoder, embeds.to(dtype), mask, trailing.to(dtype))
    kw = dict(sampling=params.talker_sampling(), st_sampling=params.subtalker_sampling(),
              max_cache_len=embeds.shape[1] + MAX_NEW, generator=None,
              first_segment=STREAM_FIRST, step_limit=MAX_NEW)
    pipeline_mod._first_packet_program(*args, **kw)  # the capture
    count = [0]
    replay = graphs.Graph.replay

    def counting(self):
        count[0] += 1
        replay(self)

    graphs.Graph.replay = counting
    try:
        state, seg, wav = pipeline_mod._first_packet_program(*args, **kw)
    finally:
        graphs.Graph.replay = replay
    e_state, e_seg, e_wav = pipeline_mod._first_packet_eager(*args, **kw)
    same = bool(torch.equal(seg, e_seg)) and all(
        torch.equal(getattr(state, f), getattr(e_state, f))
        for f in ("token", "hidden", "presence", "eos", "num_gen"))
    a, b = wav.float().cpu().numpy(), e_wav.float().cpu().numpy()
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    log(f"graphs first packet: B=1, {STREAM_FIRST} frames + codec decode: {count[0]} graph "
        f"replay(s); codes and state == the eager three-stage program: {same}; waveform "
        f"relative L2 {rel:.3g} (tol {BF16_CODEC_REL_L2}), shape {tuple(wav.shape)}")
    if count[0] != 1 or not same or not rel <= BF16_CODEC_REL_L2 or not np.isfinite(a).all():
        fail("graphs: the first packet's graph disagrees with the eager program")


def clone_clips(seed: int = 7):
    """The phase's reference clips as ``(waveform, rate)``: a few voiced
    partials with a slow vibrato and noise, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clips = []
    for seconds, rate in CLONE_CLIPS:
        t = np.arange(int(seconds * rate)) / rate
        f0 = rng.uniform(90, 220) * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / rate
        wav = sum(rng.uniform(0.05, 0.2) / k * np.sin(k * phase) for k in range(1, 6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t) ** 2)
        clips.append(((wav + 0.01 * rng.standard_normal(t.shape)).astype(np.float32), rate))
    return clips


def clone_prompts(model, prompt, texts, languages):
    """The talker prompts ``generate_voice_clone`` builds for ``texts``."""
    return model._request_prompts(**model._clone_request(texts, prompt, languages))[0]


def _launches_of(fn):
    """The kernels' launches while ``fn`` runs, and its result."""
    import torch

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}, result, time.perf_counter() - t0


def time_clone_prompts(model, clips, smi: str) -> None:
    """``create_voice_clone_prompt`` per clip (after a warm-up call on the
    same clip: the first call of a length pays cuDNN's plan search and the
    first resample scipy's import), and its stages alone: resample (host),
    Mimi encode, x-vector."""
    import torch

    from qwen_tts_tpu_torch.audio import resample

    for (wav, rate), text in zip(clips, CLONE_REF_TEXTS):
        model.create_voice_clone_prompt((wav, rate), ref_text=text)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.create_voice_clone_prompt((wav, rate), ref_text=text)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w24 = resample(wav, rate, 24000)
        t2 = time.perf_counter()
        codes = model.speech_encoder.encode([w24], 24000)[0]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        model.extract_speaker_embedding(w24, 24000)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        log(f"clone prompt: {wav.shape[0] / rate:.1f} s clip at {rate} Hz ({codes.shape[0]} "
            f"frames): create_voice_clone_prompt {(t1 - t0) * 1e3:.1f} ms; alone: resample "
            f"{(t2 - t1) * 1e3:.1f} ms, Mimi encode {(t3 - t2) * 1e3:.1f} ms, x-vector "
            f"{(t4 - t3) * 1e3:.1f} ms | {smi}")


def rvq_distances(params: dict, cfg, h, codes):
    """The distance ``|r|² - 2 r·e + |e|²`` of each given code [B, Q, T] from
    its quantizer's input ``r``, where each residual follows the given codes
    (not the argmin); h: ``mimi_latents``. Where
    two encodes of one clip first part in a quantizer branch, both codes'
    distances share a residual: a near-tie shows as two close distances."""
    import torch

    from qwen_tts_tpu_torch.models.mimi_encoder import _branches

    out = []
    q0 = 0
    for proj, books in _branches(params, cfg, codes.shape[1]):
        residual = h if proj is None else h @ proj
        for embed in books:
            idx = codes[:, q0]
            e = embed[idx]  # [B, T, D]
            out.append((residual * residual).sum(-1) - (2.0 * residual * e).sum(-1)
                       + (e * e).sum(-1))
            residual = residual - e
            q0 += 1
    return torch.stack(out, dim=1)


def code_disagreements(params: dict, cfg, wav, a, b):
    """Two encodes ``a``, ``b`` [B, Q, T] of ``wav`` (say, by two devices or
    two packages) compared: (share of codes equal, the relative gap
    ``|d_a - d_b| / max(d_a, d_b)`` of the two codes' distances where a
    quantizer branch of a frame first parts). A gap near 0 is a near-tie;
    the branch's later codes follow from it and have no gap of their own."""
    import torch

    from qwen_tts_tpu_torch.models.mimi_encoder import mimi_latents

    h = mimi_latents(params, cfg, wav)
    da, db = rvq_distances(params, cfg, h, a), rvq_distances(params, cfg, h, b)
    differ = a != b
    gaps = []
    for lo, hi in ((0, cfg.num_semantic_quantizers), (cfg.num_semantic_quantizers, a.shape[1])):
        d = differ[:, lo:hi]
        if d.shape[1] == 0:
            continue
        first = lo + d.int().argmax(dim=1, keepdim=True)  # [B, 1, T]
        parted = d.any(dim=1)
        pa, pb = da.gather(1, first)[:, 0][parted], db.gather(1, first)[:, 0][parted]
        gaps.append((pa - pb).abs() / torch.maximum(pa.abs(), pb.abs()).clamp(min=1e-30))
    return (~differ).float().mean().item(), torch.cat(gaps)


def check_clone_encoders(card, cpu, clips) -> None:
    """Card against CPU on the same clips: the Mimi codes of the padded
    batch (as ``SpeechTokenizerEncoder.encode`` pads it) agree at
    CLONE_CODE_AGREEMENT or more, every first disagreement a near-tie; the
    x-vectors lie within CLONE_XVEC_REL_L2."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.audio import resample
    from qwen_tts_tpu_torch.models.mimi_encoder import mimi_encode

    w24 = [resample(w, rate, 24000) for w, rate in clips]
    enc = cpu.speech_encoder
    bucket = enc.downsample_rate * 8
    batch = np.zeros((len(w24), -(-max(w.shape[0] for w in w24) // bucket) * bucket),
                     np.float32)
    for i, w in enumerate(w24):
        batch[i, : w.shape[0]] = w
    nq = enc.valid_num_quantizers
    with torch.inference_mode():
        on_card = mimi_encode(card.speech_encoder.params, enc.cfg,
                              torch.as_tensor(batch, device=card.device), nq).cpu()
        t0 = time.perf_counter()
        on_cpu = mimi_encode(enc.params, enc.cfg, torch.from_numpy(batch), nq)
        cpu_s = time.perf_counter() - t0
        agreement, gaps = code_disagreements(enc.params, enc.cfg, torch.from_numpy(batch),
                                             on_card, on_cpu)
    worst = gaps.max().item() if gaps.numel() else 0.0
    log(f"clone encode: card vs CPU Mimi codes of {len(w24)} clips ({tuple(on_cpu.shape)} "
        f"padded to {batch.shape[1]} samples): agreement {agreement:.6f} (min "
        f"{CLONE_CODE_AGREEMENT}), {gaps.numel()} first disagreement(s), largest relative "
        f"distance gap {worst:.3g} (near-tie limit {CLONE_NEAR_TIE_REL}); CPU encode "
        f"{cpu_s:.1f} s")
    if agreement < CLONE_CODE_AGREEMENT or worst > CLONE_NEAR_TIE_REL:
        fail("clone: card and CPU Mimi codes disagree beyond near-ties")
    rels = []
    for w in w24:
        a, b = card.extract_speaker_embedding(w, 24000), cpu.extract_speaker_embedding(w, 24000)
        rels.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    log(f"clone encode: card vs CPU x-vectors, relative L2 per clip "
        f"{[f'{r:.3g}' for r in rels]} (tol {CLONE_XVEC_REL_L2})")
    if not max(rels) <= CLONE_XVEC_REL_L2:
        fail("clone: card and CPU x-vectors disagree")


def clone_parity(base_dir: str, clips) -> None:
    """f32 on the card and on the CPU: the encoders (``check_clone_encoders``),
    then the card's ICL prompt of two clips saved as a voice file (``.pt``),
    loaded, and greedy ``generate_voice_clone`` codes from it on both:
    card == CPU. Going through the file keeps the encoders' last bits out
    of the comparison of the decode."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    models = {}
    for device in ("cuda", "cpu"):
        models[device] = Qwen3TTSModel.from_pretrained(base_dir, talker_dtype=torch.float32,
                                                       device=device, load_tokenizer=False)
        models[device].tokenizer = ChatTemplateTokenizer()
    card, cpu = models["cuda"], models["cpu"]
    check_clone_encoders(card, cpu, clips)
    path = os.path.join(base_dir, "voice.pt")
    card.save_voice_clone_prompt(
        card.create_voice_clone_prompt(clips[:2], ref_text=CLONE_REF_TEXTS[:2]), path)
    prompt = Qwen3TTSModel.load_voice_clone_prompt(path)
    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=9, min_new_tokens=10)
    texts, languages = TEXTS[:2], ["english", "auto"]
    codes = {}
    for device, model in models.items():
        t0 = time.perf_counter()
        out, _ = model.generate_codes_from_prompts(
            clone_prompts(model, prompt, texts, languages), model._merge_params(**kw))
        codes[device] = np.stack(out)
        log(f"clone parity: f32 greedy clone codes on {device} {codes[device].shape} in "
            f"{time.perf_counter() - t0:.1f} s")
    a, b = codes["cuda"], codes["cpu"]
    equal = a.shape == b.shape and bool((a == b).all())
    log(f"clone parity: card and CPU greedy codes from the voice file "
        f"{'equal' if equal else 'differ'} ({a.shape[0]} rows x {a.shape[1]} frames x "
        f"{a.shape[2]} groups; reference frames {[c.shape[0] for c in prompt['ref_code']]})")
    if not equal:
        fail(f"clone parity: card and CPU codes differ at (row, frame, group) "
             f"{np.argwhere(a != b)[:5].tolist()}")


def hold_clone_attention(bucket: int, lengths) -> dict:
    """Both decode-attention kernels against their plain versions at the
    clone batch's talker cache, S_max = its prompt bucket + MAX_NEW, whose
    split no earlier phase holds: the generic rows, then the batch's own
    left pads at its first and last decode step. Returns each kernel's
    largest error."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    s_max = bucket + MAX_NEW
    valid_from = [bucket - n for n in lengths]
    rows = [([bucket + 1] * len(lengths), valid_from), ([s_max] * len(lengths), valid_from)]
    return {name: hold_attention_at(gen, (*ATTN_TALKER, s_max), int8, "clone talker", rows)
            for name, int8 in (("decode_attention", False), ("decode_attention_int8", True))}


def check_tokenizer(base_dir: str, clips, ref_codes, model, codes, smi: str) -> None:
    """``Qwen3TTSTokenizer`` on the Base checkpoint's speech tokenizer (f32,
    on the card): ``encode`` of the clips gives the clone prompt's Mimi codes
    and ``decode`` of ``codes`` the model's ``decode_codes``, bit for bit."""
    import numpy as np

    from qwen_tts_tpu_torch.tokenizer import Qwen3TTSTokenizer

    t0 = time.perf_counter()
    tok = Qwen3TTSTokenizer.from_pretrained(os.path.join(base_dir, "speech_tokenizer"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoded = tok.encode(clips)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wavs, sr = tok.decode({"audio_codes": codes})
    decode_s = time.perf_counter() - t0
    want = model.decode_codes(codes)
    same_codes = [np.array_equal(a, b) for a, b in zip(encoded["audio_codes"], ref_codes)]
    same_wavs = [np.array_equal(a, b) for a, b in zip(wavs, want)]
    log(f"clone tokenizer: Qwen3TTSTokenizer ({tok.get_model_type()}, on {tok.device}) read in "
        f"{load_s:.1f} s; encode of the {len(clips)} clips in {encode_s:.2f} s (the Mimi "
        f"encoder read at first use): the prompt's codes {same_codes}; decode of "
        f"{[c.shape[0] for c in codes]} frames at {sr} Hz in {decode_s:.2f} s: "
        f"decode_codes' bits {same_wavs} | {smi}")
    if not (all(same_codes) and all(same_wavs) and len(same_codes) == len(clips)
            and len(same_wavs) == len(codes)):
        fail("clone: the tokenizer's encode or decode differs from the model's")


def phase_clone(base_dir: str, smi: str) -> dict:
    """Voice clone at the flagship dims (phase 11) on a Base checkpoint: the
    published ECAPA-TDNN and Mimi encoder widths. Prompts from four ragged
    reference clips (ICL) and one x-vector-only prompt; generate_voice_clone
    for the batch of 4 (bf16 talker, f32 codec, EOS banned, MAX_NEW frames)
    through the graphs, then in the serving mode; the bf16 codec on the merged
    reference + generated codes; f32 card against CPU. Returns each path's
    kernel launches."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(base_dir)
    model.tokenizer = ChatTemplateTokenizer()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = model.speech_encoder
    log(f"clone: from_pretrained of the Base checkpoint (bf16 talker, f32 codec, f32 speaker "
        f"encoder) in {load_s:.1f} s, the Mimi encoder read in {time.perf_counter() - t0:.1f} s "
        f"({enc.cfg.num_hidden_layers} x {enc.cfg.hidden_size} transformer, "
        f"{enc.cfg.num_quantizers} quantizers of {enc.cfg.codebook_size} x "
        f"{enc.cfg.codebook_dim}, {enc.valid_num_quantizers} kept)")
    if model.speaker_params is None or model.cfg.tts_model_type != "base":
        fail("clone: the Base checkpoint's speaker encoder was not read")
    tk, se = model.cfg.talker, model.cfg.speaker_encoder
    clips = clone_clips()
    time_clone_prompts(model, clips, smi)
    prompt = model.create_voice_clone_prompt(clips, ref_text=CLONE_REF_TEXTS)
    xvec_prompt = model.create_voice_clone_prompt(clips[0], x_vector_only_mode=True)
    xv = np.stack(prompt["ref_spk_embedding"])
    ref_frames = [c.shape[0] for c in prompt["ref_code"]]
    want_frames = [-(-int(sec * 24000) // model.cfg.codec.encode_downsample_rate)
                   for sec, _ in CLONE_CLIPS]
    apart = min(np.linalg.norm(xv[i] - xv[j]) / np.linalg.norm(xv[j])
                for i in range(len(xv)) for j in range(i))
    log(f"clone: x-vectors {xv.shape}, finite {np.isfinite(xv).all()}, smallest relative "
        f"distance between clips {apart:.3g}; reference codes {ref_frames} frames x "
        f"{prompt['ref_code'][0].shape[1]} groups (distinct group-0 codes "
        f"{[len(np.unique(c[:, 0])) for c in prompt['ref_code']]})")
    if (xv.shape != (len(clips), se.enc_dim) or not np.isfinite(xv).all() or not apart > 1e-3
            or ref_frames != want_frames or prompt["ref_code"][0].shape[1] != tk.num_code_groups
            or not np.array_equal(xvec_prompt["ref_spk_embedding"][0], xv[0])):
        fail("clone: unexpected prompts")

    kw = dict(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1, seed=0)
    languages = ["english", "auto", "chinese", "english"]
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    up = model.cfg.codec.decode_upsample_rate
    graphs.clear()
    model.generate_voice_clone(TEXTS, prompt, languages, **kw)  # warm-up: the capture
    log_programs("clone", smi)
    torch.cuda.reset_peak_memory_stats()
    launches, (wavs, sr), wall = _launches_of(
        lambda: model.generate_voice_clone(TEXTS, prompt, languages, **kw))
    expected = {"decode_attention": MAX_NEW * per_frame, "decode_attention_int8": 0,
                "subtalker_step": 0, "vocoder_block": 0, "int8_matmul": 0}
    log(f"clone: launches {launches}, expected {expected} (decode_attention {MAX_NEW} frames x "
        f"{per_frame}, captured launches x replays)")
    if launches != expected:
        fail("the clone path did not launch the kernels as expected")
    for i, w in enumerate(wavs):
        if w.shape != (FRAMES * up,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            fail(f"clone waveform {i}: shape {w.shape} (want {FRAMES * up} after the cut of "
                 f"{ref_frames[i]} reference frames), finite {np.isfinite(w).all()}, max |x| "
                 f"{np.abs(w).max()}")
    audio_s = len(wavs) * FRAMES * up / sr
    log(f"clone: generate_voice_clone B={len(wavs)} frames={FRAMES} (+ {ref_frames} reference "
        f"frames in the codec decode) wall {wall:.3f} s, RTF(audio/wall) {audio_s / wall:.3f}, "
        f"peak mem allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")

    prompts = clone_prompts(model, prompt, TEXTS, languages)
    bucket = gen_mod.batch_prompts(prompts)[0].shape[1]
    errs = hold_clone_attention(bucket, [p.embeds.shape[0] for p in prompts])
    params = model._merge_params(**kw)
    loops, calls = [], []
    for _ in range(5):  # in turns: the decode loop, then the whole call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, _ = model.generate_codes_from_prompts(prompts, params)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
        calls.append(_launches_of(
            lambda: model.generate_voice_clone(TEXTS, prompt, languages, **kw))[2])
    log(f"clone graph: over 5 runs, median (min..max): decode loop "
        f"{_spread([w / MAX_NEW * 1e3 for w in loops])} ms/step (prompt bucket "
        f"{bucket}); "
        f"generate_voice_clone {_spread(calls, '{:.3f}')} s, RTF(audio/wall) "
        f"{_spread([audio_s / w for w in calls], '{:.3f}')} | {smi}")
    xw, _ = model.generate_voice_clone(TEXTS, xvec_prompt, languages, **kw)
    if any(w.shape != (FRAMES * up,) or not np.isfinite(w).all() for w in xw):
        fail("clone: the x-vector-only prompt's waveforms are wrong")
    log(f"clone: x-vector-only prompt broadcast over {len(xw)} texts: {len(xw)} waveforms of "
        f"{FRAMES * up} samples")
    merged = [np.concatenate([rc, c], axis=0) for rc, c in zip(prompt["ref_code"], codes)]
    check_tokenizer(base_dir, clips, prompt["ref_code"], model, merged, smi)

    # The serving mode on the same prompts.
    model.quantize_for_serving(talker=True, kv=True)
    model.generate_voice_clone(TEXTS, prompt, languages, **kw)  # warm-up: the capture
    serving, (swavs, _), swall = _launches_of(
        lambda: model.generate_voice_clone(TEXTS, prompt, languages, **kw))
    layers, g = tk.num_hidden_layers, tk.num_code_groups
    expected = {"decode_attention": 0, "decode_attention_int8": MAX_NEW * layers,
                "subtalker_step": MAX_NEW * g, "vocoder_block": 0,
                "int8_matmul": (1 + MAX_NEW) * layers * len(LAYER_LAUNCHES) + MAX_NEW * (g - 1)}
    log(f"clone serving: launches {serving}, expected {expected} (as phase 6); wall "
        f"{swall:.3f} s, RTF(audio/wall) {audio_s / swall:.3f} | {smi}")
    if serving != expected:
        fail("the clone serving path did not launch the kernels as expected")
    if any(w.shape != (FRAMES * up,) or not np.isfinite(w).all() for w in swavs):
        fail("clone serving: wrong waveforms")
    casts = count_int8_weight_casts(model, clone_prompts(model, prompt, TEXTS, languages),
                                    dict(kw, max_new_tokens=3, min_new_tokens=4))
    log(f"clone serving: int8 weights cast whole in a 3-step decode: {casts}")
    if casts:
        fail("the clone serving path casts int8 weights whole")
    del model
    graphs.clear()
    torch.cuda.empty_cache()

    # The bf16 codec on the merged reference + generated codes.
    codec = Qwen3TTSModel.from_pretrained(base_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    hold_codec_bf16(codec, merged, "clone codec bf16")
    del codec
    torch.cuda.empty_cache()
    clone_parity(base_dir, clips)
    graphs.clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "serving": serving, "attention_err": errs}


# --------------------------------------------------------------------------
# Phase 12: the serving engines and the HTTP server
# --------------------------------------------------------------------------

# The continuous engine's load: 8 slots, 25-frame segments, a ceiling of 96
# frames, one prefill bucket of 32. 16 requests, the smoke texts in 4 voices
# (the flagship config's two speakers, each in two languages), budgets
# (max_new_tokens) of 32/48/64/96 frames four each, EOS banned, greedy.
SERVING_SLOTS, SERVING_SEGMENT, SERVING_CEILING, SERVING_BUCKET = 8, 25, 96, 32
SERVING_BUDGETS = (32, 48, 64, 96)
SERVING_VOICES = (("aiden", "english"), ("serena", "english"), ("aiden", "chinese"),
                  ("serena", "auto"))
SERVING_GREEDY = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
                      min_new_tokens=SERVING_CEILING + 1)
# A request's codes from a pool against the same request alone may differ
# only where the alone run's top two logits (eager, recorded) lie within
# this share of that call's largest |logit|: the bf16 plain ops around the
# kernels (cuBLAS products, norms) are not shown batch-invariant, and one
# bf16 ulp of a hidden state (2^-8 relative) moves a logit by about that
# much of its scale.
SERVING_NEAR_TIE = 2 ** -6
# Per-row controls: four sampled requests beside four greedy ones.
SERVING_SAMPLED = (
    dict(do_sample=True, temperature=0.7, top_k=20, top_p=1.0, repetition_penalty=1.05),
    dict(do_sample=True, temperature=1.1, top_k=0, top_p=0.8, repetition_penalty=1.2),
    dict(do_sample=True, temperature=0.9, top_k=50, top_p=0.9, repetition_penalty=1.0,
         subtalker_dosample=True, subtalker_temperature=0.8, subtalker_top_k=30),
    dict(do_sample=False, repetition_penalty=1.0, subtalker_dosample=True,
         subtalker_temperature=1.2, subtalker_top_k=0, subtalker_top_p=0.7),
)


def serving_requests():
    """(text, speaker, language, budget) of the load's 16 requests."""
    return [(text, spk, lang, SERVING_BUDGETS[(i + j) % len(SERVING_BUDGETS)])
            for i, text in enumerate(TEXTS) for j, (spk, lang) in enumerate(SERVING_VOICES)]


@contextlib.contextmanager
def counting_captures():
    """Counts the CUDA graph captures made inside (a list of one count)."""
    from qwen_tts_tpu_torch import graphs

    count, orig = [0], graphs.Graph._capture

    def counting(self, *args):
        count[0] += 1
        return orig(self, *args)

    graphs.Graph._capture = counting
    try:
        yield count
    finally:
        graphs.Graph._capture = orig


def run_continuous_load(model, requests, sync: bool, kws=None, seconds: float = 300.0):
    """The requests through a new ContinuousBatchingEngine, submitted at once
    from 4 client threads (request k by thread k % 4). Returns each
    request's waveform, its codes as the engine finished it, its latency
    from submit to result, the wall seconds, the engine's stats, the kernel
    launches of the run and each row's last (cur_len, valid_from) in the
    pool."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(
        model, num_slots=SERVING_SLOTS, segment_frames=SERVING_SEGMENT,
        max_new_tokens=SERVING_CEILING, prefill_bucket=SERVING_BUCKET, sync_dispatch=sync)
    n = len(requests)
    wavs, codes, submitted, done_at, errors, index = [None] * n, {}, [0.0] * n, [0.0] * n, [], {}
    finish = engine._finish_one

    def recording(req, req_codes):
        codes[index[id(req.future)]] = np.concatenate(req_codes)
        finish(req, req_codes)

    engine._finish_one = recording

    def client(k):
        try:
            futs = []
            for i in range(k, n, 4):
                text, spk, lang, budget = requests[i]
                kw = dict(SERVING_GREEDY, **(kws[i] if kws else {}))
                submitted[i] = time.perf_counter()
                fut = engine.submit_text(text, speaker=spk, language=lang,
                                         max_new_tokens=budget, **kw)
                index[id(fut)] = i
                fut.add_done_callback(lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
                futs.append((i, fut))
            for i, fut in futs:
                wavs[i] = fut.result(timeout=seconds)
        except Exception as e:  # reported below: the phase fails
            errors.append(e)

    counters = _counters()
    engine.start()
    try:
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds)
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        depths = ((engine._state.prefix_len + engine._state.num_gen + 1).tolist(),
                  engine._state.valid_from.tolist())
    finally:
        engine.stop()
    if errors or any(t.is_alive() for t in threads) or any(w is None for w in wavs):
        fail(f"serving: the continuous load did not finish: {errors[:3]}")
    latency = [d - s for s, d in zip(submitted, done_at)]
    return dict(wavs=wavs, codes=codes, latency=latency, wall=wall, stats=dict(engine.stats),
                launches=launches, depths=depths)


def solo_codes(model, request):
    """One request alone through ``generate_codes_from_prompts`` at the
    engines' ceiling and prefill bucket (its budget as ``step_limit``)."""
    text, spk, lang, budget = request
    prompt = card_prompt_in(model, text, spk, lang)
    params = model._merge_params(max_new_tokens=SERVING_CEILING, **SERVING_GREEDY)
    codes, _ = model.generate_codes_from_prompts([prompt], params, step_limit=[budget],
                                                 max_new_ceiling=SERVING_CEILING)
    return codes[0].astype("int64")


def card_prompt_in(model, text, speaker, language):
    from qwen_tts_tpu_torch.generate import build_prompt

    return build_prompt(model.talker_params, model.cfg,
                        model._tokenize(model.build_assistant_text(text)), language=language,
                        speaker=speaker)


def solo_margin(model, request, frame: int, group: int):
    """The alone run's top-two logit margin at (frame, group), and that
    call's largest |logit|, from an eager run that records every sampling
    call (call f x G + g chose code (f, g): the prefill's token, then per
    frame the sub-talker's G - 1 codes and the talker's next token)."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod

    calls = []
    originals = (gen_mod.sample_token, st_mod.sample_token)

    def recording(logits, cfg, generator, race=None, _orig=originals[0]):
        calls.append(logits[0].float().cpu())
        return _orig(logits, cfg, generator, race)

    gen_mod.sample_token = st_mod.sample_token = recording
    try:
        with eager_decode():
            solo_codes(model, request)
    finally:
        gen_mod.sample_token, st_mod.sample_token = originals
    lg = calls[frame * model.cfg.talker.num_code_groups + group]
    top2 = torch.topk(lg, 2).values
    return (top2[0] - top2[1]).item(), lg[lg > -1e8].abs().max().item()


def hold_against_solo(model, what: str, got: dict, requests, solos: dict) -> int:
    """Each request's codes ``got[i]`` against its codes alone (``solos``,
    keyed by request, filled on first use): equal, or first apart at a near
    tie (``SERVING_NEAR_TIE``). Returns the rows equal."""
    import numpy as np

    equal, ties = 0, []
    for i, request in enumerate(requests):
        if request not in solos:
            solos[request] = solo_codes(model, request)
        a, b = got[i], solos[request]
        if a.shape != b.shape:
            fail(f"{what}: request {i} gave {a.shape} codes, alone {b.shape}")
        if np.array_equal(a, b):
            equal += 1
            continue
        f, g = (int(v) for v in np.argwhere(a != b)[0])
        margin, scale = solo_margin(model, request, f, g)
        ties.append((i, f, g, round(margin, 5), round(scale, 3)))
        if not margin <= SERVING_NEAR_TIE * scale:
            fail(f"{what}: request {i} first differs from its codes alone at frame {f}, group "
                 f"{g}, where the alone run's top-two margin {margin:.4g} is not a near tie "
                 f"(limit {SERVING_NEAR_TIE} x {scale:.4g})")
    rest = (f"; the rest first apart at near ties (request, frame, group, margin, "
            f"max|logit|) {ties}" if ties else "")
    log(f"{what}: codes equal to each request alone for {equal} / {len(requests)} requests"
        f"{rest}")
    return equal


def _post_json(port: int, path: str, obj, timeout: float = 300.0):
    """POST ``obj``: (status, content type, body); an error status fails
    the phase with the server's message."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        fail(f"serving HTTP {path}: {e.code} {e.read()[:500]!r}")


def _wav_samples(body: bytes, up: int, frames: int, what: str):
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        rate, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    if rate != 24000 or n != frames * up or not pcm.any():
        fail(f"serving HTTP {what}: a {rate} Hz WAV of {n} samples, want {frames * up} at 24000")
    return pcm


@contextlib.contextmanager
def http_server(engine, model):
    """``make_handler`` over ``engine`` (started here) on 127.0.0.1 at a free
    port; stops both."""
    from http.server import ThreadingHTTPServer

    from qwen_tts_tpu_torch.server import make_handler

    engine.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, model))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=60)


def stream_once(port: int, body: dict):
    """POST /stream; the seconds to the first PCM bytes and the whole PCM."""
    import http.client

    import numpy as np

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or resp.headers.get("Transfer-Encoding") != "chunked":
            fail(f"serving HTTP /stream: status {resp.status}")
        first = resp.read(2)
        t_first = time.perf_counter() - t0
        pcm = np.frombuffer(first + resp.read(), dtype="<i2")
    finally:
        conn.close()
    return t_first, pcm


# The request that /clone_voice must be taken beside: long enough (~4 s of
# decode on the card) that the clone (~1 s) ends well inside it on a slow host.
HTTP_LONG_FRAMES = 256


def phase_serving_http(model, base_dir: str, smi: str) -> None:
    """/healthz, /tts, /stream (first chunk, median of 3) over a continuous
    engine on the serving model; then, on the Base checkpoint, a
    /clone_voice (inline PCM of a phase-11 clip) taken while another request
    decodes, and a /tts in that voice."""
    import urllib.request

    import numpy as np

    from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    up = model.cfg.codec.decode_upsample_rate
    tts = dict(SERVING_GREEDY, text=TEXTS[1], speaker="aiden", language="english")
    short, stream = SERVING_BUDGETS[:2]  # the /tts and /stream budgets
    engine = ContinuousBatchingEngine(model, num_slots=SERVING_SLOTS,
                                      segment_frames=SERVING_SEGMENT,
                                      max_new_tokens=SERVING_CEILING, prefill_bucket=SERVING_BUCKET)
    with http_server(engine, model) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.load(r)
        status, ctype, body = _post_json(port, "/tts", dict(tts, max_new_tokens=short))
        if health.get("status") != "ok" or status != 200 or ctype != "audio/wav":
            fail(f"serving HTTP: /healthz {health}, /tts {status} {ctype}")
        _wav_samples(body, up, short - 1, "/tts")
        firsts = []
        for _ in range(3):
            t_first, pcm = stream_once(port, dict(tts, text=TEXTS[0], max_new_tokens=stream))
            firsts.append(t_first * 1e3)
            if pcm.shape != ((stream - 1) * up,) or not pcm.any():
                fail(f"serving HTTP /stream: {pcm.shape} PCM samples, want {(stream - 1) * up}")
    log(f"serving HTTP (continuous engine, int8 weights + KV): /healthz ok; /tts a 24 kHz WAV "
        f"of {short - 1} frames; /stream {(stream - 1) * up} PCM16 samples de-chunked, first "
        f"chunk after "
        f"{_spread(firsts)} ms (3 streams, {SERVING_SEGMENT}-frame segments) | {smi}")

    base = Qwen3TTSModel.from_pretrained(base_dir)
    base.tokenizer = ChatTemplateTokenizer()
    engine = ContinuousBatchingEngine(base, num_slots=SERVING_SLOTS,
                                      segment_frames=SERVING_SEGMENT,
                                      max_new_tokens=HTTP_LONG_FRAMES, prefill_bucket=(32, 96))
    clip, rate = clone_clips()[0]
    long_done, long_body, long_s = threading.Event(), [], []
    with counting_captures() as captures, http_server(engine, base) as port:
        def long_request():
            t = time.perf_counter()
            long_body.append(_post_json(port, "/tts", dict(
                tts, text=TEXTS[3], max_new_tokens=HTTP_LONG_FRAMES,
                min_new_tokens=HTTP_LONG_FRAMES + 1)))
            long_s.append(time.perf_counter() - t)
            long_done.set()

        thread = threading.Thread(target=long_request)
        thread.start()
        deadline = time.monotonic() + 120
        while engine.stats["segments"] < 1:
            if time.monotonic() > deadline:
                fail("serving HTTP: the long request never reached a segment")
            time.sleep(0.002)
        t0 = time.perf_counter()
        status, _, body = _post_json(port, "/clone_voice", {
            "audio": {"pcm": clip.tolist(), "sample_rate": rate},
            "ref_text": CLONE_REF_TEXTS[0]})
        clone_s = time.perf_counter() - t0
        during = not long_done.is_set()
        voice = json.loads(body)
        status2, _, body2 = _post_json(port, "/tts", dict(tts, voice=voice["voice"],
                                                          max_new_tokens=short))
        thread.join(timeout=300)
        if status != 200 or status2 != 200 or not voice.get("icl") or not long_body:
            fail(f"serving HTTP clone: /clone_voice {status} {voice}, /tts {status2}")
        _wav_samples(body2, up, short - 1, "/tts in the cloned voice")
        _wav_samples(long_body[0][2], up, HTTP_LONG_FRAMES - 1, "/tts beside the clone")
    log(f"serving HTTP clone (Base checkpoint, bf16, prefill buckets 32 and 96): /clone_voice "
        f"of a {len(clip) / rate:.1f} s clip (inline PCM) in {clone_s * 1e3:.1f} ms while "
        f"another request decoded: {during}; /tts in the cloned voice a WAV of {short - 1} "
        f"frames; the "
        f"other request's WAV of {HTTP_LONG_FRAMES - 1} frames in {long_s[0]:.2f} s; "
        f"captures {captures[0]}, "
        f"segments {engine.stats['segments']}, bucket admissions "
        f"{engine.stats['bucket_admits']} | {smi}")
    if not during:
        fail("serving HTTP clone: the other request finished before the clone was taken")
    del base



def time_frame_programs(smi: str, replays: int = 25, runs: int = 5) -> None:
    """Each live frame program replayed on its own buffers: ``runs`` x
    ``replays`` replays timed with CUDA events (ms a frame, median), then
    one profiled run: device busy a frame and the share of the sorts (the
    per-row sampling's top-k and top-p). A program's buffers hold a finished
    load (every row done), and a frame in which no row is active runs the
    same kernels and changes nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qwen_tts_tpu_torch import graphs

    for kind, program in graphs.programs():
        if kind != "frame":
            continue
        b = program.frame.shape[0]
        label = "per-row sampling" if program.vec is not None else "static sampling"
        ms = []
        for _ in range(runs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(replays):
                program.graph.replay()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / replays)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                program.graph.replay()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in device) / 1e3 / replays
        sort_ms = sum(e.self_device_time_total for e in device
                      if "sort" in e.key.lower()) / 1e3 / replays
        kernels = sum(e.count for e in device) / replays
        log(f"serving frame program B={b}, S_max={program.state.k_cache['i8'].shape[2]}, "
            f"{label}: replayed {_spread(ms, '{:.3f}')} ms/frame ({runs} x {replays} replays, "
            f"events); one profiled run: device busy {busy:.3f} ms/frame in {kernels:.1f} device "
            f"ops/frame, sorts {sort_ms:.3f} ms/frame | {smi}")


def phase_serving(model_dir: str, base_dir: str, smi: str) -> dict:
    """Phase 12: the serving engines on the flagship checkpoint in the
    serving mode (int8 weights and KV cache), f32 codec, EOS banned, greedy
    unless stated. Returns the continuous load's kernel launches."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
    from qwen_tts_tpu_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    graphs.clear()
    model = Qwen3TTSModel.from_pretrained(model_dir)
    model.tokenizer = ChatTemplateTokenizer()
    model.quantize_for_serving(talker=True, kv=True)
    up, sr = model.cfg.codec.decode_upsample_rate, model.sample_rate
    requests = serving_requests()
    audio_s = sum((b - 1) * up for *_, b in requests) / sr

    # The continuous engine's load: a first run (its captures), then two
    # runs each way, double-buffered and synchronous dispatch in turns.
    with counting_captures() as captures:
        first = run_continuous_load(model, requests, sync=False)
    first_captures = captures[0]
    runs = {False: [], True: []}
    with counting_captures() as captures:
        for sync in (False, True, True, False):
            runs[sync].append(run_continuous_load(model, requests, sync))
    for i, w in enumerate(first["wavs"]):
        if w.shape != ((requests[i][3] - 1) * up,) or not np.isfinite(w).all():
            fail(f"serving: request {i} gave a waveform of {w.shape}")
    for sync, rs in runs.items():
        mode = "synchronous" if sync else "double-buffered"

        def med(key, rs=rs):
            return statistics.median(r["stats"][key] for r in rs)

        log(f"serving continuous [{mode} dispatch] 16 requests, {SERVING_SLOTS} slots, "
            f"{SERVING_SEGMENT}-frame segments, medians of {len(rs)}: wall "
            f"{_spread([r['wall'] for r in rs], '{:.3f}')} s; audio/wall "
            f"{_spread([audio_s / r['wall'] for r in rs], '{:.3f}')}; latency median "
            f"{_spread([statistics.median(r['latency']) for r in rs], '{:.3f}')} s, max "
            f"{_spread([max(r['latency']) for r in rs], '{:.3f}')} s; segments {med('segments')}, "
            f"stale_skips {med('stale_skips')}; time admit {med('time_admit_s'):.3f} s, segment "
            f"{med('time_segment_s'):.3f} s, finish {med('time_finish_s'):.3f} s, emit "
            f"{med('time_emit_s'):.3f} s; launches {rs[0]['launches']} | {smi}")
    launches = first["launches"]
    log(f"serving continuous: captures in the first run {first_captures}, in the "
        f"{len(runs[False]) + len(runs[True])} runs after it {captures[0]}; launches in the first run {launches}; audio {audio_s:.2f} s a run")
    if captures[0]:
        fail("serving: a steady load captured a program anew")
    for name in ("decode_attention_int8", "subtalker_step", "int8_matmul"):
        if not launches[name]:
            fail(f"serving: {name} was not launched by the continuous load")
    for r in runs[False] + runs[True]:
        if any(not np.array_equal(r["codes"][i], first["codes"][i]) for i in first["codes"]):
            fail("serving: a run of the load gave other codes than the first")
    casts = count_int8_weight_casts(
        model, [card_prompt_in(model, t, s, lang) for t, s, lang, _ in requests[:4]],
        dict(SERVING_GREEDY, max_new_tokens=3, min_new_tokens=4))
    log(f"serving: int8 weights cast whole in a 3-step decode: {casts}")
    if casts:
        fail("the serving engines' path casts int8 weights whole")
    solos: dict = {}
    hold_against_solo(model, "serving continuous", first["codes"], requests, solos)
    cur_len, valid_from = first["depths"]
    s_max = SERVING_BUCKET + SERVING_CEILING
    gen = torch.Generator(device="cuda").manual_seed(12)
    attention_err = {name: hold_attention_at(gen, (*ATTN_TALKER, s_max), int8, "serving pool",
                                             [(cur_len, valid_from)])
                     for name, int8 in (("decode_attention", False),
                                        ("decode_attention_int8", True))}

    # Per-row controls: the load's first four requests greedy beside four
    # sampled ones, in one pool.
    mixed = requests[:4] + [(t, s, lang, SERVING_BUDGETS[2]) for t, s, lang, _ in requests[4:8]]
    kws = [{}] * 4 + [dict(kw, seed=100 + i) for i, kw in enumerate(SERVING_SAMPLED)]
    controls = run_continuous_load(model, mixed, sync=False, kws=kws)
    hold_against_solo(model, "serving per-row controls (greedy rows against the all-greedy "
                             "pool's codes)", {i: controls["codes"][i] for i in range(4)},
                      requests[:4], {requests[i]: first["codes"][i] for i in range(4)})
    tk = model.cfg.talker
    first_vocab = tk.vocab_size - tk.suppress_tail  # EOS banned: below the suppressed band
    vocab = tk.code_predictor.vocab_size
    in_range = all(c.min() >= 0 and c[:, 0].max() < first_vocab and c[:, 1:].max() < vocab
                   for c in controls["codes"].values())
    sampled_apart = 0
    for i in range(4, 8):  # against the same text and voice, greedy, in the load
        n = min(len(controls["codes"][i]), len(first["codes"][i]))
        sampled_apart += not np.array_equal(controls["codes"][i][:n], first["codes"][i][:n])
    log(f"serving per-row controls: 4 greedy + 4 sampled rows (temperature / top_k / top_p / "
        f"repetition_penalty / sub-talker sampling per row) in one pool; codes in range (group 0 "
        f"under {first_vocab}, the others under {vocab}): "
        f"{in_range}; sampled rows apart from greedy: {sampled_apart} / 4; wall "
        f"{controls['wall']:.3f} s")
    if not in_range:
        fail("serving per-row controls: codes out of range")

    # The window engine: 8 requests of 4 budgets in one window, then the
    # same 8 texts and voices with the budgets rotated: one frame program
    # for both (a window's program depends on its batch, its sampling config
    # and its texts' trailing length, not on the budgets).
    window = requests[:8] + [r[:3] + (requests[(i + 2) % 8][3],) for i, r in
                             enumerate(requests[:8])]
    window_codes = {}
    with counting_captures() as captures:
        for half in (0, 8):
            engine = ServingEngine(model, max_batch=8, max_new_tokens=SERVING_CEILING)
            decoded = []
            orig = model.decode_codes

            def recording(codes_list, **kw):
                decoded.extend(np.asarray(c, np.int64) for c in codes_list)
                return orig(codes_list, **kw)

            model.decode_codes = recording
            futs = [engine.submit_text(t, speaker=s, language=lang, max_new_tokens=b,
                                       **SERVING_GREEDY)
                    for t, s, lang, b in window[half:half + 8]]
            t0 = time.perf_counter()
            engine.start()
            try:
                wavs = [f.result(timeout=300) for f in futs]
            finally:
                engine.stop()
                del model.decode_codes
            window_wall = time.perf_counter() - t0
            if engine.stats["batches"] != 1 or any(
                    w.shape != ((b - 1) * up,) for w, (*_, b) in zip(wavs, window[half:half + 8])):
                fail(f"serving window: {engine.stats}")
            window_codes.update({half + i: c for i, c in enumerate(decoded)})
            log(f"serving window engine: 8 requests (budgets "
                f"{[b for *_, b in window[half:half + 8]]}) in one window of "
                f"{window_wall:.3f} s, audio/wall "
                f"{sum((b - 1) * up for *_, b in window[half:half + 8]) / sr / window_wall:.3f}"
                f" | {smi}")
    log(f"serving window engine: frame programs captured for the two windows: {captures[0]}")
    if captures[0] != 1:
        fail("serving window: the windows did not share one frame program")
    hold_against_solo(model, "serving window", window_codes, window, solos)
    time_frame_programs(smi)  # the continuous pool's program and the windows'

    phase_serving_http(model, base_dir, smi)
    del model
    graphs.clear()
    torch.cuda.empty_cache()
    log(f"serving: phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "attention_err": attention_err}


# --------------------------------------------------------------------------
# Phase 13: the serving fast modes
# --------------------------------------------------------------------------

# The fast-modes phase decodes this many frames a run (two flag reads), in a
# cache of MAX_NEW frames.
FAST_FRAMES = 16
# Phase 13 runs the talker cut to its first 4 layers (widths full), as
# phase 10 does: the modes change the sub-talker and the trunks' products,
# which every layer repeats (cut from 20 layers to make room for phase 16;
# its ms a frame are not those of the full depth).
FAST_TALKER_LAYERS = 4
FAST_VOICES = (("aiden", "english"), ("serena", "auto"), ("aiden", "chinese"),
               ("serena", "english"))
# Kernel names of cuBLAS's and CUTLASS's GEMMs in a profile.
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


@contextlib.contextmanager
def st_gates(**env):
    """The sub-talker's environment gates set as given (None: unset) inside,
    restored after."""
    saved = {k: os.environ.get(k) for k in env}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(env)
    try:
        yield
    finally:
        put(saved)


@contextlib.contextmanager
def recording_logits(calls: list):
    """Every sampling call's f32 logits [B, V] appended to ``calls`` (kept on
    the card), talker and sub-talker alike, in order."""
    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod

    originals = (gen_mod.sample_token, st_mod.sample_token)

    def recording(logits, cfg, generator, race=None, _orig=originals[0]):
        calls.append(logits.float().clone())
        return _orig(logits, cfg, generator, race)

    gen_mod.sample_token = st_mod.sample_token = recording
    try:
        yield
    finally:
        gen_mod.sample_token, st_mod.sample_token = originals


def fast_inputs(model, b: int):
    """A batch of ``b`` prompts (TEXTS in turn, FAST_VOICES' voices) as
    ``_segment`` takes them."""
    from qwen_tts_tpu_torch import generate as gen_mod

    dtype = model.talker_params["norm"].dtype
    prompts = [gen_mod.build_prompt(model.talker_params, model.cfg,
                                    model._tokenize(model.build_assistant_text(TEXTS[i % 4])),
                                    speaker=FAST_VOICES[i % 4][0],
                                    language=FAST_VOICES[i % 4][1])
               for i in range(b)]
    e, m, t, _ = gen_mod.batch_prompts(prompts)
    return e.to(dtype), m, t.to(dtype)


def recorded_reference(model, inputs, gp):
    """An eager sequential run, prefill included, with every sampling call's
    logits: (state, codes [B, FAST_FRAMES, G], calls). Code (f, g) came from
    call f x G + g: the prefill's token, then per frame the sub-talker's G - 1
    codes and the talker's next token."""
    calls = []
    with recording_logits(calls):
        state, buf, _, _ = _segment(model, inputs, gp, eager=True, frames=FAST_FRAMES)
    return state, buf, calls


def hold_near_ties(what: str, got, ref) -> float:
    """Codes [B, frames, G] against a recorded reference run's: each row
    equal, or first apart where the reference's top two logits lie within
    SERVING_NEAR_TIE of that call's largest |logit|. Returns the share of
    codes equal."""
    import torch

    _, want, calls = ref
    g = want.shape[2]
    equal, ties = 0, []
    for row in range(want.shape[0]):
        apart = (got[row] != want[row]).nonzero()
        if not len(apart):
            equal += 1
            continue
        f, grp = (int(v) for v in apart[0])
        lg = calls[f * g + grp][row]
        top2 = torch.topk(lg, 2).values
        margin, scale = (top2[0] - top2[1]).item(), lg[lg > -1e8].abs().max().item()
        ties.append((row, f, grp, round(margin, 5), round(scale, 3)))
        if not margin <= SERVING_NEAR_TIE * scale:
            fail(f"{what}: row {row} first differs at frame {f}, group {grp}, where the "
                 f"reference's top-two margin {margin:.4g} is not a near tie (limit "
                 f"{SERVING_NEAR_TIE} x {scale:.4g})")
    share = (got == want).float().mean().item()
    log(f"{what}: rows equal {equal} / {want.shape[0]}; codes equal share {share:.4f}; rows "
        f"first apart at near ties (row, frame, group, margin, max|logit|): {ties}")
    return share


def fast_launches(model, inputs, gp, what: str, expected: dict):
    """A replayed segment (its program captured before) with its kernel
    launches, prefill included, held to ``expected`` exactly. Returns
    (state, codes)."""
    launches, (state, buf, _, _), _ = _launches_of(
        lambda: _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES))
    log(f"fast modes [{what}]: launches in a replayed segment of {FAST_FRAMES} frames B="
        f"{buf.shape[0]} (prefill included): {launches}, expected {expected}")
    if launches != expected:
        fail(f"fast modes [{what}]: the kernels did not launch as the route predicts")
    return state, buf


def time_programs(model, use, runs: dict, smi: str, rounds: int = 3) -> dict:
    """Replayed segments of FAST_FRAMES frames, each of ``runs`` (name ->
    (trees, inputs, gp, gates)) once untimed, then once a round in turns:
    ms a frame, median (min..max). Returns the medians."""
    ms = {name: [] for name in runs}
    for i in range(rounds + 1):
        for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            trees, inputs, gp, gates = runs[name]
            use(trees)
            with st_gates(**gates):
                wall = _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES)[2]
            if i:
                ms[name].append(wall / FAST_FRAMES * 1e3)
    for name, values in ms.items():
        log(f"fast modes time: {name}: replayed {_spread(values, '{:.3f}')} ms/frame over "
            f"{rounds} segments of {FAST_FRAMES} frames | {smi}")
    return {name: statistics.median(v) for name, v in ms.items()}


def profile_gemms(model, inputs, gp, frames: int = 8) -> tuple:
    """One profiled replayed segment: (GEMM kernels a frame, device ops a
    frame); (None, None) if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = _segment(model, inputs, gp, eager=False, frames=frames, profiler=lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))[3]
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not device:
        return None, None
    gemms = sum(e.count for e in device if any(n in e.key.lower() for n in GEMM_NAMES))
    return gemms / frames, sum(e.count for e in device) / frames


def check_fused_int8_launches(trees: dict) -> None:
    """Each fused int8 weight (``quantize_trunk_int8`` of the fused bf16
    trees: layer 0 of the talker and of the sub-talker, q|k|v and gate|up) as
    one launch, bit for bit the unfused trees' grouped launch, at M 4 (a
    decode step), 64 and 128 (the Jacobi forward at B 4 and 8)."""
    import torch

    from qwen_tts_tpu_torch.models.trunk import quantize_trunk_int8
    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul, int8_matmul_group

    gen = torch.Generator(device="cuda").manual_seed(21)
    results = []
    for who, idx in (("talker", 0), ("sub-talker", 1)):
        fused, parts = (quantize_trunk_int8(trees[name][idx]["trunk"])
                        for name in ("bf16 fused", "bf16"))
        for key, names in (("wqkv", ("wq", "wk", "wv")), ("wgu", ("gate", "up"))):
            k = fused[key + "_i8"].shape[1]
            for m in (4, 64, 128):
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                one = int8_matmul(x, fused[key + "_i8"][0], fused[key + "_s"][0])
                grouped = torch.cat(int8_matmul_group(
                    x, [(parts[n + "_i8"][0], parts[n + "_s"][0]) for n in names]), dim=-1)
                results.append((who, key, m, bool(torch.equal(one, grouped))))
    log(f"fast modes: a fused int8_matmul launch == the grouped launch, bit for bit "
        f"(who, weight, M, equal): {results}")
    if not all(r[-1] for r in results):
        fail("fast modes: a fused int8 launch differs from the grouped launch")


def check_split_attention() -> None:
    """The decode-attention kernel at the sub-talker's shapes (B=4, H16 /
    KV8, hd 128) over a cache of G/2 = 8 slots and one of G = 16 that holds
    the same first rows (other values past them): the same bits at every
    cur_len <= 8, bf16 and int8 caches."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    same = []
    for int8 in (False, True):
        for cur in range(1, 9):
            q, k, v, cl, vf = _attention_inputs(gen, 4, 16, 8, 128, 16, [cur] * 4, [0] * 4,
                                                torch.float32)
            k, v = _int8_caches(k, v) if int8 else (k.bfloat16(), v.bfloat16())
            if int8:
                half = tuple({n: c[n][:, :8].contiguous() for n in c} for c in (k, v))
            else:
                half = (k[:, :8].contiguous(), v[:, :8].contiguous())
            full = decode_attention(q.bfloat16(), k, v, cl, vf)
            same.append(bool(torch.equal(full, decode_attention(q.bfloat16(), *half, cl, vf))))
    log(f"fast modes: QTTS_ST_SPLIT: decode attention at S_max 8 == at S_max 16 for cur_len "
        f"1..8, bf16 then int8 caches: {same}")
    if not all(same):
        fail("fast modes: decode attention at S_max G/2 differs from S_max G, so the split "
             "would not give the same bits")


def phase_fast_modes(model_dir: str, smi: str) -> dict:
    """Phase 13: the serving fast modes on the flagship checkpoint, greedy,
    EOS banned, FAST_FRAMES frames a run (replayed unless stated).

    Fused trunks (``fuse_trunk_params``): bf16 codes against the unfused
    path (near ties allowed), ms a frame and GEMM kernels a frame; the
    serving mode on fused trunks: codes against the unfused serving path,
    launches exact, each fused int8 launch bit for bit the grouped one. The
    Jacobi micro-decode in the serving mode (``QTTS_ST_JACOBI=1``): the
    eager adaptive loop (its iteration histogram) and the captured G-1
    frame give the same bits, at B 4 and 8; codes against the sequential
    kernel route (near ties allowed); launches exact (no ``subtalker_step``);
    ms a frame beside ``QTTS_ST_JACOBI_ITERS=1`` and the sequential frame.
    The sub-talker int8 KV cache (``QTTS_ST_KV8=1``): launches exact, codes
    against the bf16-cache route (near ties allowed; phase 7 holds every
    position of it teacher-forced against the CPU), ms a frame. Every gate
    flipped once: one capture each, none when flipped back;
    ``QTTS_ST_SPLIT=1`` the same bits on both routes, and decode attention
    at S_max G/2 the bits of S_max G; the bf16 frame's ms with the split."""
    import torch

    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.models import subtalker as st_mod
    from qwen_tts_tpu_torch.models.trunk import fuse_trunk_params
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    model = Qwen3TTSModel.from_pretrained(model_dir, load_tokenizer=False)
    model.tokenizer = ChatTemplateTokenizer()
    cut_talker_depth(model, FAST_TALKER_LAYERS)
    tk = model.cfg.talker
    g, layers = tk.num_code_groups, tk.num_hidden_layers
    st_layers = tk.code_predictor.num_hidden_layers
    per_layer = len(LAYER_LAUNCHES)
    gp = model._merge_params(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1,
                             do_sample=False, subtalker_dosample=False, repetition_penalty=1.0)
    tp, sp = model.talker_params, model.subtalker_params
    trees = {"bf16": (tp, sp),
             "bf16 fused": (dict(tp, trunk=fuse_trunk_params(tp["trunk"])),
                            dict(sp, trunk=fuse_trunk_params(sp["trunk"])))}
    for name in ("serving", "serving fused"):
        model.talker_params, model.subtalker_params = trees[name.replace("serving", "bf16")]
        model.quantize_for_serving(talker=True, kv=True)
        trees[name] = (model.talker_params, model.subtalker_params)

    def use(name):
        model.talker_params, model.subtalker_params = trees[name]
        model.kv_int8 = name.startswith("serving")

    inputs, inputs8 = fast_inputs(model, 4), fast_inputs(model, 8)
    out = {}
    clock = [time.perf_counter()]

    def lap(section: str) -> None:
        now = time.perf_counter()
        log(f"time: fast modes, {section} {now - clock[0]:.1f} s")
        clock[0] = now

    # Fused trunks, bf16.
    use("bf16")
    ref_bf16 = recorded_reference(model, inputs, gp)
    use("bf16 fused")
    fused = _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES)
    hold_near_ties("fast modes [bf16 fused] against bf16 (eager)", fused[1], ref_bf16)
    gemms = {}
    for name in ("bf16", "bf16 fused"):
        use(name)
        gemms[name] = profile_gemms(model, inputs, gp)
    log(f"fast modes: bf16 (GEMM kernels a frame, names with {GEMM_NAMES}; device ops a "
        f"frame), one profiled replay of 8 frames each: unfused {gemms['bf16']}, fused "
        f"{gemms['bf16 fused']}; five products a layer become two, "
        f"{3 * (layers + g * st_layers)} fewer expected | {smi}")
    out["gemms"] = gemms
    lap("fused bf16")

    # Fused trunks, the serving mode.
    use("serving")
    ref_serving = recorded_reference(model, inputs, gp)
    check_fused_int8_launches(trees)
    prefill_int8 = layers * per_layer
    sequential = {"decode_attention": 0, "decode_attention_int8": FAST_FRAMES * layers,
                  "subtalker_step": FAST_FRAMES * g, "vocoder_block": 0,
                  "int8_matmul": prefill_int8 + FAST_FRAMES * (layers * per_layer + g - 1)}
    for name in ("serving", "serving fused"):
        use(name)
        _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES)  # the capture
        _, codes = fast_launches(model, inputs, gp, name, sequential)
        hold_near_ties(f"fast modes [{name}] against serving (eager)", codes, ref_serving)
    lap("fused serving")

    # The Jacobi micro-decode, the serving mode.
    use("serving")
    jacobi_frame = layers * per_layer + (g - 1) * (st_layers * per_layer + g - 1)
    histogram = {}
    orig_jacobi = st_mod.subtalker_generate_jacobi

    def counting_iters(*args, **kwargs):
        codes, iters = orig_jacobi(*args, **kwargs, return_iters=True)
        histogram[iters] = histogram.get(iters, 0) + 1
        return codes

    for batch in (inputs, inputs8):
        b = batch[0].shape[0]
        with st_gates(QTTS_ST_JACOBI="1"):
            st_mod.subtalker_generate_jacobi = counting_iters
            try:
                histogram.clear()
                eager = _segment(model, batch, gp, eager=True, frames=FAST_FRAMES)
            finally:
                st_mod.subtalker_generate_jacobi = orig_jacobi
            log(f"fast modes [jacobi B={b}]: forwards a frame in the eager adaptive loop "
                f"(the verifying one included; capped at G-1 = {g - 1}), over {FAST_FRAMES} "
                f"frames: {dict(sorted(histogram.items()))}")
            out[f"jacobi_iters_b{b}"] = dict(histogram)
            _segment(model, batch, gp, eager=False, frames=FAST_FRAMES)  # the capture
            expected = {"decode_attention": 0, "decode_attention_int8": FAST_FRAMES * layers,
                        "subtalker_step": 0, "vocoder_block": 0,
                        "int8_matmul": prefill_int8 + FAST_FRAMES * jacobi_frame}
            state, codes = fast_launches(model, batch, gp, f"jacobi B={b}", expected)
        same = _same_decode((state, codes), eager)
        log(f"fast modes [jacobi B={b}]: the captured G-1 frame == the eager adaptive loop "
            f"(buffer, token, hidden, presence, eos, num_gen bit for bit): {same}")
        if not same:
            fail(f"fast modes [jacobi B={b}]: the captured frame differs from the eager loop")
        if b == 4:
            hold_near_ties("fast modes [jacobi] against the sequential kernel route (eager)",
                           codes, ref_serving)
    with st_gates(QTTS_ST_JACOBI="1", QTTS_ST_JACOBI_ITERS="1"):
        one = _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES)[1]
    log(f"fast modes [jacobi ITERS=1]: share of codes equal to the sequential route's (one "
        f"forward is not the fixed point): {(one == ref_serving[1]).float().mean().item():.4f}")
    lap("jacobi")

    # The sub-talker int8 KV cache.
    with st_gates(QTTS_ST_KV8="1"):
        _segment(model, inputs, gp, eager=False, frames=FAST_FRAMES)  # the capture
        steps = layers + g * st_layers
        expected = {"decode_attention": 0, "decode_attention_int8": FAST_FRAMES * steps,
                    "subtalker_step": 0, "vocoder_block": 0,
                    "int8_matmul": prefill_int8 + FAST_FRAMES * (steps * per_layer + g - 1)}
        _, codes = fast_launches(model, inputs, gp, "st kv8", expected)
    hold_near_ties("fast modes [st kv8] against the bf16-cache route (eager)", codes,
                   ref_serving)
    lap("st kv8")

    jacobi, iters_1, kv8 = {"QTTS_ST_JACOBI": "1"}, {"QTTS_ST_JACOBI": "1",
                                                     "QTTS_ST_JACOBI_ITERS": "1"}, \
        {"QTTS_ST_KV8": "1"}
    out["ms"] = time_programs(model, use, {
        "serving sequential B=4": ("serving", inputs, gp, {}),
        "serving fused B=4": ("serving fused", inputs, gp, {}),
        "serving jacobi G-1 B=4": ("serving", inputs, gp, jacobi),
        "serving jacobi ITERS=1 B=4": ("serving", inputs, gp, iters_1),
        "serving st kv8 B=4": ("serving", inputs, gp, kv8),
        "serving sequential B=8": ("serving", inputs8, gp, {}),
        "serving jacobi G-1 B=8": ("serving", inputs8, gp, jacobi)}, smi)
    out["ms"].update(time_programs(model, use, {
        "bf16 B=4": ("bf16", inputs, gp, {}), "bf16 fused B=4": ("bf16 fused", inputs, gp, {}),
        "bf16 split B=4": ("bf16", inputs, gp, {"QTTS_ST_SPLIT": "1"})}, smi))
    lap("timings")

    # Gate flips: one capture each, none flipping back; SPLIT the same bits.
    # With no program alive, each flip's program is new.
    graphs.clear()
    use("serving")
    flips = {"QTTS_ST_JACOBI": "1", "QTTS_ST_JACOBI_ITERS": "1", "QTTS_ST_SPLIT": "1",
             "QTTS_ST_KV8": "1", "QTTS_ST_UNROLL": "4", "QTTS_ST_UNROLL_LAYERS": "1"}
    base = _segment(model, inputs, gp, eager=False, frames=2)
    captures = {}
    for key, value in flips.items():
        with counting_captures() as flipped, st_gates(**{key: value}):
            run = _segment(model, inputs, gp, eager=False, frames=2)
        with counting_captures() as back:
            _segment(model, inputs, gp, eager=False, frames=2)
        captures[key] = (flipped[0], back[0])
        if key == "QTTS_ST_SPLIT" and not _same_decode(run, base):
            fail("fast modes: QTTS_ST_SPLIT changed the kernel route's bits")
    log(f"fast modes: captures when each gate is flipped, then when it is flipped back: "
        f"{captures}")
    if any(c != (1, 0) for c in captures.values()):
        fail("fast modes: a gate flip did not capture exactly one new frame, or flipping it "
             "back did not replay the old one")
    use("bf16")
    split_runs = []
    for split in (None, "1"):
        with st_gates(QTTS_ST_SPLIT=split):
            split_runs.append(_segment(model, inputs, gp, eager=False, frames=FAST_FRAMES))
    same = _same_decode(*split_runs)
    log(f"fast modes: QTTS_ST_SPLIT=1 gives the bits of the unset gate: on the kernel route "
        f"(serving) True, on the layer-by-layer route (bf16) {same}")
    if not same:
        fail("fast modes: QTTS_ST_SPLIT changed the layer-by-layer route's bits")
    check_split_attention()
    lap("gate flips and split")
    log_programs("fast modes", smi)
    del model, trees
    graphs.clear()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 14: the 25 Hz tokenizer
# --------------------------------------------------------------------------

# The timed decode: B=8 rows of 250 codes (10 s of codes at 25 Hz), a
# reference mel of 100 frames each; three calls after a warm-up.
V1_BATCH, V1_CODES, V1_REF_FRAMES = 8, 250, 100
# Card against CPU in f32 (B=1, 50 codes: 2 s of codes), set before the
# first card run: the DiT's mel within V1_MEL_REL_L2 and the waveform before
# the clamp within V1_WAV_REL_L2 (relative L2; the sums run in other orders
# through 9 Euler steps of 22 layers and BigVGAN's six stages); the
# reference mels (host numpy on both sides) within V1_REF_MEL_ATOL; the
# x-vector through the synthetic CAM++ graph within V1_XVEC_ATOL; the
# Whisper-VQ codes agree at V1_CODE_AGREEMENT or more, and where two codes
# differ their distances lie within V1_NEAR_TIE_REL of each other.
V1_PARITY_CODES = 50
V1_MEL_REL_L2 = 1e-4
V1_WAV_REL_L2 = 1e-3
V1_REF_MEL_ATOL = 1e-5
V1_XVEC_ATOL = 1e-4
V1_CODE_AGREEMENT = 0.99
V1_NEAR_TIE_REL = 1e-4


def v1_specs(cfg, enc):
    """The 25 Hz checkpoint's tensors (the reference names the port's
    loaders read) for the codec config ``cfg`` and the Whisper-VQ config
    ``enc``: weights N(0, 1/fan_in), BigVGAN's convs included (fan_in
    C_in x K, so no conv gains ~sqrt(C_in) and the waveform stays off the
    clamp), norms ones, biases zeros, SnakeBeta log-parameters N(0, 0.01),
    the Whisper-VQ codebook N(0, 1/16) so that codes vary."""
    dit, bv = cfg.dit, cfg.bigvgan
    h, qd, ff = dit.hidden_size, dit.num_attention_heads * dit.head_dim, dit.hidden_size * dit.ff_mult
    p = "decoder.dit."
    specs = [(p + "time_embed.time_mlp.0.weight", (h, 256), 256),
             (p + "time_embed.time_mlp.0.bias", (h,), "zeros"),
             (p + "time_embed.time_mlp.2.weight", (h, h), h),
             (p + "time_embed.time_mlp.2.bias", (h,), "zeros"),
             (p + "text_embed.codec_embed.weight", (dit.num_embeds + 1, dit.emb_dim), 1)]
    in_dim = dit.mel_dim + dit.enc_dim + dit.emb_dim + dit.enc_emb_dim
    specs += [(p + "input_embed.proj.weight", (h, in_dim), in_dim),
              (p + "input_embed.proj.bias", (h,), "zeros")]
    specs += [(p + "input_embed.spk_encoder." + name[len("speaker_encoder."):], shape, init)
              for name, shape, init in speaker_specs(dit.spk_encoder_config())]
    for i in range(dit.num_hidden_layers):
        b = f"{p}transformer_blocks.{i}."
        for name, n_out, n_in in (("attn_norm.linear", 6 * h, h), ("attn.to_q", qd, h),
                                  ("attn.to_k", qd, h), ("attn.to_v", qd, h),
                                  ("attn.to_out.0", h, qd), ("ff.ff.0", ff, h),
                                  ("ff.ff.3", h, ff)):
            specs += [(b + name + ".weight", (n_out, n_in), n_in),
                      (b + name + ".bias", (n_out,), "zeros")]
    specs += [(p + "norm_out.linear.weight", (2 * h, h), h),
              (p + "norm_out.linear.bias", (2 * h,), "zeros"),
              (p + "proj_out.weight", (dit.mel_dim, h), h),
              (p + "proj_out.bias", (dit.mel_dim,), "zeros")]

    g = "decoder.bigvgan."
    c0 = bv.upsample_initial_channel
    specs += [(g + "conv_pre.weight", (c0, bv.mel_dim, 5), bv.mel_dim * 5),
              (g + "conv_pre.bias", (c0,), "zeros")]
    n_res = len(bv.resblock_kernel_sizes)
    for li, k in enumerate(bv.upsample_kernel_sizes):
        cin, cout = c0 // 2 ** li, c0 // 2 ** (li + 1)
        specs += [(g + f"ups.{li}.0.weight", (cin, cout, k), cin * k),
                  (g + f"ups.{li}.0.bias", (cout,), "zeros")]
        for bi in range(n_res):
            rb = f"{g}resblocks.{li * n_res + bi}."
            ks, dil = bv.resblock_kernel_sizes[bi], bv.resblock_dilation_sizes[bi]
            for c in (1, 2):
                for j in range(len(dil)):
                    specs += [(rb + f"convs{c}.{j}.weight", (cout, cout, ks), cout * ks),
                              (rb + f"convs{c}.{j}.bias", (cout,), "zeros")]
            for j in range(2 * len(dil)):
                specs += [(rb + f"activations.{j}.act.{n}", (cout,), "snake")
                          for n in ("alpha", "beta")]
            if li <= 1:
                specs += [(rb + "pre_conv.weight", (cout, cout, ks), cout * ks),
                          (rb + "pre_conv.bias", (cout,), "zeros")]
                specs += [(rb + f"pre_act.act.{n}", (cout,), "snake") for n in ("alpha", "beta")]
    c_last = c0 // 2 ** len(bv.upsample_rates)
    specs += [(g + f"activation_post.act.{n}", (c_last,), "snake") for n in ("alpha", "beta")]
    specs.append((g + "conv_post.weight", (1, c_last, 7), c_last * 7))

    e = "encoder.tokenizer."
    d = enc.n_state
    specs += [(e + "conv1.weight", (d, enc.n_mels, 3), enc.n_mels * 3),
              (e + "conv1.bias", (d,), "zeros"),
              (e + "conv2.weight", (d, d, 3), d * 3), (e + "conv2.bias", (d,), "zeros")]
    for i in range(enc.audio_vq_layers):
        b = f"{e}blocks.{i}."
        specs += [(b + "attn_ln.weight", (d,), "ones"), (b + "attn_ln.bias", (d,), "zeros"),
                  (b + "mlp_ln.weight", (d,), "ones"), (b + "mlp_ln.bias", (d,), "zeros"),
                  (b + "attn.key.weight", (d, d), d),
                  (b + "mlp.0.weight", (4 * d, d), d), (b + "mlp.0.bias", (4 * d,), "zeros"),
                  (b + "mlp.2.weight", (d, 4 * d), 4 * d), (b + "mlp.2.bias", (d,), "zeros")]
        for name in ("query", "value", "out"):
            specs += [(b + f"attn.{name}.weight", (d, d), d),
                      (b + f"attn.{name}.bias", (d,), "zeros")]
    ds = enc.audio_vq_ds_rate
    specs += [(e + "audio_vq_downsample.weight", (d, d, ds), d * ds),
              (e + "audio_vq_downsample.bias", (d,), "zeros"),
              (e + "audio_quantizer.rvqs.0.embed",
               (1, enc.audio_vq_codebook_size, enc.audio_vq_codebook_dim), 16),
              (e + "audio_quantizer.rvqs.0.layers.0.project_in.weight",
               (enc.audio_vq_codebook_dim, d), d),
              (e + "audio_quantizer.rvqs.0.layers.0.project_in.bias",
               (enc.audio_vq_codebook_dim,), "zeros")]
    return specs


# A minimal ONNX writer: the protobuf wire format of the few ModelProto /
# GraphProto / NodeProto / TensorProto / AttributeProto fields a graph needs
# (field numbers from the public onnx.proto).

def _pb_varint(n: int) -> bytes:
    n %= 1 << 64  # a negative int64 as its two's complement
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_ld(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_vi(field: int, value: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(value)


def _onnx_tensor(name: str, arr) -> bytes:
    import numpy as np

    dtype = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}[arr.dtype]
    return (b"".join(_pb_vi(1, d) for d in arr.shape) + _pb_vi(2, dtype)
            + _pb_ld(8, name.encode()) + _pb_ld(9, arr.tobytes()))


def _onnx_attr(name: str, value) -> bytes:
    key = _pb_ld(1, name.encode())
    if isinstance(value, float):
        return _pb_ld(5, key + _pb_varint((2 << 3) | 5) + struct.pack("<f", value))
    if isinstance(value, int):
        return _pb_ld(5, key + _pb_vi(3, value))
    return _pb_ld(5, key + b"".join(_pb_vi(8, v) for v in value))


def _onnx_node(op: str, inputs, outputs, **attrs) -> bytes:
    return _pb_ld(1, b"".join(_pb_ld(1, s.encode()) for s in inputs)
                  + b"".join(_pb_ld(2, s.encode()) for s in outputs) + _pb_ld(4, op.encode())
                  + b"".join(_onnx_attr(k, v) for k, v in attrs.items()))


def campplus_graph(seed: int, out_dim: int, width: int = 512) -> bytes:
    """A CAM++-style x-vector graph ([1, T, 80] fbank → [1, out_dim]):
    Transpose, Conv + BatchNormalization + Relu, a dilated grouped Conv +
    Relu, mean and standard-deviation pooling, a Shape chain (Shape → Gather
    → Unsqueeze → Concat → Reshape) that flattens the statistics, and Gemm.
    Random weights from a numpy seed."""
    import numpy as np

    r = np.random.default_rng(seed)

    def w(*shape, fan):
        return (r.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    inits = {
        "w1": w(width, 80, 5, fan=400), "b1": np.zeros(width, np.float32),
        "bn_s": (1 + 0.1 * r.standard_normal(width)).astype(np.float32),
        "bn_b": (0.1 * r.standard_normal(width)).astype(np.float32),
        "bn_m": (0.1 * r.standard_normal(width)).astype(np.float32),
        "bn_v": ((1 + 0.1 * r.standard_normal(width)) ** 2).astype(np.float32),
        "w2": w(width, width // 4, 3, fan=3 * width // 4), "b2": np.zeros(width, np.float32),
        "wg": w(out_dim, 2 * width, fan=2 * width), "bg": np.zeros(out_dim, np.float32),
        "i0": np.asarray(0, np.int64), "m1": np.asarray([-1], np.int64),
    }
    nodes = [
        _onnx_node("Transpose", ["x"], ["xt"], perm=[0, 2, 1]),
        _onnx_node("Conv", ["xt", "w1", "b1"], ["h1"], pads=[2, 2], kernel_shape=[5]),
        _onnx_node("BatchNormalization", ["h1", "bn_s", "bn_b", "bn_m", "bn_v"], ["h2"],
                   epsilon=1e-5),
        _onnx_node("Relu", ["h2"], ["h3"]),
        _onnx_node("Conv", ["h3", "w2", "b2"], ["h4"], pads=[2, 2], dilations=[2], group=4,
                   kernel_shape=[3]),
        _onnx_node("Relu", ["h4"], ["h5"]),
        _onnx_node("ReduceMean", ["h5"], ["mu_k"], axes=[2], keepdims=1),
        _onnx_node("Sub", ["h5", "mu_k"], ["dev"]),
        _onnx_node("Mul", ["dev", "dev"], ["dev2"]),
        _onnx_node("ReduceMean", ["dev2"], ["var"], axes=[-1], keepdims=0),
        _onnx_node("Sqrt", ["var"], ["std"]),
        _onnx_node("ReduceMean", ["h5"], ["mu"], axes=[2], keepdims=0),
        _onnx_node("Concat", ["mu", "std"], ["stats"], axis=1),
        _onnx_node("Shape", ["stats"], ["shp"]),
        _onnx_node("Gather", ["shp", "i0"], ["n"], axis=0),
        _onnx_node("Unsqueeze", ["n"], ["n1"], axes=[0]),
        _onnx_node("Concat", ["n1", "m1"], ["flat"], axis=0),
        _onnx_node("Reshape", ["stats", "flat"], ["stats2"]),
        _onnx_node("Gemm", ["stats2", "wg", "bg"], ["y"], transB=1, alpha=1.0, beta=1.0),
    ]
    graph = (b"".join(nodes) + b"".join(_pb_ld(5, _onnx_tensor(k, v)) for k, v in inits.items())
             + _pb_ld(11, _pb_ld(1, b"x")) + _pb_ld(12, _pb_ld(1, b"y")))
    return _pb_vi(1, 8) + _pb_ld(7, graph)


def write_v1_checkpoint(model_dir: str, cfg, enc, seed: int, device: str = "cuda") -> None:
    """A 25 Hz tokenizer directory: the decoder in ``model.safetensors`` and
    Whisper-VQ in ``encoder.safetensors`` (bf16, ``v1_specs`` plus Whisper's
    sinusoid positions, the quantizer's input centred by
    ``centre_vq_input``), ``config.json`` and a CAM++-style
    ``campplus.onnx`` (``campplus_graph``)."""
    import torch

    from qwen_tts_tpu_torch.io.safetensors import save_file
    from qwen_tts_tpu_torch.models.whisper_vq import sinusoid_positions

    os.makedirs(model_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    tensors = make_tensors(v1_specs(cfg, enc), torch.bfloat16, gen)
    tensors["encoder.tokenizer.positional_embedding"] = torch.from_numpy(
        sinusoid_positions(enc.n_ctx, enc.n_state)).to(torch.bfloat16)
    encoder = {k: tensors.pop(k) for k in list(tensors) if k.startswith("encoder.")}
    save_file(tensors, os.path.join(model_dir, "model.safetensors"))
    save_file(centre_vq_input(encoder, enc, device), os.path.join(model_dir, "encoder.safetensors"))
    with open(os.path.join(model_dir, "campplus.onnx"), "wb") as f:
        f.write(campplus_graph(seed, cfg.dit.enc_emb_dim))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"model_type": "qwen3_tts_tokenizer_25hz",
                   "encoder_config": dataclasses.asdict(enc),
                   "decoder_config": {"dit_config": dataclasses.asdict(cfg.dit),
                                      "bigvgan_config": dataclasses.asdict(cfg.bigvgan)},
                   **{k: getattr(cfg, k) for k in (
                       "input_sample_rate", "output_sample_rate", "decode_upsample_rate",
                       "encode_downsample_rate")}}, f)


def centre_vq_input(tensors: dict, enc, device: str) -> dict:
    """Whisper-VQ's tensors with the quantizer's input-projection bias set
    so that the projected features of phase 11's clips (at 16 kHz) average
    zero. Random weights give every frame a large shared component, and
    with it one code for every frame of every clip (one distinct code in
    388 frames at the published widths on an NVIDIA H100); centred, the
    codes follow what varies from frame to frame."""
    import torch

    from qwen_tts_tpu_torch.audio import resample
    from qwen_tts_tpu_torch.models import whisper_vq as wvq

    class Tensors(dict):  # the reader interface load_whisper_vq takes
        def get_f32(self, name):
            return self[name].float()

    params = wvq.load_whisper_vq(Tensors(tensors), enc, device)
    clips = [resample(w, rate, wvq.SAMPLE_RATE) for w, rate in clone_clips()]
    with torch.inference_mode():
        feats = torch.cat(wvq.encode_features(params, enc, clips))
        mean = (feats @ params["vq_proj_in_w"] + params["vq_proj_in_b"]).mean(0)
    name = "encoder.tokenizer.audio_quantizer.rvqs.0.layers.0.project_in.bias"
    return dict(tensors, **{name: (tensors[name].float() - mean.cpu()).to(tensors[name].dtype)})


def v1_flops(cfg, b: int, t_code: int, num_steps: int = 10, cfg_doubled: bool = True):
    """(DiT, BigVGAN) floating-point operations of one decode of ``b`` rows
    of ``t_code`` codes: multiply-adds count 2. The DiT: every linear per
    token (the AdaLN and time MLPs per row), the block-local attention's
    scores and products over each block's key window, num_steps - 1
    forwards on a CFG-doubled batch; ECAPA left out. BigVGAN: every conv
    and transposed conv, and the anti-aliasing filters' taps (12 up, 12
    down a sample per activation)."""
    dit, bv = cfg.dit, cfg.bigvgan
    rows = 2 * b if cfg_doubled else b
    t_mel = t_code * dit.repeats
    tokens = rows * t_mel
    h, qd = dit.hidden_size, dit.num_attention_heads * dit.head_dim
    in_dim = dit.mel_dim + dit.enc_dim + dit.emb_dim + dit.enc_emb_dim
    per_token = 2 * (in_dim * h + h * dit.mel_dim)
    per_row = 2 * (256 * h + h * h + 2 * h * h)
    nb = -(-t_mel // dit.block_size)
    attn = 0
    for i in range(dit.num_hidden_layers):
        per_token += 2 * (4 * h * qd + 2 * h * h * dit.ff_mult)
        per_row += 2 * 6 * h * h
        keys = (1 + (i in dit.look_backward_layers) + (i in dit.look_ahead_layers)) * dit.block_size
        attn += 2 * 2 * rows * dit.num_attention_heads * nb * dit.block_size * keys * dit.head_dim
    dit_flops = (num_steps - 1) * (tokens * per_token + rows * per_row + attn)

    t, c = t_mel, bv.upsample_initial_channel
    big = 2 * b * t * c * bv.mel_dim * 5

    def act(ch, length):
        return 2 * b * ch * length * 24

    for li, (rate, k) in enumerate(zip(bv.upsample_rates, bv.upsample_kernel_sizes)):
        big += 2 * b * t * c * (c // 2) * k
        t, c = t * rate, c // 2
        for ks, dil in zip(bv.resblock_kernel_sizes, bv.resblock_dilation_sizes):
            convs = 2 * len(dil) + (li <= 1)
            big += convs * 2 * b * t * c * c * ks + (convs) * act(c, t)
    big += act(c, t) + 2 * b * t * c * 7
    return dit_flops, big


def _rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def v1_inputs(cfg, b: int, t_code: int, ref_frames: int, seed: int):
    """Random codes [b, t_code] (ids 0..num_embeds), unit x-vectors and
    reference mels of ``ref_frames`` frames from ``v1_ref_mel`` of noisy
    voiced clips, from a numpy seed; a payload ``decode`` takes."""
    import numpy as np

    from qwen_tts_tpu_torch.models.whisper_vq import HOP, v1_ref_mel

    r = np.random.default_rng(seed)
    n = ref_frames * HOP
    t = np.arange(n) / 16000
    out = []
    for _ in range(b):
        wav = (0.2 * np.sin(2 * np.pi * r.uniform(90, 220) * t)
               + 0.02 * r.standard_normal(n)).astype(np.float32)
        xv = r.standard_normal(cfg.dit.enc_emb_dim).astype(np.float32)
        out.append({"audio_codes": r.integers(0, cfg.dit.num_embeds + 1, t_code),
                    "xvectors": xv / np.linalg.norm(xv),
                    "ref_mels": v1_ref_mel(wav)[:ref_frames]})
    return out


def v1_stages(tok, payload, noise=None, generator=None):
    """``decode``'s work in its two stages, timed by CUDA events on the card:
    (mel, waveform before the clamp, DiT ms, BigVGAN ms). The batch and the
    initial noise as ``decode`` makes them unless ``noise`` is given."""
    import torch

    from qwen_tts_tpu_torch.models import codec_v1
    from qwen_tts_tpu_torch.utils import full_f32

    _, codes, xv, mel = tok.batch_v1([p["audio_codes"] for p in payload],
                                     [p["xvectors"] for p in payload],
                                     [p["ref_mels"] for p in payload])
    codes = torch.as_tensor(codes, device=tok.device).clamp(min=0)
    cuda = tok.device.type == "cuda"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
    with torch.inference_mode(), full_f32():
        if cuda:
            ev[0].record()
        m = codec_v1.dit_sample(tok.params["dit"], tok.cfg.dit, codes, mel, xv, generator,
                                noise=noise)
        if cuda:
            ev[1].record()
        wav = codec_v1.bigvgan_forward(tok.params["bigvgan"], tok.cfg.bigvgan, m, clamp=False)
        if cuda:
            ev[2].record()
            torch.cuda.synchronize()
    times = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])) if cuda else (0.0, 0.0)
    return m.cpu(), wav.cpu(), *times


def check_v1_parity(model_dir: str, smi: str) -> dict:
    """f32 on the card and on the CPU: the DiT's mel and BigVGAN's waveform
    before the clamp at B=1 x V1_PARITY_CODES codes under one initial noise,
    the Whisper-VQ codes, reference mels and x-vectors of phase 11's clips
    resampled to 16 kHz. Returns the card's f32 tokenizer and the parity
    payload."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.audio import resample
    from qwen_tts_tpu_torch.models import codec_v1
    from qwen_tts_tpu_torch.models import whisper_vq as wvq
    from qwen_tts_tpu_torch.tokenizer import Qwen3TTSTokenizer

    t0 = time.perf_counter()
    card = Qwen3TTSTokenizer.from_pretrained(model_dir)
    cpu = Qwen3TTSTokenizer.from_pretrained(model_dir, device="cpu")
    log(f"25 Hz: f32 tokenizer loaded on the card ({card.device}) and the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = card.cfg
    payload = v1_inputs(cfg, 1, V1_PARITY_CODES, V1_REF_FRAMES, seed=21)
    noise = codec_v1.initial_noise(1, V1_PARITY_CODES * cfg.dit.repeats, cfg.dit.mel_dim,
                                   torch.Generator().manual_seed(5))
    mel_card, wav_card, dit_ms, big_ms = v1_stages(card, payload, noise=noise)
    t0 = time.perf_counter()
    mel_cpu, wav_cpu, _, _ = v1_stages(cpu, payload, noise=noise)
    cpu_s = time.perf_counter() - t0
    rel_mel, rel_wav = _rel_l2(mel_card, mel_cpu), _rel_l2(wav_card, wav_cpu)
    inside = (wav_cpu.abs() < 1).float().mean().item()
    log(f"25 Hz decode f32, card vs CPU, B=1 x {V1_PARITY_CODES} codes, shared noise: mel "
        f"relative L2 {rel_mel:.3g} (tol {V1_MEL_REL_L2}), waveform before the clamp "
        f"{rel_wav:.3g} (tol {V1_WAV_REL_L2}), max |wav| {wav_cpu.abs().max().item():.3g}, "
        f"share inside the clamp {inside:.4f}; card DiT {dit_ms:.1f} ms, BigVGAN "
        f"{big_ms:.1f} ms (f32, events); CPU {cpu_s:.1f} s | {smi}")
    if not (rel_mel <= V1_MEL_REL_L2 and rel_wav <= V1_WAV_REL_L2):
        fail("25 Hz: card and CPU f32 decodes disagree")
    if not torch.isfinite(wav_card).all():
        fail("25 Hz: the card's waveform is not finite")
    wavs, sr = card.decode(payload, seed=3)
    want = V1_PARITY_CODES * cfg.samples_per_code
    if sr != 24000 or wavs[0].shape != (want,) or not np.isfinite(wavs[0]).all():
        fail(f"25 Hz: decode gave {wavs[0].shape} at {sr} Hz (want {want} samples at 24000)")

    clips = [resample(w, rate, wvq.SAMPLE_RATE) for w, rate in clone_clips()]
    got = card.encode(clips, wvq.SAMPLE_RATE)
    t0 = time.perf_counter()
    want = cpu.encode(clips, wvq.SAMPLE_RATE)
    cpu_s = time.perf_counter() - t0
    enc_cfg, enc_params = cpu._encoder
    equal = total = 0
    gaps = []
    feats = wvq.encode_features(enc_params, enc_cfg, clips)
    for a, b, f in zip(got["audio_codes"], want["audio_codes"], feats):
        if a.shape != b.shape:
            fail(f"25 Hz: code counts differ card {a.shape} CPU {b.shape}")
        equal += int((a == b).sum())
        total += a.size
        if (a != b).any():
            d = wvq.vq_distances(enc_params, f).numpy()
            rows = np.nonzero(a != b)[0]
            da, db = d[rows, a[rows]], d[rows, b[rows]]
            gaps += list(np.abs(da - db) / np.maximum(np.abs(da), np.abs(db)))
    agreement = equal / total
    worst = max(gaps, default=0.0)
    mel_err = max(float(np.abs(a - b).max()) for a, b in zip(got["ref_mels"], want["ref_mels"]))
    xv_err = max(float(np.abs(a - b).max()) for a, b in zip(got["xvectors"], want["xvectors"]))
    log(f"25 Hz encode f32, card vs CPU, {len(clips)} clips at 16 kHz "
        f"({[c.shape[0] for c in want['audio_codes']]} codes): Whisper-VQ agreement "
        f"{agreement:.6f} (min {V1_CODE_AGREEMENT}), {len(gaps)} differing code(s), largest "
        f"relative distance gap {worst:.3g} (near-tie limit {V1_NEAR_TIE_REL}); "
        f"{len(set(np.concatenate(got['audio_codes']).tolist()))} distinct codes; reference "
        f"mels max |diff| {mel_err:.3g} (tol {V1_REF_MEL_ATOL}); x-vectors "
        f"({got['xvectors'][0].shape[0]} wide, CAM++-style graph) max |diff| {xv_err:.3g} "
        f"(tol {V1_XVEC_ATOL}); CPU encode {cpu_s:.1f} s")
    if agreement < V1_CODE_AGREEMENT or worst > V1_NEAR_TIE_REL:
        fail("25 Hz: card and CPU Whisper-VQ codes disagree beyond near-ties")
    if not (mel_err <= V1_REF_MEL_ATOL and xv_err <= V1_XVEC_ATOL):
        fail("25 Hz: card and CPU reference mels or x-vectors disagree")
    return {"card": card, "clips": clips, "payload": payload, "noise": noise,
            "mel": mel_card, "wav": wav_card}


V1_INIT_CODES = 25  # the initialised decoder's one decode: B=1 x 25 codes


def check_v1_initialisers(cfg, enc, codec, vq, smi: str) -> None:
    """Phase 14: the 25 Hz random initialisers on the card at the phase's
    widths against the loaders' trees from ``write_v1_checkpoint``'s
    checkpoint: ``init_codec_v1_params`` in bf16 against ``codec`` (the bf16
    loader's), ``init_whisper_vq`` against ``vq`` (the encoder's loader,
    float32 whatever the codec's dtype: its only dtype) in keys, shapes and
    dtypes; then one B=1 x V1_INIT_CODES decode from the initialised DiT and
    BigVGAN, which must be finite."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.models.codec_v1 import init_codec_v1_params
    from qwen_tts_tpu_torch.models.whisper_vq import init_whisper_vq
    from qwen_tts_tpu_torch.tokenizer import MODEL_TYPE_25HZ, Qwen3TTSTokenizer

    def specs(tree):
        return {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in _leaves(tree).items()}

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2526)
    init = init_codec_v1_params(gen, cfg, torch.bfloat16)
    init_vq = init_whisper_vq(gen, enc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for what, got, want in (("init_codec_v1_params", init, codec),
                            ("init_whisper_vq", init_vq, vq)):
        a, b = specs(got), specs(want)
        if a != b:
            fail(f"25 Hz: {what}'s tree differs from the loader's in keys, shapes, dtypes or "
                 f"devices: {sorted(set(a.items()) ^ set(b.items()))[:4]}")
    payload = v1_inputs(cfg, 1, V1_INIT_CODES, V1_REF_FRAMES, seed=31)
    t0 = time.perf_counter()
    wavs, _ = Qwen3TTSTokenizer(MODEL_TYPE_25HZ, cfg, init).decode(payload, seed=0)
    decode_s = time.perf_counter() - t0
    want = (V1_INIT_CODES * cfg.samples_per_code,)
    finite = wavs[0].shape == want and bool(np.isfinite(wavs[0]).all())
    log(f"25 Hz initialisers on the card: init_codec_v1_params (bf16, "
        f"{len(_leaves(init))} leaves) and init_whisper_vq (f32, {len(_leaves(init_vq))} "
        f"leaves) drawn in {init_s:.2f} s; keys, shapes and dtypes equal the loaders' trees "
        f"of the written checkpoint; one B=1 x {V1_INIT_CODES}-code decode of the initialised "
        f"DiT + BigVGAN in {decode_s:.2f} s: {wavs[0].shape} samples, finite {finite}, "
        f"max |x| {float(np.abs(wavs[0]).max()):.3f} | {smi}")
    if not finite:
        fail(f"25 Hz: the initialised decoder gave {wavs[0].shape} samples (want {want}), "
             f"finite {bool(np.isfinite(wavs[0]).all())}")


def phase_tokenizer_25hz(smi: str, cfg=None, enc=None) -> None:
    """Phase 14: the 25 Hz tokenizer at the JAX package's widths
    (``CodecV1Config()``, ``WhisperVQConfig()``), random bf16 weights. f32
    card against CPU (``check_v1_parity``); then the bf16 decode at
    V1_BATCH x V1_CODES codes timed (wall, DiT against BigVGAN by events,
    audio seconds, RTF, peak memory) beside its compute bound, the f32
    encode of the four clips timed, and one profiled decode (top ops by
    device time, idle share). bf16 against f32 is reported, not held.
    ``cfg`` / ``enc`` replace the widths (a rehearsal on the CPU)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qwen_tts_tpu_torch.config import CodecV1Config
    from qwen_tts_tpu_torch.models.whisper_vq import WhisperVQConfig
    from qwen_tts_tpu_torch.tokenizer import Qwen3TTSTokenizer

    cfg, enc = cfg or CodecV1Config(), enc or WhisperVQConfig()
    model_dir = tempfile.mkdtemp(prefix="qtts_v1_")
    try:
        t0 = time.perf_counter()
        write_v1_checkpoint(model_dir, cfg, enc, seed=2525)
        n_params = sum(math.prod(s) for _, s, _ in v1_specs(cfg, enc))
        size = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
        log(f"25 Hz: checkpoint of {n_params / 1e9:.3f} B parameters ({size / 2**30:.2f} GiB "
            f"bf16: DiT {cfg.dit.num_hidden_layers} x {cfg.dit.hidden_size}, BigVGAN "
            f"{cfg.bigvgan.upsample_initial_channel} ch x {cfg.bigvgan.upsample_rates}, "
            f"Whisper-VQ {enc.audio_vq_layers} x {enc.n_state}) written in "
            f"{time.perf_counter() - t0:.1f} s")
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        parity = check_v1_parity(model_dir, smi)

        bf16 = Qwen3TTSTokenizer.from_pretrained(model_dir, dtype=torch.bfloat16)
        check_v1_initialisers(cfg, enc, bf16.params, parity["card"]._encoder[1], smi)
        _, wav16, _, _ = v1_stages(bf16, parity["payload"], noise=parity["noise"])
        log(f"25 Hz decode bf16 vs f32 on the card (reported, not held): waveform before the "
            f"clamp relative L2 {_rel_l2(wav16, parity['wav']):.3g} | {smi}")
        payload = v1_inputs(cfg, V1_BATCH, V1_CODES, V1_REF_FRAMES, seed=22)
        bf16.decode(payload, seed=0)  # warm-up: cuDNN's plan search at these shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(3):
            t0 = time.perf_counter()
            wavs, sr = bf16.decode(payload, seed=i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # Every row has V1_CODES codes, so decode's cut at V1_CODES x
        # decode_upsample_rate (twice what a code makes at these widths) keeps
        # the whole decode: the samples the codes make, which the audio
        # seconds and the RTF count.
        samples = sum(w.shape[0] for w in wavs)
        want = V1_CODES * cfg.samples_per_code
        if any(w.shape != (want,) or not np.isfinite(w).all() for w in wavs):
            fail(f"25 Hz: bf16 decode shapes {[w.shape for w in wavs]} (want {want})")
        audio_s = samples / sr
        stages = [v1_stages(bf16, payload, generator=torch.Generator("cuda").manual_seed(i))[2:]
                  for i in range(3)]
        dit_flops, big_flops = v1_flops(cfg, V1_BATCH, V1_CODES)
        dit_ms = [s[0] for s in stages]
        big_ms = [s[1] for s in stages]
        wall = statistics.median(walls)
        log(f"25 Hz decode bf16, B={V1_BATCH} x {V1_CODES} codes (ref mel {V1_REF_FRAMES} "
            f"frames, 10 Euler steps, CFG): wall median {wall * 1e3:.1f} ms "
            f"({_spread([w * 1e3 for w in walls], '{:.1f}')}), {audio_s:.1f} s of audio "
            f"({samples} samples, the {cfg.samples_per_code} a code makes), RTF "
            f"{wall / audio_s:.5f}, peak memory {peak:.2f} GiB | {smi}")
        log(f"25 Hz decode bf16 stages (events, 3 runs): DiT {statistics.median(dit_ms):.1f} ms "
            f"({_spread(dit_ms, '{:.1f}')}), BigVGAN {statistics.median(big_ms):.1f} ms "
            f"({_spread(big_ms, '{:.1f}')}); bounds at the bf16 peak "
            f"({H100_BF16_FLOPS / 1e12:.0f} TFLOP/s): DiT {dit_flops / 1e12:.2f} TFLOP a call "
            f"(9 forwards) -> {dit_flops / H100_BF16_FLOPS * 1e3:.2f} ms, BigVGAN "
            f"{big_flops / 1e12:.2f} TFLOP -> {big_flops / H100_BF16_FLOPS * 1e3:.2f} ms | {smi}")
        launches = {k: c.launches for k, c in counters.items()}
        log(f"25 Hz: launches of the port's kernels over the phase {launches} (none is on "
            f"this path)")

        card, clips = parity["card"], parity["clips"]
        card.encode(clips, 16000)  # warm-up
        enc_walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.encode(clips, 16000)
            torch.cuda.synchronize()
            enc_walls.append(time.perf_counter() - t0)
        clip_s = sum(c.shape[0] for c in clips) / 16000
        log(f"25 Hz encode f32 (Whisper-VQ, reference mels, x-vectors) of {len(clips)} clips, "
            f"{clip_s:.1f} s of audio: wall median {statistics.median(enc_walls) * 1e3:.1f} ms "
            f"({_spread([w * 1e3 for w in enc_walls], '{:.1f}')}) | {smi}")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bf16.decode(payload, seed=0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        if busy_ms == 0:
            log("25 Hz profile: the profiler saw no device time (not measured)")
        else:
            log(f"25 Hz profile, one bf16 decode B={V1_BATCH} x {V1_CODES}: wall {wall_ms:.1f} "
                f"ms (profiler on), device busy {busy_ms:.1f} ms, idle share "
                f"{1 - busy_ms / wall_ms:.3f}; against the unprofiled median "
                f"{1 - busy_ms / (wall * 1e3):.3f} | {smi}")
            for e in device[:10]:
                log(f"  25 Hz profile op: {e.self_device_time_total / 1e3:8.2f} ms "
                    f"({e.self_device_time_total / 1e3 / busy_ms:.3f}) {e.count:6d}x  "
                    f"{e.key[:90]}")
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


# --------------------------------------------------------------------------
# Phase 15: training
# --------------------------------------------------------------------------

# SFT at the flagship widths: TRAIN_ROWS pre-tokenized rows (<|im_start|>
# and TRAIN_TEXT + 2 random text ids; TRAIN_FRAMES frames of every group's
# codes, 16 under 2048 at these widths; a random speaker embedding), batch
# TRAIN_BATCH, one epoch.
TRAIN_ROWS = 8
TRAIN_BATCH = 2
TRAIN_TEXT = (8, 40)
TRAIN_FRAMES = (40, 150)
TRAIN_SPEAKER = "myvoice"
# Tolerances, set before the first run:
# remat recomputes the same ops, so the four steps' losses agree up to the
# order of the gradients' sums (JAX measures ~5e-8 on the loss).
TRAIN_REMAT_LOSS_RTOL = 1e-5
# Card (f32, no TF32) against CPU at the cut depth: the loss and its terms
# differ in summation order only; each gradient leaf through 4 + 5 layers of
# backward; the params after 2 AdamW steps of lr 5e-5 from the same start,
# where only elements whose gradient sits at the noise level can flip the
# sign of their first update. The updates themselves (p2 - p0) are held
# loosely, to catch a wrong rate or decay.
TRAIN_CPU_LOSS_RTOL = 1e-5
TRAIN_CPU_GRAD_REL_L2 = 1e-4
TRAIN_CPU_PARAM_REL_L2 = 1e-4
TRAIN_CPU_UPDATE_REL_L2 = 1e-2
TRAIN_CUT_LAYERS = 4          # the talker's depth for card against CPU and resume
TRAIN_CPU_FRAMES = (20, 28)   # shorter rows there, so that the CPU side stays short
# EMA VQ at the Whisper-VQ widths (the 25 Hz tokenizer's encoder: 1280-wide
# features, a 4096 x 512 codebook behind a projection, one quantizer).
VQ_DIM, VQ_CODES, VQ_CODE_DIM, VQ_ROWS, VQ_STEPS = 1280, 4096, 512, 2000, 3
# Card against CPU, each step from the same state: codes agree at least at
# VQ_AGREEMENT, each disagreement a near tie (the CPU's distances to both
# codes within VQ_NEAR_TIE_REL); the buffers of every code no disagreement
# touched within VQ_BUFFER_REL of their largest value (sums in another order).
VQ_AGREEMENT = 0.999
VQ_NEAR_TIE_REL = 1e-5
VQ_BUFFER_REL = 1e-5


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def training_rows(path: str, config: dict, frames, seed: int, n: int = TRAIN_ROWS) -> list:
    """``n`` pre-tokenized JSONL rows for the SFT CLI, written to ``path``
    and returned: ``<|im_start|>`` and TRAIN_TEXT + 2 text ids, TRAIN_FRAMES
    frames of every code group, a speaker embedding, for the checkpoint's
    ``config.json``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    talker_cfg = config["talker_config"]
    groups = talker_cfg["num_code_groups"]
    codes = talker_cfg["code_predictor_config"]["vocab_size"]
    rows = []
    for _ in range(n):
        text = rng.integers(0, talker_cfg["text_vocab_size"], int(rng.integers(*TRAIN_TEXT)) + 2)
        rows.append({
            "text_ids": [config["im_start_token_id"]] + text.tolist(),
            "audio_codes": rng.integers(
                0, codes, (int(rng.integers(frames[0], frames[1] + 1)), groups)).tolist(),
            "speaker_embedding": (0.03 * rng.standard_normal(talker_cfg["hidden_size"])).astype(
                np.float32).tolist(),
        })
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


@contextlib.contextmanager
def seconds_of(calls: dict):
    """Each ``(module, name)`` in ``calls`` timed while the block runs:
    yields {label: [seconds of each call]}."""
    import importlib

    spent = {label: [] for label in calls}
    saved = []
    for label, (mod_name, name) in calls.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            spent[_label].append(time.perf_counter() - t0)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    try:
        yield spent
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_sft_cli(base_dir: str, data: str, out: str, remat: bool, device: str,
                profile_step=None) -> dict:
    """The port's SFT entry (``sft_12hz.train`` on the parsed flags), one
    epoch at TRAIN_BATCH; each step's loss, terms, seconds (host clock from
    the end of one step to the end of the next, after a synchronise: the
    collate and the step) and real tokens; peak device memory; the export's
    and the snapshot's seconds. ``profile_step`` profiles that step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen_tts_tpu_torch.training import sft_12hz

    args = sft_12hz.parse_args(
        ["--model-path", base_dir, "--data", data, "--output-model-path", out,
         "--speaker-name", TRAIN_SPEAKER, "--num-epochs", "1",
         "--batch-size", str(TRAIN_BATCH)] + (["--remat"] if remat else [])
        + (["--cpu"] if device == "cpu" else []))
    steps, mark = [], [time.perf_counter()]
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile_step is not None else None)

    def on_step(step, batch, loss, aux):
        _sync(device)
        now = time.perf_counter()
        steps.append({"loss": float(loss), "talker_ce": float(aux["talker_ce"]),
                      "subtalker_ce": float(aux["subtalker_ce"]), "s": now - mark[0],
                      "tokens": int(batch.pad_mask.sum()), "shape": tuple(batch.pad_mask.shape),
                      "profiled": step == profile_step})
        if prof is not None and step == profile_step - 1:
            prof.start()
        if prof is not None and step == profile_step:
            prof.stop()
        mark[0] = time.perf_counter()

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    calls = {"export": ("qwen_tts_tpu_torch.io.saver", "save_finetuned_checkpoint"),
             "snapshot": ("qwen_tts_tpu_torch.training.checkpoint", "save_train_state")}
    with seconds_of(calls) as spent:
        rc = sft_12hz.train(args, on_step)
    if rc != 0:
        fail(f"training: the SFT entry returned {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    return {"steps": steps, "peak_gib": peak, "export_s": spent["export"][0],
            "snapshot_s": spent["snapshot"][0], "prof": prof}


def log_sft_run(name: str, run: dict, smi: str) -> float:
    """Logs a run's steps; returns the median step seconds of the unprofiled
    steps after the first (the first also loads the checkpoint)."""
    for i, s in enumerate(run["steps"]):
        if not all(math.isfinite(s[k]) for k in ("loss", "talker_ce", "subtalker_ce")):
            fail(f"training: {name} step {i} loss is not finite: {s}")
    timed_steps = [s for s in run["steps"][1:] if not s["profiled"]]
    step_s = statistics.median(s["s"] for s in timed_steps)
    tokens = statistics.median(s["tokens"] for s in timed_steps)
    log(f"training SFT {name}: losses {[round(s['loss'], 5) for s in run['steps']]} (talker "
        f"{[round(s['talker_ce'], 4) for s in run['steps']]}, sub-talker "
        f"{[round(s['subtalker_ce'], 4) for s in run['steps']]}); batch shapes "
        f"{[s['shape'] for s in run['steps']]}; step {step_s * 1e3:.1f} ms median over "
        f"{len(timed_steps)} ({_spread([s['s'] * 1e3 for s in timed_steps], '{:.1f}')}; "
        f"collate + step, host clock after a synchronise), {tokens / step_s:.0f} tokens/s "
        f"({tokens:.0f} real positions a step), peak memory {run['peak_gib']:.2f} GiB; "
        f"export {run['export_s']:.1f} s, train-state snapshot {run['snapshot_s']:.1f} s | {smi}")
    return step_s


def log_profile(prof, what: str, wall_ms: float, unprofiled_ms: float, smi: str) -> None:
    """The profiled step's device busy time, idle share (against its own
    wall and the unprofiled steps' median) and top ten device ops."""
    from torch.autograd import DeviceType

    device = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if busy_ms == 0:
        log("training profile: the profiler saw no device time (not measured)")
        return
    log(f"training profile, {what}: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms in {sum(e.count for e in device)} kernels, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; against the unprofiled median "
        f"{1 - busy_ms / unprofiled_ms:.3f} | {smi}")
    for e in device[:10]:
        log(f"  training profile op: {e.self_device_time_total / 1e3:8.2f} ms "
            f"({e.self_device_time_total / 1e3 / busy_ms:.3f}) {e.count:6d}x  {e.key[:90]}")


def _leaves(tree) -> dict:
    from qwen_tts_tpu_torch.training.checkpoint import flatten

    return flatten(tree)


def _tree_to(tree, device):
    from qwen_tts_tpu_torch.training.sft import tree_map

    return tree_map(lambda t: t.to(device), tree)


def step_without_determinism(cfg, optimizer, params, opt_state, batch):
    """``make_train_step``'s step with f32 but without deterministic
    algorithms: what determinism costs."""
    from qwen_tts_tpu_torch.training.sft import loss_and_grads
    from qwen_tts_tpu_torch.utils import full_f32

    with full_f32():
        loss, aux, grads = loss_and_grads(params, cfg, batch)
        optimizer.step(grads, opt_state, params)
        return params, opt_state, loss, aux


def time_determinism(cfg, params, opt_state, batch, smi: str, runs: int = 3) -> None:
    """The full-width step with and without deterministic algorithms, in
    turns, each from a copy of the same state; every deterministic step's
    params and state the bits of the first."""
    import torch

    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step, tree_map

    optimizer = make_optimizer(5e-5, weight_decay=0.01)
    step = make_train_step(cfg, optimizer)
    times = {"deterministic": [], "not deterministic": []}
    first, same = None, True
    for _ in range(runs):
        for name, fn in (("deterministic", step),
                         ("not deterministic",
                          lambda p, o, b: step_without_determinism(cfg, optimizer, p, o, b))):
            p, o = tree_map(torch.clone, params), tree_map(torch.clone, opt_state)
            _sync("cuda")
            t0 = time.perf_counter()
            out = _leaves(fn(p, o, batch)[:2])
            _sync("cuda")
            times[name].append(time.perf_counter() - t0)
            if name == "deterministic":
                if first is None:
                    first = out
                else:
                    same = same and all(_equal_bits(first[k], out[k]) for k in first)
            del out, p, o
    del first
    det, free = (statistics.median(times[k]) for k in ("deterministic", "not deterministic"))
    log(f"training: full-width step with deterministic algorithms "
        f"{_spread([t * 1e3 for t in times['deterministic']], '{:.1f}')} ms, without "
        f"{_spread([t * 1e3 for t in times['not deterministic']], '{:.1f}')} ms (median "
        f"{runs} each, in turns, batch {tuple(batch.pad_mask.shape)}): determinism costs "
        f"{(det - free) * 1e3:.1f} ms a step ({det / free - 1:+.3f}); the {runs} "
        f"deterministic steps' params and state bit-identical: {same} | {smi}")
    if not same:
        fail("training: two deterministic steps from one state differ")


def _equal_bits(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _rel(a, b) -> float:
    """Relative L2 of ``a`` from ``b`` in f64, on ``a``'s device."""
    import torch

    a, b = a.detach().double(), b.detach().to(a.device).double()
    den = torch.linalg.norm(b)
    return float(torch.linalg.norm(a - b) / den) if den > 0 else float(torch.linalg.norm(a))


def cut_training_params(base_dir: str, device: str):
    """(cfg cut to TRAIN_CUT_LAYERS talker layers, its params in f32 on
    ``device``): widths full."""
    import torch

    from qwen_tts_tpu_torch.io.loader import load_checkpoint

    cfg, talker, sub, _, _ = load_checkpoint(base_dir, talker_dtype=torch.float32, device=device)
    cfg = dataclasses.replace(cfg, talker=dataclasses.replace(
        cfg.talker, num_hidden_layers=TRAIN_CUT_LAYERS))
    talker = dict(talker, trunk={k: v[:TRAIN_CUT_LAYERS].clone()
                                 for k, v in talker["trunk"].items()})
    return cfg, {"talker": talker, "subtalker": sub}


def check_training_card_vs_cpu(cfg, params, batches, smi: str) -> None:
    """One batch's loss, terms and every gradient leaf, then the params
    after 2 optimizer steps, card against CPU from the same params and the
    same batch tensors."""
    import torch

    from qwen_tts_tpu_torch.training.sft import (
        SFTBatch, loss_and_grads, make_optimizer, make_train_step, step_mode, tree_map)

    optimizer = make_optimizer(5e-5, weight_decay=0.01)
    sides = {}
    for side, device in (("card", params["talker"]["norm"].device), ("cpu", "cpu")):
        p0 = params if side == "card" else _tree_to(params, "cpu")
        bs = [SFTBatch(*(t.to(device) for t in b)) for b in batches[:2]]
        t0 = time.perf_counter()
        p, state = tree_map(torch.clone, p0), optimizer.init(p0)
        with step_mode(torch.device(device)):
            loss, aux, grads = loss_and_grads(p, cfg.talker, bs[0])
            optimizer.step(grads, state, p)
        make_train_step(cfg.talker, optimizer)(p, state, bs[1])
        _sync(device)
        sides[side] = {"loss": loss, "aux": aux, "grads": _leaves(grads), "p2": _leaves(p),
                       "p0": _leaves(p0), "s": time.perf_counter() - t0}
        del grads, p, state
    card, cpu = sides["card"], sides["cpu"]
    terms = {"loss": (card["loss"], cpu["loss"])}
    terms.update({k: (card["aux"][k], cpu["aux"][k]) for k in card["aux"]})
    term_err = {k: abs(float(a) - float(b)) / abs(float(b)) for k, (a, b) in terms.items()}
    grad_err = {k: _rel(card["grads"][k], cpu["grads"][k]) for k in card["grads"]}
    param_err = {k: _rel(card["p2"][k], cpu["p2"][k]) for k in card["p2"]}
    update_err = {k: _rel(card["p2"][k] - card["p0"][k], cpu["p2"][k] - cpu["p0"][k])
                  for k in card["p2"]}
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])  # noqa: E731
    log(f"training card vs CPU (f32, talker cut to {TRAIN_CUT_LAYERS} layers, widths full, "
        f"batch {tuple(batches[0].pad_mask.shape)}): relative loss / term errors "
        f"{ {k: f'{v:.2e}' for k, v in term_err.items()} } (tol {TRAIN_CPU_LOSS_RTOL}); "
        f"gradient leaves' relative L2 worst {worst(grad_err)[1]:.2e} at {worst(grad_err)[0]} "
        f"(tol {TRAIN_CPU_GRAD_REL_L2}); params after 2 steps worst {worst(param_err)[1]:.2e} "
        f"at {worst(param_err)[0]} (tol {TRAIN_CPU_PARAM_REL_L2}); updates p2 - p0 worst "
        f"{worst(update_err)[1]:.2e} at {worst(update_err)[0]} (tol {TRAIN_CPU_UPDATE_REL_L2}); "
        f"CPU side {cpu['s']:.1f} s, card {card['s']:.2f} s | {smi}")
    if max(term_err.values()) > TRAIN_CPU_LOSS_RTOL:
        fail("training: card and CPU losses disagree")
    if worst(grad_err)[1] > TRAIN_CPU_GRAD_REL_L2:
        fail("training: card and CPU gradients disagree")
    if worst(param_err)[1] > TRAIN_CPU_PARAM_REL_L2 or worst(update_err)[1] > TRAIN_CPU_UPDATE_REL_L2:
        fail("training: card and CPU params after 2 steps disagree")


def check_resume(cfg, params, batches, work: str, smi: str) -> None:
    """4 straight steps against 2 + save + restore into fresh state + 2, on
    the params' device (the card): params and optimizer state bit for bit."""
    import torch

    from qwen_tts_tpu_torch.training.checkpoint import load_train_state, save_train_state
    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step, tree_map

    optimizer = make_optimizer(5e-5, weight_decay=0.01)
    step = make_train_step(cfg.talker, optimizer)
    p, o = tree_map(torch.clone, params), optimizer.init(params)
    for b in batches:
        p, o, loss_a, _ = step(p, o, b)
    p2, o2 = tree_map(torch.clone, params), optimizer.init(params)
    for b in batches[:2]:
        p2, o2, _, _ = step(p2, o2, b)
    device = params["talker"]["norm"].device
    _sync(device)
    t0 = time.perf_counter()
    save_train_state(work, p2, o2, step=2, epoch=0)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(work) for f in fs)
    del p2, o2
    fresh = tree_map(torch.empty_like, params)  # a fresh tree of the same shapes
    t0 = time.perf_counter()
    rp, ro, meta = load_train_state(work, fresh, optimizer)
    _sync(device)
    load_s = time.perf_counter() - t0
    del fresh
    for b in batches[2:]:
        rp, ro, loss_b, _ = step(rp, ro, b)
    a, b = _leaves({"p": p, "o": o}), _leaves({"p": rp, "o": ro})
    same = set(a) == set(b) and all(_equal_bits(a[k], b[k]) for k in a)
    log(f"training resume on {device.type} (talker cut to {TRAIN_CUT_LAYERS} layers): 2 steps, "
        f"snapshot {size / 2**30:.2f} GiB saved in {save_s:.2f} s and restored in {load_s:.2f} "
        f"s, 2 steps: params and optimizer state ({len(a)} leaves) bit for bit those of 4 "
        f"straight steps: {same}; loss {float(loss_b):.6f} == {float(loss_a):.6f} | {smi}")
    if not same or meta["step"] != 2:
        fail("training: the resumed run differs from the uninterrupted one")


def export_speaks(export_dir: str, speaker_embedding, smi: str) -> None:
    """The CLI's export loaded by ``from_pretrained`` (f32) on the card:
    the baked speaker row, then ``generate_custom_voice`` in the new voice,
    greedy, 8 frames, EOS banned."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(export_dir, talker_dtype=torch.float32)
    load_s = time.perf_counter() - t0
    model.tokenizer = ChatTemplateTokenizer()
    slot = model.cfg.talker.spk_id[0][1]
    row = model.talker_params["codec_embedding"][slot].cpu().numpy()
    if model.get_supported_speakers() != [TRAIN_SPEAKER] or not np.array_equal(
            row, np.asarray(speaker_embedding, np.float32)):
        fail(f"training: the export's speakers {model.get_supported_speakers()} or its "
             f"speaker row {slot} differ from what was baked in")
    frames = 8
    wavs, sr = model.generate_custom_voice(TEXTS[0], TRAIN_SPEAKER, "english",
                                           max_new_tokens=frames + 1, min_new_tokens=frames + 2,
                                           do_sample=False, subtalker_dosample=False)
    want = frames * model.cfg.codec.decode_upsample_rate
    wav = wavs[0]
    log(f"training export: loaded in {load_s:.1f} s, speakers {model.get_supported_speakers()} "
        f"(slot {slot} = the baked embedding), {frames} greedy frames -> {wav.shape[0]} samples "
        f"at {sr} Hz, max |wav| {np.abs(wav).max():.3f} | {smi}")
    if wav.shape != (want,) or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        fail(f"training: the export spoke {wav.shape} samples (want {want}), finite and in "
             f"[-1, 1]")


def vq_card_vs_cpu(smi: str, device: str = "cuda") -> None:
    """EMA VQ at the Whisper-VQ widths: VQ_STEPS steps (k-means init and
    expiry off) on the card, each held against the CPU's step from the
    card's state of the step before; then one step with k-means init and
    dead-code expiry on, on the card."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.training import vq
    from qwen_tts_tpu_torch.training.sft import step_mode

    cfg = vq.VQTrainConfig(dim=VQ_DIM, codebook_size=VQ_CODES, codebook_dim=VQ_CODE_DIM,
                           num_quantizers=1, kmeans_init=False, threshold_ema_dead_code=0.0)
    gen = torch.Generator().manual_seed(77)
    state_cpu = vq.init_vq_state(cfg, gen)
    params_cpu = vq.init_vq_params(cfg, gen)
    state = vq.VQState(*(t.to(device) for t in state_cpu))
    params = {k: v.to(device) for k, v in params_cpu.items()}
    card_gen = torch.Generator(device=device).manual_seed(0)
    equal = total = touched = 0
    gaps, buffer_err, walls = [], 0.0, []
    for i in range(VQ_STEPS):
        x_cpu = torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            (4, VQ_ROWS // 4, VQ_DIM)).astype(np.float32))
        before = vq.VQState(*(t.cpu() for t in state))
        x = x_cpu.to(device)
        _sync(device)
        t0 = time.perf_counter()
        with step_mode(torch.device(device)):
            state, out = vq.vq_train_step(state, params, x, card_gen, cfg=cfg)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        want_state, want = vq.vq_train_step(before, params_cpu, x_cpu, torch.Generator(),
                                            cfg=cfg)
        got_idx, want_idx = out.indices.cpu().reshape(-1), want.indices.reshape(-1)
        diff = torch.nonzero(got_idx != want_idx).reshape(-1)
        equal += int((got_idx == want_idx).sum())
        total += got_idx.numel()
        xp = x_cpu.reshape(-1, VQ_DIM) @ params_cpu["in_w"][0, 0] + params_cpu["in_b"][0, 0]
        emb = before.embed[0, 0]
        hit = torch.zeros(VQ_CODES, dtype=torch.bool)
        for r in diff.tolist():
            a, b = int(got_idx[r]), int(want_idx[r])
            da, db = ((xp[r] - emb[a]) ** 2).sum(), ((xp[r] - emb[b]) ** 2).sum()
            gaps.append(float((da - db).abs() / db))
            hit[a] = hit[b] = True
        touched += int(hit.sum())
        for name in ("cluster_size", "embed", "embed_avg"):
            g, w = getattr(state, name).cpu()[0, 0], getattr(want_state, name)[0, 0]
            keep = ~hit
            err = float((g[keep] - w[keep]).abs().max() / w[keep].abs().max())
            buffer_err = max(buffer_err, err)
    agreement = equal / total
    log(f"training VQ card vs CPU ({VQ_STEPS} steps, dim {VQ_DIM}, codebook {VQ_CODES} x "
        f"{VQ_CODE_DIM} behind a projection, {VQ_ROWS} rows a step, each step from the "
        f"card's state): codes agree {agreement:.5f} (min {VQ_AGREEMENT}), {len(gaps)} "
        f"disagreements with relative distance gaps {['%.2e' % g for g in gaps[:5]]} (near "
        f"tie {VQ_NEAR_TIE_REL}), buffers of the {VQ_CODES * VQ_STEPS - touched} untouched "
        f"code-steps within {buffer_err:.2e} of their largest value (tol {VQ_BUFFER_REL}); "
        f"card {_spread([w * 1e3 for w in walls], '{:.2f}')} ms a step | {smi}")
    if agreement < VQ_AGREEMENT or any(g > VQ_NEAR_TIE_REL for g in gaps) \
            or buffer_err > VQ_BUFFER_REL:
        fail("training: the VQ step on the card disagrees with the CPU's")

    cfg_init = dataclasses.replace(cfg, kmeans_init=True, threshold_ema_dead_code=2.0)
    fresh = vq.init_vq_state(cfg_init, device=device)
    x = torch.from_numpy(np.random.default_rng(200).standard_normal(
        (4, VQ_ROWS // 4, VQ_DIM)).astype(np.float32)).to(device)
    _sync(device)
    t0 = time.perf_counter()
    with step_mode(torch.device(device)):
        fresh, out = vq.vq_train_step(fresh, params, x, card_gen, cfg=cfg_init)
    _sync(device)
    init_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in fresh[1:]) and bool(fresh.inited.all())
    log(f"training VQ k-means init ({cfg_init.kmeans_iters} iterations over {VQ_ROWS} rows) "
        f"and dead-code expiry on the card: one step {init_s * 1e3:.1f} ms, buffers finite "
        f"and initialised: {finite}, {len(torch.unique(out.indices))} distinct codes | {smi}")
    if not finite:
        fail("training: the k-means-initialised VQ step left non-finite buffers")


def phase_training(base_dir: str, smi: str, device: str = "cuda") -> None:
    """Phase 15: training. The port's SFT entry at the flagship widths on
    the Base checkpoint (f32 master weights): one epoch of TRAIN_ROWS rows
    at batch TRAIN_BATCH, remat off (one step profiled) and on (losses
    agree, peak memory lower); the first run's train state restored at full
    width, and a full-width step timed with and without deterministic
    algorithms; at the talker cut to TRAIN_CUT_LAYERS layers, card against
    CPU (loss, terms, every gradient leaf, params after 2 steps) and resume
    bit for bit; the export loaded and speaking; the EMA VQ at the
    Whisper-VQ widths. No kernel of the port's is on the training path.
    ``device`` "cpu" rehearses the phase on the CPU (at widths the caller
    patches in)."""
    import torch

    from qwen_tts_tpu_torch.io.loader import load_checkpoint
    from qwen_tts_tpu_torch.training.checkpoint import load_train_state
    from qwen_tts_tpu_torch.training.data import collate, examples_from_jsonl
    from qwen_tts_tpu_torch.training.sft import make_optimizer

    work = tempfile.mkdtemp(prefix="qtts_train_", dir=os.path.dirname(os.path.abspath(base_dir)))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    try:
        with open(os.path.join(base_dir, "config.json")) as f:
            config = json.load(f)
        data = os.path.join(work, "train.jsonl")
        rows = training_rows(data, config, TRAIN_FRAMES, seed=15)
        out_plain, out_remat = os.path.join(work, "plain"), os.path.join(work, "remat")
        plain = run_sft_cli(base_dir, data, out_plain, False, device,
                            profile_step=TRAIN_ROWS // TRAIN_BATCH - 1)
        plain_s = log_sft_run("remat off", plain, smi)
        if plain["prof"] is not None and device != "cpu":
            prof_step = plain["steps"][-1]
            log_profile(plain["prof"], f"one full-width SFT step (batch {prof_step['shape']}, "
                        f"collate + step)", prof_step["s"] * 1e3, plain_s * 1e3, smi)

        # The snapshot restored at full width; a step timed with and
        # without determinism from it.
        cfg, talker, sub, _, _ = load_checkpoint(base_dir, talker_dtype=torch.float32,
                                                 device=device)
        optimizer = make_optimizer(5e-5, weight_decay=0.01)
        t0 = time.perf_counter()
        params, opt_state, meta = load_train_state(os.path.join(out_plain, "train_state"),
                                                   {"talker": talker, "subtalker": sub},
                                                   optimizer)
        _sync(device)
        load_s = time.perf_counter() - t0
        del talker, sub
        state_dir = os.path.join(out_plain, "train_state", meta["state_dir"])
        size = sum(os.path.getsize(os.path.join(state_dir, f)) for f in os.listdir(state_dir))
        n_params = sum(t.numel() for t in _leaves(params).values())
        log(f"training: train state at full width ({n_params / 1e9:.3f} B parameters, "
            f"{size / 2**30:.2f} GiB with the optimizer's moments) saved in "
            f"{plain['snapshot_s']:.1f} s, restored in {load_s:.1f} s (warm page cache) | {smi}")
        shutil.rmtree(os.path.join(out_plain, "train_state"))
        if device != "cpu":
            examples = examples_from_jsonl(data, None, None)
            batch = collate(examples[:TRAIN_BATCH], cfg, params["talker"], params["subtalker"])
            time_determinism(cfg.talker, params, opt_state, batch, smi)
        del params, opt_state

        remat = run_sft_cli(base_dir, data, out_remat, True, device)
        remat_s = log_sft_run("remat on", remat, smi)
        shutil.rmtree(out_remat)
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(remat["steps"], plain["steps"]))
        log(f"training SFT remat on against off: losses' largest relative difference "
            f"{loss_err:.2e} (tol {TRAIN_REMAT_LOSS_RTOL}); peak memory {remat['peak_gib']:.2f} "
            f"against {plain['peak_gib']:.2f} GiB; step {remat_s * 1e3:.1f} against "
            f"{plain_s * 1e3:.1f} ms | {smi}")
        if loss_err > TRAIN_REMAT_LOSS_RTOL:
            fail("training: remat changed the losses")
        if device != "cpu" and not remat["peak_gib"] < plain["peak_gib"]:
            fail("training: remat did not lower the peak memory")

        cut_cfg, cut = cut_training_params(base_dir, device)
        training_rows(os.path.join(work, "short.jsonl"), config, TRAIN_CPU_FRAMES, seed=16,
                      n=4 * TRAIN_BATCH)
        examples = examples_from_jsonl(os.path.join(work, "short.jsonl"), None, None)
        batches = [collate(examples[i : i + TRAIN_BATCH], cut_cfg, cut["talker"],
                           cut["subtalker"]) for i in range(0, len(examples), TRAIN_BATCH)]
        check_training_card_vs_cpu(cut_cfg, cut, batches, smi)
        check_resume(cut_cfg, cut, batches, os.path.join(work, "resume"), smi)
        del cut, batches

        export_speaks(os.path.join(out_plain, "checkpoint-epoch-0"),
                      rows[0]["speaker_embedding"], smi)
        vq_card_vs_cpu(smi, device)
        launches = {k: c.launches for k, c in counters.items()}
        log(f"training: launches of the port's kernels over the phase {launches} (the "
            f"export's speech only: no kernel of the port's is on the training path)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------------------
# Phase 16: parallelism
# --------------------------------------------------------------------------

PARALLEL_SEGMENT = 25          # the pipeline's segment (the JAX module's default)
PARALLEL_FRAMES = 51           # 25 + 25 + 1 generated: 50 emitted, three codec windows
PARALLEL_CONTEXT = 25
NCCL_FRAMES = 16               # the one-rank NCCL decode: B = 4 texts, greedy
DP_TP_FRAMES = 16              # the dp 2 x tp 2 decode: B = 4, f32, greedy
CHILD_TIMEOUT = 300            # seconds a child of phase 16 may run
# NCCL kernels a one-rank group launches for an in-place sum: none (NCCL
# leaves the buffer as it is; seen in phase 16's first run on an H100, where
# 215 all-reduces a frame were captured and the replay ran no NCCL kernel).
# Each all-reduce is one kernel at two ranks or more. A one-rank average is
# one kernel (NCCL multiplies by 1 / ranks), which (b)'s probe counts.
NCCL_ONE_RANK_KERNELS = 0
# The pipeline's whole waveform against ``decode_codes`` of all its codes:
# bf16 codec windows of another length than one decode of every frame
# (logged, not held: the chunks are held bit for bit against their windows).
# The SFT step-0 loss at dp 2 x tp 2 against one device: JAX's tolerance
# (tests/test_sft_script_e2e.py:111), set before the first run.
PARALLEL_LOSS_RTOL = 1e-5
# The VQ step at dp 2 against the full batch: buffers within this of their
# largest value (sums over the ranks in another order), set before the run.
PARALLEL_VQ_BUFFER_REL = 1e-5


# The tp serving engine (``continuous.ContinuousBatchingEngine`` on a tp
# group): 3 greedy requests (EOS banned) over 2 slots, so that the third is
# admitted into a freed slot, in segments of 2 frames. (c)'s ranks run two
# tp-2 engines at once, f32, one per dp shard, each on its own 3 texts; (b)'s
# child runs one on its one-rank NCCL group, bf16, through captured frames.
ENGINE_FRAMES = (3, 4, 3)
ENGINE_SLOTS, ENGINE_SEGMENT, ENGINE_CEILING, ENGINE_BUCKET = 2, 2, 16, 32


def engine_requests(dp_rank: int) -> list:
    """(text, speaker, frames) of a dp shard's engine."""
    return [(TEXTS[(dp_rank + k) % len(TEXTS)], ("aiden", "serena")[(dp_rank + k) % 2], frames)
            for k, frames in enumerate(ENGINE_FRAMES)]


def sharded_model(model, shards):
    """A ``Qwen3TTSModel`` on a rank's shards and config (``shard_params``),
    with ``model``'s whole codec and the smoke run's tokenizer."""
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    serve = Qwen3TTSModel(dataclasses.replace(model.cfg, talker=shards.cfg), shards.talker,
                          shards.subtalker, model.codec_params)
    serve.tokenizer = ChatTemplateTokenizer()
    return serve


def serve_engine(model, requests) -> dict:
    """The continuous engine on ``model`` (on a tp group: the leader takes
    ``requests``, a follower runs ``follow()``): every segment's codes as
    ``decode_segment`` returned them, the decode-attention launches, the
    wall; the leader also each request's codes as handed to the codec, in
    the order of ``requests``, and the frames generated; the captures."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import continuous
    from qwen_tts_tpu_torch.generate import GenerationParams
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention

    segments, codes = [], {}
    decode = continuous.decode_segment

    def recording(*args, **kwargs):
        out = decode(*args, **kwargs)
        segments.append(out[1])
        return out

    continuous.decode_segment = recording
    before = decode_attention.launches
    t0 = time.perf_counter()
    try:
        with counting_captures() as captures:
            engine = continuous.ContinuousBatchingEngine(
                model, num_slots=ENGINE_SLOTS, segment_frames=ENGINE_SEGMENT,
                max_new_tokens=ENGINE_CEILING, prefill_bucket=ENGINE_BUCKET, trailing_cap=256)
            out = {"leader": engine.is_leader}
            if engine.is_leader:
                finish = engine._finish_one

                def keep(req, got):
                    codes[id(req.future)] = np.concatenate(got).tolist()
                    return finish(req, got)

                engine._finish_one = keep
                engine.start()
                try:
                    futures = [engine.submit_prompt(
                        card_prompt_in(model, text, speaker, "english"),
                        GenerationParams(max_new_tokens=frames + 1, min_new_tokens=frames + 2,
                                         do_sample=False, subtalker_do_sample=False,
                                         repetition_penalty=1.0))
                        for text, speaker, frames in requests]
                    for f in futures:
                        f.result(timeout=CHILD_TIMEOUT)
                finally:
                    engine.stop()
                out.update(codes=[codes[id(f)] for f in futures],
                           frames=engine.stats["frames"])
            else:
                engine.follow()
            torch.cuda.synchronize()
    finally:
        continuous.decode_segment = decode
    out.update(segments=[s.cpu().tolist() for s in segments], captures=captures[0],
               launches=decode_attention.launches - before, wall=time.perf_counter() - t0)
    return out


def log_engine(what: str, res: dict, per_frame: int, smi: str) -> float:
    """Log an engine run of ``serve_engine``; its frames a second."""
    rate = res["frames"] / res["wall"]
    want = (len(res["segments"]) * ENGINE_SEGMENT + res["captures"]) * per_frame
    log(f"{what}: {len(ENGINE_FRAMES)} greedy requests of {list(ENGINE_FRAMES)} frames over "
        f"{ENGINE_SLOTS} slots, segments of {ENGINE_SEGMENT}: {res['frames']} frames in "
        f"{res['wall']:.2f} s ({rate:.2f} frames/s, the engine's construction and captures "
        f"included), {len(res['segments'])} segments, {res['captures']} capture(s), "
        f"decode-attention launches {res['launches']} (predicted {want} = (segments x "
        f"{ENGINE_SEGMENT} frames + one warm-up frame a capture) x {per_frame}) | {smi}")
    if res["launches"] != want:
        fail(f"{what}: decode attention did not launch as predicted")
    return rate


# The tp window engine (``serving.ServingEngine`` on a tp group): the
# continuous engine's three greedy requests, queued before ``start()`` so that
# they make one window (their budgets differ, their controls do not: EOS
# banned under the ceiling for all), padded to batch 4, at ENGINE_CEILING.
# Then every rank streams TP_STREAM_FRAMES greedy frames, B=1, f32.
WINDOW_WAIT_MS = 50
TP_STREAM_FRAMES = 8


def serve_windows(model, requests) -> dict:
    """The window engine on ``model`` (on a tp group: the leader queues
    ``requests`` before ``start()``, a follower runs ``follow()``): every
    window's budgets and codes as ``_decode_window`` returned them, the
    decode-attention launches, the captures, the wall; the leader also the
    frames generated and the windows run."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qwen_tts_tpu_torch.serving import ServingEngine

    windows = []
    before = decode_attention.launches
    t0 = time.perf_counter()
    with counting_captures() as captures:
        engine = ServingEngine(model, max_batch=4, max_wait_ms=WINDOW_WAIT_MS,
                               max_new_tokens=ENGINE_CEILING)
        decode_window = engine._decode_window

        def recording(prompts, params, limits, *args):
            codes, info = decode_window(prompts, params, limits, *args)
            windows.append([list(limits), [c.tolist() for c in codes]])
            return codes, info

        engine._decode_window = recording
        out = {"leader": engine.is_leader}
        if engine.is_leader:
            futures = [engine.submit_text(
                text, speaker, "english", max_new_tokens=frames + 1,
                min_new_tokens=ENGINE_CEILING + 1, do_sample=False, subtalker_dosample=False,
                repetition_penalty=1.0) for text, speaker, frames in requests]
            engine.start()
            try:
                for f in futures:
                    f.result(timeout=CHILD_TIMEOUT)
            finally:
                engine.stop()
            out.update(frames=engine.stats["frames"], batches=engine.stats["batches"])
        else:
            engine.follow()
        torch.cuda.synchronize()
    out.update(windows=windows, captures=captures[0],
               launches=decode_attention.launches - before, wall=time.perf_counter() - t0)
    return out


def stream_tp(model) -> dict:
    """A greedy B=1 ``stream_custom_voice`` of TP_STREAM_FRAMES frames (EOS
    banned, the budget-exhausted frame dropped) on ``model``, in the stream
    phase's chunks: the frames, the first-packet and whole walls, the audio
    seconds, the decode-attention launches and the first-packet graphs
    built."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch import pipeline as pipeline_mod
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention

    kw = dict(max_new_tokens=TP_STREAM_FRAMES + 1, min_new_tokens=TP_STREAM_FRAMES + 2,
              do_sample=False, subtalker_dosample=False, repetition_penalty=1.0)
    frames, built = [], []
    originals = _recording_segments(pipeline_mod, frames)
    graph = pipeline_mod._FirstPacketGraph
    pipeline_mod._FirstPacketGraph = lambda *a, **k: (built.append(1), graph(*a, **k))[1]
    before = decode_attention.launches
    try:
        first_s, wall, audio_s, chunks, _ = _stream_once(model, kw, TEXTS[0], "aiden",
                                                          "english")
        torch.cuda.synchronize()
    finally:
        pipeline_mod._first_packet_program, pipeline_mod.decode_segment = originals
        pipeline_mod._FirstPacketGraph = graph
    up = model.cfg.codec.decode_upsample_rate
    return {"codes": np.stack(frames)[:TP_STREAM_FRAMES].tolist(), "first_s": first_s,
            "wall": wall, "audio_s": audio_s, "chunks": [c.shape[0] // up for c in chunks],
            "finite": all(bool(np.isfinite(c).all()) for c in chunks),
            "launches": decode_attention.launches - before, "first_packet_graphs": len(built)}


def stream_launches(per_frame: int) -> int:
    """Decode-attention launches of ``stream_tp``'s stream run eagerly or
    replayed (no capture in it): the first packet's frames, then the frames
    its one later segment runs to the flag read after the last."""
    return (STREAM_FIRST + replays(STREAM_CHUNK, TP_STREAM_FRAMES + 1 - STREAM_FIRST)) * per_frame


def frame_collectives(cfg) -> int:
    """All-reduces a decode frame issues over its tp group, from the code:
    two a trunk layer (after o and after down) for every talker layer and
    every sub-talker position's layers, and one gather (an all-reduce of a
    zero-filled tensor) for each of the G - 1 sub-talker heads."""
    cp = cfg.code_predictor
    return (2 * (cfg.num_hidden_layers + cfg.num_code_groups * cp.num_hidden_layers)
            + cfg.num_code_groups - 1)


def _child_env() -> dict:
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def start_children(fn: str, world: int, work: str, **kwargs):
    """``fn`` (a function of this script) in ``world`` child processes, each
    a rank that rendezvouses through a file in ``work``; returns the
    processes. They import the port, load the kernels phase 2 built and
    build nothing."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "args.json"), "w") as f:
        json.dump(kwargs, f)
    code = ("import sys, chip_smoke as c; "
            "c.run_child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])")
    procs = []
    for r in range(world):
        # Output to a file, not a pipe: a rank blocked on a full pipe that is
        # not being read would hold up its group's collectives.
        with open(os.path.join(work, f"log{r}.txt"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, fn, str(r), str(world), work],
                stdout=out, stderr=subprocess.STDOUT, text=True, env=_child_env(),
                cwd=os.path.dirname(os.path.abspath(__file__))))
    return procs


def child_log(work: str, rank: int) -> str:
    """The last 4000 characters a child of phase 16 wrote."""
    with open(os.path.join(work, f"log{rank}.txt"), errors="replace") as f:
        return f.read()[-4000:]


def wait_children(procs, work: str, what: str, timeout: float = CHILD_TIMEOUT) -> list:
    """Every child's result (``out<rank>.json``); a child that fails or
    outlives ``timeout`` fails the phase (the others are killed)."""
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"{what}: rank {r} outlived {timeout} s:\n{child_log(work, r)}")
            if p.returncode != 0:
                fail(f"{what}: rank {r} exited {p.returncode}:\n{child_log(work, r)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(len(procs)):
        with open(os.path.join(work, f"out{r}.json")) as f:
            results.append(json.load(f))
    return results


def run_child(fn: str, rank: int, world: int, work: str) -> None:
    """A child of phase 16: ``fn(rank, world, work, **args)``, its result to
    ``out<rank>.json``."""
    with open(os.path.join(work, "args.json")) as f:
        kwargs = json.load(f)
    result = globals()[fn](rank, world, work, **kwargs)
    with open(os.path.join(work, f"out{rank}.json"), "w") as f:
        json.dump(result, f)


def _parallel_prompts(model, texts, speakers):
    from qwen_tts_tpu_torch.generate import batch_prompts

    model.tokenizer = ChatTemplateTokenizer()
    prompts = [card_prompt(model, t, s) for t, s in zip(texts, speakers)]
    embeds, mask, trailing, _ = batch_prompts(prompts)
    dtype = model.talker_params["norm"].dtype
    return embeds.to(dtype), mask, trailing.to(dtype)


def _greedy_banned(frames: int):
    from qwen_tts_tpu_torch.ops.sampling import SamplingConfig

    return (SamplingConfig(do_sample=False, repetition_penalty=1.0, min_new_tokens=frames + 1),
            SamplingConfig(do_sample=False))


def set_mark(marks: str, name: str) -> None:
    """Leave the mark ``name`` in ``marks`` (phase 16's order of card work)."""
    open(os.path.join(marks, name), "w").close()


def await_mark(marks: str, name: str, t0: float) -> None:
    """In a child of phase 16: wait for the mark ``name`` in ``marks``;
    raises CHILD_TIMEOUT seconds after ``t0``."""
    while not os.path.exists(os.path.join(marks, name)):
        if time.perf_counter() - t0 > CHILD_TIMEOUT:
            raise RuntimeError(f"no {name!r} mark after {CHILD_TIMEOUT} s")
        time.sleep(0.05)


def _profiled_kernels(decode) -> dict:
    """``decode()`` under torch.profiler: (device events it ran, by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def child_nccl(rank: int, world: int, work: str, model_dir: str, marks: str) -> dict:
    """Phase 16 (b): a one-rank NCCL group, tp 1, the bf16 path through the
    captured frames: the codes with and without the group, ms a frame with
    and without, then the kernels of a profiled replayed frame with the
    all-reduces as sums (the path's) and as averages (the probe), then the
    tp serving engine with and without the group. Loads after the mark
    "go", times its frames after "quiet" and leaves "timed" (see
    ``phase_parallel``)."""
    import torch
    import torch.distributed as dist

    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.generate import decode_segment, generate_codes, init_decode
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qwen_tts_tpu_torch.parallel import comm
    from qwen_tts_tpu_torch.parallel.mesh import make_mesh, shard_params
    from qwen_tts_tpu_torch.parallel.multihost import init_multihost
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    t0 = time.perf_counter()
    stamps = [("start", t0)]
    init_multihost(f"file://{work}/store", 1, 0)  # one rank, one card: NCCL by the rule
    backend = dist.get_backend()
    mesh = make_mesh(tp=1)
    stamps.append(("nccl init", time.perf_counter()))
    await_mark(marks, "go", t0)
    stamps.append(("wait for go", time.perf_counter()))
    model = Qwen3TTSModel.from_pretrained(model_dir, load_tokenizer=False)
    stamps.append(("load", time.perf_counter()))
    inputs = _parallel_prompts(model, TEXTS, ["aiden", "serena", "aiden", "serena"])
    shards = shard_params(mesh, model.talker_params, model.subtalker_params, model.cfg.talker)
    sampling, st_sampling = _greedy_banned(NCCL_FRAMES)
    runs = {"no group": (model.talker_params, model.subtalker_params, model.cfg.talker),
            "group": (shards.talker, shards.subtalker, shards.cfg)}

    def codes(name):
        t, s, c = runs[name]
        return generate_codes(t, s, c, *inputs, sampling=sampling, st_sampling=st_sampling,
                              max_new_tokens=NCCL_FRAMES, generator=None).codes

    def state_of(name):
        t, _, c = runs[name]
        return init_decode(t, c, inputs[0], inputs[1], sampling=sampling,
                           max_cache_len=inputs[0].shape[1] + NCCL_FRAMES, generator=None)

    def run_segment(name, state, frames):
        t, s, c = runs[name]
        decode_segment(t, s, c, state, inputs[2], sampling=sampling, st_sampling=st_sampling,
                       segment=frames, step_limit=NCCL_FRAMES)

    def segment_ms(name):
        state = state_of(name)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run_segment(name, state, NCCL_FRAMES)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / NCCL_FRAMES

    def profiled_frame(name):
        # The profiler of the card's machine has lost device events in a full
        # run; a profile that lacks one of the frame's decode-attention
        # launches (the count its wrapper adds at the replay) is taken again.
        for _ in range(3):
            state = state_of(name)
            torch.cuda.synchronize()
            before = decode_attention.launches
            kernels = _profiled_kernels(lambda: run_segment(name, state, 1))
            want = decode_attention.launches - before
            seen = sum(n for k, n in kernels.items() if "decode_attention_kernel" in k)
            if want > 0 and seen == want:
                return kernels
            retaken.append(f"{name}: {seen} of {want}")
        raise RuntimeError(f"no profile of three held the frame's {want} decode-attention "
                           f"launches")

    retaken = []  # the profiles taken again: decode-attention launches seen of those run
    calls = comm.all_reduce.calls
    got = {name: codes(name) for name in runs}  # the first call of each captures
    captured_calls = comm.all_reduce.calls - calls
    got2 = codes("group")
    stamps.append(("captures and runs", time.perf_counter()))
    await_mark(marks, "quiet", t0)
    stamps.append(("wait for quiet", time.perf_counter()))
    ms = {name: [] for name in runs}
    for i in range(6):
        name = ("no group", "group")[i % 2 if i < 2 or i >= 4 else 1 - i % 2]
        ms[name].append(segment_ms(name))
    stamps.append(("timings", time.perf_counter()))
    set_mark(marks, "timed")
    summed = profiled_frame("group")
    # The probe: the frame captured again with every all-reduce an average,
    # which on one rank multiplies by 1 (the same bits) and which NCCL runs
    # as a kernel, where a one-rank sum is none.
    sum_all_reduce = dist.all_reduce

    def averaged(tensor, group=None):  # comm.all_reduce's call
        return sum_all_reduce(tensor, op=dist.ReduceOp.AVG, group=group)

    graphs.clear()
    dist.all_reduce = averaged
    try:
        probe_codes = codes("group")
        averaged_kernels = profiled_frame("group")
    finally:
        dist.all_reduce = sum_all_reduce
    stamps.append(("profiles", time.perf_counter()))
    # The tp engine on the group, then on the unsharded model (beside the
    # four ranks' work: its frames a second are those of a shared card).
    serve = sharded_model(model, shards)
    engines = {"group": serve_engine(serve, engine_requests(0)),
               "no group": serve_engine(model, engine_requests(0))}
    stamps.append(("engines", time.perf_counter()))
    # A stream on the group and one without: each first packet is captured.
    streams = {"group": stream_tp(serve), "no group": stream_tp(model)}
    del serve
    stamps.append(("streams", time.perf_counter()))
    dist.destroy_process_group()
    return {"equal": bool(torch.equal(got["group"], got["no group"])),
            "repeat_equal": bool(torch.equal(got2, got["group"])),
            "probe_equal": bool(torch.equal(probe_codes, got["no group"])),
            "backend": str(backend), "codes_shape": list(got["group"].shape),
            "captured_calls": captured_calls, "summed": summed, "averaged": averaged_kernels,
            "retaken": retaken, "engines": engines, "streams": streams,
            "ms": ms, "seconds": {b[0]: round(b[1] - a[1], 2) for a, b in zip(stamps, stamps[1:])}}


def child_ranks(rank: int, world: int, work: str, model_dir: str, vq_seed: int, marks: str,
                sft_argv: list) -> dict:
    """Phase 16 (c) and (d) in one rank of dp 2 x tp 2 over gloo, the ranks
    sharing the card: f32 weights, B = 4, greedy, the frames run eagerly
    (gloo's collectives cannot be captured); the tp continuous engine, the
    tp window engine and a tp stream; one dp-2 VQ step at the
    Whisper-VQ widths on the dp group; then the SFT CLI's run
    (``sft_12hz.train`` on ``sft_argv``) on these ranks, as under a
    launcher. Loads after the mark "go", leaves "loaded<rank>" and decodes
    after "timed" (see ``phase_parallel``)."""
    import io

    import torch

    from qwen_tts_tpu_torch.generate import generate_codes
    from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qwen_tts_tpu_torch.parallel.mesh import make_mesh, mesh_place, shard_params, shard_rows
    from qwen_tts_tpu_torch.parallel.multihost import init_multihost
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
    from qwen_tts_tpu_torch.training import sft_12hz
    from qwen_tts_tpu_torch.training.sft import step_mode
    from qwen_tts_tpu_torch.training.vq import make_sharded_vq_train_step

    t0 = time.perf_counter()
    init_multihost(f"file://{work}/store", world, rank)  # 4 ranks, 1 card: gloo by the rule
    backend = torch.distributed.get_backend()
    await_mark(marks, "go", t0)
    t1 = time.perf_counter()
    mesh = make_mesh(tp=2)
    model = Qwen3TTSModel.from_pretrained(model_dir, talker_dtype=torch.float32,
                                          load_tokenizer=False)
    inputs = _parallel_prompts(model, TEXTS, ["aiden", "serena", "aiden", "serena"])
    shards = shard_params(mesh, model.talker_params, model.subtalker_params, model.cfg.talker)
    serve = sharded_model(model, shards)
    del model
    place = mesh_place(mesh)
    rows = [shard_rows(mesh, x) for x in inputs]
    sampling, st_sampling = _greedy_banned(DP_TP_FRAMES)
    decode_attention.launches = 0
    t_load = time.perf_counter()
    set_mark(marks, f"loaded{rank}")
    # ``step_mode`` (the VQ step's and (d)'s) imports torch._inductor's
    # config at its first call, ~10 s in four ranks at once: imported on a
    # thread while the rank waits for "timed" and decodes (waiting on gloo
    # for most of it).
    warm = threading.Thread(target=importlib.import_module, args=("torch._inductor.config",))
    warm.start()
    await_mark(marks, "timed", t0)
    t2 = time.perf_counter()
    out = generate_codes(shards.talker, shards.subtalker, shards.cfg, *rows, sampling=sampling,
                         st_sampling=st_sampling, max_new_tokens=DP_TP_FRAMES, generator=None)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t2
    launches = decode_attention.launches
    heads = [shards.cfg.num_attention_heads, shards.cfg.num_key_value_heads,
             shards.cfg.code_predictor.num_attention_heads,
             shards.cfg.code_predictor.num_key_value_heads]
    del shards, rows
    t_engine = time.perf_counter()
    engine = serve_engine(serve, engine_requests(place.dp_rank))
    t_windows = time.perf_counter()
    windows = serve_windows(serve, engine_requests(place.dp_rank))
    t_stream = time.perf_counter()
    stream = stream_tp(serve)
    engine_s = time.perf_counter() - t_engine
    del serve

    warm.join()
    cfg, state, params, x = vq_inputs(vq_seed)
    step = make_sharded_vq_train_step(place.dp_group, cfg)
    n = x.shape[0] // place.dp_size
    with step_mode(x.device):
        new, res = step(state, params, x[place.dp_rank * n:(place.dp_rank + 1) * n],
                        torch.Generator(device="cuda").manual_seed(vq_seed))
    torch.save({"state": [t.cpu() for t in new], "indices": res.indices.cpu()},
               os.path.join(work, f"vq{rank}.pt"))
    del state, params, x, new, res
    torch.cuda.empty_cache()

    t3 = time.perf_counter()
    vq_s = t3 - t2 - decode_s - engine_s
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = sft_12hz.train(sft_12hz.parse_args(sft_argv))
    sft_s = time.perf_counter() - t3
    torch.distributed.destroy_process_group()
    return {"codes": out.codes.cpu().tolist(), "launches": launches, "backend": str(backend),
            "heads": heads, "rank": rank, "dp_rank": place.dp_rank, "tp_rank": place.tp_rank,
            "wait_s": t1 - t0, "setup_s": t_load - t1, "wait_timed_s": t2 - t_load,
            "decode_s": decode_s, "vq_s": vq_s, "sft_rc": rc, "engine": engine,
            "engine_s": engine_s, "windows": windows, "windows_s": t_stream - t_windows,
            "stream": stream, "stream_s": t_engine + engine_s - t_stream,
            "sft_lines": printed.getvalue().splitlines(), "sft_s": sft_s,
            "end": time.time()}


def vq_inputs(seed: int, device: str = "cuda"):
    """The EMA VQ at the Whisper-VQ widths, uniform init from ``seed``, no
    dead-code expiry (a dp step replaces dead codes from rank 0's rows, the
    full batch from all of them): (cfg, state, projection params, input of
    VQ_ROWS rows as 2 x VQ_ROWS / 2)."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.training.vq import VQTrainConfig, init_vq_params, init_vq_state

    cfg = VQTrainConfig(dim=VQ_DIM, codebook_size=VQ_CODES, codebook_dim=VQ_CODE_DIM,
                        kmeans_init=False, threshold_ema_dead_code=0.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_vq_state(cfg, gen, device=device)
    params = init_vq_params(cfg, gen, device=device)
    x = np.random.default_rng(seed).standard_normal((2, VQ_ROWS // 2, VQ_DIM)).astype(np.float32)
    return cfg, state, params, torch.from_numpy(x).to(device)


def check_pipeline(model_dir: str, smi: str) -> int:
    """Phase 16 (a): ``TwoStagePipeline`` with both stages on cuda:0 (two
    streams), bf16 talker and codec, B = 1, greedy, EOS banned: its codes
    against ``generate_codes`` at the pipeline's prompt bucket (16) bit for
    bit, each chunk against its window's ``codec_decode`` alone on the
    default stream bit for bit, the vocoder block's launches, the wall
    beside the two stages' device times, the whole waveform against
    ``decode_codes``. Returns the vocoder block's launches."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.generate import GenerationParams, batch_prompts, generate_codes
    from qwen_tts_tpu_torch.models import codec as codec_mod
    from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block
    from qwen_tts_tpu_torch.parallel.pipeline import TwoStagePipeline
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    model.tokenizer = ChatTemplateTokenizer()
    prompt = card_prompt(model, TEXTS[0], "aiden")
    params = GenerationParams(max_new_tokens=PARALLEL_FRAMES,
                              min_new_tokens=PARALLEL_FRAMES + 1, do_sample=False,
                              subtalker_do_sample=False, repetition_penalty=1.0)
    pp = TwoStagePipeline(model, "cuda:0", "cuda:0", segment_frames=PARALLEL_SEGMENT)
    pp.synthesize(prompt, params)  # warm-up: the frame's capture
    torch.cuda.synchronize()
    vocoder_block.launches = 0
    t0 = time.perf_counter()
    chunks = list(pp.stream(prompt, params, left_context_frames=PARALLEL_CONTEXT))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = vocoder_block.launches
    codes = pp.codes
    up = model.cfg.codec.decode_upsample_rate
    dec_cfg = model.cfg.codec.decoder
    nq = dec_cfg.num_quantizers

    embeds, mask, trailing, _ = batch_prompts([prompt], bucket=16)
    dtype = model.talker_params["norm"].dtype
    ref = generate_codes(model.talker_params, model.subtalker_params, model.cfg.talker,
                         embeds.to(dtype), mask, trailing.to(dtype),
                         sampling=params.talker_sampling(),
                         st_sampling=params.subtalker_sampling(),
                         max_new_tokens=PARALLEL_FRAMES, generator=None)
    ref_codes = ref.codes[0, : int(ref.num_gen[0]), :nq].cpu().numpy()
    codes_equal = codes.shape == ref_codes.shape and bool((codes == ref_codes).all())

    sizes = [c.shape[0] // up for c in chunks]
    chunk_equal, emitted = [], 0
    for c, n in zip(chunks, sizes):
        ctx = min(PARALLEL_CONTEXT, emitted)
        window = np.zeros((1, PARALLEL_CONTEXT + PARALLEL_SEGMENT, nq), np.int64)
        window[0, : ctx + n] = codes[emitted - ctx: emitted + n]
        alone = codec_mod.codec_decode(pp.codec_params, dec_cfg,
                                       torch.as_tensor(window, device="cuda"))
        alone = alone[0, ctx * up:(ctx + n) * up].float().cpu().numpy()
        chunk_equal.append(bool(np.array_equal(alone, c)))
        emitted += n
    whole = np.concatenate(chunks)
    want = model.decode_codes([codes])[0]
    rel = float(np.linalg.norm(whole - want) / max(np.linalg.norm(want), 1e-30))
    ms = {k: sum(v) for k, v in pp.stage_ms.items()}
    serial = ms["prefill"] + ms["talker"] + ms["codec"]
    log(f"parallel pipeline: B=1, {len(chunks)} chunks of {sizes} frames ({whole.shape[0]} "
        f"samples), segments of {PARALLEL_SEGMENT}, left context {PARALLEL_CONTEXT}; codes "
        f"{codes.shape} {'equal' if codes_equal else 'differ from'} generate_codes at prompt "
        f"bucket 16 {ref_codes.shape}; chunks bit-equal to their windows' codec_decode alone "
        f"{chunk_equal}; vocoder_block launches {launches} (predicted {2 * len(chunks)}: 2 a "
        f"window); wall {wall_ms:.2f} ms against the stages' device time (events): prefill "
        f"{ms['prefill']:.2f} ms, talker {ms['talker']:.2f} ms "
        f"({[round(v, 2) for v in pp.stage_ms['talker']]}), codec {ms['codec']:.2f} ms "
        f"({[round(v, 2) for v in pp.stage_ms['codec']]}); in series {serial:.2f} ms, the codec "
        f"hidden behind the talker {(serial - wall_ms) / max(ms['codec'], 1e-9):.3f} of its time "
        f"(1 = all of it; the wall also holds host time); whole waveform against decode_codes "
        f"of all the codes: relative L2 {rel:.3g} | {smi}")
    if not codes_equal:
        fail("parallel pipeline: codes differ from one device's")
    if not all(chunk_equal):
        fail("parallel pipeline: a chunk differs from its window's codec_decode alone")
    if launches != 2 * len(chunks) or sum(sizes) != PARALLEL_FRAMES - 1:
        fail(f"parallel pipeline: {launches} vocoder launches for {len(chunks)} windows, "
             f"{sum(sizes)} frames emitted of {PARALLEL_FRAMES} requested")
    if not np.isfinite(whole).all():
        fail("parallel pipeline: the waveform is not finite")
    del model, pp
    return launches


def start_nccl(model_dir: str, marks: str):
    """Phase 16 (b)'s child, started: (processes, directory, start time)."""
    work = tempfile.mkdtemp(prefix="qtts_nccl_")
    procs = start_children("child_nccl", 1, work, model_dir=model_dir, marks=marks)
    return procs, work, time.perf_counter()


def wait_for_marks(procs, marks: str, names, timeout: float = CHILD_TIMEOUT) -> bool:
    """Wait until ``procs`` leave the marks ``names``; False as soon as one
    of them exits first (waiting for its result then says how)."""
    t0 = time.perf_counter()
    while not all(os.path.exists(os.path.join(marks, n)) for n in names):
        if any(p.poll() is not None for p in procs):
            return False
        if time.perf_counter() - t0 > timeout:
            fail(f"parallel: no marks {names} after {timeout} s")
        time.sleep(0.05)
    return True


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def check_nccl_one_rank(model_dir: str, child, smi: str) -> None:
    """Phase 16 (b): the child of ``start_nccl`` (a process group lives as
    long as its process)."""
    import json as _json

    from qwen_tts_tpu_torch.config import TTSConfig

    procs, work, t0 = child
    try:
        (res,) = wait_children(procs, work, "parallel NCCL")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = TTSConfig.from_dict(_json.load(f)).talker
    per_frame = frame_collectives(cfg)
    # The group's first run: the prefill's all-reduces (2 a talker layer,
    # eager), then the frame's warm-up run and its capture.
    captured = (res["captured_calls"] - 2 * cfg.num_hidden_layers) / 2
    summed, averaged = res["summed"], res["averaged"]
    nccl = {k[:60]: n for k, n in summed.items() if "nccl" in k.lower()}
    added = sum(averaged.values()) - sum(summed.values())
    new = {}
    for k in sorted(set(summed) | set(averaged)):
        if averaged.get(k, 0) != summed.get(k, 0):
            new[k[:90]] = new.get(k[:90], 0) + averaged.get(k, 0) - summed.get(k, 0)
    ms = {k: statistics.median(v) for k, v in res["ms"].items()}
    log(f"parallel NCCL, one rank ({res['backend']}), tp 1, bf16, B=4, {NCCL_FRAMES} greedy "
        f"frames through the captured frames: codes with the group "
        f"{'equal' if res['equal'] else 'differ from'} the run with none (shape "
        f"{res['codes_shape']}), a second run equal {res['repeat_equal']}; all-reduces a frame "
        f"from the code {per_frame} (2 x ({cfg.num_hidden_layers} talker layers + "
        f"{cfg.num_code_groups} x {cfg.code_predictor.num_hidden_layers} sub-talker layers) + "
        f"{cfg.num_code_groups - 1} head gathers), issued while the frame was captured "
        f"{captured:g}; a profiled replayed frame: NCCL kernels with the path's sums {nccl} "
        f"(predicted {NCCL_ONE_RANK_KERNELS}: NCCL runs a one-rank in-place sum as no kernel), "
        f"the frame captured again with averages (the same bits: codes equal "
        f"{res['probe_equal']}) ran {added} device events more (predicted {per_frame}, one a "
        f"collective), by name {new} (profiles taken again for lost events: "
        f"{res['retaken'] or 'none'}); replayed ms a frame (events, medians of 3) with the group "
        f"{ms['group']:.3f} ({res['ms']['group']}), without {ms['no group']:.3f} "
        f"({res['ms']['no group']}): the collectives cost {ms['group'] - ms['no group']:.3f} ms "
        f"a frame; child {time.perf_counter() - t0:.1f} s (after its imports: "
        f"{res['seconds']}) | {smi}")
    if not (res["equal"] and res["repeat_equal"] and res["probe_equal"]):
        fail("parallel NCCL: the codes with a one-rank group differ from the run with none")
    if captured != per_frame:
        fail(f"parallel NCCL: the captured frame issued {captured} all-reduces, the code "
             f"{per_frame}")
    if sum(nccl.values()) != NCCL_ONE_RANK_KERNELS:
        fail(f"parallel NCCL: {nccl} NCCL kernels in a frame of sums, "
             f"{NCCL_ONE_RANK_KERNELS} predicted for one rank")
    if added != per_frame:
        fail(f"parallel NCCL: the frame of averages ran {added} device events more than the "
             f"frame of sums, {per_frame} collectives captured in it")
    engines = res["engines"]
    launches_per_frame = (cfg.num_hidden_layers
                          + cfg.num_code_groups * cfg.code_predictor.num_hidden_layers)
    for name in ("group", "no group"):
        log_engine(f"parallel NCCL engine [{name}] (beside (c)'s ranks)", engines[name],
                   launches_per_frame, smi)
    equal = engines["group"]["codes"] == engines["no group"]["codes"]
    log(f"parallel NCCL engine: the engine on the one-rank NCCL group (its own leader, no "
        f"followers, bf16, captured frames) gives the unsharded engine's codes: {equal} "
        f"({[len(c) for c in engines['group']['codes']]} frames)")
    if not equal or not all(len(c) == f for c, f in zip(engines["group"]["codes"],
                                                        ENGINE_FRAMES)):
        fail("parallel NCCL engine: its codes differ from the unsharded engine's")
    streams = res["streams"]
    equal = streams["group"]["codes"] == streams["no group"]["codes"]
    log(f"parallel NCCL stream: B=1, bf16, {TP_STREAM_FRAMES} greedy frames in chunks of "
        f"{streams['group']['chunks']}, on the one-rank NCCL group against none: first-packet "
        f"graphs built {streams['group']['first_packet_graphs']} and "
        f"{streams['no group']['first_packet_graphs']} (a capturable group keeps the captured "
        f"first packet), codes equal {equal}; first packet (its capture included) "
        f"{streams['group']['first_s'] * 1e3:.1f} and {streams['no group']['first_s'] * 1e3:.1f}"
        f" ms | {smi}")
    if not equal or [streams[k]["first_packet_graphs"] for k in streams] != [1, 1]:
        fail("parallel NCCL stream: the group's stream differs from the unsharded one's or "
             "its first packet was not captured")


def _batch_margin(model, inputs, frames, row, frame, group):
    """The unsharded run's top-two margin and largest |logit| of ``row`` at
    (frame, group), from an eager run that records every sampling call."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch.models import subtalker as st_mod

    calls = []
    originals = (gen_mod.sample_token, st_mod.sample_token)

    def recording(logits, cfg, generator, race=None, _orig=originals[0]):
        calls.append(logits[row].float().cpu())
        return _orig(logits, cfg, generator, race)

    gen_mod.sample_token = st_mod.sample_token = recording
    sampling, st_sampling = _greedy_banned(frames)
    try:
        with eager_decode():
            gen_mod.generate_codes(model.talker_params, model.subtalker_params,
                                   model.cfg.talker, *inputs, sampling=sampling,
                                   st_sampling=st_sampling, max_new_tokens=frames,
                                   generator=None)
    finally:
        gen_mod.sample_token, st_mod.sample_token = originals
    lg = calls[frame * model.cfg.talker.num_code_groups + group]
    top2 = torch.topk(lg, 2).values
    return (top2[0] - top2[1]).item(), lg[lg > -1e8].abs().max().item()


DP_TP_VQ_SEED = 23


def sft_inputs(base_dir: str) -> dict:
    """Phase 16 (d)'s inputs, in a directory of their own: the Base
    checkpoint with its talker cut to TRAIN_CUT_LAYERS layers, TRAIN_BATCH
    rows of training data, the SFT CLI's arguments for one step of them at
    ``--dp 2 --tp 2``."""
    work = tempfile.mkdtemp(prefix="qtts_psft_", dir=os.path.dirname(os.path.abspath(base_dir)))
    cut = os.path.join(work, "cut")
    cut_checkpoint(base_dir, cut, TRAIN_CUT_LAYERS)
    with open(os.path.join(cut, "config.json")) as f:
        config = json.load(f)
    data = os.path.join(work, "train.jsonl")
    training_rows(data, config, TRAIN_CPU_FRAMES, seed=17, n=TRAIN_BATCH)
    argv = ["--model-path", cut, "--data", data, "--output-model-path",
            os.path.join(work, "mesh"), "--speaker-name", TRAIN_SPEAKER, "--num-epochs", "1",
            "--batch-size", str(TRAIN_BATCH), "--dp", "2", "--tp", "2"]
    return {"work": work, "cut": cut, "data": data, "argv": argv}


def start_ranks(model_dir: str, sft: dict, marks: str):
    """Phase 16 (c) and (d)'s four ranks, started: (processes, their
    directory, the start time by ``time.time``)."""
    work = tempfile.mkdtemp(prefix="qtts_ranks_")
    procs = start_children("child_ranks", 4, work, model_dir=model_dir, vq_seed=DP_TP_VQ_SEED,
                           marks=marks, sft_argv=sft["argv"])
    return procs, work, time.time()


def dp_tp_reference(model_dir: str) -> dict:
    """Phase 16 (c)'s side on this process: the unsharded f32 run, the
    continuous and window engines and the stream, and the full-batch VQ
    step."""
    import torch

    from qwen_tts_tpu_torch.generate import generate_codes
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
    from qwen_tts_tpu_torch.training.sft import step_mode
    from qwen_tts_tpu_torch.training.vq import vq_train_step

    model = Qwen3TTSModel.from_pretrained(model_dir, talker_dtype=torch.float32,
                                          load_tokenizer=False)
    inputs = _parallel_prompts(model, TEXTS, ["aiden", "serena", "aiden", "serena"])
    sampling, st_sampling = _greedy_banned(DP_TP_FRAMES)
    ref = generate_codes(model.talker_params, model.subtalker_params, model.cfg.talker,
                         *inputs, sampling=sampling, st_sampling=st_sampling,
                         max_new_tokens=DP_TP_FRAMES, generator=None)
    t0 = time.perf_counter()
    engines = [serve_engine(model, engine_requests(d)) for d in range(2)]
    windows = [serve_windows(model, engine_requests(d)) for d in range(2)]
    streams = [stream_tp(model) for _ in range(2)]  # the first captures
    engines_s = time.perf_counter() - t0
    cfg, state, params, x = vq_inputs(DP_TP_VQ_SEED)
    with step_mode(x.device):
        vq_state, vq = vq_train_step(
            state, params, x, torch.Generator(device="cuda").manual_seed(DP_TP_VQ_SEED), cfg=cfg)
    return {"model": model, "inputs": inputs, "codes": ref.codes.cpu().numpy(),
            "vq_state": vq_state, "vq_indices": vq.indices.cpu(), "engines": engines,
            "windows": windows, "streams": streams, "engines_s": engines_s}


def check_dp_tp(ref: dict, res: list, work: str, wall: float, smi: str) -> int:
    """Phase 16 (c): the ranks' codes against the unsharded f32 run, their
    decode-attention launches, the dp-2 VQ step against the full batch.
    Returns the decode attention's launches on a rank."""
    import numpy as np
    import torch

    model = ref["model"]
    tk = model.cfg.talker
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    by_dp = {}
    for r in res:
        by_dp.setdefault(r["dp_rank"], []).append(np.asarray(r["codes"]))
    for dp_rank, rows in by_dp.items():
        if not all(np.array_equal(rows[0], other) for other in rows[1:]):
            fail(f"parallel dp x tp: the tp ranks of dp shard {dp_rank} decoded different codes")
    got, ref_codes = np.concatenate([by_dp[0][0], by_dp[1][0]]), ref["codes"]
    ties = []
    if not np.array_equal(got, ref_codes):
        for row in range(got.shape[0]):
            diff = np.argwhere(got[row] != ref_codes[row])
            if len(diff) == 0:
                continue
            f, g = (int(v) for v in diff[0])
            margin, scale = _batch_margin(model, ref["inputs"], DP_TP_FRAMES, row, f, g)
            ties.append((row, f, g, round(margin, 6), round(scale, 3)))
            if not margin <= SERVING_NEAR_TIE * scale:
                fail(f"parallel dp x tp: row {row} first differs from the unsharded run at "
                     f"frame {f}, group {g}, not a near tie (margin {margin:.4g}, limit "
                     f"{SERVING_NEAR_TIE} x {scale:.4g})")
    launches = [r["launches"] for r in res]
    heads = res[0]["heads"]
    log(f"parallel dp 2 x tp 2 over {res[0]['backend']}, 4 ranks sharing the card, f32, B=4, "
        f"{DP_TP_FRAMES} greedy frames (eager: gloo's collectives cannot be captured): rank "
        f"heads talker H{heads[0]}/KV{heads[1]}, sub-talker H{heads[2]}/KV{heads[3]}; codes "
        f"equal on every rank of a dp shard; against the unsharded f32 card run "
        f"{'equal' if not ties else f'first apart at near ties (row, frame, group, margin, max|logit|) {ties}'}; "
        f"decode-attention launches per rank {launches} (predicted {DP_TP_FRAMES * per_frame} = "
        f"{DP_TP_FRAMES} frames x {per_frame}); a rank's seconds after its imports: to the "
        f"mark 'go' {[round(r['wait_s'], 1) for r in res]}, load and shard "
        f"{[round(r['setup_s'], 1) for r in res]}, to the mark 'timed' "
        f"{[round(r['wait_timed_s'], 1) for r in res]}, decode "
        f"{[round(r['decode_s'], 2) for r in res]}, VQ step {[round(r['vq_s'], 1) for r in res]}, "
        f"(d) {[round(r['sft_s'], 1) for r in res]}; the ranks' wall (start to the last "
        f"one's result) {wall:.1f} s | {smi}")
    if launches != [DP_TP_FRAMES * per_frame] * 4:
        fail("parallel dp x tp: decode attention did not launch as predicted on every rank")

    # The dp-2 VQ step: dp shard r's rows are rows [r * n, (r + 1) * n).
    vq = [torch.load(os.path.join(work, f"vq{r}.pt")) for r in range(4)]
    idx = torch.cat([vq[0]["indices"], vq[2]["indices"]], dim=2)
    want = ref["vq_indices"]
    agree = float((idx == want).float().mean())
    worst = 0.0
    for name, a in zip(("inited", "cluster_size", "embed", "embed_avg"), vq[0]["state"]):
        b = getattr(ref["vq_state"], name).cpu()
        if name == "inited":
            continue
        worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))
    same_ranks = all(torch.equal(a, b) for r in (1, 2, 3)
                     for a, b in zip(vq[0]["state"], vq[r]["state"]))
    log(f"parallel VQ dp 2 (the dp group of the dp x tp mesh) at the Whisper-VQ widths "
        f"({VQ_ROWS} rows of {VQ_DIM}, {VQ_CODES} x {VQ_CODE_DIM} codebook): codes agree with "
        f"the full-batch step at {agree:.6f}; buffers' largest difference {worst:.3g} of their "
        f"largest value (tol {PARALLEL_VQ_BUFFER_REL}); every rank's buffers the same "
        f"{same_ranks} | {smi}")
    if agree != 1.0 or not worst <= PARALLEL_VQ_BUFFER_REL or not same_ranks:
        fail("parallel VQ: the dp step differs from the full-batch step")
    return launches[0]


def _first_apart(model, got, want, text, speaker, frames, what: str) -> list:
    """[] if the codes ``got`` equal ``want``, else where they first part
    (frame, group, margin, max|logit|) when that is a near tie of the
    unsharded run (``_batch_margin``, as ``check_tp_engines`` holds it);
    fails otherwise."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        fail(f"{what}: codes {got.shape}, the unsharded run's {want.shape}")
    if np.array_equal(got, want):
        return []
    f, g = (int(v) for v in np.argwhere(got != want)[0])
    margin, scale = _batch_margin(model, _parallel_prompts(model, [text], [speaker]), frames,
                                  0, f, g)
    if not margin <= SERVING_NEAR_TIE * scale:
        fail(f"{what}: first differs from the unsharded run at frame {f}, group {g}, not a "
             f"near tie (margin {margin:.4g}, limit {SERVING_NEAR_TIE} x {scale:.4g})")
    return [(f, g, round(margin, 6), round(scale, 3))]


def check_tp_engines(ref: dict, res: list, smi: str) -> None:
    """Phase 16 (c)'s tp engines: each dp shard's leader (tp rank 0) against
    the unsharded f32 engine on this process at the same settings (equal,
    or first apart at a near tie as in ``check_dp_tp``), each follower's
    segments against its leader's."""
    import numpy as np

    model = ref["model"]
    tk = model.cfg.talker
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    for d, want in enumerate(ref["engines"]):
        log_engine(f"parallel engine unsharded f32 (dp shard {d}'s requests)", want, per_frame,
                   smi)
    for r in res:
        r["engine"]["rank"] = r["dp_rank"], r["tp_rank"]
    for d in range(2):
        leader, follower = (next(r["engine"] for r in res
                                 if r["dp_rank"] == d and r["tp_rank"] == t) for t in (0, 1))
        want = ref["engines"][d]
        rate = log_engine(f"parallel tp engine, dp shard {d}, tp 2 over gloo (leader)", leader,
                          per_frame, smi)
        ties = []
        for k, ((text, speaker, frames), got, exp) in enumerate(zip(
                engine_requests(d), leader["codes"], want["codes"])):
            if np.shape(got) != (frames, tk.num_code_groups):
                fail(f"parallel tp engine: dp shard {d}'s request {k} gave codes "
                     f"{np.shape(got)}")
            ties += [(k,) + t for t in _first_apart(
                model, got, exp, text, speaker, frames + 1,
                f"parallel tp engine: dp shard {d}'s request {k}")]
        same = follower["segments"] == leader["segments"]
        log(f"parallel tp engine, dp shard {d}: the leader's codes against the unsharded "
            f"engine's {'equal' if not ties else f'first apart at near ties (request, frame, group, margin, max|logit|) {ties}'}; "
            f"the follower's {len(follower['segments'])} segments equal the leader's "
            f"{len(leader['segments'])}: {same}; follower launches {follower['launches']}, "
            f"wall {follower['wall']:.2f} s; leader {rate:.2f} frames/s beside the other "
            f"dp shard's engine | {smi}")
        if not same or follower["launches"] != leader["launches"]:
            fail(f"parallel tp engine: dp shard {d}'s follower ran other segments than its "
                 f"leader")
    log(f"parallel tp engines: the ranks' engine seconds {[round(r['engine_s'], 1) for r in res]}"
        f"; the unsharded reference engines {ref['engines_s']:.1f} s | {smi}")


def check_tp_windows(ref: dict, res: list, smi: str) -> None:
    """Phase 16 (c)'s tp window engines and tp streams. Each dp shard's
    leader against the unsharded f32 window engine on this process (one
    window of the three requests; codes equal, or first apart at a near
    tie), its follower's windows and decode-attention launches against the
    leader's; every rank's stream against the unsharded stream (the second,
    warm one), its launches against the chunk schedule, its first packet
    eager (no graph under gloo)."""
    model = ref["model"]
    tk = model.cfg.talker
    per_frame = tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers
    frames_run = replays(ENGINE_CEILING, max(ENGINE_FRAMES) + 1)
    limits = [f + 1 for f in ENGINE_FRAMES]
    for d in range(2):
        want = ref["windows"][d]
        leader, follower = (next(r["windows"] for r in res
                                 if r["dp_rank"] == d and r["tp_rank"] == t) for t in (0, 1))
        ties = []
        for k, (text, speaker, frames) in enumerate(engine_requests(d)):
            ties += [(k,) + t for t in _first_apart(
                model, leader["windows"][0][1][k], want["windows"][0][1][k], text, speaker,
                frames + 1, f"parallel tp window engine, dp shard {d}'s request {k}")]
        rate, ref_rate = leader["frames"] / leader["wall"], want["frames"] / want["wall"]
        log(f"parallel tp window engine, dp shard {d}, tp 2 over gloo: {len(ENGINE_FRAMES)} "
            f"greedy requests of {list(ENGINE_FRAMES)} frames in {len(leader['windows'])} "
            f"window(s) of budgets {[w[0] for w in leader['windows']]} (batch padded to 4, "
            f"ceiling {ENGINE_CEILING}): the leader's codes against the unsharded window "
            f"engine's {'equal' if not ties else f'first apart at near ties (request, frame, group, margin, max|logit|) {ties}'}; "
            f"the follower's windows equal the leader's {follower['windows'] == leader['windows']}"
            f"; decode-attention launches leader {leader['launches']}, follower "
            f"{follower['launches']} (predicted {frames_run * per_frame} = {frames_run} frames "
            f"x {per_frame}), unsharded {want['launches']} (+{want['captures']} capture(s)' "
            f"warm-up frame); {leader['frames']} frames in {leader['wall']:.2f} s, "
            f"{rate:.2f} frames/s a leader beside the other dp shard's engine (the engine's "
            f"construction included), unsharded window engine {want['frames']} frames in "
            f"{want['wall']:.2f} s, {ref_rate:.2f} frames/s | {smi}")
        if [w[0] for w in leader["windows"]] != [limits] or leader["batches"] != 1:
            fail(f"parallel tp window engine: dp shard {d}'s requests ran in windows "
                 f"{[w[0] for w in leader['windows']]}, not one of {limits}")
        if (follower["windows"] != leader["windows"]
                or not follower["launches"] == leader["launches"] == frames_run * per_frame
                or want["launches"] != (frames_run + want["captures"]) * per_frame):
            fail(f"parallel tp window engine: dp shard {d}'s follower ran other windows or "
                 f"launches than its leader, or the launches are not the predicted ones")
    warm = ref["streams"][1]
    for r in res:
        st = r["stream"]
        ties = _first_apart(model, st["codes"], warm["codes"], TEXTS[0], "aiden",
                            TP_STREAM_FRAMES + 1, f"parallel tp stream, rank {r['rank']}")
        log(f"parallel tp stream, rank {r['rank']} (dp {r['dp_rank']}, tp {r['tp_rank']}), "
            f"f32, B=1, {TP_STREAM_FRAMES} greedy frames in chunks of {st['chunks']}, eager "
            f"over gloo: codes against the unsharded stream "
            f"{'equal' if not ties else f'first apart at a near tie (frame, group, margin, max|logit|) {ties}'}; "
            f"first-packet graphs built {st['first_packet_graphs']}; first packet "
            f"{st['first_s'] * 1e3:.1f} ms, wall {st['wall']:.2f} s, stream RTF(audio/wall) "
            f"{st['audio_s'] / st['wall']:.4f}, decode-attention launches {st['launches']} "
            f"(predicted {stream_launches(per_frame)}); the rank's window engine "
            f"{r['windows_s']:.1f} s and stream {r['stream_s']:.1f} s | {smi}")
        if (st["first_packet_graphs"] != 0 or not st["finite"]
                or st["chunks"] != [STREAM_FIRST, TP_STREAM_FRAMES - STREAM_FIRST]
                or st["launches"] != stream_launches(per_frame)):
            fail(f"parallel tp stream: rank {r['rank']} built a first-packet graph, gave "
                 f"samples that are not finite, chunks of {st['chunks']} frames or "
                 f"{st['launches']} launches")
    first = ref["streams"][0]
    log(f"parallel stream unsharded f32, B=1, {TP_STREAM_FRAMES} greedy frames: captured first "
        f"packet (graphs built {first['first_packet_graphs']}, then "
        f"{warm['first_packet_graphs']}); warm: first packet {warm['first_s'] * 1e3:.1f} ms, "
        f"wall {warm['wall']:.3f} s, stream RTF(audio/wall) {warm['audio_s'] / warm['wall']:.3f}"
        f", decode-attention launches {warm['launches']} (predicted "
        f"{stream_launches(per_frame)}); first (capturing) {first['first_s'] * 1e3:.1f} ms "
        f"beside the ranks | {smi}")
    if (first["first_packet_graphs"], warm["first_packet_graphs"]) != (1, 0) or (
            warm["launches"] != stream_launches(per_frame)):
        fail("parallel stream unsharded: its first packet was not captured once, or the warm "
             "stream's launches are not the predicted ones")


def cut_checkpoint(base_dir: str, cut_dir: str, layers: int) -> None:
    """``base_dir`` with its talker cut to ``layers`` layers: links to its
    files, the config patched (the loader reads the layers the config
    names)."""
    os.makedirs(cut_dir)
    for name in os.listdir(base_dir):
        if name != "config.json":
            os.symlink(os.path.realpath(os.path.join(base_dir, name)),
                       os.path.join(cut_dir, name))
    with open(os.path.join(base_dir, "config.json")) as f:
        config = json.load(f)
    config["talker_config"]["num_hidden_layers"] = layers
    with open(os.path.join(cut_dir, "config.json"), "w") as f:
        json.dump(config, f)


def parallel_sft_reference(run: dict) -> None:
    """Phase 16 (d)'s one-device side, into ``run``: the CLI's first step
    on one device (load, collate, step; its lr and decay), the names,
    shapes and dtypes of its train state, its params after the step."""
    import torch

    from qwen_tts_tpu_torch.io.loader import load_checkpoint
    from qwen_tts_tpu_torch.training.checkpoint import flatten
    from qwen_tts_tpu_torch.training.data import collate, examples_from_jsonl
    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step

    t0 = time.perf_counter()
    cfg, talker, sub, _, _ = load_checkpoint(run["cut"], talker_dtype=torch.float32,
                                             device="cuda")
    params = {"talker": talker, "subtalker": sub}
    optimizer = make_optimizer(5e-5, weight_decay=0.01)
    opt_state = optimizer.init(params)
    batch = collate(examples_from_jsonl(run["data"], None, None), cfg, talker, sub)
    params, opt_state, loss, _ = make_train_step(cfg.talker, optimizer)(params, opt_state,
                                                                         batch)
    run["ref"] = float(loss)
    run["want"] = {name: {k: (tuple(v.shape), v.dtype) for k, v in flatten(tree).items()}
                   for name, tree in (("params", params), ("opt_state", opt_state))}
    run["mine"] = {k: v.cpu() for k, v in flatten(params).items()}
    run["solo_s"] = time.perf_counter() - t0


def check_parallel_sft(run: dict, res: list, smi: str) -> None:
    """Phase 16 (d): the ranks' SFT run against ``parallel_sft_reference``:
    the step-0 loss, the snapshot's names, shapes and dtypes, its params."""
    from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile

    ref, want, mine = run["ref"], run["want"], run["mine"]
    lines = res[0]["sft_lines"]
    if any(r["sft_rc"] for r in res):
        fail(f"parallel SFT: the --dp 2 --tp 2 run returned {[r['sft_rc'] for r in res]}:\n"
             + "\n".join(lines[-20:]))
    mesh_line = next((l for l in lines if l.startswith("mesh:")), None)
    step0 = next((l for l in lines if "step 0 |" in l), None)
    if mesh_line is None or "mesh: dp=2 tp=2 over 4 devices" not in mesh_line or step0 is None:
        fail(f"parallel SFT: no mesh line or no step-0 line in rank 0's lines {lines}")
    got = float(step0.split("loss")[1].split("(")[0])
    diffs = []
    for name in ("params", "opt_state"):
        st = SafeTensorsFile(os.path.join(run["work"], "mesh", "train_state", "state.step1",
                                          name + ".safetensors"))
        try:
            have = {k: (tuple(st.get(k).shape), st.get(k).dtype) for k in st.keys()}
            if have != want[name]:
                fail(f"parallel SFT: the snapshot's {name} differ from one device's in "
                     f"names, shapes or dtypes: "
                     f"{sorted(set(have.items()) ^ set(want[name].items()))[:4]}")
            if name == "params":
                for k in st.keys():
                    a, b = st.get(k).float(), mine[k].float()
                    diffs.append((float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)),
                                  k))
        finally:
            st.close()
    worst = max(diffs)
    log(f"parallel SFT: {mesh_line!r}; talker cut to {TRAIN_CUT_LAYERS} layers, widths full, "
        f"{TRAIN_BATCH} rows of {TRAIN_CPU_FRAMES} frames, one step, on the ranks of (c) as "
        f"under a launcher: step-0 loss {got:.6f} against one device's {ref:.6f} (|diff| "
        f"{abs(got - ref):.3g}, tol {PARALLEL_LOSS_RTOL} x max(1, |loss|)); the snapshot's "
        f"tensors have one device's names, shapes and dtypes, params after the step within "
        f"{worst[0]:.3g} of their largest value (worst {worst[1]}); one device (load, collate, "
        f"step) {run['solo_s']:.1f} s, dp 2 x tp 2 (load, collate, step, export, snapshot) "
        f"{[round(r['sft_s'], 1) for r in res]} s; rank 0's lines {[l[:32] for l in lines]} "
        f"| {smi}")
    if not abs(got - ref) <= PARALLEL_LOSS_RTOL * max(1.0, abs(ref)):
        fail("parallel SFT: the step-0 loss differs from one device's")


def phase_parallel(model_dir: str, base_dir: str, smi: str) -> dict:
    """Phase 16: parallelism on the one card. (a) the two-stage pipeline on
    two streams; (b) a one-rank NCCL group through the captured frames; (c)
    dp 2 x tp 2 over gloo, four ranks sharing the card, with a dp-2 VQ step;
    (d) the SFT CLI's run at dp 2 x tp 2 on the same four ranks; decode
    attention held at the tp shard's shapes. Returns the vocoder block's
    launches in (a) and the decode attention's per rank in (c)."""
    import torch

    from qwen_tts_tpu_torch import graphs

    # Every child starts now, so that their imports (CPU work) overlap (a).
    # The card's timed work runs alone, each step started by a mark: (a)
    # here; then ("go") the ranks load and (b)'s child loads and captures;
    # then ("quiet", once the four ranks are "loaded<r>") (b)'s child times
    # its frames; then ("timed") the ranks decode and train while this
    # process runs its side of (c) and (d) and (b)'s child profiles.
    sft = sft_inputs(base_dir)
    marks = tempfile.mkdtemp(prefix="qtts_marks_")
    nccl, ranks = None, None
    try:
        nccl = start_nccl(model_dir, marks)
        ranks = start_ranks(model_dir, sft, marks)
        procs, work, t0 = ranks
        vocoder = timed("parallel pipeline", check_pipeline, model_dir, smi)
        graphs.clear()
        torch.cuda.empty_cache()
        set_mark(marks, "go")
        loaded = timed("parallel wait for the ranks' loads", wait_for_marks, procs, marks,
                       [f"loaded{r}" for r in range(len(procs))])
        set_mark(marks, "quiet")
        if not (loaded and timed("parallel wait for (b)'s timings", wait_for_marks, nccl[0],
                                 marks, ["timed"])):
            # A child ended early: waiting for its result says how.
            check_nccl_one_rank(model_dir, nccl, smi)
            wait_children(procs, work, "parallel ranks")
        timed("parallel SFT one device", parallel_sft_reference, sft)
        ref = timed("parallel dp x tp unsharded", dp_tp_reference, model_dir)
        try:
            res = timed("parallel ranks", wait_children, procs, work, "parallel ranks")
            dp_tp = check_dp_tp(ref, res, work, max(r["end"] for r in res) - t0, smi)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        check_tp_engines(ref, res, smi)
        check_tp_windows(ref, res, smi)
        check_parallel_sft(sft, res, smi)
        timed("parallel NCCL", check_nccl_one_rank, model_dir, nccl, smi)
    finally:
        for child in (nccl, ranks):
            if child is not None:
                stop(child[0])
        shutil.rmtree(sft["work"], ignore_errors=True)
        shutil.rmtree(marks, ignore_errors=True)
    del ref
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(16)
    err = max(hold_attention_at(gen, (8, 1, 64, 32 + DP_TP_FRAMES), False, "talker tp shard"),
              hold_attention_at(gen, (8, 4, 128, 16), False, "subtalker tp shard",
                                micro_rows(16)))
    return {"vocoder_block": vocoder, "decode_attention": dp_tp, "attention_err": err}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds logged under ``name``."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    log(f"time: {name} {time.perf_counter() - t0:.1f} s")
    return result


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    from qwen_tts_tpu_torch import graphs

    timed("build", phase_build)
    prefill_bucket = 32
    records = timed("kernels", phase_kernels, prefill_bucket + MAX_NEW)
    records.append(timed("kernels vocoder_block", phase_kernels_vocoder_block))
    records.append(timed("kernels int8_matmul", phase_kernels_int8_matmul))
    timed("batch invariance", phase_batch_invariance)
    model_dir = tempfile.mkdtemp(prefix="qtts_smoke_")
    try:
        cfg = flagship_config()
        t0 = time.perf_counter()
        write_checkpoint(model_dir, cfg, seed=1234)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(model_dir) for f in fs)
        log(f"checkpoint: random weights at flagship dims, {size / 2**30:.2f} GiB, "
            f"written in {time.perf_counter() - t0:.1f} s")
        path = timed("path", phase_path, model_dir, smi)
        timed("parity", phase_parity, model_dir)
        graphs.clear()
        serving = timed("serving path", phase_path, model_dir, smi, serving=True)
        timed("parity int8", phase_parity, model_dir, "int8")
        graphs.clear()
        timed("parity int8+kv", phase_parity, model_dir, "int8+kv")
        graphs.clear()
        with st_gates(QTTS_ST_KV8="1"):
            timed("parity int8+kv+st-kv8", phase_parity, model_dir, "int8+kv+st-kv8")
        graphs.clear()
        timed("codec bf16", phase_codec_bf16, model_dir, smi, path)
        stream = timed("stream", phase_stream, model_dir, smi)
        timed("graphs", phase_graphs, model_dir, smi)
        base_dir = os.path.join(model_dir, "base")
        t0 = time.perf_counter()
        write_base_checkpoint(model_dir, base_dir, cfg, cfg.codec.encoder, seed=4321)
        log(f"checkpoint: Base variant (links to the talker and codec, plus the speaker "
            f"and Mimi encoders at the published widths) written in "
            f"{time.perf_counter() - t0:.1f} s")
        clone = timed("clone", phase_clone, base_dir, smi)
        serving_engines = timed("serving engines", phase_serving, model_dir, base_dir, smi)
        timed("fast modes", phase_fast_modes, model_dir, smi)
        timed("25 Hz tokenizer", phase_tokenizer_25hz, smi)
        graphs.clear()
        torch.cuda.empty_cache()
        timed("training", phase_training, base_dir, smi)
        graphs.clear()
        torch.cuda.empty_cache()
        parallel = timed("parallel", phase_parallel, model_dir, base_dir, smi)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    # Each kernel's launches come from the run of the path that uses it.
    records[0]["launches"] = path["launches"]["decode_attention"]
    records[1]["launches"] = serving["launches"]["decode_attention_int8"]
    records[2]["launches"] = serving["launches"]["subtalker_step"]
    records[3]["launches"] = stream["vocoder_block"]
    records[4]["launches"] = serving["launches"]["int8_matmul"]
    for rec in records[:2]:
        rec["max_abs_err"] = max(rec["max_abs_err"], clone["attention_err"][rec["name"]],
                                 serving_engines["attention_err"][rec["name"]])
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], parallel["attention_err"])
    log(f"time: all phases {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
