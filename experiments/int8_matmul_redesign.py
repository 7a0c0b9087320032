#!/usr/bin/env python3
"""Measurements behind the redesign of the int8-weight GEMM
(``qwen_tts_tpu_torch/csrc/int8_matmul.cu``), kept apart from
``chip_smoke.py``: none checks the port, and none runs on its main path.
Each needs one NVIDIA GPU and a built tree; it uses ``chip_smoke.py``'s
helpers (loaded by path from this file's tree) with the package of the tree
at the current directory.

    python3 experiments/int8_matmul_redesign.py timeline build/parent
    python3 experiments/int8_matmul_redesign.py variants [--rounds 2]
    python3 experiments/int8_matmul_redesign.py pdl CKPT [--runs 5]
    python3 <this tree>/experiments/int8_matmul_redesign.py paths TAG CKPT [--runs 5]

- ``timeline ROOT``: the int8 GEMM of commit a9115f3 (the design before the
  grouped launch; ``git archive a9115f3`` unpacked at ROOT) with global-timer
  stamps at its phase boundaries (``parent_int8_timeline``).
- ``variants``: the kernel against textual variants of its source, in turns
  (``INT8_VARIANTS``: programmatic dependent launch; the K split capped at 4
  cluster ranks), with each side's timeline (``compare_int8_variants``).
- ``pdl CKPT``: the replayed serving segment with the kernel as built and as
  the programmatic-dependent-launch variant, in turns (``pdl_experiment``).
  The variant is not part of the kernel: it gained nothing there.
- ``paths TAG CKPT``: the bf16 and serving decode loops, the replayed
  segments and the bf16 stream of the tree at the current directory
  (``time_paths``). Run it from two trees' roots in turns (parent, change,
  change, parent), one process each, to tell a change from the spread.

CKPT is a checkpoint directory; one is written there (random weights at the
flagship dims, seed 1234) when it holds none.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd())  # the package of the tree run from
if "chip_smoke" not in sys.modules:
    _spec = importlib.util.spec_from_file_location("chip_smoke",
                                                   os.path.join(_REPO, "chip_smoke.py"))
    sys.modules["chip_smoke"] = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(sys.modules["chip_smoke"])
from chip_smoke import (  # noqa: E402
    INT8_MATMUL_TOL, INT8_ROTATE, LAYER_LAUNCHES, MAX_NEW, TEXTS, ChatTemplateTokenizer,
    _device_us, _int8_layers, _median_breakdown, _rotating, _segment, _spread, _stream_once,
    fail, flagship_config, int8_timeline, log, phase_build, phase_device, write_checkpoint)


def parent_int8_timeline(parent_root: str, m: int = 4) -> dict:
    """The timeline of the int8 GEMM of an earlier commit (the design before
    the grouped launch, unpacked under ``parent_root`` with ``git archive
    a9115f3``) at the wq shape
    (1024 x 1024), M=``m``, bf16, over 20 weights in turn: its source with
    the same global-timer stamps as this kernel's ``timeline`` at its own
    phase boundaries (start; the weight slice widened into shared memory;
    x staged; the mma loop and the block's sums done; the first cluster
    barrier of its exchange; the end), built with nvcc beside this tree's
    kernels. Returns the median breakdown (``timeline_breakdown``)."""
    import ctypes

    import torch

    from qwen_tts_tpu_torch.models.trunk import quantize_int8
    from qwen_tts_tpu_torch.ops.cuda import build
    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import TIMELINE_SLOTS, timeline_breakdown

    src = open(os.path.join(parent_root, "qwen_tts_tpu_torch", "csrc", "int8_matmul.cu")).read()
    stamp = ("if (p.timeline && threadIdx.x == 0) {{ unsigned long long t_; asm volatile("
             "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)::\"memory\"); p.timeline[(("
             "(size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * "
             f"{TIMELINE_SLOTS} + {{}}] = t_; }}}}\n")
    edits = [
        ("  int block_k;", "  unsigned long long* timeline;\n  int block_k;", 1),
        ("  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);\n",
         "  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);\n" + stamp.format(0),
         1),
        ("  for (int i = tid; i < 16 * kMTiles * (block_k / 8); i += kThreads) {",
         stamp.format(1) + "  for (int i = tid; i < 16 * kMTiles * (block_k / 8); i += kThreads) {",
         1),
        ("  __syncthreads();\n  float acc[kMTiles][2][4];",
         stamp.format(2) + "  __syncthreads();\n  float acc[kMTiles][2][4];", 1),
        ("  const int rows = min(16 * kMTiles, p.m - m0);\n",
         "  const int rows = min(16 * kMTiles, p.m - m0);\n  __syncthreads();\n" + stamp.format(3),
         1),
        ("    count = max(0, min(per, total - first));\n",
         "    count = max(0, min(per, total - first));\n" + stamp.format(4), 1),
        ("  finish<__nv_bfloat16>(p, block_sum, rows * kMmaCols, kMmaCols, n0, m0);\n",
         "  finish<__nv_bfloat16>(p, block_sum, rows * kMmaCols, kMmaCols, n0, m0);\n"
         + stamp.format(5), 1),
        ("int dtype, int out_f32, int m, int k, int n, void* stream) {",
         "int dtype, int out_f32, int m, int k, int n, void* timeline, void* stream) {", 1),
        ("m, k, n, out_f32, block_k};", "m, k, n, out_f32, "
         "static_cast<unsigned long long*>(timeline), block_k};", 1),
    ]
    for old, new, count in edits:
        if src.count(old) != count:
            fail(f"parent_int8_timeline: {old!r} is not in the parent's source")
        src = src.replace(old, new)
    work = os.path.join(build.BUILD_DIR, "parent_int8")
    os.makedirs(work, exist_ok=True)
    cu, lib_path = os.path.join(work, "int8_matmul_timed.cu"), os.path.join(work, "timed.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"parent_int8_timeline: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.qtts_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    gen = torch.Generator(device="cuda").manual_seed(8)
    k = n = 1024
    weights = [quantize_int8(torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5)
               for _ in range(INT8_ROTATE)]
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    split, rows = ctypes.c_int(), ctypes.c_int()
    lib.qtts_int8_matmul_split(k, ctypes.byref(split), ctypes.byref(rows))
    timeline = torch.zeros(split.value * (n // 64), TIMELINE_SLOTS, dtype=torch.int64,
                           device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    parts = []
    for i in range(INT8_ROTATE + 1):
        w, s = weights[i % INT8_ROTATE]
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), 1, 0, m, k, n,
                 timeline.data_ptr(), stream)
        torch.cuda.synchronize()
        if err != 0:
            fail(f"parent_int8_timeline: launch failed, cudaError {err}")
        if i:
            parts.append(timeline_breakdown(timeline))
    rec = _median_breakdown(parts)
    log(f"int8_matmul timeline, the parent's kernel ({parent_root}), wq 1024 x 1024, M={m}, "
        f"bf16, median of {len(parts)} launches: {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def int8_variant(edits, tag: str):
    """For the ``with`` block, the int8 GEMM wrappers launch a variant of
    the kernel: this tree's ``csrc/int8_matmul.cu`` with textual edits
    ``[(old, new), ...]`` (each ``old`` must occur once), built with nvcc as
    ``build/torch_kernels/int8_matmul-<tag>-<hash>.so``. An experiment on a
    design choice, timed against the kernel in one process; graphs captured
    inside the block must be cleared before it ends."""
    import ctypes
    import hashlib

    from qwen_tts_tpu_torch.ops.cuda import build
    from qwen_tts_tpu_torch.ops.cuda import int8_matmul as im

    src = open(os.path.join(build.CSRC_DIR, "int8_matmul.cu")).read()
    for old, new in edits:
        if src.count(old) != 1:
            fail(f"int8_variant {tag}: {old!r} is not in the source once")
        src = src.replace(old, new)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, f"int8_matmul-{tag}-{digest}.cu")
    lib_path = cu[:-3] + ".so"
    if not os.path.exists(lib_path):
        with open(cu, "w") as f:
            f.write(src)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path, cu],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            fail(f"int8_variant {tag}: nvcc failed\n{proc.stderr[-3000:]}")
    im._kernel_fn("matmul")  # the kernel's own library, bound first
    saved = dict(im._fns)
    im._fns.clear()
    with mock.patch.object(build, "load_library", lambda name: ctypes.CDLL(lib_path)):
        im._kernel_fn("matmul")  # the variant, bound with the wrapper's own signatures
    try:
        yield
    finally:
        im._fns.update(saved)


# Variants of the int8 GEMM timed beside it (compare_int8_variants,
# pdl_experiment): programmatic dependent launch (the launch serialised
# programmatically; the weights requested before griddepcontrol.wait, x read
# after it); the K split capped at 4 cluster ranks (twice the steps a warp).
_PDL_WAIT = 'asm volatile("griddepcontrol.wait;" ::: "memory");\n'
INT8_VARIANTS = {
    "pdl": [("cudaLaunchAttribute attr[1];", "cudaLaunchAttribute attr[2];"),
            ("  cfg.numAttrs = 1;",
             "  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
             "  attr[1].val.programmaticStreamSerializationAllowed = 1;\n"
             "  cfg.numAttrs = 2;"),
            ("  for (int i = tid; i < rows * kBlockK; i += kThreads) {",
             _PDL_WAIT + "  for (int i = tid; i < rows * kBlockK; i += kThreads) {"),
            ("  // x at the same rows", _PDL_WAIT + "  // x at the same rows")],
    "split4": [("constexpr int kMaxSplit = 8; ", "constexpr int kMaxSplit = 4; ")],
}


def compare_int8_variants(variants=INT8_VARIANTS, rounds: int = 2) -> dict:
    """The layer's launch kinds at M=4 and M=128, bf16, over 20 layers'
    weights in turn: the kernel's device time against each variant's, in
    turns (kernel, variant, variant, kernel, ...), and the wq launch's
    timeline at M=4 (int8_timeline) on each side; each variant's outputs
    held to INT8_MATMUL_TOL of the kernel's (bit-equal where its sum order
    is the same). Returns {name: {kind@M: median us}}."""
    import torch

    from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul_group

    gen = torch.Generator(device="cuda").manual_seed(18)
    layers = _int8_layers(gen, INT8_ROTATE)
    xs = {(k, m): torch.randn(m, k, generator=gen, device="cuda").bfloat16()
          for k in (1024, 2048) for m in (4, 128)}

    def times():
        out = {}
        for m in (4, 128):
            for kind, names in LAYER_LAUNCHES:
                x = xs[(layers[0][names[0]][0].shape[0], m)]
                groups = [[layer[n] for n in names] for layer in layers]
                call = _rotating(lambda *ws: int8_matmul_group(x, ws), groups)
                us = _device_us(call, "int8_matmul_kernel", iters=40, merge=True)
                out[f"{kind}@{m}"] = round(us, 3)
        return out

    def outputs():
        return [y for (k, m), x in xs.items() for kind, names in LAYER_LAUNCHES
                if layers[0][names[0]][0].shape[0] == k
                for y in int8_matmul_group(x, [layers[0][n] for n in names])]

    want = outputs()
    results = {"kernel": collections.defaultdict(list)}
    for name, edits in variants.items():
        results[name] = collections.defaultdict(list)
        with int8_variant(edits, name):
            got = outputs()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        log(f"int8 variant {name}: outputs bit-equal to the kernel's {same}, largest error "
            f"{err:.3g} of max|kernel|")
        if err > INT8_MATMUL_TOL["bfloat16"]:
            fail(f"int8 variant {name} disagrees with the kernel")
        for i in range(2 * rounds):
            side = name if i % 4 in (1, 2) else "kernel"
            with int8_variant(edits, name) if side != "kernel" else contextlib.nullcontext():
                for key, us in times().items():
                    results[side][key].append(us)
    for name, edits in [("kernel", None)] + list(variants.items()):
        with int8_variant(edits, name) if edits else contextlib.nullcontext():
            log(f"int8 variant {name}: wq M=4 timeline "
                f"{json.dumps(int8_timeline(layers, 'wq', ('wq',)))}")
    summary = {side: {k: round(statistics.median(v), 3) for k, v in r.items()}
               for side, r in results.items()}
    log(f"int8 variants, device us a launch (median of the rounds, 20 layers' weights in turn) "
        f"| {json.dumps(summary)}")
    return summary


def pdl_experiment(model_dir: str, smi: str, runs: int = 5) -> dict:
    """Programmatic dependent launch, end to end: the replayed serving
    decode segment (int8 weights and KV, B=4, MAX_NEW frames, greedy, EOS
    banned, prefill outside) with the int8 GEMM as built and as the pdl
    variant, each captured anew, in turns (kernel, variant, variant,
    kernel, ...): ms a frame, median (min..max) of ``runs``; the two decodes
    bit for bit."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    model = Qwen3TTSModel.from_pretrained(model_dir, load_tokenizer=False)
    model.quantize_for_serving(talker=True, kv=True)
    model.tokenizer = ChatTemplateTokenizer()
    dtype = model.talker_params["norm"].dtype
    prompts = [gen_mod.build_prompt(model.talker_params, model.cfg,
                                    model._tokenize(model.build_assistant_text(t)),
                                    language=lang, speaker=spk)
               for t, spk, lang in zip(TEXTS, ["aiden", "serena"] * 2,
                                       ["english", "auto", "chinese", "english"])]
    e, m, t, _ = gen_mod.batch_prompts(prompts)
    inputs = (e.to(dtype), m, t.to(dtype))
    banned = model._merge_params(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1,
                                 do_sample=False, subtalker_dosample=False,
                                 repetition_penalty=1.0)
    ms, bufs = {"kernel": [], "pdl": []}, {}
    for i in range(2 * runs):
        side = "pdl" if i % 4 in (1, 2) else "kernel"
        graphs.clear()
        with (int8_variant(INT8_VARIANTS["pdl"], "pdl") if side != "kernel"
              else contextlib.nullcontext()):
            _segment(model, inputs, banned, eager=False)  # the capture
            _, bufs[side], wall, _ = _segment(model, inputs, banned, eager=False)
            graphs.clear()
        ms[side].append(wall / MAX_NEW * 1e3)
    same = bool(torch.equal(bufs["kernel"], bufs["pdl"]))
    log(f"pdl experiment: replayed serving segment B=4, {MAX_NEW} frames, {runs} runs each in "
        f"turns: int8 GEMM with programmatic dependent launch {_spread(ms['pdl'], '{:.3f}')} "
        f"ms/frame, without (the kernel) {_spread(ms['kernel'], '{:.3f}')}; codes equal {same} "
        f"| {smi}")
    if not same:
        fail("pdl experiment: the two decodes differ")
    del model
    torch.cuda.empty_cache()
    return ms


def time_paths(model_dir: str, smi: str, tag: str, runs: int = 5) -> dict:
    """The bf16 path and the int8 serving path (``quantize_for_serving(
    talker=True, kv=True)``) at the path's prompts (B=4, MAX_NEW frames,
    greedy, EOS banned), through the graphs: the decode loop
    (``generate_codes_from_prompts``, prefill included) in ms a step and the
    replayed segment (prefill outside) in ms a frame, median (min..max) of
    ``runs`` each, and the loop's peak device memory; then the bf16 stream
    (bf16 talker and codec, B=1, greedy, EOS banned, chip_smoke's schedule):
    first-packet latency and stream RTF over ``runs`` streams after one that
    captures. Uses only what the package had at commit a9115f3 too, so that
    that tree and a later one can be timed in turns (``tag`` names the tree
    in the log)."""
    import torch

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    out = {}
    for mode in ("bf16", "serving"):
        model = Qwen3TTSModel.from_pretrained(model_dir, load_tokenizer=False)
        if mode == "serving":
            model.quantize_for_serving(talker=True, kv=True)
        model.tokenizer = ChatTemplateTokenizer()
        dtype = model.talker_params["norm"].dtype
        prompts = [gen_mod.build_prompt(model.talker_params, model.cfg,
                                        model._tokenize(model.build_assistant_text(t)),
                                        language=lang, speaker=spk)
                   for t, spk, lang in zip(TEXTS, ["aiden", "serena"] * 2,
                                           ["english", "auto", "chinese", "english"])]
        e, m, t, _ = gen_mod.batch_prompts(prompts)
        inputs = (e.to(dtype), m, t.to(dtype))
        params = model._merge_params(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1,
                                     do_sample=False, subtalker_dosample=False,
                                     repetition_penalty=1.0)
        model.generate_codes_from_prompts(prompts, params)  # the capture
        loop, peak = [], []
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model.generate_codes_from_prompts(prompts, params)
            torch.cuda.synchronize()
            loop.append((time.perf_counter() - t0) / MAX_NEW * 1e3)
            peak.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        frames = [_segment(model, inputs, params, eager=False)[2] / MAX_NEW * 1e3
                  for _ in range(runs)]
        out[mode] = {"loop_ms": loop, "frame_ms": frames, "peak_gib": max(peak)}
        log(f"decode modes [{tag}] {mode}: decode loop {_spread(loop, '{:.3f}')} ms/step, "
            f"replayed segment {_spread(frames, '{:.3f}')} ms/frame, peak mem allocated "
            f"{max(peak):.3f} GiB ({runs} runs) | {smi}")
        del model
        graphs.clear()
        torch.cuda.empty_cache()

    model = Qwen3TTSModel.from_pretrained(model_dir, codec_dtype=torch.bfloat16,
                                          load_tokenizer=False)
    model.tokenizer = ChatTemplateTokenizer()
    kw = dict(max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW + 1, do_sample=False,
              subtalker_dosample=False, repetition_penalty=1.0)
    _stream_once(model, kw, TEXTS[0], "aiden", "english")  # the captures
    first, rtf = [], []
    for _ in range(runs):
        first_s, wall, audio_s = _stream_once(model, kw, TEXTS[0], "aiden", "english")[:3]
        first.append(first_s * 1e3)
        rtf.append(audio_s / wall)
    out["stream"] = {"first_packet_ms": first, "rtf": rtf}
    log(f"decode modes [{tag}] bf16 stream: first-packet latency {_spread(first)} ms, stream "
        f"RTF(audio/wall) {_spread(rtf, '{:.3f}')} ({runs} streams) | {smi}")
    del model
    graphs.clear()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    sub.add_parser("timeline").add_argument("root")
    sub.add_parser("variants").add_argument("--rounds", type=int, default=2)
    pdl = sub.add_parser("pdl")
    pdl.add_argument("ckpt")
    pdl.add_argument("--runs", type=int, default=5)
    paths = sub.add_parser("paths")
    paths.add_argument("tag")
    paths.add_argument("ckpt")
    paths.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()

    smi = phase_device()
    if args.what == "timeline":
        parent_int8_timeline(args.root)
        return 0
    if args.what == "variants":
        phase_build(("int8_matmul",))
        compare_int8_variants(rounds=args.rounds)
        return 0
    phase_build()
    if not os.path.exists(os.path.join(args.ckpt, "model.safetensors")):
        os.makedirs(args.ckpt, exist_ok=True)
        write_checkpoint(args.ckpt, flagship_config(), seed=1234)
    if args.what == "pdl":
        pdl_experiment(args.ckpt, smi, runs=args.runs)
    else:
        time_paths(args.ckpt, smi, args.tag, runs=args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
