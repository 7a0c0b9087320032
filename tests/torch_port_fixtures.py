"""Helpers shared by the PyTorch port's tests (tests/test_torch_*.py)."""

import fcntl
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on one host. The port's tests
    use tiny shapes that gain nothing from intra-op threads, which would only
    contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tame_codec(tree):
    """Scale every conv weight [K, Cin, Cout] of a codec parameter tree
    (JAX or torch leaves) by 1/sqrt(Cin). The fixture's random convs gain
    ~sqrt(Cin) each, which saturates the [-1, 1] clamp everywhere and would
    make a waveform comparison vacuous."""
    if isinstance(tree, dict):
        return {k: (v / math.sqrt(v.shape[1])
                    if k.endswith("_w") and getattr(v, "ndim", 0) == 3 else tame_codec(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tame_codec(v) for v in tree]
    return tree


def make_clone_checkpoint(model_dir: str) -> None:
    """``make_checkpoint(with_encoders=True)`` with random Mimi codebooks.
    The fixture's Mimi weights come from a fresh ``transformers.MimiModel``,
    whose codebooks are all zero (``embed_sum`` 0, ``cluster_usage`` 1): every
    frame would encode to code 0 and a comparison of codes would say nothing.
    Here each ``embed_sum`` is N(0, 1) x its usage, each usage in [0.5, 1.5),
    from a numpy seed; both packages then load the same file. The Mimi
    model's own random init runs under a fixed torch seed, so the file is
    the same on every run."""
    from safetensors.numpy import load_file, save_file

    from ckpt_fixture import make_checkpoint

    with torch.random.fork_rng():
        torch.manual_seed(0)
        make_checkpoint(model_dir, with_encoders=True)
    path = os.path.join(model_dir, "speech_tokenizer", "model.safetensors")
    tensors = load_file(path)
    rng = np.random.default_rng(7)
    for name in sorted(tensors):
        if name.endswith(".codebook.cluster_usage"):
            usage = rng.uniform(0.5, 1.5, tensors[name].shape).astype(np.float32)
            esum = name[: -len("cluster_usage")] + "embed_sum"
            tensors[name] = usage
            tensors[esum] = (rng.standard_normal(tensors[esum].shape)
                             * usage[:, None]).astype(np.float32)
    save_file(tensors, path)


def clone_checkpoint(tmp_path_factory) -> str:
    """One ``make_clone_checkpoint`` directory for the whole test session,
    built by the first test file that asks and shared by the rest (and by
    every pytest-xdist worker: their base temp directories share a parent).
    Readers must not write into it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d, done = root / "torch_clone_ckpt", root / "torch_clone_ckpt.done"
    with open(root / "torch_clone_ckpt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            shutil.rmtree(d, ignore_errors=True)
            make_clone_checkpoint(str(d))
            done.touch()
    return str(d)


def numpy_tree(tree):
    """A JAX parameter tree with numpy leaves, as a caller hands it to convert."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def assert_same_tree(a, b, path="root"):
    """Two port trees of float32 tensors: same keys, shapes and bits."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


# --------------------------------------------------------------------------
# A kernel's CUDA source on the CPU (tests/cuda_host): the helpers written
# in PTX cut, shared memory pointed at the emulated block's, and the body of
# its ``launch`` replaced by a run of the emulation.
# --------------------------------------------------------------------------

CUDA_HOST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host")
CSRC = os.path.join(os.path.dirname(CUDA_HOST), os.pardir, "qwen_tts_tpu_torch", "csrc")


def host_source(name: str, helpers, launches: dict) -> str:
    """``csrc/<name>.cu`` rewritten for the host emulation: each function of
    ``helpers`` (written in PTX) cut, ``extern __shared__`` memory taken from
    the emulated block, and the body of each function whose first line is a
    key of ``launches`` replaced by its value."""
    s = open(os.path.join(CSRC, name + ".cu")).read()
    for helper in helpers:
        m = re.search(r"(template <int N>\n)?__device__ __forceinline__ \w+ " + helper + r"\(", s)
        assert m, f"{helper} not found in {name}.cu"
        first = s[m.start():s.index("\n", m.start())]
        end = (s.index("\n", m.start()) + 1 if first.rstrip().endswith("}")
               else s.index("\n}\n", m.start()) + 3)
        s = s[:m.start()] + s[end:]
    s = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
               "unsigned char* smem = emu::tls.smem;", s)
    for signature, launch_body in launches.items():
        start = s.index(signature)
        body = s.index("{\n", start) + 2
        end = s.index("\n}\n", body) + 3
        s = s[:body] + launch_body + "\n}\n" + s[end:]
    return s


def build_host_library(source: str, work) -> str:
    """Compile a host source with g++ against tests/cuda_host; returns the
    library's path (skips the test without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    src, lib = os.path.join(work, "kernel_host.cpp"), os.path.join(work, "kernel_host.so")
    with open(src, "w") as f:
        f.write(source)
    build = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         "-I", os.path.join(CUDA_HOST, "include"), "-o", lib, src],
        capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stderr[-4000:]
    return lib


# --------------------------------------------------------------------------
# The serving stack's tests (tests/test_torch_serving.py, _continuous*.py,
# _server.py): both packages on the shared clone checkpoint, f32 on the
# CPU, and the JAX package's solo greedy codes as the reference.
# --------------------------------------------------------------------------

# Engines decode at this ceiling; each JAX reference decodes at the same
# ceiling with its row's budget (``step_limit``), so one compiled program
# serves every budget and the caches have the engines' length.
SERVING_CEILING = 16
SERVING_BUCKET = 32


def serving_models(ckpt: str, kv_int8: bool = False):
    """(JAX model, port model) from ``ckpt``: f32 talkers, the port on the
    CPU, ``FakeTokenizer`` (tests/test_voice_clone.py) for text requests, the
    same tamed codec on both sides."""
    import jax.numpy as jnp

    from test_voice_clone import FakeTokenizer
    from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

    jm = JaxModel.from_pretrained(ckpt, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    jm.tokenizer = tm.tokenizer = FakeTokenizer()
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = tame_codec(tm.codec_params)
    jm.kv_int8 = tm.kv_int8 = kv_int8
    return jm, tm


def greedy_params(module, frames: int, **kw):
    """``module.GenerationParams`` (either package's ``generate``) for
    ``frames`` greedy frames: EOS banned at every token (the last is the
    (frames + 1)-th), so a row runs to its budget, frames + 1, and the
    budget trim keeps ``frames``. ``kw`` overrides."""
    return module.GenerationParams(**{**dict(
        max_new_tokens=frames + 1, min_new_tokens=frames + 2, do_sample=False,
        subtalker_do_sample=False, repetition_penalty=1.0), **kw})


def jax_solo_codes(jm, ids, frames: int, *, speaker="aiden", language="english",
                   ceiling: int = SERVING_CEILING, **prompt_kw):
    """The JAX package's greedy codes [frames, G] for one request alone,
    through ``generate_codes_from_prompts`` at an engine's ceiling and the
    default prefill bucket (a budget of frames + 1, EOS banned)."""
    import dataclasses

    from qwen_tts_tpu import generate as j_generate

    prompt = j_generate.build_prompt(jm.talker_params, jm.cfg, np.asarray(ids, np.int32),
                                     language=language, speaker=speaker,
                                     st_params=jm.subtalker_params, **prompt_kw)
    params = dataclasses.replace(greedy_params(j_generate, ceiling), max_new_tokens=ceiling)
    codes, _ = jm.generate_codes_from_prompts(
        [prompt], params, step_limit=[frames + 1], max_new_ceiling=ceiling, trailing_bucket=16)
    assert codes[0].shape[0] == frames
    return np.asarray(codes[0], np.int64)


class DecodedCodes:
    """Records every code array a model's ``decode_codes`` is given (the
    engines' finished requests, from their worker threads), in order."""

    def __init__(self, model):
        self.model, self.codes = model, []
        self._orig = model.decode_codes

    def __enter__(self) -> list:
        def recording(codes_list, **kw):
            self.codes.extend(np.asarray(c, np.int64).copy() for c in codes_list)
            return self._orig(codes_list, **kw)

        self.model.decode_codes = recording
        return self.codes

    def __exit__(self, *exc) -> None:
        del self.model.decode_codes
