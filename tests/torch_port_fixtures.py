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
