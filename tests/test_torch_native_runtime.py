"""The port's native host runtime (``qwen_tts_tpu_torch/io/native.py`` over
its own copy of the C++ source) against the port's pure-Python reader and
writer and against the JAX package's ``qwen_tts_tpu/io/native.py``: mapped
views byte for byte, the bf16 conversion exact, WAV files byte for byte
with JAX's runtime, and the build inside ``build/`` with nothing under the
root ``csrc/`` touched."""

import json
import os

import numpy as np
import pytest
import torch

from qwen_tts_tpu.io import native as j_native
from qwen_tts_tpu.io.wav import write_wav as j_py_write
from qwen_tts_tpu_torch.io import native
from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile, save_file
from qwen_tts_tpu_torch.io.wav import read_wav, write_wav as py_write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(), reason="needs g++ to build the runtime")


@pytest.fixture(scope="module")
def st_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "t.safetensors")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a": torch.randn((32, 16), generator=g),
        "b": torch.randint(0, 100, (8,), generator=g, dtype=torch.int32),
        "c": torch.randn((7, 33), generator=g).to(torch.bfloat16),
    }
    save_file(tensors, path)
    return path, tensors


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_native_map_matches_readers(st_file):
    """Each tensor's view equals the port's reader and JAX's NativeMap, byte
    for byte, and the header is the file's."""
    path, tensors = st_file
    m = native.NativeMap(path, prefetch_threads=2)
    jm = j_native.NativeMap(path, prefetch_threads=2)
    assert m.header_bytes() == jm.header_bytes()
    header = json.loads(m.header_bytes())
    py = SafeTensorsFile(path)
    for name, want in tensors.items():
        begin, end = header[name]["data_offsets"]
        got = m.view(begin, end)
        assert got.dtype == np.uint8 and not got.flags.writeable
        assert got.tobytes() == _bytes(want) == _bytes(py.get(name))
        assert got.tobytes() == jm.view(begin, end).tobytes()
    # A typed tensor over the view, without a copy of the mapping's bytes.
    begin, end = header["a"]["data_offsets"]
    a = torch.frombuffer(bytearray(m.view(begin, end)), dtype=torch.float32).reshape(32, 16)
    assert torch.equal(a, tensors["a"])
    py.close()
    m.close()
    jm.close()


def test_bf16_roundtrip():
    """bf16 → f32 is exact: the bits of torch's cast and of JAX's runtime."""
    x = torch.randn(100000, generator=torch.Generator().manual_seed(1))
    bf = x.to(torch.bfloat16)
    bits = bf.view(torch.int16).numpy().view(np.uint16)
    got = native.bf16_to_f32(bits, n_threads=4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), bf.float().numpy().view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  j_native.bf16_to_f32(bits, n_threads=4).view(np.uint32))
    # Past 2^20 elements the conversion runs on several threads.
    big = np.tile(bits, 12)
    np.testing.assert_array_equal(native.bf16_to_f32(big, n_threads=4),
                                  np.tile(bf.float().numpy(), 12))


def _pcm(path) -> tuple:
    with open(path, "rb") as f:
        raw = f.read()
    return raw[:44], np.frombuffer(raw[44:], "<i2")


def test_native_wav_bytes(tmp_path):
    """The runtime's WAV equals JAX's runtime's byte for byte. Against the
    port's (and JAX's) io/wav.py the 44-byte header is the same and each
    sample follows its writer's rule: the runtime clips to [-1, 1] and
    rounds x * 32767 half away from zero in f32, io/wav.py truncates toward
    zero; at most one step apart."""
    x = np.concatenate([np.sin(np.linspace(0, 100, 24000)).astype(np.float32) * 0.5,
                        np.array([1.5, -1.5, 1.0, -1.0, 0.0, 0.25 / 32767], np.float32)])
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("native", "jax", "py", "jax_py")}
    native.write_wav(paths["native"], x, 24000)
    j_native.write_wav(paths["jax"], x, 24000)
    py_write(paths["py"], x, 24000)
    j_py_write(paths["jax_py"], x, 24000)
    with open(paths["native"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    with open(paths["py"], "rb") as a, open(paths["jax_py"], "rb") as b:
        assert a.read() == b.read()
    head_n, pcm_n = _pcm(paths["native"])
    head_p, pcm_p = _pcm(paths["py"])
    assert head_n == head_p
    s = np.clip(x, -1, 1) * np.float32(32767)
    rounded = np.where(s >= 0, s + np.float32(0.5), s - np.float32(0.5)).astype(np.int16)
    truncated = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(pcm_n, rounded)
    np.testing.assert_array_equal(pcm_p, truncated)
    assert np.abs(pcm_n.astype(np.int32) - pcm_p).max() <= 1
    wav, rate = read_wav(paths["native"])
    assert rate == 24000 and wav.shape == x.shape


def _snapshot(root):
    return {os.path.join(r, f): os.stat(os.path.join(r, f)).st_mtime_ns
            for r, _, fs in os.walk(root) for f in fs}


def test_build_goes_into_build_and_leaves_csrc(tmp_path):
    """A fresh compile of the port's copy lands in build/host/; no file of
    the root csrc/ is written, added or removed."""
    out = native.library_path()
    assert os.path.commonpath([out, os.path.join(REPO, "build", "host")]) == os.path.join(
        REPO, "build", "host")
    assert native.SOURCE == os.path.join(REPO, "qwen_tts_tpu_torch", "csrc", "host",
                                         "qtts_runtime.cpp")
    before = _snapshot(os.path.join(REPO, "csrc"))
    assert native.build(out)
    assert os.path.exists(out)
    assert _snapshot(os.path.join(REPO, "csrc")) == before
