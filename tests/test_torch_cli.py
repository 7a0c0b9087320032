"""The port's ``qwen-tts`` command line (``python -m qwen_tts_tpu_torch``) on
the tiny Base fixture, on the CPU, after tests/test_cli_clone.py: an ICL
clone and an x-vector-only clone write the WAV that the port's pipeline
gives for the same request (within one PCM16 step), a saved voice file
drives a second run to the same bits, and the flags are the JAX CLI's.

``from_pretrained`` is patched to load in f32 on the CPU with a fake
tokenizer, as the JAX test patches it; the CLI itself adds no device flag."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_voice_clone import FakeTokenizer
from torch_port_fixtures import clone_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu import cli as j_cli
from qwen_tts_tpu_torch import cli
from qwen_tts_tpu_torch.io.wav import read_wav, write_wav
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM16_ATOL = 1.1 / 32768


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return clone_checkpoint(tmp_path_factory)


@pytest.fixture()
def patched_cli(monkeypatch):
    orig = Qwen3TTSModel.from_pretrained.__func__

    def patched(cls, d, **kw):
        kw.setdefault("talker_dtype", torch.float32)
        kw.setdefault("device", "cpu")
        kw["load_tokenizer"] = False
        m = orig(cls, d, **kw)
        m.tokenizer = FakeTokenizer()
        return m

    monkeypatch.setattr(Qwen3TTSModel, "from_pretrained", classmethod(patched))
    return cli.main


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    wav = (0.1 * np.sin(np.linspace(0, 150, 960)) + 0.02 * rng.standard_normal(960)
           ).astype(np.float32)
    path = str(tmp_path_factory.mktemp("torch_cli_ref") / "ref.wav")
    write_wav(path, wav, 24000)
    return path, read_wav(path)[0]  # the WAV's own samples, as the CLI reads them


@pytest.mark.parametrize("mode", ["icl", "xvec"])
def test_cli_clone_matches_pipeline(ckpt, tmp_path, patched_cli, ref, mode):
    ref_path, ref_wav = ref
    out, voice = str(tmp_path / "clone.wav"), str(tmp_path / "voice.npz")
    flags = ["--ref-text", "ref"] if mode == "icl" else ["--x-vector-only"]
    assert patched_cli(["-d", ckpt, "--text", "hi", "-l", "english", "--ref-audio", ref_path,
                        *flags, "--save-voice", voice, "--greedy", "--max-tokens", "4",
                        "-o", out]) == 0

    model = Qwen3TTSModel.from_pretrained(ckpt)  # patched: f32, CPU, fake tokenizer
    prompt = (model.create_voice_clone_prompt(ref_wav, ref_text="ref") if mode == "icl"
              else model.create_voice_clone_prompt(ref_wav, x_vector_only_mode=True))
    want, sr = model.generate_voice_clone("hi", prompt, language="english", max_new_tokens=4,
                                          do_sample=False, subtalker_dosample=False,
                                          repetition_penalty=1.0)
    got, got_sr = read_wav(out)
    assert got_sr == sr and got.shape == want[0].shape
    np.testing.assert_allclose(got, want[0], atol=PCM16_ATOL, rtol=0)

    # The saved voice file drives a second run without the reference audio.
    out2 = str(tmp_path / "clone2.wav")
    assert patched_cli(["-d", ckpt, "--text", "hi", "-l", "english", "--voice-file", voice,
                        "--greedy", "--max-tokens", "4", "-o", out2]) == 0
    np.testing.assert_array_equal(read_wav(out2)[0], got)


def test_flags_are_the_jax_cli_flags():
    def flags(parser):
        return sorted((tuple(a.option_strings), a.dest, a.default)
                      for a in parser._actions)

    assert flags(cli.build_argparser()) == flags(j_cli.build_argparser())


def test_module_entry_point_runs_the_cli():
    out = subprocess.run([sys.executable, "-m", "qwen_tts_tpu_torch", "--help"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--ref-audio", "--ref-text", "--x-vector-only", "--voice-file",
                 "--save-voice", "--greedy"):
        assert flag in out.stdout


def test_console_scripts_resolve_to_the_ports_mains():
    """``pyproject.toml`` names the port's three commands beside the JAX
    package's, and each target imports to a callable ``main`` of the port."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if v.startswith("qwen_tts_tpu_torch.")}
    assert port == {"qwen-tts-torch": "qwen_tts_tpu_torch.cli:main",
                    "qwen-tts-torch-serve": "qwen_tts_tpu_torch.server:main",
                    "qwen-tts-torch-demo": "qwen_tts_tpu_torch.demo:main"}
    assert {k: v for k, v in scripts.items() if k not in port} == {
        "qwen-tts": "qwen_tts_tpu.cli:main", "qwen-tts-serve": "qwen_tts_tpu.server:main",
        "qwen-tts-demo": "qwen_tts_tpu.demo:main"}
    for target in port.values():
        module, attr = target.split(":")
        fn = getattr(importlib.import_module(module), attr)
        assert callable(fn) and fn.__module__ == module, target
