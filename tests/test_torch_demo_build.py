"""The port's Gradio demo (``qwen_tts_tpu_torch/demo.py``): the five cases of
tests/test_demo_build.py against the port, under a copy of that file's
gradio stand-in (gradio is not installed here). Every tab's callback (clone,
custom voice, save voice, load voice and generate) runs against the shared
clone checkpoint, f32 on the CPU, and its audio equals the port's direct
``Qwen3TTSModel`` call with the same arguments and seed, bit for bit; the
parser's surface equals the JAX package's ``build_parser()``."""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from torch_port_fixtures import clone_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu import demo as j_demo
from qwen_tts_tpu_torch import demo as demo_mod
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel


class _Component:
    def __init__(self, *a, **k):
        self.args = a
        self.kwargs = k


class _Button(_Component):
    def click(self, fn, inputs, outputs):
        _REGISTRY.append((fn, inputs, outputs))


_REGISTRY = []


class _Ctx:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def gradio_stub(monkeypatch):
    gr = types.ModuleType("gradio")
    gr.Blocks = gr.Tab = gr.Tabs = gr.Row = gr.Column = _Ctx
    for name in ("Markdown", "Textbox", "Dropdown", "Slider", "Checkbox", "Audio", "File"):
        setattr(gr, name, _Component)
    gr.Button = _Button
    monkeypatch.setitem(sys.modules, "gradio", gr)
    _REGISTRY.clear()
    return gr


@pytest.fixture(scope="module")
def base_model(tmp_path_factory):
    return Qwen3TTSModel.from_pretrained(clone_checkpoint(tmp_path_factory),
                                         talker_dtype=torch.float32, device="cpu",
                                         load_tokenizer=False)


# (max_new_tokens, temperature, top_k, top_p, repetition_penalty)
CTL = (5, 0.9, 2, 1.0, 1.0)
CTL_KW = dict(max_new_tokens=5, temperature=0.9, top_k=2, top_p=1.0, repetition_penalty=1.0)


def _ref_pcm16():
    rng = np.random.default_rng(0)
    ref_wav = (0.2 * rng.standard_normal(16000)).astype(np.float32)
    return (16000, (ref_wav * 32767).astype(np.int16))


def _patch_ids(monkeypatch, model):
    monkeypatch.setattr(
        model, "_tokenize",
        lambda s: np.array([1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3], np.int32),
    )


def _direct_prompt(model):
    wav, sr = demo_mod.audio_to_pair(_ref_pcm16())
    return model.create_voice_clone_prompt((wav, sr), ref_text="reference transcript",
                                           sample_rate=None, x_vector_only_mode=False)


def test_demo_base_clone_callback_end_to_end(base_model, monkeypatch, gradio_stub):
    assert demo_mod.detect_model_kind(base_model) == "base"
    _patch_ids(monkeypatch, base_model)
    demo_mod.build_demo(base_model)
    # Clone tab + Save/Load tab register 3 callbacks.
    assert len(_REGISTRY) == 3
    run_clone = _REGISTRY[0][0]

    (sr, wav), status = run_clone(
        _ref_pcm16(), "reference transcript", False, "text to speak", "english", *CTL)
    assert status == "Finished."
    assert sr == 24000
    assert wav.ndim == 1 and wav.shape[0] > 0 and np.isfinite(wav).all()
    want, want_sr = base_model.generate_voice_clone(
        "text to speak", _direct_prompt(base_model), "english", **CTL_KW)
    assert want_sr == sr
    np.testing.assert_array_equal(wav, want[0])

    # Errors surface in the Status box, not as exceptions.
    out, status = run_clone(None, "t", False, "text", "english", *CTL)
    assert out is None and "required" in status


def test_demo_save_load_voice_tab(base_model, monkeypatch, gradio_stub):
    _patch_ids(monkeypatch, base_model)
    demo_mod.build_demo(base_model)
    save_voice = _REGISTRY[1][0]
    load_and_gen = _REGISTRY[2][0]

    path, status = save_voice(_ref_pcm16(), "reference transcript", False)
    assert status == "Finished." and path.endswith(".pt")

    (sr, wav), status = load_and_gen(path, "text to speak", "english")
    assert status == "Finished."
    assert sr == 24000 and wav.shape[0] > 0 and np.isfinite(wav).all()
    want, _ = base_model.generate_voice_clone(
        "text to speak", base_model.load_voice_clone_prompt(path), "english")
    np.testing.assert_array_equal(wav, want[0])

    # Missing file / missing text are reported, not raised.
    out, status = load_and_gen(None, "text", "english")
    assert out is None and "required" in status
    out, status = load_and_gen(path, "  ", "english")
    assert out is None and "required" in status


def test_demo_custom_voice_callback(base_model, monkeypatch, gradio_stub):
    monkeypatch.setattr(
        base_model, "cfg",
        dataclasses.replace(base_model.cfg, tts_model_type="custom_voice"),
    )
    _patch_ids(monkeypatch, base_model)
    demo_mod.build_demo(base_model)
    run_cv = _REGISTRY[0][0]
    (sr, wav), status = run_cv("hello there", "aiden", "english", *CTL)
    assert status == "Finished."
    assert sr == 24000
    assert wav.shape[0] > 0 and np.isfinite(wav).all()
    want, _ = base_model.generate_custom_voice("hello there", "aiden", "english", **CTL_KW)
    np.testing.assert_array_equal(wav, want[0])


def test_normalize_gradio_audio_int_dtypes():
    from qwen_tts_tpu_torch.demo import normalize_gradio_audio

    y = normalize_gradio_audio(np.array([-32768, 0, 32767], np.int16))
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, [-1.0, 0.0, 32767 / 32768], atol=1e-6)
    y = normalize_gradio_audio(np.array([0, 128, 255], np.uint8))
    np.testing.assert_allclose(y, [-1.0, 0.0, 127 / 128], atol=1e-6)
    y = normalize_gradio_audio(np.array([[2.0, 0.0], [0.0, -2.0]]))
    assert y.shape == (2,) and np.abs(y).max() <= 1.0
    for x in (np.array([-32768, 5, 32767], np.int16), np.array([3, 200], np.uint8),
              np.array([[2.0, 0.5], [0.1, -2.0]], np.float32)):
        np.testing.assert_array_equal(normalize_gradio_audio(x), j_demo.normalize_gradio_audio(x))


def _surface(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type, a.nargs,
                   tuple(a.choices) if a.choices else None) for a in parser._actions)


def test_demo_parser_reference_surface():
    from qwen_tts_tpu_torch.demo import build_parser, collect_gen_defaults

    assert _surface(build_parser()) == _surface(j_demo.build_parser())
    args = build_parser().parse_args([
        "/tmp/ckpt", "--temperature", "0.7", "--subtalker-top-k", "8",
        "--ip", "0.0.0.0", "--port", "8000",
    ])
    assert args.checkpoint_pos == "/tmp/ckpt"
    assert args.host == "0.0.0.0" and args.port == 8000
    gd = collect_gen_defaults(args)
    assert gd == {"temperature": 0.7, "subtalker_top_k": 8}
    args = build_parser().parse_args(["-d", "/x"])
    assert args.checkpoint == "/x"


def test_main_without_gradio_prints_the_install_hint(monkeypatch, capsys):
    """JAX's hint, naming the port's CLI and server; exit code 3; nothing
    is loaded."""
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    assert j_demo.main(["/no/such/ckpt"]) == 3
    want = capsys.readouterr().err
    assert demo_mod.main(["/no/such/ckpt"]) == 3
    got = capsys.readouterr().err
    assert "pip install gradio" in got
    assert got == want.replace("qwen_tts_tpu.", "qwen_tts_tpu_torch.")
