"""The port's voice files, audio input and WAV IO against the JAX package's,
on the CPU. No model is needed: prompts are made from a numpy seed.

Voice files round-trip in both containers (``.pt``, the reference demo's
torch payload, loaded with ``weights_only=True``; ``.npz``), and a file
written by either package loads in the other to the same prompt, bit for
bit. ``audio.resample`` (scipy's polyphase filter with the same Kaiser
design) and the WAV reader and writer give the JAX package's bits."""

import base64
import io

import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu import audio as j_audio
from qwen_tts_tpu import voice_prompt as j_vp
from qwen_tts_tpu.io import wav as j_wav
from qwen_tts_tpu_torch import audio as t_audio
from qwen_tts_tpu_torch import voice_prompt as t_vp
from qwen_tts_tpu_torch.io import wav as t_wav


def _prompt(icl=(True, False), seed=0):
    """A prompt dict: one item per entry of ``icl`` (ICL or x-vector only)."""
    rng = np.random.default_rng(seed)
    p = {k: [] for k in ("ref_code", "ref_spk_embedding", "ref_text", "icl_mode",
                         "x_vector_only_mode")}
    for i, on in enumerate(icl):
        p["ref_code"].append(rng.integers(0, 2048, (7 + i, 16)).astype(np.int32) if on
                             else None)
        p["ref_spk_embedding"].append(rng.standard_normal(32).astype(np.float32))
        p["ref_text"].append(f"reference {i}" if on else None)
        p["icl_mode"].append(on)
        p["x_vector_only_mode"].append(not on)
    return p


def _assert_prompt_equal(a, b):
    assert set(a) == set(b)
    n = len(a["ref_spk_embedding"])
    assert all(len(a[k]) == len(b[k]) == n for k in a)
    for i in range(n):
        np.testing.assert_array_equal(a["ref_spk_embedding"][i], b["ref_spk_embedding"][i])
        assert b["ref_spk_embedding"][i].dtype == np.float32
        if a["ref_code"][i] is None:
            assert b["ref_code"][i] is None
        else:
            assert b["ref_code"][i].dtype == np.int32
            np.testing.assert_array_equal(a["ref_code"][i], b["ref_code"][i])
        for k in ("ref_text", "icl_mode", "x_vector_only_mode"):
            assert a[k][i] == b[k][i], k


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
def test_round_trip(tmp_path, suffix):
    p = _prompt()
    path = str(tmp_path / f"voice{suffix}")
    assert t_vp.save_voice_clone_prompt(p, path) == path
    _assert_prompt_equal(p, t_vp.load_voice_clone_prompt(path))


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_between_packages(tmp_path, suffix, writer):
    p = _prompt(seed=1)
    path = str(tmp_path / f"voice{suffix}")
    save, load = ((j_vp.save_voice_clone_prompt, t_vp.load_voice_clone_prompt)
                  if writer == "jax" else
                  (t_vp.save_voice_clone_prompt, j_vp.load_voice_clone_prompt))
    save(p, path)
    _assert_prompt_equal(p, load(path))


def test_reference_demo_payload_and_invalid_files(tmp_path):
    payload = {"items": [{
        "ref_code": torch.arange(12, dtype=torch.int64).reshape(3, 4),
        "ref_spk_embedding": torch.linspace(-1, 1, 8),
        "ref_text": "hello", "icl_mode": True, "x_vector_only_mode": False,
    }]}
    path = str(tmp_path / "demo.pt")
    torch.save(payload, path)
    _assert_prompt_equal(j_vp.load_voice_clone_prompt(path), t_vp.load_voice_clone_prompt(path))
    for bad, match in (({"nope": 1}, "items"), ({"items": []}, "empty"),
                       ({"items": {"a": 1}}, "not a list")):
        torch.save(bad, path)
        with pytest.raises(ValueError, match=match):
            t_vp.load_voice_clone_prompt(path)
    with pytest.raises(ValueError, match="ref_spk_embedding"):
        t_vp.save_voice_clone_prompt(dict(_prompt(), ref_spk_embedding=[None, None]), path)


def test_normalize_voice_clone_prompt_forms():
    """The dict of lists, one flat item, a list of items and an object with
    the item's attributes all normalize as in the JAX package."""
    p = _prompt((True,), seed=2)
    item = {k: v[0] for k, v in p.items()}

    class Item:
        pass

    obj = Item()
    for k, v in item.items():
        setattr(obj, k, v)
    for form in (p, item, [item], obj, [dict(item, ref_code=torch.from_numpy(item["ref_code"]))]):
        _assert_prompt_equal(j_vp.normalize_voice_clone_prompt(form),
                             t_vp.normalize_voice_clone_prompt(form))


@pytest.mark.parametrize("rates", [(16000, 24000), (44100, 24000), (24000, 16000),
                                   (22050, 24000), (24000, 24000)])
def test_resample_bit_for_bit(rates):
    x = np.random.default_rng(rates[0]).standard_normal(3001).astype(np.float32)
    got, want = t_audio.resample(x, *rates), j_audio.resample(x, *rates)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_audio_inputs_and_wav_io_match_jax(tmp_path):
    x = (0.5 * np.sin(np.linspace(0, 300, 2400))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    t_wav.write_wav(path, x, 16000)
    other = str(tmp_path / "b.wav")
    j_wav.write_wav(other, x, 16000)
    assert open(path, "rb").read() == open(other, "rb").read()
    b64 = "data:audio/wav;base64," + base64.b64encode(open(path, "rb").read()).decode()
    forms = [path, b64, (x, 16000), (np.stack([x, -x], axis=-1), 22050)]
    got, want = t_audio.normalize_audio_inputs(forms), j_audio.normalize_audio_inputs(forms)
    assert len(got) == len(want) == 4
    for (gw, gsr), (ww, wsr) in zip(got, want):
        assert gsr == wsr and gw.dtype == np.float32
        np.testing.assert_array_equal(gw, ww)
    wav, sr = t_wav.read_wav(io.BytesIO(open(path, "rb").read()))
    assert sr == 16000
    np.testing.assert_array_equal(wav, j_wav.read_wav(path)[0])
    with pytest.raises(ValueError, match="tuple"):
        t_audio.normalize_audio_inputs(x)
