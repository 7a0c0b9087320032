"""The port's 25 Hz speech-tokenizer wrapper (``Qwen3TTSTokenizer`` on a
``qwen3_tts_tokenizer_25hz`` directory) against the JAX package's, on the CPU
in f32 (the 25 Hz scenarios of tests/test_tokenizer_wrapper.py).

Both packages read the same directories (``make_tame_v1_checkpoint`` at
``TINY_V1``, with the Whisper-VQ tensors of ``TINY`` and a CAM++-style
``campplus.onnx`` where the test needs them). The port's ``decode(seed=s)``
draws its initial noise with ``codec_v1.initial_noise`` on a generator
seeded by ``s``; the JAX decoder is handed that tensor as ``noise=``.
Waveforms lie within ``REL`` x max|JAX's|, codes are equal, reference mels
equal and x-vectors within 1e-5."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_codec_v1 import TINY_V1
from test_onnx_native import _make_tdnn_onnx
from test_whisper_vq import TINY as TINY_ENC
from torch_port_fixtures import make_tame_v1_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu.models import codec_v1 as jv1
from qwen_tts_tpu.tokenizer import Qwen3TTSTokenizer as JTokenizer
from qwen_tts_tpu_torch.io.wav import write_wav
from qwen_tts_tpu_torch.models.codec_v1 import initial_noise
from qwen_tts_tpu_torch.tokenizer import Qwen3TTSTokenizer as TTokenizer

REL = 1e-4
LENGTHS = (5, 3)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"enc": with Whisper-VQ and campplus.onnx, "plain": decoder only,
    "up32": decoder only, decode_upsample_rate 32 (twice what a code makes)}."""
    root = tmp_path_factory.mktemp("v1tok")
    out = {k: str(root / k) for k in ("enc", "plain", "up32")}
    make_tame_v1_checkpoint(out["enc"], TINY_V1, enc_cfg=TINY_ENC)
    blob, _, _ = _make_tdnn_onnx(np.random.default_rng(2))
    with open(os.path.join(out["enc"], "campplus.onnx"), "wb") as f:
        f.write(blob)
    make_tame_v1_checkpoint(out["plain"], TINY_V1)
    make_tame_v1_checkpoint(out["up32"], dataclasses.replace(TINY_V1, decode_upsample_rate=32))
    return out


@pytest.fixture(scope="module")
def toks(dirs):
    return {k: (JTokenizer.from_pretrained(d), TTokenizer.from_pretrained(d, device="cpu"))
            for k, d in dirs.items()}


def _payload(seed: int):
    r = np.random.default_rng(seed)
    dit = TINY_V1.dit
    return [{"audio_codes": r.integers(0, dit.num_embeds + 1, (n,)),
             "xvectors": r.standard_normal(dit.enc_emb_dim).astype(np.float32),
             "ref_mels": (0.3 * r.standard_normal((9 - i, dit.mel_dim))).astype(np.float32)}
            for i, n in enumerate(LENGTHS)]


def _jax_decode(jtok, payload, seed: int) -> np.ndarray:
    """The JAX decoder on the padded batch (codes -1, mels 0) under the
    noise the port's ``decode(seed=seed)`` draws."""
    b, t = len(payload), max(len(p["audio_codes"]) for p in payload)
    codes = np.full((b, t), -1, np.int32)
    mel = np.zeros((b, max(p["ref_mels"].shape[0] for p in payload), TINY_V1.dit.mel_dim),
                   np.float32)
    for i, p in enumerate(payload):
        codes[i, : len(p["audio_codes"])] = p["audio_codes"]
        mel[i, : p["ref_mels"].shape[0]] = p["ref_mels"]
    xv = np.stack([p["xvectors"] for p in payload])
    noise = initial_noise(b, t * TINY_V1.dit.repeats, TINY_V1.dit.mel_dim,
                          torch.Generator().manual_seed(seed))
    return np.asarray(jv1.codec_v1_decode(jtok.params, jtok.cfg, jnp.asarray(codes),
                                          jnp.asarray(xv), jnp.asarray(mel),
                                          jax.random.PRNGKey(0), noise=jnp.asarray(noise)))


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_from_pretrained_reads_the_config(toks):
    jtok, ttok = toks["plain"]
    for getter in ("get_model_type", "get_output_sample_rate", "get_input_sample_rate",
                   "get_decode_upsample_rate", "get_encode_downsample_rate"):
        assert getattr(ttok, getter)() == getattr(jtok, getter)(), getter
    assert ttok.get_model_type() == "qwen3_tts_tokenizer_25hz"
    assert ttok.device == torch.device("cpu")
    assert ttok.params["bigvgan"]["pre_w"].dtype == torch.float32


def test_from_pretrained_runs_on_cuda_unless_told(dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTokenizer.from_pretrained(dirs["plain"])


def test_decode_matches_jax_in_every_payload_form(toks):
    jtok, ttok = toks["plain"]
    payload = _payload(3)
    want = _jax_decode(jtok, payload, seed=5)
    forms = {
        "list of dicts": payload,
        "dict of lists": {k: [p[k] for p in payload] for k in payload[0]},
        "dict of arrays": {"audio_codes": [p["audio_codes"][None] for p in payload],
                           "xvectors": np.stack([p["xvectors"] for p in payload]),
                           "ref_mels": [p["ref_mels"] for p in payload]},
    }
    j_wavs, j_sr = jtok.decode(payload)
    for name, form in forms.items():
        wavs, sr = ttok.decode(form, seed=5)
        assert sr == j_sr == 24000, name
        for i, (w, n) in enumerate(zip(wavs, LENGTHS)):
            # Where decode_upsample_rate is what a code makes, the cut is JAX's.
            assert w.shape == j_wavs[i].shape == (n * 16,), name
            _close(w, want[i, : n * 16])
    other, _ = ttok.decode(payload, seed=6)
    assert not np.array_equal(other[0], ttok.decode(payload, seed=5)[0][0])


def test_trim_at_the_samples_a_code_makes(toks):
    """decode_upsample_rate 32 where a code makes 16 samples: the port cuts
    each row at 16 a code; JAX's cut at 32 keeps the short row's padding."""
    jtok, ttok = toks["up32"]
    assert ttok.get_decode_upsample_rate() == jtok.get_decode_upsample_rate() == 32
    assert ttok.cfg.samples_per_code == 16
    payload = _payload(7)
    full = _jax_decode(jtok, payload, seed=1)  # [B, 5 * 16]
    wavs, _ = ttok.decode(payload, seed=1)
    j_wavs, _ = jtok.decode(payload)
    for i, n in enumerate(LENGTHS):
        assert wavs[i].shape == (n * 16,)
        _close(wavs[i], full[i, : n * 16])
    assert j_wavs[1].shape == (min(3 * 32, full.shape[1]),) != wavs[1].shape


def test_encode_matches_jax_from_arrays_tuples_and_a_path(toks, tmp_path):
    jtok, ttok = toks["enc"]
    r = np.random.default_rng(9)
    a = (0.2 * np.sin(np.linspace(0, 400, 16000)) + 0.02 * r.standard_normal(16000)
         ).astype(np.float32)
    b = (0.3 * r.standard_normal(9000)).astype(np.float32)
    path = str(tmp_path / "clip.wav")
    write_wav(path, b, 24000)
    for args in (([a, b], 16000), ([(a, 16000), (b, 24000)],), (path,)):
        got, want = ttok.encode(*args), jtok.encode(*args)
        assert len(got["audio_codes"]) == len(want["audio_codes"])
        for g, w in zip(got["audio_codes"], want["audio_codes"]):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got["ref_mels"], want["ref_mels"]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got["xvectors"], want["xvectors"]):
            np.testing.assert_allclose(g, w, atol=1e-5)
    assert [c.shape[0] for c in ttok.encode([a, b], 16000)["audio_codes"]] == [25, 15]


def test_encode_without_campplus_gives_no_xvectors(toks, dirs, tmp_path):
    d = str(tmp_path / "no_onnx")
    shutil.copytree(dirs["enc"], d)
    os.remove(os.path.join(d, "campplus.onnx"))
    out = TTokenizer.from_pretrained(d, device="cpu").encode(
        [np.zeros(3000, np.float32)], 16000)
    assert out["xvectors"] is None and out["audio_codes"][0].shape == (5,)


def test_encode_without_encoder_tensors_fails_loudly(toks):
    _, ttok = toks["plain"]
    with pytest.raises(KeyError, match="encoder.tokenizer"):
        ttok.encode([np.zeros(1000, np.float32)], 16000)


def test_a_code_above_num_embeds_raises(toks):
    _, ttok = toks["plain"]
    payload = _payload(11)
    payload[1]["audio_codes"][2] = TINY_V1.dit.num_embeds + 3
    with pytest.raises(ValueError, match=f"code {TINY_V1.dit.num_embeds + 3} at \\(1, 2\\)"):
        ttok.decode(payload)
    with pytest.raises(ValueError, match="xvectors"):
        ttok.decode({"audio_codes": [p["audio_codes"] for p in payload]})
