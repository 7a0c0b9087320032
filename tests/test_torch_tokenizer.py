"""The port's 12 Hz speech-tokenizer wrapper (``Qwen3TTSTokenizer``) and its
resampler against the JAX package's, on the CPU in f32 (the 12 Hz scenarios
of tests/test_tokenizer_wrapper.py).

Both packages read the speech tokenizer of the shared clone checkpoint
(``make_clone_checkpoint``: random Mimi codebooks, so codes vary); codes and
clips come from a numpy seed. Decoded waveforms of random codes must lie
within 1e-5 of the JAX package's (those of encoded clips within the codec
tests' 1e-4), and encoded codes must equal its codes."""

import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from torch_port_fixtures import clone_checkpoint, one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu import audio as j_audio
from qwen_tts_tpu.io.wav import write_wav
from qwen_tts_tpu.tokenizer import Qwen3TTSTokenizer as JTokenizer
from qwen_tts_tpu_torch import audio as t_audio
from qwen_tts_tpu_torch.tokenizer import Qwen3TTSTokenizer as TTokenizer

# f32 on both sides: summation order only.
ATOL = 1e-5
# The decode of encoded codes, which sit at the clamp more often than random
# ones: the codec's bound in tests/test_torch_models.py.
CODEC_ATOL = 1e-4


def _wav(seed: int, n: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (0.3 * np.sin(np.linspace(0, n / 15, n)) + 0.05 * r.standard_normal(n)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(speech tokenizer dir, JAX tokenizer, port tokenizer on the CPU), both
    codecs tamed the same way."""
    d = os.path.join(clone_checkpoint(tmp_path_factory), "speech_tokenizer")
    jtok = JTokenizer.from_pretrained(d)
    ttok = TTokenizer.from_pretrained(d, device="cpu")
    jtok.params = tame_codec(jtok.params)
    ttok.params = tame_codec(ttok.params)
    return d, jtok, ttok


def test_from_pretrained_reads_the_config(tokenizers):
    _, jtok, ttok = tokenizers
    for getter in ("get_model_type", "get_output_sample_rate", "get_input_sample_rate",
                   "get_decode_upsample_rate", "get_encode_downsample_rate"):
        assert getattr(ttok, getter)() == getattr(jtok, getter)(), getter
    assert ttok.get_model_type() == "qwen3_tts_tokenizer_12hz"
    assert ttok.params["pre_conv_w"].dtype == torch.float32


def test_from_pretrained_runs_on_cuda_unless_told(tokenizers):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTokenizer.from_pretrained(tokenizers[0])


def test_decode_matches_jax_in_every_payload_form(tokenizers):
    _, jtok, ttok = tokenizers
    nq = ttok.cfg.decoder.num_quantizers
    r = np.random.default_rng(3)
    codes = [r.integers(0, ttok.cfg.decoder.codebook_size, (n, nq)) for n in (5, 3)]
    want, sr = jtok.decode({"audio_codes": codes})
    assert sr == 24000
    up = ttok.get_decode_upsample_rate()
    for payload in ({"audio_codes": codes}, [{"audio_codes": c} for c in codes]):
        got, got_sr = ttok.decode(payload)
        assert got_sr == sr and [w.shape for w in got] == [(5 * up,), (3 * up,)]
        for g, w in zip(got, want):
            assert 0.1 < (np.abs(g) < 1).mean()  # not clamped flat
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    with pytest.raises(TypeError):
        ttok.decode(codes[0])


def test_encode_matches_jax_and_round_trips(tokenizers, tmp_path):
    _, jtok, ttok = tokenizers
    clip24, clip16 = _wav(0, 6000), _wav(1, 3000)
    path = str(tmp_path / "ref.wav")
    write_wav(path, clip16, 16000)
    cases = [((clip24,), {"sample_rate": 24000}), (([clip24, clip24[:2500]],),
                                                   {"sample_rate": 24000}),
             (((clip16, 16000),), {}), (([(clip16, 16000), (clip24, 24000)],), {}),
             ((path,), {})]
    for args, kw in cases:
        want = jtok.encode(*args, **kw)["audio_codes"]
        got = ttok.encode(*args, **kw)
        assert len(got["audio_codes"]) == len(want)
        for g, w in zip(got["audio_codes"], want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        # encode's own output decodes, one clip per row, as JAX decodes it.
        wavs, _ = ttok.decode(got)
        for wav, c, jw in zip(wavs, got["audio_codes"], jtok.decode({"audio_codes": want})[0]):
            assert wav.shape == (c.shape[0] * ttok.get_decode_upsample_rate(),)
            np.testing.assert_allclose(wav, jw, atol=CODEC_ATOL, rtol=0)
    np.testing.assert_array_equal(ttok.load_audio(path, 24000), jtok.load_audio(path, 24000))
    with pytest.raises(ValueError, match="sample_rate"):
        ttok.encode(clip24)


# --------------------------------------------------------------------------
# Resampling without scipy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rates,n", [((16000, 24000), 4000), ((44100, 24000), 882)])
def test_resample_without_scipy(rates, n, monkeypatch):
    """``np.convolve`` takes one BLAS dot per output sample; with BLAS's
    threads on a crowded host each dot waits for its threads (39 s against
    0.35 s for the 44.1 kHz case here), so the test runs BLAS on one
    thread."""
    from scipy.signal import resample_poly

    wav = _wav(2, n)
    up, down = rates[1] // np.gcd(*rates), rates[0] // np.gcd(*rates)
    h = j_audio._design_kaiser(up, down)
    with threadpool_limits(limits=1):
        with_scipy = t_audio.resample(wav, *rates)
        np.testing.assert_array_equal(with_scipy, j_audio.resample(wav, *rates))
        monkeypatch.setitem(sys.modules, "scipy.signal", None)
        with pytest.raises(ImportError):
            import scipy.signal  # noqa: F401
        got = t_audio.resample(wav, *rates)
        np.testing.assert_array_equal(
            got, j_audio._resample_poly_np(np.asarray(wav, np.float64), up, down, h))
    assert got.dtype == np.float32 and got.shape == with_scipy.shape
    np.testing.assert_allclose(
        got, resample_poly(np.asarray(wav, np.float64), up, down, window=h), atol=1e-5, rtol=0)
