"""The port's speaker encoder (ECAPA-TDNN x-vector and its mel frontend)
against the JAX package's, on the CPU, in f32.

Both packages load the speaker encoder of one tiny Base checkpoint
(``make_clone_checkpoint``). Clips are made from a numpy seed:
1 s, 0.25 s, a 16 kHz clip resampled to 24 kHz, and a 1200-sample clip whose
mel has 4 frames, fewer than the dilated taps' reflect pad of 4 needs
(``F.pad(mode="reflect")`` would refuse it; numpy's reflect, and so the JAX
package's, reflects again off the far edge).

Tolerances: the filterbank bit for bit (numpy on both sides); log-mel within
1e-4 absolute (the two FFTs round differently); x-vectors within 1e-4
relative L2 (the convs sum in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (  # noqa: F401
    assert_same_tree, clone_checkpoint, numpy_tree, one_torch_thread)
from qwen_tts_tpu.audio import resample as j_resample
from qwen_tts_tpu.config import TTSConfig as JCfg
from qwen_tts_tpu.io.safetensors import MultiSafeTensors as JReader
from qwen_tts_tpu.models import speaker as j_spk
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch.convert import convert_encoder_tree
from qwen_tts_tpu_torch.models import speaker as t_spk
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

MEL_ATOL = 1e-4
XVEC_REL_L2 = 1e-4


def _clip(kind: str) -> np.ndarray:
    """A 24 kHz test clip: a chirp-like tone plus noise."""
    rng = np.random.default_rng({"1s": 0, "0.25s": 1, "16k": 2, "short": 3}[kind])
    if kind == "16k":
        n = 16000
        x = 0.2 * np.sin(np.linspace(0, 900, n)) + 0.05 * rng.standard_normal(n)
        return j_resample(x.astype(np.float32), 16000, 24000)
    n = {"1s": 24000, "0.25s": 6000, "short": 1200}[kind]
    x = 0.2 * np.sin(np.linspace(0, 0.05 * n, n) ** 1.2) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


CLIPS = ("1s", "0.25s", "16k", "short")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return clone_checkpoint(tmp_path_factory)


@pytest.fixture(scope="module")
def encoders(ckpt):
    """(cfg, JAX params, port params by the port's loader)."""
    cfg = JCfg.from_pretrained(ckpt).speaker_encoder
    st = JReader(ckpt)
    jp = j_spk.load_speaker_encoder(st, cfg)
    st.close()
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    return cfg, jp, tm.speaker_params


@pytest.mark.parametrize("args", [(24000, 1024, 128, 0.0, 12000.0),
                                  (24000, 1024, 16, 0.0, 12000.0),
                                  (16000, 512, 80, 20.0, None)])
def test_mel_filterbank_bit_for_bit(args):
    np.testing.assert_array_equal(t_spk.mel_filterbank(*args), j_spk.mel_filterbank(*args))


@pytest.mark.parametrize("n,left,right", [(10, 3, 4), (5, 4, 4), (4, 4, 4), (3, 7, 2),
                                          (2, 5, 5), (1, 2, 3), (6, 0, 0)])
def test_reflect_pad_matches_numpy_for_any_length(n, left, right):
    x = np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32)
    got = t_spk.reflect_pad(torch.from_numpy(x), left, right).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (0, 0), (left, right)), mode="reflect"))


@pytest.mark.parametrize("kind", CLIPS)
def test_log_mel_matches_jax(kind):
    wav = _clip(kind)[None]
    want = np.asarray(j_spk.mel_spectrogram(jnp.asarray(wav), num_mels=16))
    got = t_spk.mel_spectrogram(torch.from_numpy(wav), num_mels=16).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


def test_convert_agrees_with_loader(encoders):
    _, jp, tp = encoders
    converted = convert_encoder_tree(numpy_tree(jp), device="cpu")
    assert_same_tree(converted, tp)


@pytest.mark.parametrize("kind", CLIPS)
def test_speaker_encoder_forward_matches_jax(encoders, kind):
    cfg, jp, tp = encoders
    mels = np.asarray(j_spk.mel_spectrogram(jnp.asarray(_clip(kind)[None]), num_mels=16))
    want = np.asarray(j_spk.speaker_encoder_forward(jp, cfg, jnp.asarray(mels)))
    with torch.inference_mode():
        got = t_spk.speaker_encoder_forward(tp, cfg, torch.tensor(mels)).numpy()
    assert got.shape == want.shape == (1, cfg.enc_dim)
    assert np.linalg.norm(got - want) <= XVEC_REL_L2 * np.linalg.norm(want)


def test_extract_speaker_embedding_and_16k_prompt_match_jax(ckpt):
    jm = JaxModel.from_pretrained(ckpt, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    for kind in ("1s", "0.25s"):
        want = jm.extract_speaker_embedding(_clip(kind), 24000)
        got = tm.extract_speaker_embedding(_clip(kind), 24000)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.linalg.norm(got - want) <= XVEC_REL_L2 * np.linalg.norm(want)
    with pytest.raises(ValueError, match="24000 Hz"):
        tm.extract_speaker_embedding(_clip("1s"), 16000)
    # A 16 kHz reference goes through the resampler before the x-vector.
    rng = np.random.default_rng(5)
    wav16 = (0.2 * np.sin(np.linspace(0, 600, 12000))
             + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    want = jm.create_voice_clone_prompt((wav16, 16000), x_vector_only_mode=True)
    got = tm.create_voice_clone_prompt((wav16, 16000), x_vector_only_mode=True)
    assert got["ref_code"] == [None] and got["x_vector_only_mode"] == [True]
    a, b = got["ref_spk_embedding"][0], want["ref_spk_embedding"][0]
    assert np.linalg.norm(a - b) <= XVEC_REL_L2 * np.linalg.norm(b)

