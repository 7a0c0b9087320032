"""The port's Mimi encoder and ``SpeechTokenizerEncoder`` against the JAX
package's, on the CPU, in f32.

Both packages load the encoder of one tiny Base checkpoint
(``make_clone_checkpoint``: Mimi weights from ``transformers``, random
codebooks);
clips come from a numpy seed. The codes must agree at >= 0.99, and where a
quantizer branch of a frame first parts the two codes must be a near-tie:
their distances, on the port's shared residual, within 1e-5 relative
(``code_disagreements``; the branch's later codes follow from that pick).
The encoder's trims and padding are held exactly: each clip's codes cut to
``ceil(n / downsample_rate)`` frames, and unchanged by its batch-mates and
its right padding."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import code_disagreements
from ckpt_fixture import TINY_MIMI_CONFIG
from torch_port_fixtures import (  # noqa: F401
    assert_same_tree, clone_checkpoint, numpy_tree, one_torch_thread)
from qwen_tts_tpu.codec_encoder import SpeechTokenizerEncoder as JEncoder, _jit_mimi_encode
from qwen_tts_tpu.io.safetensors import MultiSafeTensors as JReader
from qwen_tts_tpu.models import mimi_encoder as j_mimi
from qwen_tts_tpu_torch.codec_encoder import SpeechTokenizerEncoder as TEncoder
from qwen_tts_tpu_torch.convert import convert_encoder_tree
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors as TReader
from qwen_tts_tpu_torch.models import mimi_encoder as t_mimi

MIN_AGREEMENT = 0.99
NEAR_TIE_REL = 1e-5


def _wav(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(np.linspace(0, n / 15, n)) + 0.05 * rng.standard_normal(n)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    st_dir = os.path.join(clone_checkpoint(tmp_path_factory), "speech_tokenizer")
    cfg_j = j_mimi.MimiEncoderConfig.from_dict(TINY_MIMI_CONFIG)
    cfg_t = t_mimi.MimiEncoderConfig.from_dict(TINY_MIMI_CONFIG)
    st = JReader(st_dir)
    jp = j_mimi.load_mimi_encoder(st, cfg_j)
    st.close()
    st = TReader(st_dir)
    tp = t_mimi.load_mimi_encoder(st, cfg_t, torch.device("cpu"))
    st.close()
    return st_dir, cfg_j, jp, cfg_t, tp


def test_config_matches_jax():
    assert (t_mimi.MimiEncoderConfig.from_dict(TINY_MIMI_CONFIG).__dict__
            == j_mimi.MimiEncoderConfig.from_dict(TINY_MIMI_CONFIG).__dict__)
    assert t_mimi.MimiEncoderConfig().__dict__ == j_mimi.MimiEncoderConfig().__dict__


def test_convert_agrees_with_loader(setup):
    _, _, jp, _, tp = setup
    assert_same_tree(convert_encoder_tree(numpy_tree(jp), device="cpu"), tp)


def _hold_codes(cfg_t, tp, wav, got, want):
    """Agreement >= 0.99 and every first disagreement a near-tie."""
    assert got.shape == want.shape
    agreement, gaps = code_disagreements(
        tp, cfg_t, torch.tensor(wav), torch.tensor(got), torch.tensor(want))
    assert agreement >= MIN_AGREEMENT, agreement
    assert (gaps <= NEAR_TIE_REL).all(), gaps.tolist()
    return agreement


@pytest.mark.parametrize("case", ["one_clip", "batch_of_two", "four_quantizers"])
def test_mimi_encode_matches_jax(setup, case):
    _, cfg_j, jp, cfg_t, tp = setup
    wav, nq = {"one_clip": (_wav(0, 3000)[None], None),
               "batch_of_two": (np.stack([_wav(1, 2400), _wav(2, 2400)]), None),
               "four_quantizers": (_wav(3, 4800)[None], 4)}[case]
    want = np.asarray(_jit_mimi_encode()(jp, cfg_j, jnp.asarray(wav), num_quantizers=nq))
    with torch.inference_mode():
        got = t_mimi.mimi_encode(tp, cfg_t, torch.from_numpy(wav), num_quantizers=nq).numpy()
    assert got.shape[1] == (nq or cfg_t.num_quantizers)
    assert ((got >= 0) & (got < cfg_t.codebook_size)).all()
    _hold_codes(cfg_t, tp, wav, got, want)


def test_code_disagreements_shows_a_planted_flip(setup):
    """The near-tie check sees a code that is not a tie: a planted flip of an
    acoustic code has a large gap."""
    _, _, _, cfg_t, tp = setup
    wav = torch.from_numpy(_wav(4, 2400)[None])
    codes = t_mimi.mimi_encode(tp, cfg_t, wav)
    flipped = codes.clone()
    flipped[0, 2, 3] = (flipped[0, 2, 3] + 1) % cfg_t.codebook_size
    agreement, gaps = code_disagreements(tp, cfg_t, wav, codes, flipped)
    assert agreement == pytest.approx(1 - 1 / codes.numel())
    assert gaps.shape == (1,) and gaps[0] > 1e-3


def test_speech_tokenizer_encoder_trims_and_pads_as_jax(setup):
    st_dir, _, _, cfg_t, tp = setup
    je = JEncoder.from_pretrained(st_dir)
    te = TEncoder.from_pretrained(st_dir, device="cpu")
    assert (te.valid_num_quantizers, te.input_sample_rate, te.downsample_rate) == (
        je.valid_num_quantizers, je.input_sample_rate, je.downsample_rate)
    bucket = te.downsample_rate * 8
    wavs = [_wav(5, bucket // 3), _wav(6, bucket + 7), _wav(7, 100)]
    want, got = je.encode(wavs, 24000), te.encode(wavs, 24000)
    for w, g, x in zip(want, got, wavs):
        assert g.dtype == np.int32
        assert g.shape == w.shape == (-(-x.shape[0] // te.downsample_rate),
                                      min(te.valid_num_quantizers, cfg_t.num_quantizers))
        padded = np.zeros((1, 2 * bucket), np.float32)
        padded[0, : x.shape[0]] = x
        _hold_codes(cfg_t, tp, padded, _frames(g, padded, te), _frames(w, padded, te))
    # A 16 kHz clip is resampled to the encoder's rate first, as in JAX.
    w16 = _wav(8, 1600)
    np.testing.assert_array_equal(te.encode([w16], 16000)[0], je.encode([w16], 16000)[0])


def _frames(codes: np.ndarray, padded: np.ndarray, enc) -> np.ndarray:
    """A clip's trimmed [T, Q] codes laid into the port's [1, Q, T'] encode
    of the clip zero-padded (the gap check takes whole encodes; the frames
    past the clip are the same on both sides)."""
    full = t_mimi.mimi_encode(enc.params, enc.cfg, torch.from_numpy(padded))
    full = full[:, : codes.shape[1]].numpy().astype(np.int32)
    full[0, :, : codes.shape[0]] = codes.T
    return full


def test_codes_do_not_change_with_batch_mates_or_padding(setup):
    st_dir = setup[0]
    te = TEncoder.from_pretrained(st_dir, device="cpu")
    bucket = te.downsample_rate * 8
    w1, w2, w3 = _wav(9, bucket // 3), _wav(10, bucket // 2 + 7), _wav(11, 2 * bucket + 5)
    alone = te.encode([w1], 24000)[0]
    for mates in ([w2], [w3], [w2, w3]):
        np.testing.assert_array_equal(te.encode([w1] + mates, 24000)[0], alone)
        np.testing.assert_array_equal(te.encode(mates + [w1], 24000)[-1], alone)


@pytest.mark.parametrize("rates", [(24000, 16000), (16000, 24000), (22050, 24000),
                                   (24000, 24000)])
def test_resample_linear_equals_jax(rates):
    """The cold-path linear resampler, bit for bit the JAX package's."""
    from qwen_tts_tpu.codec_encoder import resample_linear as j_resample
    from qwen_tts_tpu_torch.codec_encoder import resample_linear

    wav = np.random.default_rng(sum(rates)).standard_normal(1001).astype(np.float32)
    got, want = resample_linear(wav, *rates), j_resample(wav, *rates)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
