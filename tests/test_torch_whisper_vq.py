"""The port's 25 Hz encoder (``qwen_tts_tpu_torch/models/whisper_vq.py``:
Whisper-VQ and the reference mel) against the JAX package's, on the CPU in
f32.

The weights are the JAX package's ``init_whisper_vq`` at ``TINY`` carried
across by ``convert_whisper_vq_tree``, and a checkpoint written by
``make_v1_checkpoint`` for the loader; inputs come from numpy seeds.
Features lie within ``REL`` x max|JAX's|; codes are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_codec_v1 import TINY_V1
from test_whisper_vq import TINY
from torch_port_fixtures import make_tame_v1_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.safetensors import MultiSafeTensors as JSafeTensors
from qwen_tts_tpu.models import whisper_vq as jwvq
from qwen_tts_tpu_torch.convert import convert_whisper_vq_tree
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models import whisper_vq as twvq

REL = 1e-4
T_CFG = twvq.WhisperVQConfig(**dataclasses.asdict(TINY))


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _clips():
    """Ragged 16 kHz clips: under one window, exactly one, and several with
    a ragged tail."""
    r = np.random.default_rng(11)
    out = []
    for n in (1500, 2 * TINY.n_window * twvq.HOP * 2, 9000, 16000):
        t = np.arange(n) / 16000
        out.append((0.2 * np.sin(2 * np.pi * r.uniform(100, 300) * t)
                    + 0.02 * r.standard_normal(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def enc():
    """(JAX params, the port's params on the CPU)."""
    jp = jwvq.init_whisper_vq(jax.random.PRNGKey(3), TINY)
    return jp, convert_whisper_vq_tree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_log_mel_and_reference_mel_equal_jax():
    for wav in _clips()[:3]:
        np.testing.assert_array_equal(twvq.whisper_log_mel(wav, 16, padding=320),
                                      jwvq.whisper_log_mel(wav, 16, padding=320))
        np.testing.assert_array_equal(twvq.v1_ref_mel(wav), jwvq.v1_ref_mel(wav))


def test_stem_trunk_and_vq_match_jax(enc):
    jp, tp = enc
    r = np.random.default_rng(12)
    mel = r.standard_normal((3, 2 * TINY.n_window, TINY.n_mels)).astype(np.float32)
    want = jwvq._conv_stem(jp, jnp.asarray(mel))
    got = twvq._conv_stem(tp, torch.from_numpy(mel))
    _close(got.numpy(), want)
    mask = np.ones((3, TINY.n_window), bool)
    mask[2, 5:] = False
    x = np.array(want)
    want = jwvq.encoder_trunk(jp, TINY, jnp.asarray(x), jnp.asarray(mask))
    got = twvq.encoder_trunk(tp, T_CFG, torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.numpy(), want)
    feats = r.standard_normal((40, TINY.n_state)).astype(np.float32)
    np.testing.assert_array_equal(twvq.vq_encode(tp, T_CFG, torch.from_numpy(feats)).numpy(),
                                  np.asarray(jwvq.vq_encode(jp, TINY, jnp.asarray(feats))))


def test_encode_waveforms_codes_equal_jax_on_ragged_clips(enc):
    jp, tp = enc
    clips = _clips()
    want = jwvq.encode_waveforms(jp, TINY, clips)
    got = twvq.encode_waveforms(tp, T_CFG, clips)
    for g, w, wav in zip(got, want, clips):
        assert g.dtype == np.int32 and g.shape == (-(-len(wav) // 640),)
        np.testing.assert_array_equal(g, w)
    assert len({int(c) for g in got for c in g}) > 4  # the codes vary


def test_bounded_groups_equal_one_call(enc):
    _, tp = enc
    clips = _clips()
    one = twvq.encode_features(tp, T_CFG, clips, group=10_000)
    for group in (1, 3):
        for a, b in zip(twvq.encode_features(tp, T_CFG, clips, group=group), one):
            _close(a.numpy(), b.numpy(), 1e-6)
        for a, b in zip(twvq.encode_waveforms(tp, T_CFG, clips, group=group),
                        twvq.encode_waveforms(tp, T_CFG, clips)):
            np.testing.assert_array_equal(a, b)


def test_no_waveforms_no_codes(enc):
    assert twvq.encode_waveforms(enc[1], T_CFG, []) == []


def test_loader_tree_equals_the_converted_jax_tree(tmp_path):
    d = str(tmp_path / "v1e")
    make_tame_v1_checkpoint(d, TINY_V1, enc_cfg=TINY)
    jst, tst = JSafeTensors(d), MultiSafeTensors(d)
    try:
        want = convert_whisper_vq_tree(
            jax.tree_util.tree_map(np.asarray, jwvq.load_whisper_vq(jst, TINY)), device="cpu")
        got = twvq.load_whisper_vq(tst, T_CFG, device="cpu")
    finally:
        jst.close()
        tst.close()
    flat_g = jax.tree_util.tree_flatten_with_path(got)
    flat_w = jax.tree_util.tree_flatten_with_path(want)
    assert [p for p, _ in flat_g[0]] == [p for p, _ in flat_w[0]]
    for (path, a), (_, b) in zip(flat_g[0], flat_w[0]):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), path
    assert got["conv1_w"].shape == (TINY.n_state, TINY.n_mels, 3)  # Conv1d [out, in, K]
