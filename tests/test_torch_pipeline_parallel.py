"""The port's two-stage talker | codec pipeline (``parallel/pipeline.py``)
against the JAX package's ``TwoStagePipeline`` on the tiny fixture, f32:
the same codes, the same waveform within 1e-4 (``WAV_ATOL``: the port's
f32 codec tolerance across frameworks; measured 2.8e-5, above the 1e-5 the
JAX package's own pipeline test holds), chunks that follow the segments, and
the budget rule (11 requested frames give 10 emitted). Both stages on the CPU
(the one-card run is ``chip_smoke.py``'s phase 16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.generate import GenerationParams as JParams
from qwen_tts_tpu.generate import build_prompt as j_build_prompt
from qwen_tts_tpu.parallel.pipeline import TwoStagePipeline as JPipeline
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch.generate import GenerationParams as TParams
from qwen_tts_tpu_torch.generate import build_prompt as t_build_prompt
from qwen_tts_tpu_torch.parallel.pipeline import TwoStagePipeline
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

# Waveforms, f32: the codes behind them are equal (held exactly), so these
# are the codec's summation order over windows of other lengths (against the
# port's one-device decode) and across frameworks (against JAX): the port's
# codec tolerance (``tests/test_torch_streaming.py``'s F32_ATOL). Each chunk
# is the bits of its own window's ``codec_decode``.
WAV_ATOL = 1e-4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pp_torch_ckpt"))
    make_checkpoint(d)
    jm = JaxModel.from_pretrained(d, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(d, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = tame_codec(tm.codec_params)
    return jm, tm


def _greedy(module, frames):
    return module(max_new_tokens=frames, min_new_tokens=frames, do_sample=False,
                  subtalker_do_sample=False, repetition_penalty=1.0)


def _prompts(models, ids):
    jm, tm = models
    kw = dict(language="english", speaker="aiden")
    return (j_build_prompt(jm.talker_params, jm.cfg, ids, st_params=jm.subtalker_params, **kw),
            t_build_prompt(tm.talker_params, tm.cfg, ids, st_params=tm.subtalker_params, **kw))


def test_two_stage_pipeline_matches_jax_and_one_device(models):
    jm, tm = models
    jp, tp = _prompts(models, np.asarray([1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3], np.int32))
    want = JPipeline(jm, segment_frames=5).synthesize(jp, _greedy(JParams, 12))
    pp = TwoStagePipeline(tm, dev_talker="cpu", dev_codec="cpu", segment_frames=5)
    assert pp.talker_params is tm.talker_params  # already on the stage's device
    got = pp.synthesize(tp, _greedy(TParams, 12))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=WAV_ATOL)
    codes, _ = tm.generate_codes_from_prompts([tp], _greedy(TParams, 12))
    j_codes, _ = jm.generate_codes_from_prompts([jp], _greedy(JParams, 12))
    nq = tm.cfg.codec.decoder.num_quantizers
    np.testing.assert_array_equal(pp.codes, codes[0][:, :nq])
    np.testing.assert_array_equal(pp.codes, np.asarray(j_codes[0])[:, :nq])
    np.testing.assert_allclose(got, tm.decode_codes(codes)[0], atol=WAV_ATOL)


def test_two_stage_pipeline_streams_chunks(models):
    jm, tm = models
    jp, tp = _prompts(models, np.asarray([1, 2, 3, 10, 11, 4, 5, 1, 2, 3], np.int32))
    chunks = list(TwoStagePipeline(tm, "cpu", "cpu", segment_frames=4).stream(
        tp, _greedy(TParams, 11)))
    want = list(JPipeline(jm, segment_frames=4).stream(jp, _greedy(JParams, 11)))
    up = tm.cfg.codec.decode_upsample_rate
    assert len(chunks) == len(want) >= 2
    assert sum(c.shape[0] for c in chunks) == 10 * up
    for c, w in zip(chunks, want):
        np.testing.assert_allclose(c, np.asarray(w), atol=WAV_ATOL)


def test_two_stage_pipeline_needs_two_cards_without_devices(models):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    with pytest.raises(ValueError, match="2-stage pipeline needs >= 2 devices"):
        TwoStagePipeline(models[1])

