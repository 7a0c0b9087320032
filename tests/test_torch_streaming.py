"""Streaming synthesis through both packages on the tiny fixture: f32 talker,
greedy decoding, EOS banned so both run to the budget.

The port's ``stream_from_prompt`` must cut the same chunks from the same codes
as the JAX package's, with the same audio (f32 codec: within summation-order
noise; bf16 codec: within the bf16 codec's own distance, see
``test_torch_vocoder.py``), and its codes must equal the one-shot codes at
the stream's prompt bucket."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from test_torch_vocoder import CODEC_REL_L2, _rel_l2
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu import pipeline as j_pipeline
from qwen_tts_tpu.generate import batch_prompts as j_batch_prompts
from qwen_tts_tpu.generate import build_prompt as j_build_prompt
from qwen_tts_tpu.generate import generate_codes as j_generate_codes
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.convert import convert_tree
from qwen_tts_tpu_torch.generate import batch_prompts as t_batch_prompts
from qwen_tts_tpu_torch.generate import build_prompt as t_build_prompt
from qwen_tts_tpu_torch.generate import generate_codes as t_generate_codes
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

IDS = np.array([1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3])
MAX_NEW = 9
CHUNKING = dict(first_chunk_frames=2, chunk_frames=4, left_context_frames=3)
# f32 on both sides, summation order only (as tests/test_streaming.py).
F32_ATOL = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_streaming_ckpt"))
    make_checkpoint(d)
    return d


def _models(ckpt, codec_dtype):
    """JAX and port models with the same (tamed) codec parameters."""
    jm = JaxModel.from_pretrained(ckpt, talker_dtype=jnp.float32, load_tokenizer=False,
                                  codec_dtype={torch.float32: jnp.float32,
                                               torch.bfloat16: jnp.bfloat16}[codec_dtype])
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, codec_dtype=codec_dtype,
                                    device="cpu", load_tokenizer=False)
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = convert_tree(jax.tree_util.tree_map(np.asarray, jm.codec_params),
                                   torch.device("cpu"), codec_dtype)
    return jm, tm


@pytest.fixture(scope="module")
def f32_models(ckpt):
    return _models(ckpt, torch.float32)


def _params(model, max_new=MAX_NEW):
    p = model._merge_params(max_new_tokens=max_new)
    return dataclasses.replace(p, do_sample=False, subtalker_do_sample=False,
                               repetition_penalty=1.0, min_new_tokens=max_new + 1)


def _prompt(model):
    if isinstance(model, JaxModel):
        return j_build_prompt(model.talker_params, model.cfg, IDS, language="english",
                              speaker="serena", st_params=model.subtalker_params)
    return t_build_prompt(model.talker_params, model.cfg, IDS, language="english",
                          speaker="serena")


def _stream(model, monkeypatch, **kw):
    """The stream's chunks and every frame its segments generated (from
    each segment's ``num_gen`` delta)."""
    mod = j_pipeline if isinstance(model, JaxModel) else t_pipeline
    frames = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            state, seg = out[0], out[1]
            n = int(np.asarray(state.num_gen)[0])
            frames.extend(np.asarray(seg)[0, : n - len(frames)].astype(np.int64))
            return out
        return wrapped

    monkeypatch.setattr(mod, "_first_packet_program", recording(mod._first_packet_program))
    monkeypatch.setattr(mod, "decode_segment", recording(mod.decode_segment))
    chunks = [w for w, _ in model.stream_from_prompt(_prompt(model), _params(model),
                                                     **{**CHUNKING, **kw})]
    monkeypatch.undo()
    return chunks, np.stack(frames)


def _oneshot_codes(model):
    """generate_codes at the stream's prompt bucket (16)."""
    p = _params(model)
    if isinstance(model, JaxModel):
        e, m, t, _ = j_batch_prompts([_prompt(model)], bucket=16)
        out = j_generate_codes(
            model.talker_params, model.subtalker_params, model.cfg.talker,
            jnp.asarray(e, jnp.float32), jnp.asarray(m), jnp.asarray(t, jnp.float32),
            sampling=p.talker_sampling(), st_sampling=p.subtalker_sampling(),
            max_new_tokens=MAX_NEW, rng=jax.random.PRNGKey(0))
    else:
        e, m, t, _ = t_batch_prompts([_prompt(model)], bucket=16)
        out = t_generate_codes(
            model.talker_params, model.subtalker_params, model.cfg.talker, e, m, t,
            sampling=p.talker_sampling(), st_sampling=p.subtalker_sampling(),
            max_new_tokens=MAX_NEW, generator=None)
    return np.asarray(out.codes)[0, : int(np.asarray(out.num_gen)[0])].astype(np.int64)


def test_stream_matches_jax_and_oneshot(f32_models, monkeypatch):
    jm, tm = f32_models
    up = tm.cfg.codec.decode_upsample_rate
    j_chunks, j_frames = _stream(jm, monkeypatch)
    t_chunks, t_frames = _stream(tm, monkeypatch)
    # 8 frames emitted (the 9th, budget-exhausted, is dropped): 2 + 4 + 2.
    assert [c.shape[0] for c in t_chunks] == [c.shape[0] for c in j_chunks] == [
        2 * up, 4 * up, 2 * up]
    np.testing.assert_array_equal(t_frames, j_frames)
    emitted = sum(c.shape[0] for c in t_chunks) // up
    np.testing.assert_array_equal(t_frames[:emitted], _oneshot_codes(tm))
    np.testing.assert_array_equal(t_frames[:emitted], _oneshot_codes(jm))
    for t, j in zip(t_chunks, j_chunks):
        np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    assert 0.05 < np.mean(np.abs(np.concatenate(t_chunks)) < 1)


def test_stream_with_bf16_codec_matches_jax(ckpt, monkeypatch):
    jm, tm = _models(ckpt, torch.bfloat16)
    j_chunks, j_frames = _stream(jm, monkeypatch)
    t_chunks, t_frames = _stream(tm, monkeypatch)
    np.testing.assert_array_equal(t_frames, j_frames)
    assert [c.shape for c in t_chunks] == [c.shape for c in j_chunks]
    for t, j in zip(t_chunks, j_chunks):
        assert t.dtype == np.float32 and np.abs(t).max() <= 1
        assert _rel_l2(t, j) < CODEC_REL_L2


def test_decode_codes_bucket_equals_unbucketed(f32_models):
    _, tm = f32_models
    r = np.random.default_rng(4)
    g = tm.cfg.talker.num_code_groups
    codes = [r.integers(0, 64, (n, g)) for n in (5, 3)]
    plain = tm.decode_codes(codes)
    bucketed = tm.decode_codes(codes, bucket=8)
    for a, b, c in zip(plain, bucketed, codes):
        assert a.shape == b.shape == (c.shape[0] * tm.cfg.codec.decode_upsample_rate,)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_ref_codes_seed_the_history_only(f32_models, monkeypatch):
    """Reference codes condition the codec's left context; only the new
    frames' audio comes out, and it equals the JAX package's."""
    jm, tm = f32_models
    up = tm.cfg.codec.decode_upsample_rate
    ref = np.random.default_rng(5).integers(0, 64, (4, tm.cfg.talker.num_code_groups))
    j_chunks, _ = _stream(jm, monkeypatch, ref_codes=ref)
    t_chunks, _ = _stream(tm, monkeypatch, ref_codes=ref)
    assert sum(c.shape[0] for c in t_chunks) == (MAX_NEW - 1) * up
    assert [c.shape for c in t_chunks] == [c.shape for c in j_chunks]
    for t, j in zip(t_chunks, j_chunks):
        np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    plain, _ = _stream(tm, monkeypatch)
    assert not np.allclose(t_chunks[0], plain[0], atol=1e-3)  # the context mattered


def test_stream_in_int8_serving_mode(ckpt, monkeypatch):
    _, tm = _models(ckpt, torch.float32)
    tm.quantize_for_serving(talker=True, kv=True)
    chunks, frames = _stream(tm, monkeypatch)
    up = tm.cfg.codec.decode_upsample_rate
    assert [c.shape[0] for c in chunks] == [2 * up, 4 * up, 2 * up]
    assert frames.shape == (MAX_NEW, tm.cfg.talker.num_code_groups)
    assert all(np.isfinite(c).all() for c in chunks)
