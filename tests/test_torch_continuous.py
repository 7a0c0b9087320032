"""The port's continuous-batching engine on the tiny clone fixture, f32, on the
CPU (the scenarios of tests/test_continuous.py, test_continuous_streaming.py,
test_multi_bucket.py and the engine case of test_kv_int8.py).

Each finished request's codes, as the engine hands them to the codec, must
equal the JAX package's greedy codes for the same request alone
(``jax_solo_codes``: ``generate_codes_from_prompts`` at the engine's
ceiling), whatever else shares the pool: requests joining mid-decode,
sampled neighbours, slot reuse, several prefill buckets, ICL clones, the
int8 KV cache. One scenario runs the JAX package's own engine and must give
the same codes. Streamed audio is held to the one-shot decode of those codes
within 1e-4 (re-decoded left context, as the JAX tests allow). Every engine
stops in a ``finally``; every wait has a time limit."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from torch_port_fixtures import (  # noqa: F401
    DecodedCodes,
    SERVING_BUCKET,
    SERVING_CEILING,
    clone_checkpoint,
    greedy_params,
    jax_solo_codes,
    one_torch_thread,
    serving_models,
)
from qwen_tts_tpu.continuous import ContinuousBatchingEngine as JaxEngine
from qwen_tts_tpu_torch import continuous as t_continuous
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

IDS_A = [1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3]
IDS_B = [1, 2, 3, 20, 21, 22, 23, 24, 4, 5, 1, 2, 3]
WAIT = 120  # seconds any future or event may take


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


@pytest.fixture(scope="module")
def solo(models):
    """JAX solo codes, computed once per (ids, frames, kv_int8)."""
    jm, _ = models
    cache = {}

    def codes(ids, frames):
        key = (tuple(ids), frames, jm.kv_int8)
        if key not in cache:
            cache[key] = jax_solo_codes(jm, ids, frames)
        return cache[key]

    return codes


def _prompt(tm, ids):
    return t_generate.build_prompt(tm.talker_params, tm.cfg, np.asarray(ids), language="english",
                                   speaker="aiden")


def _engine(tm, **kw):
    kw = dict(dict(num_slots=3, segment_frames=2, max_new_tokens=SERVING_CEILING,
                   prefill_bucket=SERVING_BUCKET, trailing_cap=32), **kw)
    return ContinuousBatchingEngine(tm, **kw)


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _assert_codes(recorded, wanted):
    """Each wanted code array was decoded, and nothing else (any order)."""
    assert len(recorded) == len(wanted)
    left = list(recorded)
    for w in wanted:
        hit = [i for i, r in enumerate(left) if r.shape == w.shape and np.array_equal(r, w)]
        assert hit, f"codes {w[:2].tolist()}... not decoded; got {[r[:2].tolist() for r in left]}"
        left.pop(hit[0])


def test_continuous_matches_jax_solo_greedy(models, solo):
    """The second request joins while the first decodes."""
    _, tm = models
    up = tm.cfg.codec.decode_upsample_rate
    engine = _engine(tm).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut1 = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 6))
            _wait_for(lambda: engine.stats["segments"] >= 1, "the first segment")
            fut2 = engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6))
            wavs = [fut1.result(timeout=WAIT), fut2.result(timeout=WAIT)]
    finally:
        engine.stop()
    _assert_codes(recorded, [solo(IDS_A, 6), solo(IDS_B, 6)])
    assert [w.shape for w in wavs] == [(6 * up,)] * 2
    np.testing.assert_allclose(wavs[0], tm.decode_codes([solo(IDS_A, 6)])[0], atol=1e-5)
    assert engine.stats["requests"] == 2 and engine.stats["bucket_admits"] == {32: 2}


def test_continuous_matches_the_jax_engine(models, solo):
    """The JAX package's own engine, same requests and settings: the same
    codes, and waveforms within the f32 codec tolerance."""
    jm, tm = models
    runs = {}
    for name, model, engine_cls in (("jax", jm, JaxEngine),
                                    ("torch", tm, ContinuousBatchingEngine)):
        engine = engine_cls(model, num_slots=2, segment_frames=2,
                            max_new_tokens=SERVING_CEILING, prefill_bucket=SERVING_BUCKET,
                            trailing_cap=32).start()
        try:
            with DecodedCodes(model) as recorded:
                futs = [engine.submit_ids(np.asarray(ids, np.int32), speaker="aiden",
                                          language="english", do_sample=False,
                                          subtalker_dosample=False, repetition_penalty=1.0,
                                          max_new_tokens=frames + 1)
                        for ids, frames in ((IDS_A, 5), (IDS_B, 3))]
                wavs = [f.result(timeout=WAIT) for f in futs]
        finally:
            engine.stop()
        runs[name] = (recorded, wavs)
    # The JAX package's _merge_params drops min_new_tokens and the port's
    # takes it (ROADMAP.md §3); here neither request passes it, so both take
    # the default of 2 and may stop at EOS: compare what they decoded.
    (j_codes, j_wavs), (t_codes, t_wavs) = runs["jax"], runs["torch"]
    _assert_codes(t_codes, j_codes)
    for a, b in zip(t_wavs, j_wavs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("who", ["talker", "subtalker"])
def test_sampled_neighbour_leaves_a_greedy_slot_exact(models, solo, who):
    """A sampled request admitted first (talker or sub-talker sampling, per
    row) beside a greedy one: the greedy slot keeps its solo codes."""
    _, tm = models
    if who == "talker":
        sampled = greedy_params(t_generate, 5, do_sample=True, temperature=1.3, top_k=8)
    else:
        sampled = greedy_params(t_generate, 5, subtalker_do_sample=True,
                                subtalker_temperature=1.5, subtalker_top_k=4)
    sampled = dataclasses.replace(sampled, seed=13)
    engine = _engine(tm, num_slots=2).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut_s = engine.submit_prompt(_prompt(tm, [1, 2, 3, 30, 31, 32, 4, 5, 1, 2, 3]),
                                         sampled)
            fut_g = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 5))
            wav_s, wav_g = fut_s.result(timeout=WAIT), fut_g.result(timeout=WAIT)
    finally:
        engine.stop()
    up = tm.cfg.codec.decode_upsample_rate
    assert wav_s.shape == wav_g.shape == (5 * up,) and np.isfinite(wav_s).all()
    assert any(np.array_equal(r, solo(IDS_A, 5)) for r in recorded)
    vocab = tm.cfg.talker.code_predictor.vocab_size
    assert all(((r >= 0) & (r < max(vocab, tm.cfg.talker.vocab_size))).all() for r in recorded)


def test_many_requests_reuse_slots(models, solo):
    _, tm = models
    ids = [[1, 2, 3, 10 + i, 11 + i, 4, 5, 1, 2, 3] for i in range(5)]
    engine = _engine(tm, num_slots=2).start()
    try:
        with DecodedCodes(tm) as recorded:
            futs = [engine.submit_prompt(_prompt(tm, x), greedy_params(t_generate, 3))
                    for x in ids]  # more requests than slots
            wavs = [f.result(timeout=WAIT) for f in futs]
    finally:
        engine.stop()
    up = tm.cfg.codec.decode_upsample_rate
    assert all(w.shape == (3 * up,) and np.isfinite(w).all() for w in wavs)
    _assert_codes(recorded, [solo(x, 3) for x in ids])
    assert engine.stats["requests"] == 5


def test_streaming_slot_matches_the_one_shot_decode(models, solo):
    _, tm = models
    chunks, dones = [], []
    engine = _engine(tm, num_slots=2).start()
    try:
        fut = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 6),
                                   stream_callback=lambda w, d: (chunks.append(w),
                                                                 dones.append(d)))
        assert fut.result(timeout=WAIT).shape == (0,)
    finally:
        engine.stop()
    assert dones[-1] is True and dones.count(True) == 1
    assert len(chunks) >= 3  # 6 frames in 2-frame segments
    want = tm.decode_codes([solo(IDS_A, 6)])[0]
    got = np.concatenate(chunks)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_streaming_slot_uses_one_codec_window(models, monkeypatch):
    """Every streamed chunk decodes in one fixed window (context + segment
    frames): one codec program for the engine's life."""
    _, tm = models
    shapes = set()
    orig = t_continuous._codec_window

    def counting(params, cfg, window):
        shapes.add(tuple(window.shape))
        return orig(params, cfg, window)

    monkeypatch.setattr(t_continuous, "_codec_window", counting)
    chunks = []
    engine = _engine(tm, num_slots=2).start()
    try:
        engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 9),
                             stream_callback=lambda w, d: chunks.append(w)
                             ).result(timeout=WAIT)
    finally:
        engine.stop()
    nq = tm.cfg.codec.decoder.num_quantizers
    assert shapes == {(1, 25 + 2, nq)}
    assert sum(c.shape[0] for c in chunks) == 9 * tm.cfg.codec.decode_upsample_rate


def test_continuous_engine_kv_int8_matches_jax_solo(models, solo):
    """Int8 KV cache in the pool and in the JAX reference alike."""
    jm, tm = models
    jm.kv_int8 = tm.kv_int8 = True
    try:
        engine = _engine(tm).start()
        try:
            assert isinstance(engine._state.k_cache, dict)
            with DecodedCodes(tm) as recorded:
                fut1 = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 6))
                _wait_for(lambda: engine.stats["segments"] >= 1, "the first segment")
                fut2 = engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6))
                fut1.result(timeout=WAIT), fut2.result(timeout=WAIT)
        finally:
            engine.stop()
        _assert_codes(recorded, [solo(IDS_A, 6), solo(IDS_B, 6)])
    finally:
        jm.kv_int8 = tm.kv_int8 = False


def test_mixed_buckets_and_icl_clone_match_jax(models):
    """prefill_bucket=(16, 128): a short prompt takes the small bucket, an
    ICL clone prompt the large one, in one pool; both give the JAX solo
    codes (the clone's after its reference codes, which lead its codec
    decode) and a prompt past the largest bucket is refused at submit."""
    jm, tm = models
    ref = (0.1 * np.sin(np.linspace(0, 150, 4800))).astype(np.float32)
    se, ri, rc = tm.clone_prompt_inputs(tm.create_voice_clone_prompt(ref, ref_text="ref"))

    def ids(text):
        return tm._tokenize(tm.build_assistant_text(text))

    greedy = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
                  max_new_tokens=5, min_new_tokens=6)
    engine = ContinuousBatchingEngine(tm, num_slots=2, segment_frames=2,
                                      max_new_tokens=SERVING_CEILING,
                                      prefill_bucket=(16, 128)).start()
    try:
        assert engine.prefill_buckets == (16, 128) and engine.prefill_bucket == 128
        with DecodedCodes(tm) as recorded:
            f_short = engine.submit_ids(ids("alpha"), speaker="aiden", language="english",
                                        **greedy)
            f_icl = engine.submit_ids(ids("beta"), language="english", speaker_embed=se,
                                      ref_ids=ri, ref_codes=rc, **greedy)
            w_short, w_icl = f_short.result(timeout=WAIT), f_icl.result(timeout=WAIT)
        assert engine.stats["bucket_admits"] == {16: 1, 128: 1}
        with pytest.raises(ValueError, match="prefill bucket"):
            engine.submit_ids(ids("beta"), language="english", speaker_embed=se, ref_ids=ri,
                              ref_codes=np.tile(rc, (60, 1))[:150], **greedy)
    finally:
        engine.stop()
    g = tm.cfg.talker.num_code_groups
    want_short = jax_solo_codes(jm, ids("alpha"), 4)
    want_icl = jax_solo_codes(jm, ids("beta"), 4, speaker=None, speaker_embed=se, ref_ids=ri,
                              ref_codes=rc)
    _assert_codes(recorded, [want_short, np.concatenate([rc[:, :g], want_icl])])
    up = tm.cfg.codec.decode_upsample_rate
    assert w_short.shape == w_icl.shape == (4 * up,)
