"""The port's window-batching engine on the tiny clone fixture, f32, on the
CPU (the scenarios of tests/test_serving.py and the window cases of
test_continuous_cancel.py and test_server_clone.py).

Requests that differ only in budget share a window and one decode shape
(the engine's ceiling, a per-row budget, the batch padded to a power of two,
the trailing text rounded to 16 rows); requests of other sampling controls
wait for a later window. Each request's codes equal the JAX package's solo
greedy codes at the same ceiling. Windows are ordered by submitting before
the worker starts, never by a sleep; every wait has a time limit and every
engine stops in a ``finally``."""

import numpy as np
import pytest

from torch_port_fixtures import (  # noqa: F401
    DecodedCodes,
    clone_checkpoint,
    jax_solo_codes,
    one_torch_thread,
    serving_models,
)
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine
from qwen_tts_tpu_torch.serving import ServingEngine
from concurrent.futures import CancelledError

IDS_A = np.array([1, 2, 3, 10, 11, 4, 5, 1, 2, 3])
IDS_B = np.array([1, 2, 3, 20, 21, 22, 4, 5, 1, 2, 3])
GREEDY = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0)
# EOS banned at every token of a budget up to 8. One value for every request:
# the port's window key holds min_new_tokens (a window's program has one),
# which the JAX package's _merge_params drops (ROADMAP.md §3).
NO_EOS = 9
WAIT = 120


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


def test_engine_batches_concurrent_requests(models):
    _, tm = models
    engine = ServingEngine(tm, max_batch=4, max_wait_ms=200, max_new_tokens=4).start()
    try:
        futs = [engine.submit_ids(IDS_A, speaker="aiden", language="english", do_sample=False),
                engine.submit_ids(IDS_B, speaker="serena", language="auto", do_sample=False)]
        wavs = [f.result(timeout=WAIT) for f in futs]
    finally:
        engine.stop()
    assert all(w.ndim == 1 and np.isfinite(w).all() for w in wavs)
    assert engine.stats["requests"] == 2 and engine.stats["batches"] <= 2


def test_window_groups_by_sampling_controls(models):
    """Budgets 4 and 7 share a window; the sampled request waits for its own.
    Each row stops at its own budget (budget - 1 frames)."""
    _, tm = models
    engine = ServingEngine(tm, max_batch=4, max_wait_ms=300, max_new_tokens=8)
    futs = [engine.submit_ids(IDS_A, speaker="aiden", language="english", max_new_tokens=n,
                              min_new_tokens=NO_EOS, **kw)
            for n, kw in ((4, GREEDY), (7, GREEDY), (4, dict(do_sample=True, temperature=1.3)))]
    engine.start()
    try:
        wavs = [f.result(timeout=WAIT) for f in futs]
    finally:
        engine.stop()
    up = tm.cfg.codec.decode_upsample_rate
    assert [w.shape[0] for w in wavs] == [3 * up, 6 * up, 3 * up]
    assert engine.stats["batches"] == 2


def test_window_budgets_share_one_decode_shape_and_match_jax_solo(models, monkeypatch):
    """Windows of budgets 4 and 7 (batch 2), then 6, then 5 (batch 1):
    every window decodes at the ceiling, so a batch size gives one shape;
    each request's codes are the JAX solo codes at that ceiling."""
    jm, tm = models
    shapes = []
    orig = t_pipeline.generate_codes

    def recording(talker, st, cfg, embeds, mask, trailing, **kw):
        shapes.append((tuple(embeds.shape), tuple(trailing.shape), kw["max_new_tokens"]))
        return orig(talker, st, cfg, embeds, mask, trailing, **kw)

    monkeypatch.setattr(t_pipeline, "generate_codes", recording)
    requests = [(IDS_A, 4), (IDS_B, 7), (IDS_A, 6), (IDS_B, 5)]
    engine = ServingEngine(tm, max_batch=4, max_wait_ms=300, max_new_tokens=8)
    # The first two queue before the worker starts: one window.
    futs = [engine.submit_ids(ids, speaker="aiden", language="english", max_new_tokens=n,
                              min_new_tokens=NO_EOS, **GREEDY) for ids, n in requests[:2]]
    engine.start()
    try:
        with DecodedCodes(tm) as recorded:
            wavs = [f.result(timeout=WAIT) for f in futs]
            for ids, n in requests[2:]:  # one window each
                wavs.append(engine.submit_ids(ids, speaker="aiden", language="english",
                                              max_new_tokens=n, min_new_tokens=NO_EOS, **GREEDY
                                              ).result(timeout=WAIT))
    finally:
        engine.stop()
    assert len(shapes) == 3 and shapes[1] == shapes[2]
    assert shapes[0][0][0] == 2 and shapes[1][0][0] == 1
    assert {s[2] for s in shapes} == {8} and {s[1][1] for s in shapes} == {17}
    up = tm.cfg.codec.decode_upsample_rate
    want = [jax_solo_codes(jm, ids, n - 1, ceiling=8) for ids, n in requests]
    assert [r.tolist() for r in recorded] == [w.tolist() for w in want]
    assert [w.shape[0] for w in wavs] == [(n - 1) * up for _, n in requests]
    np.testing.assert_allclose(wavs[0], tm.decode_codes([want[0]])[0], atol=1e-5)


def test_submit_rejects_budget_above_engine_ceiling(models):
    """Both engines refuse a budget above their ceiling at submit, in the
    caller's thread, rather than cut it."""
    _, tm = models
    for engine in (ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=4),
                   ContinuousBatchingEngine(tm, num_slots=2, segment_frames=2,
                                            max_new_tokens=4)):
        with pytest.raises(ValueError, match="ceiling"):
            engine.submit_ids(IDS_A, speaker="aiden", language="english", max_new_tokens=8)


def test_window_engine_cancel_queued(models):
    """A queued request cancels; one inside a finished window does not."""
    _, tm = models
    engine = ServingEngine(tm, max_batch=1, max_wait_ms=5, max_new_tokens=16)
    fut1 = engine.submit_ids(IDS_A, speaker="aiden", language="english", max_new_tokens=16,
                             **GREEDY)
    fut2 = engine.submit_ids(IDS_B, speaker="aiden", language="english", max_new_tokens=16,
                             **GREEDY)
    assert engine.cancel(fut2) is True
    engine.start()
    try:
        with pytest.raises(CancelledError):
            fut2.result(timeout=WAIT)
        assert fut1.result(timeout=WAIT).shape[0] > 0
        assert engine.cancel(fut1) is False  # already finished
    finally:
        engine.stop()


def test_window_engine_cancel_held_incompatible_request(models):
    """A request held for a later window (other sampling controls) cancels
    from the held list; the compatible requests are unaffected. All three
    queue before the worker starts, so the first window holds the sampled
    one whatever the timing."""
    _, tm = models
    engine = ServingEngine(tm, max_batch=2, max_wait_ms=300, max_new_tokens=16)
    fut_greedy = engine.submit_ids(IDS_A, speaker="aiden", language="english",
                                   max_new_tokens=8, **GREEDY)
    fut_sampled = engine.submit_ids(IDS_A, speaker="aiden", language="english",
                                    max_new_tokens=8, do_sample=True, temperature=1.3)
    fut_greedy2 = engine.submit_ids(IDS_A, speaker="aiden", language="english",
                                    max_new_tokens=6, **GREEDY)
    assert engine.cancel(fut_sampled) is True
    engine.start()
    try:
        with pytest.raises(CancelledError):
            fut_sampled.result(timeout=WAIT)
        assert fut_greedy.result(timeout=WAIT).shape[0] > 0
        assert fut_greedy2.result(timeout=WAIT).shape[0] > 0
    finally:
        engine.stop()
    assert engine.stats["batches"] == 1


def test_window_engine_icl_clone_matches_jax_solo(models):
    """An ICL clone through the window: its codes are the JAX solo codes,
    its waveform the pipeline's (reference frames cut)."""
    jm, tm = models
    ref = (0.1 * np.sin(np.linspace(0, 150, 4800))).astype(np.float32)
    prompt = tm.create_voice_clone_prompt(ref, ref_text="ref")
    se, ri, rc = tm.clone_prompt_inputs(prompt)
    want_wav, _ = tm.generate_voice_clone("hi", prompt, language="english", max_new_tokens=4,
                                          min_new_tokens=5, **GREEDY)
    engine = ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=16).start()
    try:
        with DecodedCodes(tm) as recorded:
            got = engine.submit_text("hi", language="english", speaker_embed=se, ref_ids=ri,
                                     ref_codes=rc, max_new_tokens=4, min_new_tokens=5,
                                     **GREEDY).result(timeout=WAIT)
    finally:
        engine.stop()
    g = tm.cfg.talker.num_code_groups
    want = jax_solo_codes(jm, tm._tokenize(tm.build_assistant_text("hi")), 3, speaker=None,
                          speaker_embed=se, ref_ids=ri, ref_codes=rc)
    assert len(recorded) == 1 and np.array_equal(recorded[0], np.concatenate([rc[:, :g], want]))
    assert got.shape == want_wav[0].shape
    np.testing.assert_allclose(got, want_wav[0], atol=1e-5)
