"""The port's continuous engine under cancellation, deadlines, poisoned
requests and double-buffered dispatch, on the tiny clone fixture, f32, on
the CPU (the scenarios of tests/test_continuous_cancel.py and
test_continuous_inflight.py).

A cancelled or expired slot resolves its own future and frees its slot; the
requests beside it keep the JAX package's solo greedy codes. Under
double-buffered dispatch a segment is read after the next one is queued:
the frames of a slot freed (and admitted again) in between are dropped
(``stale_skips``), the shutdown drain resolves every future, and the
synchronous mode gives the same codes. Events are ordered by what the
engine reports (a streamed chunk, a segment count), never by a sleep; every
wait has a time limit and every engine stops in a ``finally``."""

import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from torch_port_fixtures import (  # noqa: F401
    DecodedCodes,
    SERVING_BUCKET,
    clone_checkpoint,
    greedy_params,
    jax_solo_codes,
    one_torch_thread,
    serving_models,
)
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine
from qwen_tts_tpu_torch.generate import Prompt

IDS_A = [1, 2, 3, 10, 11, 12, 4, 5]
IDS_B = [1, 2, 3, 20, 21, 22, 23, 24, 4, 5]
WAIT = 120


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


def _prompt(tm, ids):
    return t_generate.build_prompt(tm.talker_params, tm.cfg, np.asarray(ids), language="english",
                                   speaker="aiden")


def _engine(tm, **kw):
    kw = dict(dict(num_slots=3, segment_frames=2, max_new_tokens=64,
                   prefill_bucket=SERVING_BUCKET, trailing_cap=32), **kw)
    return ContinuousBatchingEngine(tm, **kw)


def _solo(jm, ids, frames, ceiling=64):
    return jax_solo_codes(jm, ids, frames, ceiling=ceiling)


def _first_chunk(events: list):
    """(an Event set at the first streamed chunk, the stream callback that
    logs (samples, done) into ``events``)."""
    started = threading.Event()

    def callback(wav, done):
        events.append((wav.size, done))
        started.set()

    return started, callback


def test_cancel_midflight_frees_slot_others_unaffected(models):
    jm, tm = models
    started, callback = _first_chunk(events := [])
    engine = _engine(tm).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut_long = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 63),
                                            stream_callback=callback)
            fut_b = engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6))
            assert started.wait(WAIT), "the long request never streamed"
            assert engine.cancel(fut_long) is True
            with pytest.raises(CancelledError):
                fut_long.result(timeout=WAIT)
            fut_b.result(timeout=WAIT)
            # The cancelled slot is reusable.
            assert engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6)
                                        ).result(timeout=WAIT).shape[0] > 0
        assert engine.cancel(fut_b) is False  # finished: a no-op
    finally:
        engine.stop()
    want = _solo(jm, IDS_B, 6)
    assert len(recorded) == 2 and all(np.array_equal(r, want) for r in recorded)
    assert events[-1][1] is True


def test_cancel_while_queued(models):
    _, tm = models
    engine = _engine(tm, num_slots=1)
    fut1 = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 20))
    fut2 = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 20))
    assert engine.cancel(fut2) is True  # still queued: the worker has not started
    engine.start()
    try:
        with pytest.raises(CancelledError):
            fut2.result(timeout=WAIT)
        assert fut1.result(timeout=WAIT).shape[0] > 0
    finally:
        engine.stop()


def test_timeout_resolves_future_and_frees_slot(models):
    _, tm = models
    engine = _engine(tm).start()
    try:
        fut = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 63),
                                   timeout_s=0.001)
        with pytest.raises(TimeoutError):
            fut.result(timeout=WAIT)
        assert engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 4)
                                    ).result(timeout=WAIT).shape[0] > 0
    finally:
        engine.stop()


def test_poisoned_request_does_not_stall_others(models):
    """Embeddings of the wrong width fail inside the admission's prefill:
    that request's future holds the exception, the others finish."""
    jm, tm = models
    bad = Prompt(embeds=torch.zeros(4, 7), trailing_text=torch.zeros(1, 7),
                 tts_pad_embed=torch.zeros(7))
    engine = _engine(tm).start()
    try:
        with DecodedCodes(tm) as recorded:
            futs = [engine.submit_prompt(p, greedy_params(t_generate, 6))
                    for p in (_prompt(tm, IDS_A), bad, _prompt(tm, IDS_A))]
            with pytest.raises(RuntimeError):
                futs[1].result(timeout=WAIT)
            assert all(f.result(timeout=WAIT).shape[0] > 0 for f in (futs[0], futs[2]))
    finally:
        engine.stop()
    want = _solo(jm, IDS_A, 6)
    assert len(recorded) == 2 and all(np.array_equal(r, want) for r in recorded)


def test_streamed_cancel_sends_final_callback(models):
    _, tm = models
    started, callback = _first_chunk(events := [])
    engine = _engine(tm, max_new_tokens=256).start()
    try:
        fut = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 255),
                                   stream_callback=callback)
        assert started.wait(WAIT), "no streamed chunk arrived"
        assert engine.cancel(fut)
        with pytest.raises(CancelledError):
            fut.result(timeout=WAIT)
    finally:
        engine.stop()
    assert events[-1][1] is True  # the stream ended cleanly


def test_slot_readmitted_while_segment_inflight(models):
    """One slot, two queued requests: A's end is read while its frozen
    follow-up segment is in flight, so B takes the slot before that segment
    is read. Its frames (A's) are dropped by identity, and B keeps its solo
    codes."""
    jm, tm = models
    engine = _engine(tm, num_slots=1, max_new_tokens=16).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut_a = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 4))
            fut_b = engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6))
            fut_a.result(timeout=WAIT), fut_b.result(timeout=WAIT)
    finally:
        engine.stop()
    assert [r.tolist() for r in recorded] == [_solo(jm, IDS_A, 4, 16).tolist(),
                                              _solo(jm, IDS_B, 6, 16).tolist()]
    assert engine.stats["stale_skips"] >= 1


def test_cancel_races_inflight_segment(models):
    """A cancel lands between a segment's dispatch and its read: the freed
    slot's frames in flight are dropped, the other slot keeps its codes."""
    jm, tm = models
    started, callback = _first_chunk([])
    engine = _engine(tm, num_slots=2).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut_a = engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 60),
                                         stream_callback=callback)
            fut_c = engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 8))
            assert started.wait(WAIT), "A never streamed"
            assert engine.cancel(fut_a)
            fut_c.result(timeout=WAIT)
            with pytest.raises(CancelledError):
                fut_a.result(timeout=WAIT)
    finally:
        engine.stop()
    assert len(recorded) == 1 and np.array_equal(recorded[0], _solo(jm, IDS_B, 8))
    assert engine.stats["stale_skips"] >= 1


def test_shutdown_drain_resolves_every_future(models):
    """stop() with requests queued and decoding: every future resolves
    (a result or CancelledError), none is left waiting."""
    _, tm = models
    engine = _engine(tm, num_slots=1, max_new_tokens=256).start()
    futs = [engine.submit_prompt(_prompt(tm, IDS_A), greedy_params(t_generate, 200))
            for _ in range(3)]
    deadline = time.monotonic() + WAIT
    while engine.stats["segments"] == 0:
        assert time.monotonic() < deadline, "no segment ran"
        time.sleep(0.005)
    engine.stop()
    assert not engine._worker.is_alive()
    for fut in futs:
        try:
            fut.result(timeout=10)
        except CancelledError:
            pass


def test_streaming_order_under_one_segment_lag(models):
    """Chunks arrive in order, one done=True and it is the last; together
    they are the one-shot decode of the solo codes within 1e-4."""
    jm, tm = models
    events = []
    engine = _engine(tm, num_slots=2, max_new_tokens=16).start()
    try:
        fut = engine.submit_prompt(
            _prompt(tm, IDS_B), greedy_params(t_generate, 8),
            stream_callback=lambda wav, done: events.append((np.asarray(wav).copy(), done)))
        assert fut.result(timeout=WAIT).shape == (0,)
    finally:
        engine.stop()
    dones = [d for _, d in events]
    assert dones.count(True) == 1 and dones[-1]
    want = tm.decode_codes([_solo(jm, IDS_B, 8, 16)])[0]
    streamed = np.concatenate([w for w, _ in events])
    assert streamed.shape == want.shape
    np.testing.assert_allclose(streamed, want, atol=1e-4)


@pytest.mark.parametrize("env", [False, True])
def test_sync_dispatch_mode_matches_solo(models, monkeypatch, env):
    """sync_dispatch=True, or QTTS_ENGINE_SYNC_DISPATCH=1: each segment is
    read at once, nothing late, the same codes."""
    jm, tm = models
    if env:
        monkeypatch.setenv("QTTS_ENGINE_SYNC_DISPATCH", "1")
    engine = _engine(tm, num_slots=2, max_new_tokens=16,
                     **({} if env else {"sync_dispatch": True}))
    assert engine.sync_dispatch
    engine.start()
    try:
        with DecodedCodes(tm) as recorded:
            engine.submit_prompt(_prompt(tm, IDS_B), greedy_params(t_generate, 6)
                                 ).result(timeout=WAIT)
    finally:
        engine.stop()
    assert len(recorded) == 1 and np.array_equal(recorded[0], _solo(jm, IDS_B, 6, 16))
    assert engine.stats["stale_skips"] == 0


def test_device_lock_is_reentrant_exclusive_and_granted_in_turn():
    """``graphs.FairLock``: a holder may take it again; threads that wait get
    it in the order they asked; under many threads and fast switching no
    update inside it is lost; a thread that does not hold it cannot release
    it."""
    import sys

    from qwen_tts_tpu_torch.graphs import FairLock

    lock, order = FairLock(), []
    with lock, lock:  # reentrant
        threads = []
        for i in range(4):
            t = threading.Thread(target=lambda i=i: (lock.acquire(), order.append(i),
                                                     lock.release()))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + WAIT
            while len(lock._waiting) < i + 1:  # queued before the next one starts
                assert time.monotonic() < deadline
                time.sleep(0.001)
    for t in threads:
        t.join(timeout=WAIT)
    assert order == [0, 1, 2, 3] and not any(t.is_alive() for t in threads)
    with pytest.raises(RuntimeError):
        lock.release()

    count, interval = [0], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(200):
                with lock:
                    value = count[0]
                    time.sleep(0)
                    count[0] = value + 1

        workers = [threading.Thread(target=add) for _ in range(16)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers) and count[0] == 16 * 200
