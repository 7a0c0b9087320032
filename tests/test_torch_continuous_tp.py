"""The continuous-batching engine under tensor parallelism
(``qwen_tts_tpu_torch/continuous.py``: a leader at tp rank 0, a follower
replaying its commands) at world 2, tp 2 over gloo, f32 on the CPU, on the
shared clone checkpoint, in one group of two ranks (``tests/torch_dist.py``).

The leader takes, in turn: three greedy requests over two slots (the third
waits for a freed slot), a prompt over the largest bucket (refused before
any broadcast), a sampled request, a prompt one hidden unit too wide (its
admission raises on both ranks), a request cancelled mid-decode beside a
long neighbour, and a greedy request after it. The greedy codes equal the
JAX package's unsharded ``generate_codes_from_prompts`` for each request
alone and the waveforms its ``decode_codes`` within ``F32_ATOL`` (the
``want`` of tests/test_continuous.py:243-245); every segment's frame budgets
and codes are the same on both ranks (the sampled request's too); the cancel
zeroes the slot's budget on both; ``stop()`` ends ``follow()`` within
``STOP_WAIT`` seconds. With no placement the engine broadcasts nothing and
its codes are the JAX codes, as before the tp path existed."""

import time

import numpy as np
import pytest
import torch

from torch_dist import run_ranks
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
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

IDS_A = [1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3]
IDS_B = [1, 2, 3, 20, 21, 22, 23, 24, 4, 5, 1, 2, 3]
IDS_C = [1, 2, 3, 30, 31, 4, 5, 1, 2, 3]
WAIT = 120  # seconds any future may take
F32_ATOL = 1e-4  # the port's cross-framework codec tolerance (test_torch_streaming.py)
STOP_WAIT = 10.0  # seconds from the leader's stop() to follow()'s return
GREEDY = {"A": (IDS_A, 4), "B": (IDS_B, 6), "C": (IDS_C, 5), "L2": (IDS_A, 14),
          "N": (IDS_C, 6)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    _, tm = models
    sampled = t_generate.GenerationParams(max_new_tokens=7, min_new_tokens=8, top_k=8,
                                          seed=5)
    requests = [
        ("A", IDS_A, greedy_params(t_generate, 4), "batch"),
        ("B", IDS_B, greedy_params(t_generate, 6), "batch"),
        ("C", IDS_C, greedy_params(t_generate, 5), "wait"),
        ("big", IDS_A, greedy_params(t_generate, 4), "oversize"),
        ("S", IDS_A, sampled, "wait"),
        ("P", IDS_A, greedy_params(t_generate, 3), "poison"),
        ("L2", IDS_A, greedy_params(t_generate, 14), "batch"),
        ("L", IDS_B, greedy_params(t_generate, 14), "cancel"),
        ("N", IDS_C, greedy_params(t_generate, 6), "wait"),
    ]
    t0 = time.monotonic()
    leader, follower = run_ranks(
        "torch_dist:tp_engine", 2, tmp_path_factory.mktemp("tp_engine"), cfg=tm.cfg,
        talker=tm.talker_params, subtalker=tm.subtalker_params, codec=tm.codec_params,
        requests=requests, wait=WAIT)
    assert leader["leader"] and not follower["leader"]
    print(f"tp engine ranks: {time.monotonic() - t0:.1f} s")
    return leader, follower


@pytest.fixture(scope="module")
def solo(models):
    jm, _ = models
    return {name: jax_solo_codes(jm, ids, frames) for name, (ids, frames) in GREEDY.items()}


def _assert_codes(recorded, wanted):
    """Each wanted code array was decoded, and nothing else (any order)."""
    assert len(recorded) == len(wanted)
    left = list(recorded)
    for w in wanted:
        hit = [i for i, r in enumerate(left) if r.shape == w.shape and np.array_equal(r, w)]
        assert hit, f"codes {w[:2].tolist()}... not decoded"
        left.pop(hit[0])


def test_greedy_codes_and_waveforms_equal_jax_unsharded(models, run, solo):
    jm, _ = models
    leader, _ = run
    sampled = [c for c in leader["decoded"]
               if not any(c.shape == w.shape and np.array_equal(c, w) for w in solo.values())]
    assert len(sampled) == 1  # S; the poisoned and the cancelled requests reach no codec
    _assert_codes([c for c in leader["decoded"] if c is not sampled[0]], list(solo.values()))
    for name, codes in solo.items():
        want = np.asarray(jm.decode_codes([codes])[0])
        np.testing.assert_allclose(leader["results"][name], want, atol=F32_ATOL, err_msg=name)


def test_follower_segments_equal_the_leaders(run):
    """Every segment's budgets and codes, the sampled request's included,
    bit for bit on both ranks."""
    leader, follower = run
    assert len(leader["segments"]) == len(follower["segments"]) > 10
    for (la, ca), (fa, cf) in zip(leader["segments"], follower["segments"]):
        assert torch.equal(la, fa)
        assert torch.equal(ca, cf)
    assert isinstance(leader["results"]["S"], np.ndarray) and leader["results"]["S"].size


def test_refusal_poison_and_cancel(run):
    leader, follower = run
    results = leader["results"]
    # Refused in the caller's thread: no admission command went out for it.
    assert results["big"].startswith("refused: prompt length")
    assert leader["commands"].count("admit") == 8  # A B C S P L2 L N
    # The poisoned admission raised on both ranks; serving went on.
    assert results["P"].startswith("RuntimeError")
    assert leader["failed_admits"] == follower["failed_admits"] == 1
    assert leader["requests"] == 7
    # The cancel: one limit command, and a segment where that slot's budget
    # went from the request's (15) to 0 while its neighbour kept 15, on both
    # ranks alike (the budgets are compared segment by segment above).
    assert results["L"].startswith("CancelledError")
    assert leader["commands"].count("limit") == 1
    budgets = [lim.tolist() for lim, _ in follower["segments"]]
    assert any(sorted(prev) == [15, 15] and sorted(cur) == [0, 15]
               for prev, cur in zip(budgets, budgets[1:])), budgets


def test_stop_ends_follow(run):
    leader, follower = run
    assert leader["commands"][-1] == "stop"
    assert 0 <= follower["returned"] - leader["stop"] < STOP_WAIT


def test_no_placement_engine_unchanged(models, solo):
    """No placement: no command group, nothing broadcast, the JAX codes."""
    _, tm = models
    engine = ContinuousBatchingEngine(tm, num_slots=2, segment_frames=2,
                                      max_new_tokens=SERVING_CEILING,
                                      prefill_bucket=SERVING_BUCKET, trailing_cap=32)
    assert engine.is_leader and engine._channel is None
    engine.start()
    try:
        with DecodedCodes(tm) as recorded:
            futs = [engine.submit_prompt(
                t_generate.build_prompt(tm.talker_params, tm.cfg, np.asarray(ids),
                                        language="english", speaker="aiden"),
                greedy_params(t_generate, frames)) for ids, frames in GREEDY.values()]
            for f in futs:
                f.result(timeout=WAIT)
    finally:
        engine.stop()
    _assert_codes(recorded, list(solo.values()))
