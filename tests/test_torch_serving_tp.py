"""The window-batching engine under tensor parallelism
(``qwen_tts_tpu_torch/serving.py``: a leader at tp rank 0, a follower
replaying its windows) at world 2, tp 2 over gloo, f32 on the CPU, on the
shared clone checkpoint, in one group of two ranks (``tests/torch_dist.py``).

The leader queues, before ``start()``, three greedy requests of different
budgets (one window) and a sampled one (other controls: held for a second
window); then a prompt one hidden unit too wide (its window raises on both
ranks) and a greedy request after it. The greedy codes equal the JAX
package's unsharded ``generate_codes_from_prompts`` for each request alone
(``jax_solo_codes``) and the waveforms its ``decode_codes`` within
``F32_ATOL``; every window's budgets and codes, the sampled one's too, are
the same on both ranks; ``stop()`` ends ``follow()`` within ``STOP_WAIT``
seconds; each wrong-role call raises. With no placement the engine makes no
command group and its codes are the JAX codes.

Alone ~33 s on the CPU (most of it the two ranks' imports and the JAX
references); ~26 s of worker time inside the tier-1 run (6 xdist workers)."""

import time

import numpy as np
import pytest

from torch_dist import run_ranks
from torch_port_fixtures import (  # noqa: F401
    DecodedCodes,
    SERVING_CEILING,
    clone_checkpoint,
    jax_solo_codes,
    one_torch_thread,
    serving_models,
)
from qwen_tts_tpu_torch.serving import ServingEngine

IDS_A = [1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3]
IDS_B = [1, 2, 3, 20, 21, 22, 23, 24, 4, 5, 1, 2, 3]
IDS_C = [1, 2, 3, 30, 31, 4, 5, 1, 2, 3]
WAIT = 120  # seconds any future may take
F32_ATOL = 1e-4  # the port's cross-framework codec tolerance (test_torch_streaming.py)
STOP_WAIT = 10.0  # seconds from the leader's stop() to follow()'s return
# EOS banned at every frame under the ceiling. One value for every request:
# the window key holds min_new_tokens (tests/test_torch_serving.py).
NO_EOS = SERVING_CEILING + 1
GREEDY_KW = dict(speaker="aiden", language="english", min_new_tokens=NO_EOS, do_sample=False,
                 subtalker_dosample=False, repetition_penalty=1.0)
GREEDY = {"A": (IDS_A, 4), "B": (IDS_B, 6), "C": (IDS_C, 5), "N": (IDS_C, 3)}


def _greedy(name):
    ids, frames = GREEDY[name]
    return name, ids, dict(GREEDY_KW, max_new_tokens=frames + 1), 0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    _, tm = models
    sampled = ("S", IDS_A, dict(GREEDY_KW, max_new_tokens=7, do_sample=True, top_k=8, seed=5), 0)
    queued = [_greedy("A"), _greedy("B"), _greedy("C"), sampled]
    later = [("P", IDS_A, dict(GREEDY_KW, max_new_tokens=4), 1), _greedy("N")]
    t0 = time.monotonic()
    leader, follower = run_ranks(
        "torch_dist:tp_windows", 2, tmp_path_factory.mktemp("tp_windows"), cfg=tm.cfg,
        talker=tm.talker_params, subtalker=tm.subtalker_params, codec=tm.codec_params,
        queued=queued, later=later, wait=WAIT)
    assert leader["leader"] and not follower["leader"]
    print(f"tp window engine ranks: {time.monotonic() - t0:.1f} s")
    return leader, follower


@pytest.fixture(scope="module")
def solo(models):
    jm, _ = models
    return {name: jax_solo_codes(jm, ids, frames) for name, (ids, frames) in GREEDY.items()}


def test_one_window_of_greedy_codes_equals_jax_unsharded(models, run, solo):
    """A, B and C share the first window; N runs in a window of its own.
    Each one's codes are the JAX solo codes, its waveform JAX's."""
    jm, _ = models
    leader, _ = run
    windows = leader["windows"]
    assert [w[0] for w in windows[:1]] == [[5, 7, 6]]
    for name, got in zip("ABC", windows[0][1]):
        np.testing.assert_array_equal(got, solo[name], err_msg=name)
    np.testing.assert_array_equal(windows[-1][1][0], solo["N"])
    for name, codes in solo.items():
        want = np.asarray(jm.decode_codes([codes])[0])
        np.testing.assert_allclose(leader["results"][name], want, atol=F32_ATOL, err_msg=name)


def test_held_sampled_window_and_follower_replays(run):
    """The sampled request waits for a window of its own on both ranks, and
    every window's budgets and codes are the same on the follower as on the
    leader, the sampled window's too."""
    leader, follower = run
    assert [(w[0], w[2]) for w in leader["windows"]] == [
        ([5, 7, 6], False), ([7], True), ([4], False)]  # P's window raised: not recorded
    assert len(follower["windows"]) == len(leader["windows"])
    for (la, lc, ls), (fa, fc, fs) in zip(leader["windows"], follower["windows"]):
        assert la == fa and ls == fs
        assert len(lc) == len(fc) and all(np.array_equal(a, b) for a, b in zip(lc, fc))
    s = leader["results"]["S"]
    assert isinstance(s, np.ndarray) and s.size and np.isfinite(s).all()


def test_poisoned_window_raises_on_both_ranks(run):
    leader, follower = run
    assert leader["results"]["P"].startswith("RuntimeError")
    assert leader["stats"]["failed_windows"] == follower["failed_windows"] == 1
    assert leader["stats"]["requests"] == 5 and leader["stats"]["batches"] == 3
    assert isinstance(leader["results"]["N"], np.ndarray)  # the follower served on


def test_stop_ends_follow_and_wrong_roles_raise(run):
    leader, follower = run
    assert 0 <= follower["returned"] - leader["stop"] < STOP_WAIT
    assert [name for name, _ in leader["wrong"]] == ["follow"]
    assert [name for name, _ in follower["wrong"]] == ["start", "submit_ids"]
    for _, message in leader["wrong"] + follower["wrong"]:
        assert message != "allowed" and ("leader" in message or "follow" in message)


def test_no_placement_engine_unchanged(models, solo):
    """No placement: no command group, nothing broadcast, the JAX codes."""
    _, tm = models
    engine = ServingEngine(tm, max_batch=4, max_wait_ms=200, max_new_tokens=SERVING_CEILING)
    assert engine.is_leader and engine._channel is None
    futs = [engine.submit_ids(np.asarray(GREEDY[n][0]), **dict(
        GREEDY_KW, max_new_tokens=GREEDY[n][1] + 1)) for n in "ABC"]
    engine.start()
    try:
        with DecodedCodes(tm) as recorded:
            for f in futs:
                f.result(timeout=WAIT)
    finally:
        engine.stop()
    assert engine.stats["batches"] == 1
    for got, name in zip(recorded, "ABC"):
        np.testing.assert_array_equal(got, solo[name], err_msg=name)
