"""The traffic generator: the seed changes the order, the ids and the
voices, never the mix of sizes or the number of arrivals."""

import collections

import _paths  # noqa: F401

import registry
import traffic

CFG = registry.config("qwen3-tts-12hz-0.6b")
SERVE = dict(registry.traffic("stream-open-loop"), rate=registry.workload("serve-0.6b")["rate"])
BATCH = registry.traffic("offline-b32")
SEEDS = (0, 1, 2 ** 31 + 7, 2 ** 32 + 3)


def test_same_seed_same_schedule():
    a = traffic.schedule(SERVE, CFG, 2 ** 31 + 11, 51)
    b = traffic.schedule(SERVE, CFG, 2 ** 31 + 11, 51)
    assert a == b


def test_other_seed_other_schedule_same_mix():
    runs = [traffic.schedule(SERVE, CFG, s, 51) for s in SEEDS]
    assert len({tuple(r["due"] for r in run) for run in runs}) == len(SEEDS)
    assert len({tuple(tuple(r["text_ids"]) for r in run[:5]) for run in runs}) == len(SEEDS)
    # The stratified mix: every seed draws the same count in the window and
    # the same lengths in each full block.
    assert len({sum(r["due"] >= 0 for r in run) for run in runs}) == 1
    n = SERVE["block"]
    for run in runs:
        first = sorted(r["frames"] for r in run[:n])
        assert first == sorted(traffic.lognormal_midpoints(n, **SERVE["frames"]).tolist())
        assert sum(r["greedy"] for r in run[:n]) == SERVE["greedy_per_block"]


def test_arrivals_at_the_rate():
    run = traffic.schedule(SERVE, CFG, 5, 51)
    counted = [r for r in run if r["due"] >= 0]
    assert abs(len(counted) - SERVE["rate"] * 51) <= SERVE["block"]
    assert min(r["due"] for r in run) >= -SERVE["ramp_s"]
    assert max(r["due"] for r in run) < 51


def test_lengths_texts_and_voices_in_range():
    run = traffic.schedule(SERVE, CFG, 9, 51)
    f = SERVE["frames"]
    assert all(f["lo"] <= r["frames"] <= f["hi"] for r in run)
    t = CFG["talker_config"]
    voices = collections.Counter((r["speaker"], r["language"]) for r in run)
    assert set(voices) <= {(s, l) for s in t["spk_id"] for l in t["codec_language_id"]}
    for r in run:
        ids = r["text_ids"]
        assert ids[:3] == [CFG["im_start_token_id"], 77091, 198]
        assert ids[-5:] == [CFG["im_end_token_id"], 198, CFG["im_start_token_id"], 77091, 198]
        assert 8 <= len(ids) - 8 <= 200
        assert max(ids[3:-5]) < CFG["text_template"]["ordinary_text_tokens"]


def test_batch_calls_same_lengths_every_call():
    calls = [traffic.calls(BATCH, CFG, s, i) for s in SEEDS for i in range(3)]
    assert len({tuple(sorted(r["frames"] for r in c["rows"])) for c in calls}) == 1
    assert [c["greedy"] for c in calls[:3]] == [True, False, False]
