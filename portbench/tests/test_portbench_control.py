"""The check's two ends at a size a test run holds: a whole run of each
tiny cell (the look for a card skipped) comes out correct, the control at
the precision below comes out over every cell's limits, and each fault the
cells can have, planted in the timed path, makes ``correct`` false.

The tiny cells' limits were set as the real cells' are, from the program's
and the control's readings (PERF.md)."""

import time

import _paths
import pytest
import torch

import control
import harness

CELLS = ("tiny-serve", "tiny-batch")
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _paths.tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, seconds=2.0):
    ctx = harness.context(cell, SEED, torch.device("cpu"), root)
    return harness.run_cell(ctx, seconds, False, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(root, cell):
    own, ctl, codes = control.readings(cell, SEED + 1, 2.0, torch.device("cpu"), root)
    limits = harness.context(cell, 0, torch.device("cpu"), root).limits
    assert codes > 0
    assert all(own[k] <= limits[k] for k in limits), own
    assert any(ctl[k] > limits[k] for k in limits), ctl


def _unchanged_step(monkeypatch):
    from qwen_tts_tpu_torch.models import talker

    monkeypatch.setattr(talker, "trunk_decode_step",
                        lambda params, dims, hidden, cos, sin, kc, vc, *a, **k: (hidden, kc, vc))


def _half_batch(monkeypatch):
    """The second half of the batch's rows left out: their logits the mean
    of the first half's."""
    from qwen_tts_tpu_torch.models import talker

    real = talker.talker_decode_step

    def half(*a, **k):
        logits, hidden, kc, vc = real(*a, **k)
        h = max(1, logits.shape[0] // 2)
        logits = torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand(
            logits.shape[0] - h, -1)])
        return logits, hidden, kc, vc

    monkeypatch.setattr(talker, "talker_decode_step", half)


def _token_altered(monkeypatch):
    from qwen_tts_tpu_torch import generate

    for name in ("sample_token", "sample_token_vec"):
        real = getattr(generate, name)
        monkeypatch.setattr(generate, name, lambda *a, _r=real, **k: (_r(*a, **k) + 1) % 200)


def _audio_altered(monkeypatch):
    from qwen_tts_tpu_torch.models import codec

    real = codec.codec_decode
    monkeypatch.setattr(codec, "codec_decode", lambda *a, **k: real(*a, **k) * 1.01)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "token_altered": _token_altered, "audio_altered": _audio_altered}


# Each cell with each fault it can have: the check reads both halves of the
# batch's rows and of the engine's slots.
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(root, cell)
    assert not res["correct"], res["checks"]
