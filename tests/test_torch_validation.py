"""The port's greedy-parity gate (``qwen_tts_tpu_torch/validation.py``)
against the JAX package's (``qwen_tts_tpu/validation.py``), f32 on the CPU,
on the fixture checkpoint of tests/test_parity.py.

The port's ``check_parity`` passes at both of that file's
parametrisations; the port's cache-free oracle and its production trace each
equal the JAX package's (tokens, stop reason, stop step); ``report()`` has
the JAX lines; and a planted cache fault (the fast path's talker seeing one
cache position fewer from a known frame on) fails the gate at the first step
that fault can reach."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu import generate as j_generate
from qwen_tts_tpu import validation as j_validation
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch import validation as t_validation
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

IDS = np.array([1, 2, 3, 10, 11, 12, 13, 14, 4, 5, 1, 2, 3], np.int32)
MAX_NEW = 12
CASES = [("aiden", "english"), (None, "auto")]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parity_ckpt"))
    make_checkpoint(d)
    jm = JaxModel.from_pretrained(d, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(d, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    return jm, tm


def _prompts(models, speaker, language):
    jm, tm = models
    jp = j_generate.build_prompt(jm.talker_params, jm.cfg, IDS, language=language,
                                 speaker=speaker, st_params=jm.subtalker_params)
    tp = t_generate.build_prompt(tm.talker_params, tm.cfg, IDS, language=language,
                                 speaker=speaker, st_params=tm.subtalker_params)
    return jp, tp


def _port(tm, fn, prompt):
    return fn(tm.talker_params, tm.subtalker_params, tm.cfg, prompt, MAX_NEW)


@pytest.mark.parametrize("speaker,language", CASES)
def test_port_check_parity_passes(models, speaker, language):
    _, tm = models
    result = _port(tm, t_validation.check_parity, _prompts(models, speaker, language)[1])
    assert result.ok, result.report()
    assert result.first_divergence is None


# The JAX oracle runs op by op and compiles every op again at each prefix
# length (~2.5 s a step on the CPU), so the port's oracle is held to it over
# this many steps; over MAX_NEW the port's oracle equals the port's fast
# trace (test_port_check_parity_passes), which equals JAX's.
EAGER_MAX_NEW = 4


@pytest.mark.parametrize("name,max_new", [("eager_greedy_trace", EAGER_MAX_NEW),
                                          ("fast_greedy_trace", MAX_NEW)])
def test_traces_equal_jax(models, name, max_new):
    """Each trace of the port equals the JAX package's, tokens, stop reason
    and stop step alike, and the two reports read the same."""
    jm, tm = models
    jp, tp = _prompts(models, *CASES[0])
    want = getattr(j_validation, name)(jm.talker_params, jm.subtalker_params, jm.cfg, jp,
                                       max_new)
    got = getattr(t_validation, name)(tm.talker_params, tm.subtalker_params, tm.cfg, tp,
                                      max_new)
    assert len(got.tokens) == max_new
    assert tuple(got) == tuple(want)
    want = j_validation.ParityResult(True, None, want, want).report()
    assert t_validation.ParityResult(True, None, got, got).report() == want


def test_report_lines_match_jax():
    fast = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], "max_tokens", 10)
    eager = ([1, 2, 3, 9, 9, 9, 9, 9, 9, 9], "eos", 10)
    for args in ((True, None, fast, fast), (False, 3, fast, eager), (False, 0, fast, eager)):
        t_args = (args[0], args[1], t_validation.Trace(*args[2]), t_validation.Trace(*args[3]))
        j_args = (args[0], args[1], j_validation.Trace(*args[2]), j_validation.Trace(*args[3]))
        assert (t_validation.ParityResult(*t_args).report()
                == j_validation.ParityResult(*j_args).report())


# The planted fault starts at this frame: from it on, the fast path's talker
# step attends from valid_from + 1 (one cache position fewer, the prompt's
# first). The token of step FAULT_FRAME + 1 is the first it can change.
FAULT_FRAME = 2


def test_planted_cache_fault_fails_at_its_step(models, monkeypatch):
    _, tm = models
    prompt = _prompts(models, *CASES[0])[1]
    s = prompt.embeds.shape[0]  # the fast path's prefix (bucket 1)
    clean = _port(tm, t_validation.fast_greedy_trace, prompt)
    step = t_talker.talker_decode_step

    def one_position_fewer(params, cfg, emb, rope_pos, kc, vc, cur_len, valid_from):
        late = cur_len >= s + FAULT_FRAME + 1  # the talker step of frame FAULT_FRAME on
        return step(params, cfg, emb, rope_pos, kc, vc, cur_len,
                    valid_from + late.to(valid_from.dtype))

    monkeypatch.setattr(t_generate.talker_mod, "talker_decode_step", one_position_fewer)
    faulty = _port(tm, t_validation.fast_greedy_trace, prompt)
    # Where the fault first shows: the faulty production trace against the
    # clean one, both of the fast path.
    shows = next(i for i, (a, b) in enumerate(zip(faulty.tokens, clean.tokens)) if a != b)
    assert shows > FAULT_FRAME
    result = _port(tm, t_validation.check_parity, prompt)
    assert not result.ok
    assert result.eager == clean  # the oracle never runs the talker's decode step
    assert result.first_divergence == shows, result.report()
    assert f"PARITY FAIL — first divergence at step {shows}" in result.report()
