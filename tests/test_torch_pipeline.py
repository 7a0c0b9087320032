"""``generate_custom_voice`` through both packages on the tiny fixture, f32.

Greedy decoding must give the same codes token for token and allclose
waveforms. Sampled decoding cannot match the JAX draws (different RNGs), so
it is checked on its semantics: shapes, the EOS and budget trim, and that
one seed gives one output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from test_voice_clone import FakeTokenizer
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.generate import build_prompt as jax_build_prompt
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch.generate import build_prompt as torch_build_prompt
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

GREEDY = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=10)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_pipeline_ckpt"))
    make_checkpoint(d)
    jm = JaxModel.from_pretrained(d, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(d, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    jm.tokenizer = tm.tokenizer = FakeTokenizer()
    # Keep part of the waveform inside the clamp so the comparison says something.
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = tame_codec(tm.codec_params)
    return jm, tm


def _codes(model, texts, speakers, languages, instructs, non_streaming, **kw):
    """Codes the way ``_generate`` builds them, for a token-exact check."""
    build_prompt = jax_build_prompt if isinstance(model, JaxModel) else torch_build_prompt
    prompts = []
    for text, spk, lang, instr in zip(texts, speakers, languages, instructs):
        ids = model._tokenize(model.build_assistant_text(text))
        instr_ids = model._tokenize(model.build_instruct_text(instr)) if instr else None
        prompts.append(build_prompt(
            model.talker_params, model.cfg, ids, language=lang, speaker=spk,
            instruct_ids=instr_ids, non_streaming=non_streaming))
    return model.generate_codes_from_prompts(prompts, model._merge_params(**kw))


@pytest.mark.parametrize("non_streaming", [False, True])
def test_greedy_custom_voice_matches_jax(models, non_streaming):
    jm, tm = models
    texts = ["hello there, a longer line", "hi"]
    speakers = ["aiden", "serena"]
    languages = ["auto", "english"]
    instructs = [None, "calm"]
    jcodes, jinfo = _codes(jm, texts, speakers, languages, instructs, non_streaming, **GREEDY)
    tcodes, tinfo = _codes(tm, texts, speakers, languages, instructs, non_streaming, **GREEDY)
    np.testing.assert_array_equal(tinfo["num_gen"], jinfo["num_gen"])
    for t, j in zip(tcodes, jcodes):
        np.testing.assert_array_equal(t, j)

    jw, jsr = jm.generate_custom_voice(texts, speakers, languages, instruct=instructs,
                                       non_streaming_mode=non_streaming, **GREEDY)
    tw, tsr = tm.generate_custom_voice(texts, speakers, languages, instruct=instructs,
                                       non_streaming_mode=non_streaming, **GREEDY)
    assert tsr == jsr
    up = tm.cfg.codec.decode_upsample_rate
    for t, j, c in zip(tw, jw, tcodes):
        assert t.shape == j.shape == (c.shape[0] * up,)
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    assert 0.05 < np.mean(np.abs(np.concatenate(tw)) < 1)


def test_sampled_shapes_trim_and_seed(models):
    _, tm = models
    texts, speakers = ["one two three", "four"], ["aiden", "serena"]
    kw = dict(max_new_tokens=6, top_k=4, seed=5)
    a, sr = tm.generate_custom_voice(texts, speakers, **kw)
    b, _ = tm.generate_custom_voice(texts, speakers, **kw)
    assert sr == tm.sample_rate
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    up = tm.cfg.codec.decode_upsample_rate
    codes, info = _codes(tm, texts, speakers, ["auto"] * 2, [None] * 2, False, **kw)
    g = tm.cfg.talker.num_code_groups
    for c, w, n, stopped in zip(codes, a, info["num_gen"], info["stopped"]):
        assert c.shape == (n, g) and w.shape == (n * up,)
        # A row stopped by EOS keeps all its frames; a row that ran out of
        # budget loses its final, unexpanded one.
        assert n <= 6 if stopped else n == 5
        tk = tm.cfg.talker
        assert ((c[:, 0] >= 0) & (c[:, 0] < tk.vocab_size - tk.suppress_tail)).all()
        assert ((c[:, 1:] >= 0) & (c[:, 1:] < tk.code_predictor.vocab_size)).all()
    # min_new_tokens beyond the budget bans EOS: every row runs to the trim.
    codes, info = _codes(tm, texts, speakers, ["auto"] * 2, [None] * 2, False,
                         max_new_tokens=4, min_new_tokens=5, seed=1)
    assert not info["stopped"].any() and list(info["num_gen"]) == [3, 3]


def test_eos_stops_a_row_early(models):
    _, tm = models
    cfg = tm.cfg.talker
    # Make EOS the only token the talker can pick after the first frame.
    head = tm.talker_params["codec_head"]
    saved = head.clone()
    head[:, cfg.codec_eos_token_id] = 1e4
    try:
        codes, info = _codes(tm, ["abc", "defgh"], ["aiden", "aiden"], ["auto"] * 2,
                             [None] * 2, False, max_new_tokens=6, min_new_tokens=2,
                             do_sample=False, subtalker_dosample=False)
    finally:
        head.copy_(saved)
    assert info["stopped"].all()
    assert list(info["num_gen"]) == [2, 2]
    assert [c.shape[0] for c in codes] == [2, 2]


def test_generate_codes_step_limit_and_trim(models):
    """Per-row budgets below max_new_tokens, with and without the trim of a
    budget-exhausted row's last frame (EOS banned, so every row hits its
    budget)."""
    import dataclasses

    from qwen_tts_tpu_torch.generate import GenerationParams, batch_prompts, generate_codes

    _, tm = models
    prompts = [torch_build_prompt(tm.talker_params, tm.cfg,
                                  tm._tokenize(tm.build_assistant_text(t)), speaker="aiden")
               for t in ("abc", "defgh", "ij")]
    embeds, mask, trailing, _ = batch_prompts(prompts)
    p = dataclasses.replace(GenerationParams().greedy(), min_new_tokens=9)
    for trim, want in ((True, [1, 3, 0]), (False, [2, 4, 0])):
        out = generate_codes(
            tm.talker_params, tm.subtalker_params, tm.cfg.talker, embeds, mask, trailing,
            sampling=p.talker_sampling(), st_sampling=p.subtalker_sampling(),
            max_new_tokens=5, generator=None, trim_last_on_budget=trim,
            step_limit=[2, 4, 0])
        assert out.num_gen.tolist() == want and not out.stopped.any()
        assert out.codes.shape == (3, 5, tm.cfg.talker.num_code_groups)
