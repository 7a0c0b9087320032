"""Voice clone through both packages on the tiny Base fixture, f32, on the
CPU: the ICL prompt, greedy ``generate_voice_clone`` codes and waveforms.

One checkpoint (``make_clone_checkpoint``) loads into both packages. The
prompt dict comes from the port's ``create_voice_clone_prompt`` and feeds
both, so the comparisons below hold generation; the JAX package's own prompt
from the same audio is held against it first.

Tolerances: prompt embeddings within 1e-5 absolute (the same gathers and
sums in f32); greedy codes exactly equal; waveforms within 1e-4 absolute
(the f32 codec tolerance of tests/test_torch_pipeline.py); x-vectors within
1e-4 relative L2 (tests/test_torch_speaker.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_voice_clone import FakeTokenizer
from torch_port_fixtures import clone_checkpoint, one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.generate import build_prompt as jax_build_prompt
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch.generate import build_prompt as torch_build_prompt
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

GREEDY = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=6)
EMBED_ATOL = 1e-5
WAV_ATOL = 1e-4
XVEC_REL_L2 = 1e-4


def _ref_wav(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * np.sin(np.linspace(0, n / 32, n)) + 0.02 * rng.standard_normal(n)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return clone_checkpoint(tmp_path_factory)


def _load(ckpt, serving=False):
    jm = JaxModel.from_pretrained(ckpt, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    jm.tokenizer = tm.tokenizer = FakeTokenizer()
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = tame_codec(tm.codec_params)
    if serving:
        jm.quantize_for_serving(talker=True)
        tm.quantize_for_serving(talker=True)
    return jm, tm


@pytest.fixture(scope="module")
def models(ckpt):
    return _load(ckpt)


@pytest.fixture(scope="module")
def prompts(models):
    """Port prompts: ICL from a 4800-sample clip (100 frames, longer than
    the text), ICL from a 480-sample clip (10 frames, shorter than the text:
    the text trails into the decode), and x-vector only."""
    _, tm = models
    return {
        "icl": tm.create_voice_clone_prompt(_ref_wav(4800), ref_text="hello"),
        "icl_short": tm.create_voice_clone_prompt(_ref_wav(480, 1), ref_text="ref"),
        "xvec": tm.create_voice_clone_prompt(_ref_wav(4800), x_vector_only_mode=True),
    }


def test_base_model_and_prompt_agree_with_jax(models, prompts):
    jm, tm = models
    assert tm.speaker_params is not None and tm.cfg.tts_model_type == "base"
    assert tm.model_dir == jm.model_dir
    want = jm.create_voice_clone_prompt(_ref_wav(4800), ref_text="hello")
    got = prompts["icl"]
    assert got["icl_mode"] == [True] and got["x_vector_only_mode"] == [False]
    assert got["ref_text"] == ["hello"]
    codes = got["ref_code"][0]
    assert codes.dtype == np.int32
    assert codes.shape == (4800 // tm.cfg.codec.encode_downsample_rate,
                           tm.cfg.talker.num_code_groups)
    np.testing.assert_array_equal(codes, want["ref_code"][0])
    a, b = got["ref_spk_embedding"][0], want["ref_spk_embedding"][0]
    assert np.linalg.norm(a - b) <= XVEC_REL_L2 * np.linalg.norm(b)
    assert len(np.unique(codes[:, 0])) > 2  # random codebooks: the codes vary


def _prompt_pair(jm, tm, prompt, text, non_streaming):
    """The same clone request's prompt built by each package."""
    out = []
    for m, build in ((jm, jax_build_prompt), (tm, torch_build_prompt)):
        se, ri, rc = m.clone_prompt_inputs(prompt, 0)
        out.append(build(m.talker_params, m.cfg, m._tokenize(m.build_assistant_text(text)),
                         language="english", speaker_embed=se, ref_ids=ri, ref_codes=rc,
                         non_streaming=non_streaming, st_params=m.subtalker_params))
    return out


def _hold_prompt(jp, tp):
    for j, t in zip(jp, tp):
        t = t.float().numpy()
        assert t.shape == np.shape(j)
        np.testing.assert_allclose(t, np.asarray(j, np.float32), atol=EMBED_ATOL, rtol=0)


@pytest.mark.parametrize("kind,non_streaming", [("icl", False), ("icl", True),
                                                ("icl_short", False), ("icl_short", True),
                                                ("xvec", False)])
def test_clone_prompt_embeddings_match_jax(models, prompts, kind, non_streaming):
    jm, tm = models
    jp, tp = _prompt_pair(jm, tm, prompts[kind], "hello there", non_streaming)
    _hold_prompt(jp, tp)
    if kind == "icl_short" and not non_streaming:
        assert tp.trailing_text.shape[0] > 1  # the text outlasts the codes


def _codes(model, build, prompt, texts):
    """Greedy codes of generate_voice_clone's prompts (clone_prompt_inputs →
    build_prompt → generate_codes_from_prompts)."""
    built = []
    for i, text in enumerate(texts):
        se, ri, rc = model.clone_prompt_inputs(prompt, i)
        built.append(build(model.talker_params, model.cfg,
                           model._tokenize(model.build_assistant_text(text)),
                           language="english", speaker_embed=se, ref_ids=ri, ref_codes=rc,
                           st_params=model.subtalker_params))
    return model.generate_codes_from_prompts(built, model._merge_params(**GREEDY))[0]


def _request(prompts, case):
    """(prompt dict, texts) of a case; "broadcast" is one item over two texts."""
    if case == "broadcast":
        return prompts["icl"], ["hi there", "second text"]
    if case == "mixed":  # an ICL item and an x-vector-only item in one batch
        both = {k: prompts["icl_short"][k] + prompts["xvec"][k] for k in prompts["xvec"]}
        return both, ["hi there", "second text"]
    return prompts[case], ["hello there"]


@pytest.mark.parametrize("case", ["icl", "xvec", "broadcast", "mixed"])
def test_greedy_voice_clone_matches_jax(models, prompts, case):
    jm, tm = models
    prompt, texts = _request(prompts, case)
    jw, jsr = jm.generate_voice_clone(texts, prompt, language="english", **GREEDY)
    tw, tsr = tm.generate_voice_clone(texts, prompt, language="english", **GREEDY)
    assert tsr == jsr and len(tw) == len(jw) == len(texts)
    n = len(texts)
    full = {k: (list(v) * n if v and len(v) == 1 else v) for k, v in prompt.items()}
    jcodes = _codes(jm, jax_build_prompt, full, texts)
    tcodes = _codes(tm, torch_build_prompt, full, texts)
    up = tm.cfg.codec.decode_upsample_rate
    for t, j, c, w in zip(tcodes, jcodes, tcodes, tw):
        np.testing.assert_array_equal(t, j)
        # The reference frames' share of the waveform is cut.
        assert w.shape == (c.shape[0] * up,)
    for t, j in zip(tw, jw):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=WAV_ATOL, rtol=0)
    assert 0.05 < np.mean(np.abs(np.concatenate(tw)) < 1)


def test_prompt_count_mismatch_and_narrow_codes_raise(models, prompts):
    _, tm = models
    two = {k: (list(v) * 2 if v else v) for k, v in prompts["icl"].items()}
    with pytest.raises(ValueError, match="2 item"):
        tm.generate_voice_clone(["a", "b", "c"], voice_clone_prompt=two, **GREEDY)
    # A voice file of a model with fewer code groups raises before any gather.
    narrow = dict(prompts["icl"], ref_code=[prompts["icl"]["ref_code"][0][:, :-1]])
    with pytest.raises(ValueError, match="groups"):
        tm.generate_voice_clone("a", voice_clone_prompt=narrow, **GREEDY)


def test_generate_voice_clone_from_ref_audio(models):
    """``ref_audio`` builds the prompt inline: the same codes as a prompt
    made first."""
    _, tm = models
    wav = _ref_wav(960, 2)
    a, _ = tm.generate_voice_clone("hi", ref_audio=(wav, 24000), ref_text="ref", **GREEDY)
    b, _ = tm.generate_voice_clone(
        "hi", tm.create_voice_clone_prompt(wav, ref_text="ref"), **GREEDY)
    np.testing.assert_array_equal(a[0], b[0])


def test_serving_mode_clone_prompt_matches_jax(ckpt, prompts):
    """After quantize_for_serving the reference codes' embeddings come from
    the int8 tables, as in the JAX package."""
    jm, tm = _load(ckpt, serving=True)
    assert "embeds_i8" in tm.subtalker_params
    for non_streaming in (False, True):
        _hold_prompt(*_prompt_pair(jm, tm, prompts["icl"], "hello there", non_streaming))
