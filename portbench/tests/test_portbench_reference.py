"""The plain reference against the port's own CPU path at tiny widths. The
test imports both; the reference itself imports nothing of the port."""

import json
import os

import _paths
import numpy as np
import pytest
import torch

import sut
import traffic
import weights as bench_weights
from reference import check
from reference import model as ref

with open(os.path.join(_paths.TESTS, "tiny", "configs", "tiny.json"), encoding="utf-8") as f:
    CFG = json.load(f)
TTS = sut.tts_config(CFG)


@pytest.fixture(scope="module")
def weights():
    return bench_weights.draw(CFG, 2 ** 31 + 5, torch.device("cpu"), torch.float32,
                              torch.float32)


def _request(seed=3):
    mix = {"block": 4, "frames": {"median": 12, "sigma": 0.6, "lo": 4, "hi": 30},
           "text_tokens": {"median": 10, "sigma": 0.6, "lo": 8, "hi": 20}}
    return traffic.block(mix, CFG, seed, 0)[0]


def test_prompt_embeds_match_the_port(weights):
    from qwen_tts_tpu_torch.generate import build_prompt

    r = _request()
    port = build_prompt(weights["talker"], TTS, np.asarray(r["text_ids"]), language=r["language"],
                        speaker=r["speaker"])
    embeds, trailing, pad = ref.prompt_embeds(ref.Precision(), weights["talker"], CFG,
                                              r["text_ids"], r["speaker"], r["language"])
    torch.testing.assert_close(embeds, port.embeds, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(trailing, port.trailing_text, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pad, port.tts_pad_embed, rtol=1e-5, atol=1e-5)


def test_int8_weights_match_the_port(weights):
    from qwen_tts_tpu_torch.models.trunk import quantize_int8

    w = weights["talker"]["trunk"]["wq"]
    q, s = quantize_int8(w)
    torch.testing.assert_close(ref.int_weight(w, 127.0), q.float() * s.float(), rtol=0, atol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_codes_of_the_port_sit_at_the_reference_best(weights, int8):
    """The port's greedy decode, float or int8 weights (int8 KV cache with
    them), teacher-forced through the reference, which re-derives the int8
    weights and the cache's rounding: the served codes are the reference's
    best."""
    from qwen_tts_tpu_torch.generate import GenerationParams, build_prompt

    m = sut.model(TTS, weights, int8)
    rows = [_request(s) for s in (3, 4)]
    prompts = [build_prompt(m.talker_params, TTS, np.asarray(r["text_ids"]),
                            language=r["language"], speaker=r["speaker"]) for r in rows]
    frames = [r["frames"] for r in rows]
    params = GenerationParams(max_new_tokens=32, do_sample=False, subtalker_do_sample=False,
                              repetition_penalty=1.05, min_new_tokens=33)
    codes, _ = m.generate_codes_from_prompts(prompts, params, step_limit=[f + 1 for f in frames],
                                             max_new_ceiling=32)
    wavs = m.decode_codes(codes, bucket=8)
    sample = []
    for r, c, w in zip(rows, codes, wavs):
        assert c.shape[0] == r["frames"]
        t_max = -(-max(frames) // 8) * 8
        sample.append(dict(r, codes=c, repetition_penalty=1.05, min_new_tokens=33, audio=w,
                           greedy=True,
                           codec={"mode": "chunked", "t_max": t_max, "chunk": 300, "context": 25}))
    got = check.readings(weights, CFG, sample, {"int8": int8, "codec_dtype": "float32"})
    assert got["talker_gap"] <= 1e-4 and got["subtalker_gap"] <= 1e-4
    assert got["codec_err"] <= 1e-5


def _leaves(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _leaves(v, path + (i,))
    else:
        yield path, t


@pytest.mark.parametrize("name", ["tiny", "qwen3-tts-12hz-0.6b"])
def test_weights_have_the_port_layout(name):
    """The benchmark's leaves, worked out from the configuration file, are
    the keys, shapes and dtypes of the port's own initialisers."""
    import registry
    from qwen_tts_tpu_torch.models.codec import init_codec_params
    from qwen_tts_tpu_torch.models.subtalker import init_subtalker_params
    from qwen_tts_tpu_torch.models.talker import init_talker_params

    cfg = CFG if name == "tiny" else registry.config(name)
    tts, g = sut.tts_config(cfg), torch.Generator()
    port = {"talker": init_talker_params(g, tts.talker, torch.bfloat16, "meta"),
            "subtalker": init_subtalker_params(g, tts.talker.code_predictor,
                                               tts.talker.hidden_size, torch.bfloat16, "meta"),
            "codec": init_codec_params(g, tts.codec.decoder, torch.bfloat16, "meta")}
    mine = {(part,) + path: (shape, torch.bfloat16) for part in bench_weights.PARTS
            for path, shape, _, _ in bench_weights.LEAVES[part](cfg)}
    assert mine == {p: (tuple(t.shape), t.dtype) for p, t in _leaves(port)}


def test_weights_drawn_from_the_seed(weights):
    again = bench_weights.draw(CFG, 2 ** 31 + 5, torch.device("cpu"), torch.float32,
                               torch.float32)
    other = bench_weights.draw(CFG, 2 ** 31 + 6, torch.device("cpu"), torch.float32,
                               torch.float32)
    a, b, c = (dict(_leaves(w)) for w in (weights, again, other))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("talker", "codec_head")], c[("talker", "codec_head")])
    w = a[("talker", "trunk", "wq")]
    assert abs(float(w.std()) * CFG["talker_config"]["hidden_size"] ** 0.5 - 1.0) < 0.05
    conv2 = a[("codec", "blocks", 0, "resunits", 0, "conv2_w")]
    assert abs(float(conv2.std()) * conv2.shape[1] ** 0.5 - 0.1) < 0.01
    assert torch.equal(a[("talker", "norm")], torch.ones_like(a[("talker", "norm")]))



def test_codec_matches_the_port_over_stream_windows(weights):
    from qwen_tts_tpu_torch.models.codec import codec_decode

    dec = TTS.codec.decoder
    codes = torch.randint(0, dec.codebook_size, (9, dec.num_quantizers),
                          generator=torch.Generator().manual_seed(1))
    windows, cuts = ref.stream_windows(codes, [2, 5, 2], context=5, segment=5)
    port = codec_decode(weights["codec"], dec, windows)
    mine = ref.codec_decode(ref.Precision(), weights["codec"], CFG, windows)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)
    assert [c for c, _ in cuts] == [0, 2, 5]


def test_chunk_spans_match_the_port():
    assert ref.chunk_spans(384, 300, 25) == [(0, 300, 0), (300, 384, 25)]
    assert ref.chunk_spans(20, 300, 25) == [(0, 20, 0)]
