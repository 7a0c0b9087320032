"""The PyTorch port's ops against the JAX package's, on the same numpy inputs
(f32 on the CPU). Sampling is compared on its filters and on greedy
decoding: torch.Generator and jax.random draw different numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.ops import attention as j_attn
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.ops import convs as j_convs
from qwen_tts_tpu.ops import norms as j_norms
from qwen_tts_tpu.ops import rope as j_rope
from qwen_tts_tpu.ops import sampling as j_samp
from qwen_tts_tpu.ops import snake as j_snake
from qwen_tts_tpu.ops.pallas.decode_attention import pallas_attention_decode_step
from qwen_tts_tpu_torch.ops import attention as t_attn
from qwen_tts_tpu_torch.ops import convs as t_convs
from qwen_tts_tpu_torch.ops import norms as t_norms
from qwen_tts_tpu_torch.ops import rope as t_rope
from qwen_tts_tpu_torch.ops import sampling as t_samp
from qwen_tts_tpu_torch.ops import snake as t_snake
from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention

# f32 on both sides; differences are summation order only.
ATOL = 2e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(torch_out, jax_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=rtol)


def test_rms_norm_and_layer_norm():
    r = _rng()
    x = r.standard_normal((3, 5, 32)).astype(np.float32)
    w = r.standard_normal(32).astype(np.float32)
    bias = r.standard_normal(32).astype(np.float32)
    _close(t_norms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(t_norms.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(bias), 1e-6),
           j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), 1e-6))


@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_and_mrope_merge(interleaved):
    r = _rng(1)
    hd, sections = 64, (16, 8, 8)
    pos = r.integers(0, 500, size=(2, 7))
    tc, ts = t_rope.rope_cos_sin(torch.tensor(pos), hd, 10000.0)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), hd, 10000.0)
    # positions up to 500 rad: f32 trig differs in the last ulps.
    _close(tc, jc, atol=1e-4)
    _close(ts, js, atol=1e-4)
    # Three distinct streams so the merge is not an identity.
    cos3 = r.standard_normal((3, 2, 7, hd)).astype(np.float32)
    sin3 = r.standard_normal((3, 2, 7, hd)).astype(np.float32)
    tm = t_rope.merge_mrope_sections(torch.tensor(cos3), torch.tensor(sin3), sections,
                                     interleaved=interleaved)
    jm = j_rope.merge_mrope_sections(jnp.asarray(cos3), jnp.asarray(sin3), sections,
                                     interleaved=interleaved)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = r.standard_normal((2, 7, 4, hd)).astype(np.float32)
    _close(t_rope.apply_rope(torch.tensor(x), tm[0][:, :, None], tm[1][:, :, None]),
           j_rope.apply_rope(jnp.asarray(x), jm[0][:, :, None], jm[1][:, :, None]))


@pytest.mark.parametrize("window", [None, 3])
def test_attention_prefill_pad_mask_and_window(window):
    r = _rng(2)
    b, s, h, kv, hd = 2, 9, 4, 2, 16
    q = r.standard_normal((b, s, h, hd)).astype(np.float32)
    k = r.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = r.standard_normal((b, s, kv, hd)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[1, :4] = False  # left padding: fully masked query rows stay finite
    got = t_attn.attention_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                   pad_mask=torch.tensor(pad), sliding_window=window)
    want = j_attn.attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    pad_mask=jnp.asarray(pad), sliding_window=window)
    assert torch.isfinite(got).all()
    _close(got, want)


def _decode_case(seed, b, h, kv, hd, s_max, cur_len, valid_from):
    r = _rng(seed)
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    k = r.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    v = r.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    return q, k, v, np.asarray(cur_len, np.int32), np.asarray(valid_from, np.int32)


DECODE_CASES = [
    # the shapes of tests/test_pallas_attention.py
    (3, 8, 2, 16, 32, [7, 20, 32], [0, 3, 1]),
    (2, 4, 2, 8, 16, [9, 9], [0, 0]),
    # flagship talker and sub-talker heads at a small cache
    (2, 16, 2, 64, 24, [24, 11], [0, 5]),
    (2, 16, 8, 128, 16, [16, 3], [0, 0]),
]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_jax_and_pallas(case, window):
    b, h, kv, hd, s_max, cur_len, valid_from = case
    q, k, v, cl, vf = _decode_case(3, b, h, kv, hd, s_max, cur_len, valid_from)
    want = j_attn.attention_decode_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur_len=jnp.asarray(cl),
        valid_from=jnp.asarray(vf), sliding_window=window)
    pallas = pallas_attention_decode_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur_len=jnp.asarray(cl),
        valid_from=jnp.asarray(vf), sliding_window=window, interpret=True)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    plain = t_attn.attention_decode_step(tq, tk, tv, cur_len=torch.tensor(cl),
                                         valid_from=torch.tensor(vf), sliding_window=window)
    before = decode_attention.launches
    wrapped = decode_attention(tq, tk, tv, torch.tensor(cl), torch.tensor(vf), window)
    assert decode_attention.launches == before  # CPU tensors: plain version, no launch
    for got in (plain, wrapped):
        _close(got, want)
        _close(got, pallas)


def test_update_kv_cache_in_place():
    r = _rng(11)
    k = r.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = r.standard_normal((2, 10, 2, 8)).astype(np.float32)
    kn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    vn = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    jk, jv = j_attn.update_kv_cache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
                                    jnp.asarray(vn), jnp.int32(4))
    tk, tv = torch.tensor(k), torch.tensor(v)
    gk, gv = t_attn.update_kv_cache(tk, tv, torch.tensor(kn), torch.tensor(vn), 4)
    assert gk is tk and gv is tv
    _close(gk, jk, atol=0)
    _close(gv, jv, atol=0)


@pytest.mark.parametrize("dilation,groups,stride", [(1, 1, 1), (3, 1, 1), (1, 6, 1), (1, 1, 2)])
def test_causal_conv1d(dilation, groups, stride):
    r = _rng(4)
    x = r.standard_normal((2, 11, 6)).astype(np.float32)
    w = r.standard_normal((5, 6 // groups, 6)).astype(np.float32)
    bias = r.standard_normal(6).astype(np.float32)
    got = t_convs.causal_conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(bias),
                                dilation=dilation, stride=stride, groups=groups)
    want = j_convs.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                 dilation=dilation, stride=stride, groups=groups)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("stride", [2, 3, 5])
def test_causal_conv_transpose1d(stride):
    r = _rng(5)
    x = r.standard_normal((2, 7, 4)).astype(np.float32)
    w = r.standard_normal((2 * stride, 4, 3)).astype(np.float32)
    bias = r.standard_normal(3).astype(np.float32)
    got = t_convs.causal_conv_transpose1d(torch.tensor(x), torch.tensor(w),
                                          torch.tensor(bias), stride=stride)
    want = j_convs.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(bias), stride=stride)
    assert got.shape == (2, 7 * stride, 3)
    _close(got, want)


def test_snake_beta_f32():
    r = _rng(6)
    x = (3 * r.standard_normal((2, 9, 8))).astype(np.float32)
    a = np.exp(0.1 * r.standard_normal(8)).astype(np.float32)
    b = np.exp(0.1 * r.standard_normal(8)).astype(np.float32)
    _close(t_snake.snake_beta(torch.tensor(x), torch.tensor(a), torch.tensor(b)),
           j_snake.snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    # float32 and bfloat16 (tests/test_torch_vocoder.py) are the only types.
    with pytest.raises(TypeError):
        t_snake.snake_beta(torch.tensor(x).half(), torch.tensor(a), torch.tensor(b))


def _logits(seed=7, b=3, v=64):
    r = _rng(seed)
    x = r.standard_normal((b, v)).astype(np.float32)
    x[0, 5] = x[0, 9] = x[0].max() + 1.0  # a tie at the top
    x[1, :4] = x[1].max() + 0.5           # a 4-way tie
    return x


def test_sampling_filters_match_jax():
    x = _logits()
    tx, jx = torch.tensor(x), jnp.asarray(x)
    presence = _rng(8).random(x.shape) < 0.3
    suppress = np.asarray(j_samp.build_suppress_mask(64, eos_id=60, tail=10))
    np.testing.assert_array_equal(
        t_samp.build_suppress_mask(64, eos_id=60, tail=10).numpy(), suppress)
    _close(t_samp.apply_suppress_mask(tx, torch.tensor(suppress)),
           j_samp.apply_suppress_mask(jx, jnp.asarray(suppress)), atol=0)
    _close(t_samp.apply_repetition_penalty(tx, torch.tensor(presence), 1.3),
           j_samp.apply_repetition_penalty(jx, jnp.asarray(presence), 1.3), atol=0)
    for k in (1, 2, 5, 63):
        _close(t_samp._top_k_filter(tx, k), j_samp._top_k_filter(jx, k), atol=0)
    for p in (0.1, 0.5, 0.9):
        _close(t_samp._top_p_filter(tx, p), j_samp._top_p_filter(jx, p), atol=0)


def test_sampling_greedy_and_top1_are_argmax():
    x = _logits(9)
    x[0, 9] = x[0, 5] - 0.25  # break the tie: top-1 sampling is then deterministic
    x[1, 1:4] -= 0.25
    tx = torch.tensor(x)
    want = np.asarray(j_samp.sample_token(jnp.asarray(x),
                                          j_samp.SamplingConfig(do_sample=False), None))
    got = t_samp.sample_token(tx, t_samp.SamplingConfig(do_sample=False), None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x.argmax(-1))
    top1 = t_samp.SamplingConfig(do_sample=True, top_k=1)
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        np.testing.assert_array_equal(t_samp.sample_token(tx, top1, g).numpy(), want)
    jtop1 = np.asarray(j_samp.sample_token(
        jnp.asarray(x), j_samp.SamplingConfig(do_sample=True, top_k=1),
        jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(jtop1, want)


def test_sampling_same_seed_same_draw_and_respects_filters():
    x = torch.tensor(_logits(10, b=4, v=128))
    cfg = t_samp.SamplingConfig(do_sample=True, top_k=5, temperature=0.9)
    a = t_samp.sample_token(x, cfg, torch.Generator().manual_seed(3))
    b = t_samp.sample_token(x, cfg, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    kept = t_samp._top_k_filter(x, 5) > -1e8
    g = torch.Generator().manual_seed(4)
    for _ in range(20):
        tok = t_samp.sample_token(x, cfg, g)
        assert kept[torch.arange(4), tok].all()
