"""The port's trunk, talker, sub-talker and codec against the JAX package's,
on the tiny fixture checkpoint in f32 (parameters carried across with
``convert.py``, inputs made from a numpy seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu.models import codec as j_codec
from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import talker as j_talker
from qwen_tts_tpu.models import trunk as j_trunk
from qwen_tts_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from qwen_tts_tpu.ops.sampling import SamplingConfig as JSampling
from qwen_tts_tpu_torch.convert import convert_params
from qwen_tts_tpu_torch.models import codec as t_codec
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.models import trunk as t_trunk
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin as t_rope_cos_sin
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig as TSampling

# f32 on both sides: summation order only, through a few layers.
ATOL = 1e-4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_models_ckpt"))
    make_checkpoint(d)
    cfg, jt, js, jc, _ = j_load(d, talker_dtype=jnp.float32)
    np_tree = jax.tree_util.tree_map(np.asarray, (jt, js, jc))
    tt, ts, tc = convert_params(*np_tree, talker_dtype=torch.float32, device="cpu")
    return cfg, (jt, js, jc), (tt, ts, tc)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_trunk_prefill_and_decode(models):
    cfg, (jt, _, _), (tt, _, _) = models
    dims_j = j_talker.talker_dims(cfg.talker)
    dims_t = t_talker.talker_dims(cfg.talker)
    r = np.random.default_rng(0)
    b, s, s_max = 2, 6, 10
    x = r.standard_normal((b, s, cfg.talker.hidden_size)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[0, :2] = False
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc, js_ = j_rope_cos_sin(jnp.asarray(pos), dims_j.head_dim, 10000.0)
    tc, ts_ = t_rope_cos_sin(torch.tensor(pos), dims_t.head_dim, 10000.0)
    jh, jk, jv = j_trunk.trunk_prefill(jt["trunk"], dims_j, jnp.asarray(x), jc, js_,
                                       pad_mask=jnp.asarray(pad))
    th, tk, tv = t_trunk.trunk_prefill(tt["trunk"], dims_t, torch.tensor(x), tc, ts_,
                                       pad_mask=torch.tensor(pad))
    _close(th, jh)
    _close(tk, jk)
    _close(tv, jv)

    # Decode one token on top of the prefill, per-row lengths and left pad.
    shape = (dims_j.num_layers, b, s_max, dims_j.kv_heads, dims_j.head_dim)
    kc = np.zeros(shape, np.float32)
    vc = np.zeros(shape, np.float32)
    kc[:, :, :s], vc[:, :, :s] = np.asarray(jk), np.asarray(jv)
    new = r.standard_normal((b, cfg.talker.hidden_size)).astype(np.float32)
    cur_len = np.array([s + 1, s + 1], np.int32)
    valid_from = np.array([2, 0], np.int32)
    dpos = np.array([4, 6])
    jc1, js1 = j_rope_cos_sin(jnp.asarray(dpos), dims_j.head_dim, 10000.0)
    tc1, ts1 = t_rope_cos_sin(torch.tensor(dpos), dims_t.head_dim, 10000.0)
    jh2, jk2, jv2 = j_trunk.trunk_decode_step(
        jt["trunk"], dims_j, jnp.asarray(new), jc1, js1, jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(cur_len), valid_from=jnp.asarray(valid_from))
    tkc, tvc = torch.tensor(kc), torch.tensor(vc)
    th2, tk2, tv2 = t_trunk.trunk_decode_step(
        tt["trunk"], dims_t, torch.tensor(new), tc1, ts1, tkc, tvc,
        torch.tensor(cur_len), valid_from=torch.tensor(valid_from))
    assert tk2 is tkc  # written in place
    _close(th2, jh2)
    _close(tk2, jk2)
    _close(tv2, jv2)


def test_talker_prefill_and_decode(models):
    cfg, (jt, _, _), (tt, _, _) = models
    tk = cfg.talker
    r = np.random.default_rng(1)
    b, s, s_max = 2, 5, 9
    x = r.standard_normal((b, s, tk.hidden_size)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[1, :3] = False
    jk, jv = j_talker.alloc_kv_cache(tk, b, s_max)
    tkc, tvc = t_talker.alloc_kv_cache(tk, b, s_max, device="cpu")
    jpre = j_talker.talker_prefill(jt, tk, jnp.asarray(x), jnp.asarray(pad), jk, jv)
    tpre = t_talker.talker_prefill(tt, tk, torch.tensor(x), torch.tensor(pad), tkc, tvc)
    for a, c in zip(tpre, jpre):
        _close(a, c)

    emb = r.standard_normal((b, tk.hidden_size)).astype(np.float32)
    n_real = pad.sum(-1).astype(np.int32)
    args_np = (n_real, np.full(b, s + 1, np.int32), (s - n_real).astype(np.int32))
    jout = j_talker.talker_decode_step(
        jt, tk, jnp.asarray(emb), jnp.asarray(args_np[0]), jpre.k_cache, jpre.v_cache,
        jnp.asarray(args_np[1]), jnp.asarray(args_np[2]))
    tout = t_talker.talker_decode_step(
        tt, tk, torch.tensor(emb), torch.tensor(args_np[0]), tpre.k_cache, tpre.v_cache,
        torch.tensor(args_np[1]), torch.tensor(args_np[2]))
    for a, c in zip(tout, jout):
        _close(a, c)


def test_subtalker_greedy_codes_and_group_sum(models):
    cfg, (jt, js, _), (tt, ts, _) = models
    cp = cfg.talker.code_predictor
    r = np.random.default_rng(2)
    b = 3
    hidden = r.standard_normal((b, cfg.talker.hidden_size)).astype(np.float32)
    first = r.integers(0, cp.vocab_size, size=b).astype(np.int32)
    jcodes = j_st.subtalker_generate(
        js, cp, jt["codec_embedding"], jnp.asarray(hidden), jnp.asarray(first),
        JSampling(do_sample=False), None)
    tcodes = t_st.subtalker_generate(
        ts, cp, tt["codec_embedding"], torch.tensor(hidden), torch.tensor(first).long(),
        TSampling(do_sample=False), None)
    assert tcodes.shape == (b, cp.num_code_groups)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    _close(t_st.embed_groups_sum(ts, tt["codec_embedding"], tcodes),
           j_st.embed_groups_sum(js, jt["codec_embedding"], jcodes))


def _codes(cfg, b, t, seed):
    dec = cfg.codec.decoder
    return np.random.default_rng(seed).integers(
        0, dec.codebook_size, size=(b, t, dec.num_quantizers)).astype(np.int32)


def test_codec_decode_and_chunk_seams(models):
    cfg, (_, _, jc), (_, _, tc) = models
    jc, tc = tame_codec(jc), tame_codec(tc)
    dec = cfg.codec.decoder
    codes = _codes(cfg, 2, 13, 3)
    codes[1, -3:] = -1  # right padding, clamped to 0 like the JAX decode
    jw = j_codec.codec_decode(jc, dec, jnp.asarray(codes))
    tw = t_codec.codec_decode(tc, dec, torch.tensor(codes))
    assert tw.shape == (2, 13 * dec.total_upsample)
    assert 0.1 < (tw.abs() < 1).float().mean() and torch.isfinite(tw).all()
    _close(tw, jw)
    # chunk_size 5 with 3 frames of left context crosses two seams.
    jch = j_codec.chunked_decode(jc, dec, jnp.asarray(codes), chunk_size=5,
                                 left_context_size=3)
    tch = t_codec.chunked_decode(tc, dec, torch.tensor(codes), chunk_size=5,
                                 left_context_size=3)
    assert tch.shape == tw.shape
    _close(tch, jch)
