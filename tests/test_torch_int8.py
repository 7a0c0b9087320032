"""The port's int8 serving mode against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in the port: the quantizers, the int8 trunk with int8 dict KV
caches, the int8-cache decode attention, the sub-talker micro-step (against
the TPU kernel in interpret mode and against JAX's int8 trunk step), the
kernel layout of its pack, the parameter carry-over, and
``quantize_for_serving`` end to end."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from test_voice_clone import FakeTokenizer
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.config import TalkerConfig
from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import talker as j_talker
from qwen_tts_tpu.models import trunk as j_trunk
from qwen_tts_tpu.ops import attention as j_attn
from qwen_tts_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch.convert import convert_params, convert_tree
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.models import trunk as t_trunk
from qwen_tts_tpu_torch.ops import attention as t_attn
from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_int8
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
    KERNEL_DIMS,
    pack_subtalker_weights,
    subtalker_step,
    subtalker_step_plain,
    subtalker_step_rows,
    unpack_subtalker_weights,
)
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin as t_rope_cos_sin
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# f32 on both sides differs in summation order only.
F32_TOL = 1e-5
# bf16: both sides round the same ops to bf16 (8 mantissa bits) but sum in
# another order, so a value may land one bf16 ulp apart (2^-8 relative) and
# carry that through a layer.
BF16_RTOL = 2 ** -6
TINY = j_trunk.TrunkDims(num_layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                         intermediate=96, eps=1e-6)


def _np(t):
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rand_trunk(dims, seed, scale=1.0):
    """A float trunk tree (numpy f32 leaves) from a seed."""
    r = np.random.default_rng(seed)
    l, d, h, kv, hd, i = (dims.num_layers, dims.hidden, dims.heads, dims.kv_heads,
                          dims.head_dim, dims.intermediate)

    def w(*shape):
        return (r.standard_normal(shape) * scale / np.sqrt(shape[-2])).astype(np.float32)

    return {"wq": w(l, d, h * hd), "wk": w(l, d, kv * hd), "wv": w(l, d, kv * hd),
            "wo": w(l, h * hd, d), "gate": w(l, d, i), "up": w(l, d, i), "down": w(l, i, d),
            "input_norm": (1 + 0.1 * r.standard_normal((l, d))).astype(np.float32),
            "post_attn_norm": (1 + 0.1 * r.standard_normal((l, d))).astype(np.float32),
            "q_norm": (1 + 0.1 * r.standard_normal((l, hd))).astype(np.float32),
            "k_norm": (1 + 0.1 * r.standard_normal((l, hd))).astype(np.float32)}


def _both(tree, jdtype, tdtype):
    """The same numpy tree as JAX arrays and as torch tensors, in one dtype."""
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), tree)
    tt = convert_tree(jax.tree_util.tree_map(np.asarray, jt), CPU, tdtype)
    return jt, tt


# --------------------------------------------------------------------------
# (a) the quantizers give the same int8 values and scales bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_quantizers_bit_identical(jdtype, tdtype):
    jt, tt = _both(_rand_trunk(TINY, 0), jdtype, tdtype)
    jq = j_trunk.quantize_trunk_int8(jt)
    tq = t_trunk.quantize_trunk_int8(tt)
    assert sorted(jq) == sorted(tq)
    for k in jq:
        want = np.asarray(jq[k])
        got = tq[k]
        if k.endswith("_i8"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        elif k.endswith("_s"):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=k)

    r = np.random.default_rng(1)
    tables = {"embeds": r.standard_normal((3, 40, 24)).astype(np.float32),
              "lm_heads": r.standard_normal((3, 24, 40)).astype(np.float32),
              "norm": np.ones(24, np.float32)}
    jtab, ttab = _both(tables, jdtype, tdtype)
    jq, tq = j_st.quantize_subtalker_tables_int8(jtab), t_st.quantize_subtalker_tables_int8(ttab)
    assert sorted(jq) == sorted(tq)
    for k in ("embeds_i8", "lm_heads_i8"):
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]), err_msg=k)
    for k in ("embeds_s", "lm_heads_s"):
        np.testing.assert_array_equal(tq[k].view(torch.int16).numpy(),
                                      np.asarray(jq[k]).view(np.int16), err_msg=k)
    assert t_st.quantize_subtalker_tables_int8(tq).keys() == tq.keys()  # idempotent

    x = r.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    jq8, js = j_attn.quantize_kv(jnp.asarray(x, jdtype))
    tq8, ts = t_attn.quantize_kv(torch.tensor(x).to(tdtype))
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------------
# (g) the carry-over keeps int8 leaves and scales at their own dtype
# --------------------------------------------------------------------------

def test_convert_params_keeps_int8_leaves():
    jt = jax.tree_util.tree_map(jnp.asarray, _rand_trunk(TINY, 2))
    tables = {"embeds": jnp.ones((3, 8, 64)), "lm_heads": jnp.ones((3, 64, 8)),
              "norm": jnp.ones(64)}
    talker = {"trunk": j_trunk.quantize_trunk_int8(jt), "norm": jnp.ones(64)}
    subtalker = dict(j_st.quantize_subtalker_tables_int8(tables),
                     trunk=j_trunk.quantize_trunk_int8(jt))
    kc, _ = j_talker.alloc_kv_cache(TalkerConfig(num_hidden_layers=1), 1, 4, kv_int8=True)
    talker["cache"] = kc
    np_trees = jax.tree_util.tree_map(np.asarray, (talker, subtalker))
    t_talker_p, t_sub, _ = convert_params(*np_trees, talker_dtype=torch.bfloat16, device="cpu")
    for name, tree, src in (("talker", t_talker_p["trunk"], np_trees[0]["trunk"]),
                            ("subtalker", t_sub["trunk"], np_trees[1]["trunk"]),
                            ("tables", t_sub, np_trees[1])):
        for k, v in tree.items():
            if k.endswith("_i8"):
                assert v.dtype == torch.int8, (name, k)
                np.testing.assert_array_equal(v.numpy(), src[k], err_msg=f"{name}.{k}")
            elif k.endswith("_s"):
                assert v.dtype == torch.bfloat16, (name, k)
                np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                              src[k].view(np.int16))
            elif isinstance(v, torch.Tensor):
                assert v.dtype == torch.bfloat16, (name, k)  # floats take the dtype
    assert t_talker_p["cache"]["i8"].dtype == torch.int8
    assert t_talker_p["cache"]["s"].dtype == torch.float32
    np.testing.assert_array_equal(t_talker_p["cache"]["s"].numpy(), np_trees[0]["cache"]["s"])


# --------------------------------------------------------------------------
# (c) the int8-dict decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_int8_attention_decode_step_matches_jax(jdtype, tdtype, window):
    r = np.random.default_rng(3)
    b, h, kv, hd, s_max = 3, 4, 2, 16, 9
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    k = r.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    v = r.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    cur_len = np.array([9, 4, 6], np.int32)
    valid_from = np.array([0, 1, 6], np.int32)  # row 2 is empty: uniform over S_max
    jk, jv = ({"i8": a, "s": s} for a, s in (j_attn.quantize_kv(jnp.asarray(x)) for x in (k, v)))
    tk, tv = ({"i8": a, "s": s} for a, s in (t_attn.quantize_kv(torch.tensor(x)) for x in (k, v)))
    jout = j_attn.attention_decode_step(
        jnp.asarray(q, jdtype), jk, jv, cur_len=jnp.asarray(cur_len),
        valid_from=jnp.asarray(valid_from), sliding_window=window)
    tq = torch.tensor(q).to(tdtype)
    args = (torch.tensor(cur_len), torch.tensor(valid_from))
    tout = t_attn.attention_decode_step(tq, tk, tv, cur_len=args[0], valid_from=args[1],
                                        sliding_window=window)
    assert tout.dtype == tdtype
    tol = F32_TOL if tdtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(_np(tout), _np(jout), atol=tol, rtol=0)

    # On CPU tensors the wrappers take the plain version (all f32 inside), and
    # a dict cache goes to the int8 variant without counting a launch.
    before = (decode_attention.launches, decode_attention_int8.launches)
    wrapped = decode_attention(tq, tk, tv, *args, window)
    assert (decode_attention.launches, decode_attention_int8.launches) == before
    assert wrapped.dtype == tdtype
    np.testing.assert_allclose(_np(wrapped), _np(jout), atol=tol, rtol=0)


# --------------------------------------------------------------------------
# (b) the int8 trunk step with int8 dict caches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_int8_trunk_decode_step_matches_jax(jdtype, tdtype):
    jt, tt = _both(_rand_trunk(TINY, 4), jdtype, tdtype)
    jq, tq = j_trunk.quantize_trunk_int8(jt), t_trunk.quantize_trunk_int8(tt)
    r = np.random.default_rng(5)
    b, s_max = 2, 7
    shape = (TINY.num_layers, b, s_max, TINY.kv_heads, TINY.head_dim)
    caches = [t_attn.quantize_kv(torch.tensor(r.standard_normal(shape).astype(np.float32)))
              for _ in range(2)]
    cur_len = np.array([5, 7], np.int32)
    valid_from = np.array([1, 0], np.int32)
    hidden = r.standard_normal((b, TINY.hidden)).astype(np.float32)
    jc, js = j_rope_cos_sin(jnp.asarray([3, 6]), TINY.head_dim, 10000.0)
    tc, ts = t_rope_cos_sin(torch.tensor([3, 6]), TINY.head_dim, 10000.0)
    jkc, jvc = ({"i8": jnp.asarray(a.numpy()), "s": jnp.asarray(s.numpy())} for a, s in caches)
    tkc, tvc = ({"i8": a.clone(), "s": s.clone()} for a, s in caches)
    jh, jk, jv = j_trunk.trunk_decode_step(
        jq, TINY, jnp.asarray(hidden, jdtype), jc, js, jkc, jvc, jnp.asarray(cur_len),
        valid_from=jnp.asarray(valid_from), layer_windows=jnp.asarray([2 ** 30, 3]))
    th, tk, tv = t_trunk.trunk_decode_step(
        tq, TINY, torch.tensor(hidden).to(tdtype), tc, ts, tkc, tvc, torch.tensor(cur_len),
        valid_from=torch.tensor(valid_from), layer_windows=[2 ** 30, 3])
    assert tk is tkc and th.dtype == tdtype  # the caches are written in place
    if tdtype == torch.float32:
        np.testing.assert_allclose(_np(th), _np(jh), atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(_np(th), _np(jh), atol=BF16_RTOL * np.abs(_np(jh)).max(),
                                   rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        # The written rows dequantize to the same K/V; untouched rows are equal.
        deq_t = _np(got["i8"]) * _np(got["s"])[..., None]
        deq_j = _np(want["i8"]) * _np(want["s"])[..., None]
        tol = F32_TOL if tdtype == torch.float32 else BF16_RTOL * np.abs(deq_j).max()
        np.testing.assert_allclose(deq_t, deq_j, atol=tol, rtol=0)
        rows = np.arange(b)
        keep = np.ones(shape[:3], bool)
        keep[:, rows, cur_len - 1] = False
        np.testing.assert_array_equal(_np(got["i8"])[keep], _np(want["i8"])[keep])


def test_int8_kv_talker_prefill_and_decode_matches_jax(tmp_path):
    from qwen_tts_tpu.io.loader import load_checkpoint as j_load

    make_checkpoint(str(tmp_path))
    cfg, jt, _, _, _ = j_load(str(tmp_path), talker_dtype=jnp.float32)
    jt = dict(jt, trunk=j_trunk.quantize_trunk_int8(jt["trunk"]))
    tt = convert_tree(jax.tree_util.tree_map(np.asarray, jt), CPU, torch.float32)
    tk = cfg.talker
    r = np.random.default_rng(6)
    b, s, s_max = 2, 5, 8
    x = r.standard_normal((b, s, tk.hidden_size)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[1, :2] = False
    jkc, jvc = j_talker.alloc_kv_cache(tk, b, s_max, kv_int8=True)
    tkc, tvc = t_talker.alloc_kv_cache(tk, b, s_max, device="cpu", kv_int8=True)
    assert tkc["i8"].dtype == torch.int8 and (tkc["s"] == np.float32(1e-8)).all()
    jpre = j_talker.talker_prefill(jt, tk, jnp.asarray(x), jnp.asarray(pad), jkc, jvc)
    tpre = t_talker.talker_prefill(tt, tk, torch.tensor(x), torch.tensor(pad), tkc, tvc)
    np.testing.assert_allclose(_np(tpre.logits), _np(jpre.logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(tpre.k_cache["s"]), _np(jpre.k_cache["s"]), rtol=1e-5)

    emb = r.standard_normal((b, tk.hidden_size)).astype(np.float32)
    n_real = pad.sum(-1).astype(np.int32)
    jout = j_talker.talker_decode_step(
        jt, tk, jnp.asarray(emb), jnp.asarray(n_real), jpre.k_cache, jpre.v_cache,
        jnp.full(b, s + 1, jnp.int32), jnp.asarray(s - n_real))
    tout = t_talker.talker_decode_step(
        tt, tk, torch.tensor(emb), torch.tensor(n_real), tpre.k_cache, tpre.v_cache,
        torch.full((b,), s + 1, dtype=torch.int32), torch.tensor(s - n_real))
    np.testing.assert_allclose(_np(tout[0]), _np(jout[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(tout[1]), _np(jout[1]), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# (e) the micro-step's plain version against JAX's int8 trunk step, f32
# --------------------------------------------------------------------------

def test_subtalker_step_plain_matches_jax_int8_trunk_f32():
    jt, _ = _both(_rand_trunk(TINY, 7), jnp.float32, torch.float32)
    jq = j_trunk.quantize_trunk_int8(jt)
    packed = pack_subtalker_weights(convert_tree(jax.tree_util.tree_map(np.asarray, jq), CPU,
                                                 torch.float32))
    r = np.random.default_rng(8)
    b, g = 3, 5
    shape = (TINY.num_layers, b, g, TINY.kv_heads, TINY.head_dim)
    jkc, jvc = jnp.zeros(shape), jnp.zeros(shape)
    tkc, tvc = torch.zeros(shape), torch.zeros(shape)
    jcos, jsin = j_rope_cos_sin(jnp.arange(g), TINY.head_dim, 10000.0)
    tcos, tsin = t_rope_cos_sin(torch.arange(g), TINY.head_dim, 10000.0)
    for pos in range(g):
        x = r.standard_normal((b, TINY.hidden)).astype(np.float32)
        jh, jkc, jvc = j_trunk.trunk_decode_step(
            jq, TINY, jnp.asarray(x), jnp.broadcast_to(jcos[pos], (b, TINY.head_dim)),
            jnp.broadcast_to(jsin[pos], (b, TINY.head_dim)), jkc, jvc, pos + 1,
            unroll_layers=True)
        before = subtalker_step.launches
        th, tkc, tvc = subtalker_step(packed, torch.tensor(x), tcos[pos], tsin[pos], tkc, tvc,
                                      pos, TINY.eps)
        assert subtalker_step.launches == before  # CPU tensors: the plain version
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# (h) the kernel layout of the pack
# --------------------------------------------------------------------------

def _int8_trunk(dims, seed, dtype=torch.bfloat16):
    """A ``quantize_trunk_int8``-shaped tree with random int8 weights and
    scales (no float weights to quantize, so flagship dims stay cheap)."""
    g = torch.Generator().manual_seed(seed)
    l, d, h, kv, hd, i = dims
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
              "gate": (d, i), "up": (d, i), "down": (i, d)}
    tree = {}
    for k, (fan_in, out) in shapes.items():
        tree[k + "_i8"] = torch.randint(-127, 128, (l, fan_in, out), generator=g,
                                        dtype=torch.int8)
        tree[k + "_s"] = (torch.rand(l, 1, out, generator=g) * 0.01 + 1e-3).bfloat16()
    for k, n in (("input_norm", d), ("post_attn_norm", d), ("q_norm", hd), ("k_norm", hd)):
        tree[k] = (1 + 0.1 * torch.randn(l, n, generator=g)).to(dtype)
    return tree


def _row_major(tree):
    """The pack's weights row-major, as the kernel's first layout had them:
    [Wq|Wk|Wv] and [gate|up] concatenated along their output columns."""
    def cat(*keys):
        return torch.cat([tree[k + "_i8"] for k in keys], dim=-1)

    def scales(*keys):
        return torch.cat([tree[k + "_s"] for k in keys], dim=-1).float().squeeze(1)

    return {"wqkv": cat("wq", "wk", "wv"), "qkv_s": scales("wq", "wk", "wv"),
            "wo": cat("wo"), "wo_s": scales("wo"), "wgu": cat("gate", "up"),
            "gu_s": scales("gate", "up"), "down": cat("down"), "down_s": scales("down"),
            **{k: tree[k] for k in ("input_norm", "post_attn_norm", "q_norm", "k_norm")}}


def test_subtalker_pack_untiles_bit_for_bit_at_flagship_dims():
    tree = _int8_trunk(KERNEL_DIMS, seed=11)
    packed = pack_subtalker_weights(tree)
    assert packed.kernel_refuses == "operands on cpu"  # flagship dims: only the device
    # One contiguous run per (layer, block) of 128 blocks: 120 KB per block per layer.
    per_block = {k: packed[k].shape[2] for k in ("wqkv", "wo", "wgu", "down")}
    assert {k: packed[k].shape[:2] for k in per_block} == {k: (5, 128) for k in per_block}
    assert per_block == {"wqkv": 32768, "wo": 16384, "wgu": 49152, "down": 24576}
    # [gate|up]: block 0's first tile holds gate column 0 at lane 0 (k 0, 1, 8, 9).
    np.testing.assert_array_equal(packed["wgu"][0, 0, :4].numpy(),
                                  tree["gate_i8"][0, [0, 1, 8, 9], 0].numpy())
    np.testing.assert_array_equal(packed["gu_s"][0, 8:16].numpy(),
                                  tree["up_s"][0, 0, :8].float().numpy())
    rows = unpack_subtalker_weights(packed)
    want = _row_major(tree)
    assert sorted(rows) == sorted(want)
    for k, v in want.items():
        assert rows[k].dtype == v.dtype, k
        assert torch.equal(rows[k], v), k


@pytest.mark.parametrize("dims", [(2, 64, 4, 2, 16, 96), (2, 32, 4, 4, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subtalker_step_plain_on_the_pack_equals_row_major(dims, dtype):
    """The plain version on the tiled pack gives the bits of the same step on
    the row-major weights (the first layout), outputs and cache rows."""
    tree = _int8_trunk(dims, seed=12, dtype=dtype)
    packed = pack_subtalker_weights(tree)
    rows = _row_major(tree)
    l, d, _, kv, hd, _ = dims
    r = np.random.default_rng(13)
    b, g = 3, 4
    caches = [torch.zeros(l, b, g, kv, hd, dtype=dtype) for _ in range(4)]
    cos, sin = t_rope_cos_sin(torch.arange(g), hd, 10000.0)
    for pos in range(g):
        x = torch.tensor(r.standard_normal((b, d)), dtype=torch.float32).to(dtype)
        got, _, _ = subtalker_step_plain(packed, x, cos[pos], sin[pos], *caches[:2], pos, 1e-6)
        want, _, _ = subtalker_step_rows(rows, x, cos[pos], sin[pos], *caches[2:], pos, 1e-6)
        assert torch.equal(got, want)
    assert torch.equal(caches[0], caches[2]) and torch.equal(caches[1], caches[3])


# --------------------------------------------------------------------------
# (d) the micro-step's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------

def _pallas_step_module():
    path = os.path.join(REPO, "scripts", "exp_pallas_subtalker_step.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_subtalker_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The same rounding points on both sides, sums in another order: a hidden
# value may differ by a bf16 ulp or two of the largest |h| and a cache value
# by one bf16 ulp of its own magnitude (the script's own check against XLA's
# composition, which rounds elsewhere, allows 0.08).
PALLAS_H_RTOL = 2 ** -6
PALLAS_CACHE_ATOL = 2 ** -5


def test_subtalker_step_plain_matches_pallas_kernel_interpret():
    mod = _pallas_step_module()
    dims = j_trunk.TrunkDims(num_layers=mod.L, hidden=mod.D, heads=mod.H, kv_heads=mod.KV,
                             head_dim=mod.HD, intermediate=mod.I, eps=mod.EPS)
    trunk = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   _rand_trunk(dims, 9))
    tq = j_trunk.quantize_trunk_int8(trunk)
    packed_j = mod.pack_weights(tq, trunk)
    packed_t = pack_subtalker_weights(convert_tree(jax.tree_util.tree_map(np.asarray, tq),
                                                   CPU, torch.bfloat16))
    b, g = 2, 4
    kc_j = jnp.zeros((mod.L, g, b, mod.KV * mod.HD), jnp.bfloat16)
    vc_j = jnp.zeros_like(kc_j)
    shape = (mod.L, b, g, mod.KV, mod.HD)
    kc_t = torch.zeros(shape, dtype=torch.bfloat16)
    vc_t = torch.zeros(shape, dtype=torch.bfloat16)
    cos, sin = t_rope_cos_sin(torch.arange(g), mod.HD, 10000.0)
    r = np.random.default_rng(10)
    for pos in range(3):
        x = r.standard_normal((b, mod.D)).astype(ml_dtypes.bfloat16)
        h_j, kc_j, vc_j = mod.pallas_subtalker_trunk_step(
            packed_j, jnp.asarray(x), jnp.asarray(cos[pos].numpy())[None],
            jnp.asarray(sin[pos].numpy())[None], kc_j, vc_j, pos, g_max=g, interpret=True)
        h_t, kc_t, vc_t = subtalker_step_plain(
            packed_t, torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16), cos[pos],
            sin[pos], kc_t, vc_t, pos, mod.EPS)
        want = _np(h_j)
        np.testing.assert_allclose(_np(h_t), want, atol=PALLAS_H_RTOL * np.abs(want).max(),
                                   rtol=0)
        for got, ref in ((kc_t, kc_j), (vc_t, vc_j)):
            rows = _np(ref)[:, pos].reshape(mod.L, b, mod.KV, mod.HD)
            np.testing.assert_allclose(_np(got[:, :, pos]), rows, atol=PALLAS_CACHE_ATOL,
                                       rtol=2 ** -7)


# --------------------------------------------------------------------------
# (f) the slice: quantize_for_serving + greedy generate_custom_voice, f32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_int8_ckpt"))
    make_checkpoint(d)
    jm = JaxModel.from_pretrained(d, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(d, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    jm.tokenizer = tm.tokenizer = FakeTokenizer()
    jm.codec_params = tame_codec(jm.codec_params)
    tm.codec_params = tame_codec(tm.codec_params)
    assert tm.quantize_for_serving(talker=True, kv=True) is tm
    jm.quantize_for_serving(talker=True, kv=True)
    return jm, tm


def test_quantize_for_serving_state(serving_models):
    _, tm = serving_models
    assert tm.kv_int8
    assert "wq_i8" in tm.talker_params["trunk"] and "wq" not in tm.talker_params["trunk"]
    st = tm.subtalker_params
    assert "embeds_i8" in st and "lm_heads_i8" in st and "embeds" not in st
    assert st["trunk_packed"]["wqkv"].dtype == torch.int8
    assert st["trunk_packed"]["qkv_s"].dtype == torch.float32


def test_serving_mode_greedy_matches_jax(serving_models):
    jm, tm = serving_models
    texts = ["hello there, a longer line", "hi"]
    speakers = ["aiden", "serena"]
    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=10)
    jw, _ = jm.generate_custom_voice(texts, speakers, "auto", **kw)
    tw, _ = tm.generate_custom_voice(texts, speakers, "auto", **kw)
    prompts_j, prompts_t = [], []
    from qwen_tts_tpu.generate import build_prompt as jb
    from qwen_tts_tpu_torch.generate import build_prompt as tb

    for text, spk in zip(texts, speakers):
        prompts_j.append(jb(jm.talker_params, jm.cfg,
                            jm._tokenize(jm.build_assistant_text(text)), speaker=spk))
        prompts_t.append(tb(tm.talker_params, tm.cfg,
                            tm._tokenize(tm.build_assistant_text(text)), speaker=spk))
    jcodes, jinfo = jm.generate_codes_from_prompts(prompts_j, jm._merge_params(**kw))
    tcodes, tinfo = tm.generate_codes_from_prompts(prompts_t, tm._merge_params(**kw))
    np.testing.assert_array_equal(tinfo["num_gen"], jinfo["num_gen"])
    for t, j in zip(tcodes, jcodes):
        np.testing.assert_array_equal(t, j)
    up = tm.cfg.codec.decode_upsample_rate
    for t, j, c in zip(tw, jw, tcodes):
        assert t.shape == j.shape == (c.shape[0] * up,)
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
