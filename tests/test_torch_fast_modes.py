"""The port's serving fast modes against the JAX package's, on the CPU in f32:
fused trunk projections, the Jacobi sub-talker, the sub-talker int8 KV cache,
``QTTS_ST_SPLIT`` and the gates in the captured programs' keys (the scenarios
of tests/test_fused_trunk.py, test_subtalker_jacobi.py, test_kv_int8.py and
the Jacobi case of test_continuous.py).

Parameters come from the JAX package's random init and are carried across
with ``convert.py``; inputs come from a numpy seed. Greedy codes must equal
the JAX package's exactly; sampled traces (``torch.Generator`` draws, which
JAX cannot reproduce) are held to the port's own sequential trace from the
same seed."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (  # noqa: F401
    DecodedCodes,
    SERVING_BUCKET,
    SERVING_CEILING,
    clone_checkpoint,
    greedy_params,
    one_torch_thread,
)
from qwen_tts_tpu import generate as j_generate
from qwen_tts_tpu.config import tiny_tts_config as j_tiny_config
from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import talker as j_talker
from qwen_tts_tpu.models import trunk as j_trunk
from qwen_tts_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from qwen_tts_tpu.ops.sampling import SamplingConfig as JSampling
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.config import tiny_tts_config
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine
from qwen_tts_tpu_torch.convert import convert_params, convert_tree
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import trunk as t_trunk
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import pack_subtalker_weights
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin as t_rope_cos_sin
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig as TSampling
from qwen_tts_tpu_torch.ops.sampling_vec import VecSampling as TVecSampling

CPU = torch.device("cpu")
# f32 on both sides: summation order only (tests/test_fused_trunk.py's bound).
ATOL = 1e-5
DIMS = j_trunk.TrunkDims(num_layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                         intermediate=96, eps=1e-6)
WAIT = 120  # seconds any engine future may take


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _torch(tree):
    """A JAX tree as the port's tree (f32 on the CPU; int8 leaves and scales
    keep their dtype)."""
    return convert_tree(jax.tree_util.tree_map(np.asarray, tree), CPU, torch.float32)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX (talker, sub-talker) params, port
    params): the JAX package's random init of the tiny config."""
    jcfg = j_tiny_config()
    rng = jax.random.PRNGKey(0)
    jt = j_talker.init_talker_params(rng, jcfg.talker)
    js = j_st.init_subtalker_params(jax.random.fold_in(rng, 1), jcfg.talker.code_predictor,
                                    jcfg.talker.hidden_size)
    tt, ts, _ = convert_params(*jax.tree_util.tree_map(np.asarray, (jt, js)),
                               talker_dtype=torch.float32, device="cpu")
    return jcfg, tiny_tts_config(), (jt, js), (tt, ts)


def _st_inputs(tiny, seed, batch=3):
    """(JAX args, port args) of one frame's micro-decode: the talker's codec
    table, a hidden state and each row's first code."""
    jcfg, _, (jt, _), (tt, _) = tiny
    r = np.random.default_rng(seed)
    hidden = (r.standard_normal((batch, jcfg.talker.hidden_size)) * 0.3).astype(np.float32)
    first = r.integers(0, jcfg.talker.code_predictor.vocab_size, batch)
    return ((jt["codec_embedding"], jnp.asarray(hidden), jnp.asarray(first, jnp.int32)),
            (tt["codec_embedding"], torch.tensor(hidden), torch.tensor(first)))


def _st_params(tiny, int8_tables: bool):
    _, _, (_, js), (_, ts) = tiny
    if not int8_tables:
        return js, ts
    return j_st.quantize_subtalker_tables_int8(js), t_st.quantize_subtalker_tables_int8(ts)


# --------------------------------------------------------------------------
# Fused trunk projections
# --------------------------------------------------------------------------

def _rand_trunk(seed):
    r = np.random.default_rng(seed)
    l, d, h, kv, hd, i = (DIMS.num_layers, DIMS.hidden, DIMS.heads, DIMS.kv_heads,
                          DIMS.head_dim, DIMS.intermediate)

    def w(*shape):
        return (r.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def norm(*shape):
        return (1 + 0.1 * r.standard_normal(shape)).astype(np.float32)

    return {"wq": w(l, d, h * hd), "wk": w(l, d, kv * hd), "wv": w(l, d, kv * hd),
            "wo": w(l, h * hd, d), "gate": w(l, d, i), "up": w(l, d, i), "down": w(l, i, d),
            "input_norm": norm(l, d), "post_attn_norm": norm(l, d), "q_norm": norm(l, hd),
            "k_norm": norm(l, hd)}


def _trunk_outputs(jtree, ttree, seed=1):
    """(JAX, port) outputs of trunk_prefill (hidden, k, v) and of one
    trunk_decode_step (hidden and both caches) on the same inputs."""
    r = np.random.default_rng(seed)
    b, s = 2, 6
    x = r.standard_normal((b, s, DIMS.hidden)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc, js_ = j_rope_cos_sin(jnp.asarray(pos), DIMS.head_dim, 10000.0)
    tc, ts_ = t_rope_cos_sin(torch.tensor(pos), DIMS.head_dim, 10000.0)
    jout = list(j_trunk.trunk_prefill(jtree, DIMS, jnp.asarray(x), jc, js_))
    tout = list(t_trunk.trunk_prefill(ttree, DIMS, torch.tensor(x), tc, ts_))
    shape = (DIMS.num_layers, b, 8, DIMS.kv_heads, DIMS.head_dim)
    jh, jkc, jvc = j_trunk.trunk_decode_step(
        jtree, DIMS, jnp.asarray(x[:, 0]), jc[:, 0], js_[:, 0], jnp.zeros(shape),
        jnp.zeros(shape), jnp.int32(1))
    th, tkc, tvc = t_trunk.trunk_decode_step(
        ttree, DIMS, torch.tensor(x[:, 0]), tc[:, 0], ts_[:, 0], torch.zeros(shape),
        torch.zeros(shape), torch.ones(b, dtype=torch.int32))
    return jout + [jh, jkc, jvc], tout + [th, tkc, tvc]


def test_fuse_trunk_params_matches_jax():
    tree = _rand_trunk(0)
    jfused = j_trunk.fuse_trunk_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tfused = t_trunk.fuse_trunk_params(_torch(tree))
    assert sorted(tfused) == sorted(jfused)
    assert "wq" not in tfused and "gate" not in tfused
    for k in jfused:
        np.testing.assert_array_equal(_np(tfused[k]), np.asarray(jfused[k]), err_msg=k)
    jout, tout = _trunk_outputs(jfused, tfused)
    _, unfused = _trunk_outputs(jfused, _torch(tree))
    for j, t, u in zip(jout, tout, unfused):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(t), _np(u), atol=ATOL, rtol=0)


def test_quantized_fused_trunk_bit_identical_and_packs_alike():
    tree = _rand_trunk(2)
    jq = j_trunk.quantize_trunk_int8(
        j_trunk.fuse_trunk_params(jax.tree_util.tree_map(jnp.asarray, tree)))
    tq = t_trunk.quantize_trunk_int8(t_trunk.fuse_trunk_params(_torch(tree)))
    assert sorted(tq) == sorted(jq)
    for k in jq:
        got, want = tq[k], np.asarray(jq[k])
        if k.endswith("_s"):
            assert got.dtype == torch.bfloat16
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(_np(got), want, err_msg=k)
    # Per-column scales: the fused int8 values and scales are the parts'.
    parts = t_trunk.quantize_trunk_int8(_torch(tree))
    for fused, keys in (("wqkv", ("wq", "wk", "wv")), ("wgu", ("gate", "up"))):
        for suffix in ("_i8", "_s"):
            assert torch.equal(tq[fused + suffix],
                               torch.cat([parts[k + suffix] for k in keys], dim=-1))
    jout, tout = _trunk_outputs(jq, tq)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL, rtol=0)
    fused_pack, pack = pack_subtalker_weights(tq), pack_subtalker_weights(parts)
    assert sorted(fused_pack) == sorted(pack)
    for k in pack:
        assert fused_pack[k].dtype == pack[k].dtype and torch.equal(fused_pack[k], pack[k]), k
    # Either pack untiles to the unfused int8 tree, bit for bit.
    for p in (pack, fused_pack):
        tree = p.trunk()
        assert sorted(tree) == sorted(parts) and p.trunk() is tree
        for k in parts:
            assert tree[k].dtype == parts[k].dtype and torch.equal(tree[k], parts[k]), k


@pytest.mark.parametrize("dims", [(2, 32, 4, 4, 16, 64), (5, 1024, 16, 8, 128, 3072)])
def test_pack_untiles_to_the_int8_tree(dims):
    """``SubtalkerPack.trunk`` (what the layer-by-layer routes of the serving
    mode run) is the tree that was packed, bit for bit, where the heads'
    width differs from the hidden width (the flagship sub-talker's too)."""
    from test_torch_int8 import _int8_trunk

    tree = _int8_trunk(dims, seed=14)
    got = pack_subtalker_weights(tree).trunk()
    assert sorted(got) == sorted(tree)
    for k in tree:
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k]), k


# --------------------------------------------------------------------------
# The Jacobi micro-decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("int8_tables", [False, True])
def test_jacobi_greedy_matches_jax_and_sequential(tiny, int8_tables, monkeypatch):
    jcfg, tcfg, _, _ = tiny
    jcp, tcp = jcfg.talker.code_predictor, tcfg.talker.code_predictor
    g = tcp.num_code_groups
    jp, tp = _st_params(tiny, int8_tables)
    jargs, targs = _st_inputs(tiny, seed=5 if int8_tables else 1)
    greedy = TSampling(do_sample=False)
    seq = t_st.subtalker_generate(tp, tcp, *targs, greedy)
    jac, iters = t_st.subtalker_generate_jacobi(tp, tcp, *targs, return_iters=True)
    jjac, jiters = j_st.subtalker_generate_jacobi(jp, jcp, *jargs, return_iters=True)
    jseq = j_st.subtalker_generate(jp, jcp, *jargs, JSampling(do_sample=False), None)
    np.testing.assert_array_equal(_np(seq), np.asarray(jseq))
    np.testing.assert_array_equal(_np(jac), np.asarray(jjac))
    np.testing.assert_array_equal(_np(jac), _np(seq))
    assert iters == int(jiters) and 1 <= iters <= g - 1
    full = t_st.subtalker_generate_jacobi(tp, tcp, *targs, fixed_iters=g - 1)
    np.testing.assert_array_equal(_np(full), _np(seq))
    one = t_st.subtalker_generate_jacobi(tp, tcp, *targs, fixed_iters=1)
    np.testing.assert_array_equal(
        _np(one), np.asarray(j_st.subtalker_generate_jacobi(jp, jcp, *jargs, fixed_iters=1)))
    # A captured frame's schedule: exactly G-1 forwards, no host read.
    from test_torch_graph_safe import NoHostReads

    forwards = []
    prefill = t_trunk.trunk_prefill
    monkeypatch.setattr(t_st, "trunk_prefill",
                        lambda *a, **k: forwards.append(1) or prefill(*a, **k))
    with NoHostReads():
        captured = t_st.subtalker_generate_jacobi(tp, tcp, *targs, fixed_iters=g - 1)
    np.testing.assert_array_equal(_np(captured), _np(seq))
    assert len(forwards) == g - 1


SAMPLED = {
    "top_k": (TSampling(do_sample=True, temperature=0.9, top_k=50, top_p=1.0), False),
    "top_p_int8": (TSampling(do_sample=True, temperature=1.3, top_k=0, top_p=0.8), True),
    "vec": (None, False),
}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_jacobi_sampled_equals_sequential_sampled(tiny, case):
    _, tcfg, _, _ = tiny
    tcp = tcfg.talker.code_predictor
    sampling, int8_tables = SAMPLED[case]
    _, tp = _st_params(tiny, int8_tables)
    _, targs = _st_inputs(tiny, seed=13, batch=4)
    vec = None
    if sampling is None:  # per row: greedy, top-k and top-p rows side by side
        vec = TVecSampling(do_sample=torch.tensor([True, False, True, True]),
                           temperature=torch.tensor([0.9, 1.0, 1.4, 0.7]),
                           top_k=torch.tensor([50, 0, 8, 0], dtype=torch.int32),
                           top_p=torch.tensor([1.0, 1.0, 0.9, 0.8]),
                           repetition_penalty=torch.ones(4),
                           min_new_tokens=torch.zeros(4, dtype=torch.int32))
        sampling = TSampling(do_sample=False)

    def gen():
        return torch.Generator().manual_seed(11)

    seq = t_st.subtalker_generate(tp, tcp, *targs, sampling, gen(), vec)
    jac = t_st.subtalker_generate_jacobi(tp, tcp, *targs, sampling=sampling, generator=gen(),
                                         vec_sampling=vec)
    np.testing.assert_array_equal(_np(jac), _np(seq))
    other = t_st.subtalker_generate(tp, tcp, *targs, sampling,
                                    torch.Generator().manual_seed(12), vec)
    assert not torch.equal(other, seq)  # the draws do decide the codes


# --------------------------------------------------------------------------
# The sub-talker int8 KV cache and QTTS_ST_SPLIT
# --------------------------------------------------------------------------

def test_subtalker_kv8_matches_jax_and_takes_the_layer_route(tiny, monkeypatch):
    jcfg, tcfg, _, (_, ts) = tiny
    jcp, tcp = jcfg.talker.code_predictor, tcfg.talker.code_predictor
    jp, tp = _st_params(tiny, False)
    jargs, targs = _st_inputs(tiny, seed=3, batch=2)
    kc, vc = t_st.alloc_subtalker_cache(tcp, 2, kv_int8=True)
    assert kc["i8"].dtype == torch.int8 and kc["i8"].shape == (2, 2, 8, 2, 16)
    assert kc["s"].dtype == torch.float32 and bool((kc["s"] == 1e-8).all())
    greedy = TSampling(do_sample=False)
    want = np.asarray(j_st.subtalker_generate(jp, jcp, *jargs, JSampling(do_sample=False),
                                              None, kv_int8=True))
    np.testing.assert_array_equal(_np(t_st.subtalker_generate(tp, tcp, *targs, greedy,
                                                              kv_int8=True)), want)
    monkeypatch.setenv("QTTS_ST_KV8", "1")
    np.testing.assert_array_equal(_np(t_st.subtalker_generate(tp, tcp, *targs, greedy)), want)
    # The serving mode's trunk, kept only as the pack: the int8 cache still
    # takes the layer-by-layer route (over the tree untiled from the pack),
    # never the micro-step kernel.
    served = dict(ts, trunk_packed=pack_subtalker_weights(t_trunk.quantize_trunk_int8(
        ts["trunk"])))
    del served["trunk"]
    want8 = np.asarray(j_st.subtalker_generate(
        dict(jp, trunk=j_trunk.quantize_trunk_int8(jp["trunk"])), jcp, *jargs,
        JSampling(do_sample=False), None, kv_int8=True))
    monkeypatch.setattr(t_st, "subtalker_step", lambda *a, **k: pytest.fail("kernel route"))
    np.testing.assert_array_equal(_np(t_st.subtalker_generate(served, tcp, *targs, greedy)),
                                  want8)


def _recorded_logits(monkeypatch):
    """Every f32 logits tensor the sub-talker's heads give, in order."""
    seen, head = [], t_st._lm_head_logits
    monkeypatch.setattr(t_st, "_lm_head_logits",
                        lambda *a: seen.append(head(*a)) or seen[-1])
    return seen


@pytest.mark.parametrize("route", ["layers", "kernel"])
def test_split_gives_the_same_bits(tiny, route, monkeypatch):
    _, tcfg, _, (_, ts) = tiny
    tcp = tcfg.talker.code_predictor
    params = ts
    if route == "kernel":  # the serving mode's pack (its plain version here)
        trunk = t_trunk.quantize_trunk_int8(ts["trunk"])
        params = dict(ts, trunk=trunk, trunk_packed=pack_subtalker_weights(trunk))
    _, targs = _st_inputs(tiny, seed=4, batch=2)
    sampling = TSampling(do_sample=True, top_k=20)
    runs = []
    for split in (None, "1"):
        if split:
            monkeypatch.setenv("QTTS_ST_SPLIT", split)
        seen = _recorded_logits(monkeypatch)
        codes = t_st.subtalker_generate(params, tcp, *targs, sampling,
                                        torch.Generator().manual_seed(3))
        runs.append((codes, torch.stack(seen)))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


# --------------------------------------------------------------------------
# The gates through the decode loop, and the programs' keys
# --------------------------------------------------------------------------

def _decode_inputs(tiny, seed=0):
    jcfg = tiny[0]
    r = np.random.default_rng(seed)
    b, s, d = 2, 8, jcfg.talker.hidden_size
    embeds = r.standard_normal((b, s, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, :3] = False
    trailing = r.standard_normal((b, 4, d)).astype(np.float32)
    return embeds, mask, trailing


def _greedy_codes(tiny, params=None, kv_int8=False, frames=5):
    """(JAX, port) greedy codes [B, frames, G] of generate_codes on the tiny
    params (``params``: (JAX, port) (talker, sub-talker) trees instead)."""
    jcfg, tcfg, jp, tp = tiny
    (jt, js), (tt, ts) = params or (jp, tp)
    e, m, t = _decode_inputs(tiny)
    gp = j_generate.GenerationParams().greedy()
    jout = j_generate.generate_codes(
        jt, js, jcfg.talker, jnp.asarray(e), jnp.asarray(m), jnp.asarray(t),
        sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
        max_new_tokens=frames, rng=jax.random.PRNGKey(0), kv_int8=kv_int8)
    tgp = t_generate.GenerationParams().greedy()
    tout = t_generate.generate_codes(
        tt, ts, tcfg.talker, torch.tensor(e), torch.tensor(m), torch.tensor(t),
        sampling=tgp.talker_sampling(), st_sampling=tgp.subtalker_sampling(),
        max_new_tokens=frames, generator=None, kv_int8=kv_int8)
    return np.asarray(jout.codes), _np(tout.codes)


GATES = {
    "jacobi": ({"QTTS_ST_JACOBI": "1"}, False),
    "jacobi_talker_kv8": ({"QTTS_ST_JACOBI": "1"}, True),
    "jacobi_iters_1": ({"QTTS_ST_JACOBI": "1", "QTTS_ST_JACOBI_ITERS": "1"}, False),
    "st_kv8": ({"QTTS_ST_KV8": "1"}, False),
    "split": ({"QTTS_ST_SPLIT": "1"}, False),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_through_the_decode_matches_jax(tiny, gate, monkeypatch):
    env, kv_int8 = GATES[gate]
    _, plain = _greedy_codes(tiny, kv_int8=kv_int8)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcodes, tcodes = _greedy_codes(tiny, kv_int8=kv_int8)
    np.testing.assert_array_equal(tcodes, jcodes)
    if gate == "jacobi_iters_1":  # one forward is not the fixed point here
        assert not np.array_equal(tcodes, plain)
    elif gate != "st_kv8":  # exact gates
        np.testing.assert_array_equal(tcodes, plain)


@pytest.mark.parametrize("kind", ["fused", "fused_int8"])
def test_fused_trunks_greedy_match_jax(tiny, kind):
    jcfg, tcfg, (jt, js), (tt, ts) = tiny
    jt = dict(jt, trunk=j_trunk.fuse_trunk_params(jt["trunk"]))
    js = dict(js, trunk=j_trunk.fuse_trunk_params(js["trunk"]))
    tt = dict(tt, trunk=t_trunk.fuse_trunk_params(tt["trunk"]))
    ts = dict(ts, trunk=t_trunk.fuse_trunk_params(ts["trunk"]))
    if kind == "fused_int8":  # the serving mode on fused trunks, both packages
        jt = dict(jt, trunk=j_trunk.quantize_trunk_int8(jt["trunk"]))
        js = j_st.quantize_subtalker_tables_int8(
            dict(js, trunk=j_trunk.quantize_trunk_int8(js["trunk"])))
        model = t_pipeline.Qwen3TTSModel(tcfg, tt, ts).quantize_for_serving(talker=True)
        tt, ts = model.talker_params, model.subtalker_params
        assert "wqkv_i8" in tt["trunk"] and "trunk" not in ts and "trunk_packed" in ts
    jcodes, tcodes = _greedy_codes(tiny, params=((jt, js), (tt, ts)))
    np.testing.assert_array_equal(tcodes, jcodes)


def test_gate_flips_change_the_program_keys(tiny, monkeypatch):
    _, tcfg, _, (tt, _) = tiny
    e, m, t = (torch.tensor(a) for a in _decode_inputs(tiny))
    state = t_generate._prefill(tt, tcfg.talker, e, m, sampling=TSampling(do_sample=False),
                                max_cache_len=16, generator=None)
    greedy = TSampling(do_sample=False)

    def keys():
        return (t_generate.frame_key(state, t, tcfg.talker, greedy, greedy),
                t_pipeline.first_packet_key(e, t, tcfg.talker, tcfg.codec.decoder,
                                            sampling=greedy, st_sampling=greedy,
                                            max_cache_len=16, first_segment=2, kv_int8=False))

    base = keys()
    for name in t_st.ST_ENV_KEYS:
        monkeypatch.setenv(name, "1")
        flipped = keys()
        assert flipped[0] != base[0] and flipped[1] != base[1], name
        monkeypatch.delenv(name)
        assert keys() == base, name


FRAME_GATES = {
    "jacobi_greedy": ({"QTTS_ST_JACOBI": "1"}, True, False),
    "jacobi_sampled": ({"QTTS_ST_JACOBI": "1"}, True, True),
    "st_kv8_sampled": ({"QTTS_ST_KV8": "1"}, True, True),
    "split_sampled": ({"QTTS_ST_SPLIT": "1"}, False, True),
}


@pytest.mark.parametrize("gate", sorted(FRAME_GATES))
def test_a_gated_frame_reads_no_device_value(tiny, gate, monkeypatch):
    """A frame under each gate, as the card captures it (the Jacobi loop's
    captured schedule), hands no device value to the host."""
    from test_torch_graph_safe import NoHostReads

    env, serving, sampled = FRAME_GATES[gate]
    _, tcfg, _, (tt, ts) = tiny
    if serving:
        model = t_pipeline.Qwen3TTSModel(tcfg, tt, ts).quantize_for_serving(talker=True, kv=True)
        tt, ts = model.talker_params, model.subtalker_params
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gp = t_generate.GenerationParams(top_k=20, top_p=0.8)
    gp = gp if sampled else gp.greedy()
    e, m, t = (torch.tensor(a) for a in _decode_inputs(tiny))
    generator = torch.Generator().manual_seed(0)
    state = t_generate._prefill(tt, tcfg.talker, e, m, sampling=gp.talker_sampling(),
                                max_cache_len=16, generator=generator, kv_int8=serving)
    limit = torch.tensor([8, 8], dtype=torch.int32)
    body = t_generate._frame_body(tt, ts, tcfg.talker, gp.talker_sampling(),
                                  gp.subtalker_sampling(), t, limit, generator, captured=True)
    with NoHostReads():
        new, codes = body(state)
    assert codes.shape == (2, tcfg.talker.num_code_groups) and new.num_gen.tolist() == [1, 1]


# --------------------------------------------------------------------------
# The continuous engine under QTTS_ST_JACOBI=1
# --------------------------------------------------------------------------

def test_continuous_engine_jacobi_greedy_slot_exact(tmp_path_factory, monkeypatch):
    """A greedy slot of the continuous engine under the Jacobi gate equals
    its solo sequential codes while a sampled slot (sub-talker sampling
    too) decodes beside it."""
    from test_voice_clone import FakeTokenizer

    tm = t_pipeline.Qwen3TTSModel.from_pretrained(
        clone_checkpoint(tmp_path_factory), talker_dtype=torch.float32, device="cpu",
        load_tokenizer=False)
    tm.tokenizer = FakeTokenizer()

    def prompt(ids):
        return t_generate.build_prompt(tm.talker_params, tm.cfg, np.asarray(ids),
                                       language="english", speaker="aiden")

    p_greedy = prompt([1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3])
    p_sampled = prompt([1, 2, 3, 20, 21, 22, 23, 24, 4, 5, 1, 2, 3])
    greedy = greedy_params(t_generate, 5)
    sampled = dataclasses.replace(greedy, do_sample=True, subtalker_do_sample=True,
                                  temperature=1.1, top_k=8, seed=13)
    solo, _ = tm.generate_codes_from_prompts(
        [p_greedy], dataclasses.replace(greedy, max_new_tokens=SERVING_CEILING),
        step_limit=[6], max_new_ceiling=SERVING_CEILING, trailing_bucket=16)
    monkeypatch.setenv("QTTS_ST_JACOBI", "1")
    engine = ContinuousBatchingEngine(tm, num_slots=2, segment_frames=2,
                                      max_new_tokens=SERVING_CEILING,
                                      prefill_bucket=SERVING_BUCKET, trailing_cap=32).start()
    try:
        with DecodedCodes(tm) as recorded:
            fut_s = engine.submit_prompt(p_sampled, sampled)
            fut_g = engine.submit_prompt(p_greedy, greedy)
            deadline = time.monotonic() + WAIT
            wav_s = fut_s.result(timeout=WAIT)
            wav_g = fut_g.result(timeout=max(deadline - time.monotonic(), 1))
    finally:
        engine.stop()
    up = tm.cfg.codec.decode_upsample_rate
    assert wav_s.shape == wav_g.shape == (5 * up,) and np.isfinite(wav_s).all()
    assert any(r.shape == solo[0].shape and np.array_equal(r, solo[0]) for r in recorded)
    np.testing.assert_allclose(wav_g, tm.decode_codes(solo)[0], atol=1e-5)
