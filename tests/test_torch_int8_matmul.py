"""The int8-weight GEMM of the serving mode (``ops/cuda/int8_matmul.py``) on
the CPU.

Its plain version is held against the JAX package's ``_w_matmul`` and the
sub-talker's int8 LM-head logits on the same numpy inputs, f32 and bf16; the
trunk and the sub-talker route their int8 products through it; and the
kernel's CUDA source (``csrc/int8_matmul.cu``), compiled with g++ against the
host emulation in ``tests/cuda_host``, is held against the plain version per
element (the CUDA-core kernel for f32 activations, the tensor-core one for
bf16) and, bit for bit, gives a row the same result at M 1, 4 and 32. The
emulation runs in one subprocess with a time limit."""

import ctypes
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import trunk as j_trunk
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import trunk as t_trunk
from qwen_tts_tpu_torch.models.trunk import quantize_int8
from qwen_tts_tpu_torch.ops.cuda import int8_matmul as im
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import (
    int8_matmul,
    int8_matmul_group,
    int8_matmul_plain,
)
from qwen_tts_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin as t_rope_cos_sin
from torch_port_fixtures import (  # noqa: F401
    CUDA_HOST,
    build_host_library,
    host_source,
    one_torch_thread,
)

# f32: summation order only, relative to the largest value. bf16: the
# product rounds to bf16 (8 significant bits) after a sum in another order,
# so a value may land one ulp (at most 2^-7 of the largest) apart, and the
# scale multiplies that.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# (M, K, N): the fixture talker's projections (hidden 32, q/kv 32, I 64),
# the tiny config's (hidden 64, kv 32, I 128), and the sub-talker LM head.
SHAPES = [(6, 32, 32), (6, 64, 128), (4, 128, 64), (3, 64, 128)]


def _operands(m, k, n, dtype, seed):
    """x from a numpy seed and an int8 weight with bf16 scales from
    quantize_int8 (the JAX package's bits)."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((r.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    w_i8, s = quantize_int8(w)
    return x, w_i8, s


def _close(got, want, dtype):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else
        jnp.int8 if t.dtype == torch.int8 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_w_matmul(m, k, n, dtype):
    x, w_i8, s = _operands(m, k, n, dtype, seed=k + n)
    want = j_trunk._w_matmul({"w_i8": _jnp(w_i8), "w_s": _jnp(s)}, "w", _jnp(x))
    got = int8_matmul_plain(x, w_i8, s)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    _close(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))), dtype)
    # On CPU tensors the wrapper is the plain version, bit for bit.
    assert torch.equal(int8_matmul(x, w_i8, s), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_f32_out_matches_jax_lm_head_logits(dtype):
    r = np.random.default_rng(3)
    g, d, v, b = 3, 64, 128, 4
    heads = torch.from_numpy((r.standard_normal((g, d, v)) / np.sqrt(d)).astype(np.float32))
    heads_i8, heads_s = quantize_int8(heads)
    hidden = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(dtype)
    params = {"lm_heads_i8": heads_i8, "lm_heads_s": heads_s}
    j_params = {"lm_heads_i8": _jnp(heads_i8), "lm_heads_s": _jnp(heads_s)}
    for head in range(g):
        want = np.asarray(j_st._lm_head_logits(j_params, _jnp(hidden), head))
        got = int8_matmul(hidden, heads_i8[head], heads_s[head], f32_out=True)
        assert got.dtype == torch.float32
        _close(got, torch.from_numpy(want), dtype)
        assert torch.equal(t_st._lm_head_logits(params, hidden, head), got)


def test_trunk_and_subtalker_route_int8_products_through_it(monkeypatch):
    """Every int8 projection of the trunk and the int8 LM heads go through
    the int8 GEMM, the products that read one x (q|k|v, gate|up) as one
    grouped launch; no caller casts an int8 weight itself."""
    calls = []

    def counting(x, w_i8, s, f32_out=False):
        calls.append(([tuple(w_i8.shape)], f32_out))
        return int8_matmul(x, w_i8, s, f32_out)

    def counting_group(x, weights, f32_out=False):
        calls.append(([tuple(w.shape) for w, _ in weights], f32_out))
        return int8_matmul_group(x, weights, f32_out)

    monkeypatch.setattr(t_trunk, "int8_matmul", counting)
    monkeypatch.setattr(t_trunk, "int8_matmul_group", counting_group)
    monkeypatch.setattr(t_st, "int8_matmul", counting)
    r = np.random.default_rng(1)
    d, i = 64, 96
    layer = {}
    for key, shape in (("wq", (d, d)), ("wk", (d, 32)), ("wv", (d, 32)), ("wo", (d, d)),
                       ("gate", (d, i)), ("up", (d, i)), ("down", (i, d))):
        layer[key + "_i8"], layer[key + "_s"] = quantize_int8(
            torch.from_numpy(r.standard_normal(shape).astype(np.float32)))
    x = torch.from_numpy(r.standard_normal((2, d)).astype(np.float32))
    dims = t_trunk.TrunkDims(1, d, 4, 2, 16, i, 1e-6, qk_norm=False)
    q, k, v = t_trunk._project_qkv(layer, x, dims)
    for got, key in ((q, "wq"), (k, "wk"), (v, "wv")):
        assert torch.equal(got.flatten(-2), t_trunk._w_matmul(layer, key, x))
    t_trunk._w_matmul(layer, "wo", x)
    t_trunk._mlp(layer, x)
    heads_i8, heads_s = quantize_int8(
        torch.from_numpy(r.standard_normal((2, d, 128)).astype(np.float32)))
    t_st._lm_head_logits({"lm_heads_i8": heads_i8, "lm_heads_s": heads_s}, x, 1)
    assert calls[0] == ([(d, d), (d, 32), (d, 32)], False)
    assert [c for c, _ in calls[1:4]] == [[(d, d)], [(d, 32)], [(d, 32)]]  # the checks above
    assert [c for c, _ in calls[4:7]] == [[(d, d)], [(d, i), (d, i)], [(i, d)]]
    assert calls[-1] == ([(d, 128)], True) and len(calls) == 8


def test_plain_group_is_the_single_products():
    """int8_matmul_group on CPU tensors: each product the bits of its
    int8_matmul_plain, f32 and bf16, f32 logits too."""
    for dtype in (torch.float32, torch.bfloat16):
        x, w1, s1 = _operands(5, 64, 96, dtype, seed=21)
        _, w2, s2 = _operands(5, 64, 32, dtype, seed=22)
        for f32_out in (False, True):
            got = int8_matmul_group(x, [(w1, s1), (w2, s2)], f32_out)
            want = [int8_matmul_plain(x, w, s, f32_out) for w, s in ((w1, s1), (w2, s2))]
            assert len(got) == 2 and all(torch.equal(a, b) for a, b in zip(got, want))


def test_int8_trunk_decode_step_through_the_group_matches_jax(monkeypatch):
    """The port's int8 trunk_decode_step, its q|k|v and gate|up through
    int8_matmul_group (4 int8 GEMM calls a layer), against the JAX
    trunk_decode_step on quantize_trunk_int8 params, float caches, f32 and
    bf16, with the int8 trunk tests' tolerances (test_torch_int8.py)."""
    dims = j_trunk.TrunkDims(num_layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                             intermediate=96, eps=1e-6)
    r = np.random.default_rng(11)
    shapes = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64),
              "gate": (64, 96), "up": (64, 96), "down": (96, 64), "input_norm": (64,),
              "post_attn_norm": (64,), "q_norm": (16,), "k_norm": (16,)}
    trunk = {k: (1 + 0.1 * r.standard_normal((2, *v)) if "norm" in k else
                 r.standard_normal((2, *v)) / np.sqrt(v[0])).astype(np.float32)
             for k, v in shapes.items()}
    b, s_max = 3, 9
    cache = [r.standard_normal((2, b, s_max, 2, 16)).astype(np.float32) for _ in range(2)]
    hidden = r.standard_normal((b, 64)).astype(np.float32)
    cur_len = np.array([4, 9, 6], np.int32)
    valid_from = np.array([0, 2, 1], np.int32)
    calls = []

    def counting_group(x, weights, f32_out=False):
        calls.append(len(weights))
        return int8_matmul_group(x, weights, f32_out)

    def counting(x, w_i8, s, f32_out=False):
        calls.append(1)
        return int8_matmul(x, w_i8, s, f32_out)

    monkeypatch.setattr(t_trunk, "int8_matmul_group", counting_group)
    monkeypatch.setattr(t_trunk, "int8_matmul", counting)
    for jdtype, tdtype, rtol in ((jnp.float32, torch.float32, 1e-5),
                                 (jnp.bfloat16, torch.bfloat16, 2 ** -6)):
        jq = j_trunk.quantize_trunk_int8({k: jnp.asarray(v, jdtype) for k, v in trunk.items()})
        tq = t_trunk.quantize_trunk_int8({k: torch.from_numpy(v).to(tdtype)
                                          for k, v in trunk.items()})
        jc, js = j_rope_cos_sin(jnp.asarray(cur_len - 1), 16, 10000.0)
        tc, ts = t_rope_cos_sin(torch.from_numpy(cur_len - 1), 16, 10000.0)
        jh, _, _ = j_trunk.trunk_decode_step(
            jq, dims, jnp.asarray(hidden, jdtype), jc, js, *(jnp.asarray(c, jdtype) for c in cache),
            jnp.asarray(cur_len), valid_from=jnp.asarray(valid_from))
        calls.clear()
        th, _, _ = t_trunk.trunk_decode_step(
            tq, dims, torch.from_numpy(hidden).to(tdtype), tc.to(tdtype), ts.to(tdtype),
            *(torch.from_numpy(c).to(tdtype) for c in cache), torch.from_numpy(cur_len),
            valid_from=torch.from_numpy(valid_from))
        assert calls == [3, 1, 2, 1] * 2  # q|k|v, o, gate|up, down per layer
        want = np.asarray(jh.astype(jnp.float32))
        err = np.abs(th.float().numpy() - want).max()
        assert err <= rtol * np.abs(want).max(), (tdtype, err)


@pytest.mark.parametrize("k,want", [(32, (1, 1)), (64, (1, 2)), (200, (1, 8)),
                                    (256, (2, 4)), (1024, (8, 4)), (2048, (8, 8)),
                                    (4096, (8, 16)), (4097, None)])
def test_split_of_k(emulated, k, want):
    """The f32 kernel's K split (cluster ranks, weight rows per thread)
    follows K alone: up to 8 ranks while each rank's 32 groups keep 4 rows,
    then the power of two of rows that covers K; past MAX_K the kernel
    refuses."""
    lib = ctypes.CDLL(emulated[2])
    n_split, rows = ctypes.c_int(), ctypes.c_int()
    err = lib.qtts_int8_matmul_split(k, ctypes.byref(n_split), ctypes.byref(rows))
    if want is None:
        assert err != 0 and k > im.MAX_K
    else:
        assert err == 0 and (n_split.value, rows.value) == want and k <= im.MAX_K


@pytest.mark.parametrize("k,want", [(16, (1, 1)), (64, (1, 1)), (128, (2, 1)), (256, (4, 1)),
                                    (512, (8, 1)), (1024, (8, 2)), (2048, (8, 4)),
                                    (4096, (8, 8)), (4112, None)])
def test_mma_split_of_k(emulated, k, want):
    """The tensor-core kernel's K split (cluster ranks, 16-row steps per
    warp) follows K alone: ranks double up to 8 while the cluster's 4 warps
    a rank do not cover K in one step each, then the steps double; past
    MAX_K the kernel refuses. A 1024 x 1024 projection spreads over
    16 column tiles x 8 ranks = 128 blocks."""
    lib = ctypes.CDLL(emulated[2])
    n_split, steps = ctypes.c_int(), ctypes.c_int()
    err = lib.qtts_int8_matmul_mma_split(k, ctypes.byref(n_split), ctypes.byref(steps))
    if want is None:
        assert err != 0 and k > im.MAX_K
    else:
        assert err == 0 and (n_split.value, steps.value) == want and k <= im.MAX_K
        assert n_split.value * 4 * steps.value * 16 >= k


# name: (M, K, N, dtype, f32_out)
EMULATED = {
    "talker-wk-bf16": (4, 1024, 128, torch.bfloat16, False),
    "down-bf16": (4, 2048, 64, torch.bfloat16, False),
    "ragged-f32": (5, 256, 96, torch.float32, False),
    "ragged-bf16": (17, 256, 96, torch.bfloat16, False),  # two m16 tiles, half a column block
    "ragged-k-f32": (4, 200, 32, torch.float32, False),
    "head-bf16-f32-out": (3, 128, 128, torch.bfloat16, True),
    "head-f32-f32-out": (2, 64, 48, torch.float32, True),
    "rows-40-bf16": (40, 128, 64, torch.bfloat16, False),  # two row tiles of two m16 tiles
}
# Grouped launches at the fixture's shapes, name: (M, K, [N_e], dtype): the
# fixture talker's q|k|v (hidden 32) and gate|up (I 64), the tiny config's
# q|k|v (q 64, kv 32); each also launched alone per weight.
GROUPED = {
    "qkv-32": (4, 32, [32, 32, 32]),
    "qkv-64": (4, 64, [64, 32, 32]),
    "gate-up": (6, 32, [64, 64]),
    "qkv-64-m17": (17, 64, [64, 32, 32]),
}
# Batch invariance: rows of one x [32, K] at M 32, 4 (rows 0..3) and 1 (row 5).
INVARIANCE = (1024, 64)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Builds the emulated kernel and runs every case in one subprocess.
    Returns ({name: (error code, outputs)}, cases, the library's path)."""
    work = str(tmp_path_factory.mktemp("int8_matmul_host"))
    source = host_source(
        "int8_matmul", ("load_weight8", "global_ns",
                        "cluster_arrive_relaxed", "cluster_wait", "smem_addr", "mbar_init",
                        "fence_mbarrier_init", "mbar_expect_tx", "mbar_wait", "push_async",
                        "mma_bf16"),
        {"cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p, "
         "cudaStream_t stream) {": "  return emu::run(kernel, grid, smem, p);"})
    lib = build_host_library(source, work)
    cases = {}
    for i, (name, (m, k, n, dtype, f32_out)) in enumerate(sorted(EMULATED.items())):
        x, w, s = _operands(m, k, n, dtype, seed=100 + i)
        cases[name] = {"x": x, "ws": [(w, s)], "f32_out": f32_out}
    for i, (name, (m, k, ns)) in enumerate(sorted(GROUPED.items())):
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{name}-{str(dtype).split('.')[1]}"
            x = _operands(m, k, 16, dtype, seed=200 + i)[0]
            ws = [_operands(1, k, n, dtype, seed=300 + 10 * i + e)[1:] for e, n in enumerate(ns)]
            cases[tag] = {"x": x, "ws": ws, "f32_out": False}
            for e, w in enumerate(ws):
                cases[f"{tag}-alone{e}"] = {"x": x, "ws": [w], "f32_out": False}
    k, n = INVARIANCE
    for dtype in (torch.bfloat16, torch.float32):
        x, w, s = _operands(32, k, n, dtype, seed=7)
        w2, s2 = _operands(1, k, 32, dtype, seed=8)[1:]
        tag = str(dtype).split(".")[1]
        for m, rows in ((32, slice(0, 32)), (4, slice(0, 4)), (1, slice(5, 6))):
            cases[f"m{m}-{tag}"] = {"x": x[rows].contiguous(), "ws": [(w, s), (w2, s2)],
                                    "f32_out": False}
    w40, s40 = (t[:, :40].contiguous() for t in cases["ragged-f32"]["ws"][0])
    cases["refused-n"] = dict(cases["ragged-f32"], ws=[(w40, s40)])
    cases["refused-group"] = dict(cases["ragged-f32"], ws=cases["ragged-f32"]["ws"] * 5)
    torch.save(cases, os.path.join(work, "cases.pt"))
    run = subprocess.run(
        [sys.executable, os.path.join(CUDA_HOST, "run_int8_matmul.py"), lib,
         os.path.join(work, "cases.pt"), os.path.join(work, "out.pt")],
        capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return torch.load(os.path.join(work, "out.pt")), cases, lib


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_kernel_matches_plain(emulated, name):
    results, cases, _ = emulated
    err, got = results[name]
    case = cases[name]
    assert err == 0
    (w, s), = case["ws"]
    want = int8_matmul_plain(case["x"], w, s, case["f32_out"])
    assert got[0].dtype == want.dtype and got[0].shape == want.shape
    _close(got[0], want, case["x"].dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_emulated_group_is_its_single_launches(emulated, name, dtype):
    """One grouped launch gives each weight the bits of its launch alone,
    and each within TOL of the plain version."""
    results, cases, _ = emulated
    tag = f"{name}-{dtype}"
    err, got = results[tag]
    case = cases[tag]
    assert err == 0 and len(got) == len(case["ws"])
    for e, (w, s) in enumerate(case["ws"]):
        alone_err, alone = results[f"{tag}-alone{e}"]
        assert alone_err == 0 and torch.equal(got[e], alone[0])
        _close(got[e], int8_matmul_plain(case["x"], w, s), case["x"].dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_emulated_kernel_rows_do_not_depend_on_m(emulated, dtype):
    """A grouped launch's rows at M 32, 4 and 1: the same bits, each weight."""
    results, _, _ = emulated
    full = results[f"m32-{dtype}"][1]
    assert all(results[f"m{m}-{dtype}"][0] == 0 for m in (32, 4, 1))
    for e in range(2):
        assert torch.equal(results[f"m4-{dtype}"][1][e], full[e][:4])
        assert torch.equal(results[f"m1-{dtype}"][1][e], full[e][5:6])


def test_emulated_kernel_refuses_n_not_a_multiple_of_16(emulated):
    results, _, _ = emulated
    for name in ("refused-n", "refused-group"):
        err, outs = results[name]
        assert err == 1  # cudaErrorInvalidValue, before any launch
        assert all(torch.isnan(o).all() for o in outs)
