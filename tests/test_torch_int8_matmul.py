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
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul, int8_matmul_plain
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
    int8_matmul; no caller casts an int8 weight itself."""
    calls = []

    def counting(x, w_i8, s, f32_out=False):
        calls.append((tuple(w_i8.shape), f32_out))
        return int8_matmul(x, w_i8, s, f32_out)

    monkeypatch.setattr(t_trunk, "int8_matmul", counting)
    monkeypatch.setattr(t_st, "int8_matmul", counting)
    r = np.random.default_rng(1)
    d, i = 64, 96
    layer = {}
    for key, shape in (("wq", (d, d)), ("wk", (d, 32)), ("wv", (d, 32)), ("wo", (d, d)),
                       ("gate", (d, i)), ("up", (d, i)), ("down", (i, d))):
        layer[key + "_i8"], layer[key + "_s"] = quantize_int8(
            torch.from_numpy(r.standard_normal(shape).astype(np.float32)))
    x = torch.from_numpy(r.standard_normal((2, d)).astype(np.float32))
    for key in ("wq", "wk", "wv", "wo", "gate", "up"):
        t_trunk._w_matmul(layer, key, x)
    t_trunk._mlp(layer, x)
    heads_i8, heads_s = quantize_int8(
        torch.from_numpy(r.standard_normal((2, d, 128)).astype(np.float32)))
    t_st._lm_head_logits({"lm_heads_i8": heads_i8, "lm_heads_s": heads_s}, x, 1)
    assert [c for c, _ in calls[:6]] == [(d, d), (d, 32), (d, 32), (d, d), (d, i), (d, i)]
    assert [c for c, _ in calls[6:9]] == [(d, i), (d, i), (i, d)]
    assert calls[-1] == ((d, 128), True) and len(calls) == 10


@pytest.mark.parametrize("k,want", [(32, (1, 1)), (64, (1, 2)), (200, (1, 8)),
                                    (256, (2, 4)), (1024, (8, 4)), (2048, (8, 8)),
                                    (4096, (8, 16)), (4097, None)])
def test_split_of_k(emulated, k, want):
    """The K split (cluster ranks, weight rows per thread) follows K alone:
    up to 8 ranks while each rank's 32 groups keep 4 rows, then the power of
    two of rows that covers K; past MAX_K the kernel refuses."""
    lib = ctypes.CDLL(emulated[2])
    n_split, rows = ctypes.c_int(), ctypes.c_int()
    err = lib.qtts_int8_matmul_split(k, ctypes.byref(n_split), ctypes.byref(rows))
    if want is None:
        assert err != 0 and k > im.MAX_K
    else:
        assert err == 0 and (n_split.value, rows.value) == want and k <= im.MAX_K


# name: (M, K, N, dtype, f32_out)
EMULATED = {
    "talker-wk-bf16": (4, 1024, 128, torch.bfloat16, False),
    "down-bf16": (4, 2048, 64, torch.bfloat16, False),
    "ragged-f32": (5, 256, 96, torch.float32, False),
    "ragged-bf16": (17, 256, 96, torch.bfloat16, False),  # two m16 tiles, half a column block
    "ragged-k-f32": (4, 200, 32, torch.float32, False),
    "head-bf16-f32-out": (3, 128, 128, torch.bfloat16, True),
    "head-f32-f32-out": (2, 64, 48, torch.float32, True),
}
# Batch invariance: rows of one x [32, K] at M 32, 4 (rows 0..3) and 1 (row 5).
INVARIANCE = (1024, 64)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Builds the emulated kernel and runs every case in one subprocess.
    Returns ({name: (error code, output)}, cases, the library's path)."""
    work = str(tmp_path_factory.mktemp("int8_matmul_host"))
    source = host_source(
        "int8_matmul", ("cluster_arrive", "cluster_wait", "ldsm_x4", "ldsm_x4_trans", "mma_bf16"),
        {"cudaError_t launch(const Args& a) {":
         "  return emu::run(int8_matmul_kernel<T, kRows>,\n"
         "                  dim3(a.n_split, (a.p.n + kCols - 1) / kCols,\n"
         "                       (a.p.m + kRowsPerBlock - 1) / kRowsPerBlock),\n"
         "                  kSmemBytes, a.p);",
         "cudaError_t launch_mma(const Args& a) {":
         "  return emu::run(int8_matmul_kernel_mma<kMTiles>,\n"
         "                  dim3(a.n_split, (a.p.n + kMmaCols - 1) / kMmaCols,\n"
         "                       (a.p.m + 16 * kMTiles - 1) / (16 * kMTiles)),\n"
         "                  mma_smem_bytes(a.p.block_k, kMTiles), a.p);"})
    lib = build_host_library(source, work)
    cases = {}
    for i, (name, (m, k, n, dtype, f32_out)) in enumerate(sorted(EMULATED.items())):
        x, w, s = _operands(m, k, n, dtype, seed=100 + i)
        cases[name] = {"x": x, "w": w, "s": s, "f32_out": f32_out}
    k, n = INVARIANCE
    for dtype in (torch.bfloat16, torch.float32):
        x, w, s = _operands(32, k, n, dtype, seed=7)
        tag = str(dtype).split(".")[1]
        for m, rows in ((32, slice(0, 32)), (4, slice(0, 4)), (1, slice(5, 6))):
            cases[f"m{m}-{tag}"] = {"x": x[rows].contiguous(), "w": w, "s": s,
                                    "f32_out": False}
    cases["refused-n"] = dict(cases["ragged-f32"], w=cases["ragged-f32"]["w"][:, :40],
                              s=cases["ragged-f32"]["s"][:, :40])
    cases["refused-n"]["w"] = cases["refused-n"]["w"].contiguous()
    cases["refused-n"]["s"] = cases["refused-n"]["s"].contiguous()
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
    want = int8_matmul_plain(case["x"], case["w"], case["s"], case["f32_out"])
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want, case["x"].dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_emulated_kernel_rows_do_not_depend_on_m(emulated, dtype):
    results, _, _ = emulated
    full = results[f"m32-{dtype}"][1]
    assert all(results[f"m{m}-{dtype}"][0] == 0 for m in (32, 4, 1))
    assert torch.equal(results[f"m4-{dtype}"][1], full[:4])
    assert torch.equal(results[f"m1-{dtype}"][1], full[5:6])


def test_emulated_kernel_refuses_n_not_a_multiple_of_16(emulated):
    results, _, _ = emulated
    err, out = results["refused-n"]
    assert err == 1  # cudaErrorInvalidValue, before any launch
    assert torch.isnan(out).all()
