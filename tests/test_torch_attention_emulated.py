"""The decode-attention kernel's CUDA source on the CPU, against the JAX
function.

``qwen_tts_tpu_torch/csrc/decode_attention.cu`` compiles with g++ against the
host emulation in ``tests/cuda_host`` (one thread per CUDA thread; shuffles,
``mma.sync``, cluster barriers and distributed shared memory emulated), so
its index arithmetic, fragment layouts, split, merge and edge rows run here,
where there is no card. Each case's inputs come from numpy with a seed and
go through the emulated kernel and through
``qwen_tts_tpu.ops.attention.attention_decode_step`` (f32); each output is
held per element. The emulation runs in one subprocess with a time limit, so
a deadlock fails these tests instead of hanging the run."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.ops import attention as j_attn
from qwen_tts_tpu_torch.ops.attention import quantize_kv
from qwen_tts_tpu_torch.ops.cuda.decode_attention import NO_WINDOW, choose_split
from torch_port_fixtures import (  # noqa: F401
    CUDA_HOST as HOST,
    build_host_library,
    host_source,
    one_torch_thread,
)

# The kernel's helpers written in PTX; cuda_host_emu.h defines them for the host.
PTX_HELPERS = ("cp_async16", "cp_async4", "cp_async_commit", "cp_async_wait",
               "cluster_arrive_relaxed", "cluster_arrive", "cluster_wait", "mma_bf16")
# f32 queries: summation order only. bf16 queries: the output rounds to bf16
# (half an ulp, at most 2^-8 relative) on top of that.
F32_ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 2 ** -8, 1e-5
# Rows of 4: the whole cache, one position, half the cache from a ragged
# start, and an empty row (uniform over S_max).
ROWS4 = lambda s: ([s, 1, s // 2, 3], [0, 0, 2, 3])  # noqa: E731
# Rows of 3 over a longer cache: whole, ragged, and 5 positions (fewer than
# 8 splits).
ROWS3 = ([300, 150, 40], [0, 7, 35])

# name: (heads, kv, hd, s_max, rows, q dtype, int8 cache, window, n_split or None)
CASES = {
    "talker-bf16": (16, 2, 64, 97, ROWS4(97), "bf16", False, None, None),
    "talker-bf16-window9": (16, 2, 64, 97, ROWS4(97), "bf16", False, 9, None),
    "talker-f32": (16, 2, 64, 97, ROWS4(97), "f32", False, None, None),
    "subtalker-bf16": (16, 8, 128, 16, ROWS4(16), "bf16", False, None, None),
    "subtalker-f32": (16, 8, 128, 16, ROWS4(16), "f32", False, 9, None),
    "g1-bf16": (8, 8, 64, 40, ROWS4(40), "bf16", False, None, None),
    "g16-hd128-bf16-window70": (16, 1, 128, 200, ROWS4(200), "bf16", False, 70, None),
    "long-bf16": (16, 2, 64, 300, ROWS3, "bf16", False, None, None),
    "long-f32-window37": (16, 2, 64, 300, ROWS3, "f32", False, 37, None),
    "int8-talker-bf16": (16, 2, 64, 97, ROWS4(97), "bf16", True, None, None),
    "int8-talker-f32-window9": (16, 2, 64, 97, ROWS4(97), "f32", True, 9, None),
    "int8-hd128-bf16": (16, 8, 128, 48, ROWS4(48), "bf16", True, None, None),
    "int8-long-bf16-window37": (16, 2, 64, 300, ROWS3, "bf16", True, 37, None),
    **{f"split{n}-bf16": (16, 2, 64, 300, ROWS3, "bf16", False, None, n) for n in (1, 2, 4, 8)},
    **{f"split{n}-int8": (16, 2, 64, 300, ROWS3, "bf16", True, None, n) for n in (1, 2, 4, 8)},
}
# Runs besides the cases: a second launch of one (same bits), and split
# counts the kernel refuses (not a power of two, or past one cluster).
REPEAT = "long-bf16"
REFUSED = (3, 6, 16, 32)
# Batch invariance: one row of `n` positions, the talker's heads, at B=4 in
# a cache of S_max 300 from position 41 (the reference), and alone (B=1) at
# (S_max, left padding) below; each must give the reference's bits. 60
# positions: 4 chunks, n_split 2 (S_max 97) or 8 (300); 250: 16 chunks,
# n_split 4 (256) or 8 (1100).
INVARIANT_ROWS = {60: ((97, 0), (97, 30), (300, 0), (300, 200)),
                  250: ((256, 0), (256, 6), (1100, 0), (1100, 700))}
INVARIANT_REF = (300, 41)


def _invariance_cases(int8: bool):
    """{name: case}: the reference batch and each lone copy of its row 1."""
    h, kv, hd = 16, 2, 64
    r = np.random.default_rng(21 + int8)
    cases = {}
    for n, lone in INVARIANT_ROWS.items():
        q_row = r.standard_normal((h, hd)).astype(np.float32)
        k_row, v_row = (r.standard_normal((n, kv, hd)).astype(np.float32) * 3 for _ in range(2))

        def place(b, s_max, row, at):
            q = r.standard_normal((b, h, hd)).astype(np.float32)
            k, v = (r.standard_normal((b, s_max, kv, hd)).astype(np.float32) * 3 for _ in range(2))
            q[row], k[row, at:at + n], v[row, at:at + n] = q_row, k_row, v_row
            q = torch.from_numpy(q).bfloat16()
            k, v = torch.from_numpy(k), torch.from_numpy(v)
            if int8:
                k, v = ({"i8": i8, "s": sc} for i8, sc in (quantize_kv(x) for x in (k, v)))
            else:
                k, v = k.bfloat16(), v.bfloat16()
            cur = [s_max - 3 * i for i in range(b)]
            vfrom = [5 * i for i in range(b)]
            cur[row], vfrom[row] = at + n, at
            return {"q": q, "k": k, "v": v, "cur_len": torch.tensor(cur, dtype=torch.int32),
                    "valid_from": torch.tensor(vfrom, dtype=torch.int32), "window": NO_WINDOW,
                    "n_split": choose_split(s_max)}
        tag = f"invariant{'-int8' if int8 else ''}-n{n}"
        cases[f"{tag}-ref"] = place(4, INVARIANT_REF[0], 1, INVARIANT_REF[1])
        for s_max, at in lone:
            cases[f"{tag}-s{s_max}-at{at}"] = place(1, s_max, 0, at)
    return cases


def _inputs(name):
    """numpy inputs from a seed, as the kernel's tensors."""
    h, kv, hd, s_max, (cur, vfrom), dtype, int8, window, n_split = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    b = len(cur)
    q = torch.from_numpy(r.standard_normal((b, h, hd)).astype(np.float32))
    q = q.bfloat16() if dtype == "bf16" else q
    k, v = (torch.from_numpy(r.standard_normal((b, s_max, kv, hd)).astype(np.float32) * 3)
            for _ in range(2))
    if int8:
        k, v = ({"i8": i8, "s": s} for i8, s in (quantize_kv(x) for x in (k, v)))
    elif dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    return {"q": q, "k": k, "v": v, "cur_len": torch.tensor(cur, dtype=torch.int32),
            "valid_from": torch.tensor(vfrom, dtype=torch.int32),
            "window": NO_WINDOW if window is None else window,
            "n_split": n_split or choose_split(s_max)}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Builds the emulated kernel and runs every case once (and the extra
    runs) in one subprocess. Returns {name: (error code, output)}."""
    work = tmp_path_factory.mktemp("decode_attention_host")
    lib = build_host_library(host_source(
        "decode_attention", PTX_HELPERS, {"cudaError_t launch(const Args& a) {":
        "  return emu::run(decode_attention_kernel<T, C, HD, G>,\n"
        "                  dim3(a.n_split, a.p.kv_heads, a.batch),\n"
        "                  Layout<T, C, HD, G>::kBytes, a.p);"}), str(work))
    cases = {name: _inputs(name) for name in CASES}
    cases["repeat"] = cases[REPEAT]
    cases.update(_invariance_cases(False))
    cases.update(_invariance_cases(True))
    for n in REFUSED:
        cases[f"refused{n}"] = dict(cases[REPEAT], n_split=n)
    torch.save(cases, work / "cases.pt")
    run = subprocess.run(
        [sys.executable, os.path.join(HOST, "run_kernel.py"), str(lib), str(work / "cases.pt"),
         str(work / "out.pt")], capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return torch.load(work / "out.pt"), cases


def _reference(case):
    """attention_decode_step in JAX, f32, on the case's values."""
    k, v = case["k"], case["v"]
    if isinstance(k, dict):
        j_k, j_v = ({n: jnp.asarray(t.numpy()) for n, t in c.items()} for c in (k, v))
    else:
        j_k, j_v = (jnp.asarray(t.float().numpy()) for t in (k, v))
    window = None if case["window"] == NO_WINDOW else case["window"]
    out = j_attn.attention_decode_step(
        jnp.asarray(case["q"].float().numpy()), j_k, j_v,
        cur_len=jnp.asarray(case["cur_len"].numpy()),
        valid_from=jnp.asarray(case["valid_from"].numpy()), sliding_window=window)
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_jax(emulated, name):
    results, cases = emulated
    err, out = results[name]
    assert err == 0
    got, want = out.float().numpy(), _reference(cases[name])
    if out.dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_emulated_kernel_two_launches_give_the_same_bits(emulated):
    results, _ = emulated
    assert torch.equal(results["repeat"][1], results[REPEAT][1])


@pytest.mark.parametrize("n_split", REFUSED)
def test_emulated_kernel_refuses_split_counts_it_cannot_merge(emulated, n_split):
    results, _ = emulated
    err, out = results[f"refused{n_split}"]
    assert err == 1  # cudaErrorInvalidValue, before any launch
    assert torch.isnan(out).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", sorted(INVARIANT_ROWS))
def test_emulated_kernel_gives_a_row_the_same_bits_alone_and_in_a_batch(emulated, n, int8):
    """A row at B=1 against the same row at B=4: two S_max each, with and
    without left padding, float and int8 caches, bit for bit."""
    results, cases = emulated
    tag = f"invariant{'-int8' if int8 else ''}-n{n}"
    err, ref = results[f"{tag}-ref"]
    assert err == 0
    splits = set()
    for s_max, at in INVARIANT_ROWS[n]:
        name = f"{tag}-s{s_max}-at{at}"
        err, out = results[name]
        assert err == 0
        splits.add(cases[name]["n_split"])
        assert torch.equal(out[0], ref[1]), name
    assert len(splits) == 2  # the lone copies ran at two n_split
