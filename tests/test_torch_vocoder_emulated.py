"""The vocoder-block kernel's CUDA source on the CPU, against its plain
version.

``qwen_tts_tpu_torch/csrc/vocoder_block.cu`` compiles with g++ against the
host emulation in ``tests/cuda_host`` (one thread per CUDA thread; ldmatrix,
``mma.sync`` by its PTX fragment layouts, cp.async as a copy), so its tiles,
the history it carries from tile to tile, the warm-up of a segment, the
transposed conv's phases and the epilogues run here, where there is no card.
Each case's inputs come from numpy with a seed and go through the emulated
kernel and through ``vocoder_block_plain`` (bf16, on the CPU); each output is
held within ``VOCODER_TOL`` x max |ref|. The emulated card reports few SMs,
so that each batch row splits into segments of several tiles. Cases with a
split run clusters of CTAs that share each tile's columns (cluster barriers
and stores to the peers' shared memory emulated) and must give the bits of
the same case without a split. The emulation runs in one subprocess with a
time limit."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
    PLAN_KEYS,
    pack_vocoder_block,
    vocoder_block_plain,
)
from torch_port_fixtures import (  # noqa: F401
    CUDA_HOST,
    build_host_library,
    host_source,
    one_torch_thread,
)

# As chip_smoke.VOCODER_TOL: both sides round at the same points, but the
# f32 sums run in another order, so an intermediate can land one bf16 ulp
# apart and carry through the block's later convs.
VOCODER_TOL = 2 ** -6
HELPERS = ("cp_async16", "cp_async_commit", "cp_async_wait", "ldsm_x4", "ldsm_x4_trans",
           "mma_bf16", "cluster_arrive", "cluster_wait")
# name: (C_in, C_out, rate, taps, B, T_in, emulated SMs, split: CTAs a tile,
# 0 for the plan's choice)
CASES = {
    "c64-c32-s4-k7": (64, 32, 4, 7, 2, 150, 2, 1),
    "c32-c16-s3-k3": (32, 16, 3, 3, 1, 200, 1, 1),
    "c128-c96-s3-k7": (128, 96, 3, 7, 1, 100, 1, 1),
    "c384-c192-s4-k7": (384, 192, 4, 7, 1, 60, 1, 1),
    "c32-c16-s5-k7": (32, 16, 5, 7, 1, 70, 1, 1),
    # Column splits: two segments a row at 4 SMs, and a cluster of 3 over
    # one segment; the plan's own choice on a short row of an idle card.
    "c64-c32-s4-k7-split2": (64, 32, 4, 7, 2, 150, 4, 2),
    "c96-c96-s3-k7-split3": (96, 96, 3, 7, 1, 100, 2, 3),
    "c64-c32-s4-k7-auto": (64, 32, 4, 7, 1, 60, 4, 0),
}
REPEAT = "c64-c32-s4-k7"
# The split cases; each must give the bits of its own inputs at split 1
# (run as "<name>-split1").
SPLIT_CASES = ("c64-c32-s4-k7-split2", "c96-c96-s3-k7-split3", "c64-c32-s4-k7-auto")


def _block(c_in, c_out, rate, taps, seed):
    """A bf16 block in the loader's layouts from a numpy seed (as
    chip_smoke.random_vocoder_block draws them)."""
    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    def w(*shape, fan):
        return t(r.standard_normal(shape) / np.sqrt(fan))

    def snake(c):
        return t(np.exp(0.1 * r.standard_normal(c)))

    def bias(c):
        return t(0.01 * r.standard_normal(c))

    units = [{"alpha1": snake(c_out), "beta1": snake(c_out),
              "conv1_w": w(taps, c_out, c_out, fan=taps * c_out), "conv1_b": bias(c_out),
              "alpha2": snake(c_out), "beta2": snake(c_out),
              "conv2_w": w(1, c_out, c_out, fan=c_out), "conv2_b": bias(c_out)}
             for _ in range(3)]
    return {"alpha": snake(c_in), "beta": snake(c_in),
            "tconv_w": w(2 * rate, c_in, c_out, fan=2 * c_in), "tconv_b": bias(c_out),
            "resunits": units}


def _case(name):
    c_in, c_out, rate, taps, b, t_in, sms, split = CASES[name]
    seed = sorted(CASES).index(name)
    block = _block(c_in, c_out, rate, taps, seed)
    x = torch.from_numpy(
        0.5 * np.random.default_rng(100 + seed).standard_normal((b, t_in, c_in)).astype(
            np.float32)).bfloat16()
    weights, vectors = pack_vocoder_block(block)
    return {"x": x, "weights": [w.contiguous() for w in weights], "vectors": vectors,
            "rate": rate, "sms": sms, "split": split, "block": block}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Builds the emulated kernel and runs every case (and a second launch
    of one) in one subprocess. Returns ({name: (error code, output, plan)},
    cases)."""
    work = str(tmp_path_factory.mktemp("vocoder_block_host"))
    source = host_source(
        "vocoder_block", HELPERS,
        {"cudaError_t launch(const Params& p, const Plan& plan, int batch, cudaStream_t stream) {":
         "  return emu::run(vocoder_block_kernel<kNT, kMinBlocks, kK>,\n"
         "                  dim3(plan.segments * p.split, batch), plan.smem, p, kThreads,\n"
         "                  p.split);",
         # As many clusters as SMs hold CTAs, over the cluster's size.
         "int max_clusters_of(const Plan& plan, int n) {":
         "  return emu::sm_count * kMinBlocks / n;"})
    source += '\nextern "C" void emu_set_sms(int n) { emu::sm_count = n; }\n'
    lib = build_host_library(source, work)
    cases = {name: _case(name) for name in CASES}
    cases["repeat"] = cases[REPEAT]
    for name in SPLIT_CASES:
        cases[f"{name}-split1"] = dict(cases[name], split=1)
    torch.save({k: {f: v for f, v in c.items() if f != "block"} for k, c in cases.items()},
               os.path.join(work, "cases.pt"))
    run = subprocess.run(
        [sys.executable, os.path.join(CUDA_HOST, "run_vocoder_block.py"), lib,
         os.path.join(work, "cases.pt"), os.path.join(work, "out.pt")],
        capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stderr[-4000:]
    return torch.load(os.path.join(work, "out.pt")), cases


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_plain(emulated, name):
    results, cases = emulated
    err, got, plan = results[name]
    assert err == 0
    case = cases[name]
    want = vocoder_block_plain(case["x"], case["block"], case["rate"])
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= VOCODER_TOL * want.float().abs().max().item(), (err, dict(zip(PLAN_KEYS, plan)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_plan_splits_rows_into_segments_of_tiles(emulated, name):
    """Each case runs several tiles a batch row; the cases with more than
    one segment a row also run warm-up tiles ahead of their later segments."""
    results, cases = emulated
    plan = dict(zip(PLAN_KEYS, results[name][2]))
    c_in, c_out, rate, taps, b, t_in, sms, split = CASES[name]
    tiles = -(-t_in * rate // plan["tile"])
    assert plan["tile"] % rate == 0 and plan["tile"] % 16 == 0
    assert plan["segments"] == -(-tiles // plan["seg_tiles"])
    assert plan["warm_tiles"] * plan["tile"] >= (taps - 1) * 13
    if split:
        assert plan["split"] == split
        assert tiles >= 3 and (plan["segments"] > 1 or plan["seg_tiles"] > 1)
    else:  # two tiles on 8 CTA slots: the plan splits the columns
        assert plan["split"] > 1 and c_out % (16 * plan["split"]) == 0


def test_emulated_kernel_two_launches_give_the_same_bits(emulated):
    results, _ = emulated
    assert torch.equal(results["repeat"][1], results[REPEAT][1])


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_emulated_column_split_gives_the_bits_of_no_split(emulated, name):
    """Each column's sums run in the same order whichever CTA computes it,
    and every snake is the same arithmetic: a split changes no bit."""
    results, _ = emulated
    err, unsplit, plan = results[f"{name}-split1"]
    assert err == 0 and dict(zip(PLAN_KEYS, plan))["split"] == 1
    assert torch.equal(results[name][1], unsplit)
