"""Runs the host-emulated vocoder-block library over a file of cases and
saves the outputs: ``python run_vocoder_block.py LIB CASES OUT``.

Each case is a dict with x [B, T_in, C_in] bf16, the block's weights and
vectors in the kernel's order (``pack_vocoder_block``), rate, taps, the SM
count the emulated card reports and the split asked for (0: the plan's);
the result is (cudaError code, output, the launch plan). ``tests/test_torch_vocoder_emulated.py`` runs this in a
subprocess with a time limit."""

import ctypes
import os
import sys

import torch

PLAN_KEYS = 8


def run(lib, case):
    x, weights, vectors = case["x"], case["weights"], case["vectors"]
    b, t_in, c_in = x.shape
    c_out = weights[0].shape[2]
    taps = weights[1].shape[0]
    lib.emu_set_sms(case["sms"])
    plan = (ctypes.c_int * PLAN_KEYS)()
    split = case["split"]
    err = lib.qtts_vocoder_block_plan(c_in, c_out, case["rate"], taps, 1, 3, 9, b, t_in, 0, split,
                                      plan)
    out = torch.full((b, t_in * case["rate"], c_out), float("nan"), dtype=torch.bfloat16)
    if err == 0:
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))  # noqa: E731
        err = lib.qtts_vocoder_block(x.data_ptr(), out.data_ptr(), ptrs(weights), ptrs(vectors),
                                     b, t_in, c_in, c_out, case["rate"], taps, 1, 3, 9, 0, split,
                                     None, None)
    return err, out, list(plan)


def main(lib_path, cases_path, out_path):
    # One OS thread per emulated CUDA thread, hundreds at once: on half the
    # cores, at a lower priority, the emulation leaves the test suite's other
    # workers cores of their own (XLA's CPU collectives in the JAX package's
    # multi-device tests can lose a participant when every core is crowded).
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[: max(2, len(cores) // 2)])
    os.nice(10)
    lib = ctypes.CDLL(lib_path)
    lib.qtts_vocoder_block.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2)
    lib.qtts_vocoder_block_plan.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.emu_set_sms.argtypes = [ctypes.c_int]
    cases = torch.load(cases_path)
    torch.save({name: run(lib, case) for name, case in cases.items()}, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])
