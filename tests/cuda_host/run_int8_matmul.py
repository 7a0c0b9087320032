"""Runs the host-emulated int8-matmul library over a file of cases and saves
the outputs: ``python run_int8_matmul.py LIB CASES OUT``.

Each case is a dict with x [M, K] (f32 or bf16), ws, a list of (w int8
[K, N], s bf16 [1, N]) that one launch computes, and f32_out, on the CPU;
the result is (cudaError code, [output per weight]).
``tests/test_torch_int8_matmul.py`` runs this in a subprocess with a time
limit."""

import ctypes
import os
import sys

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP = 4


def run(lib, case):
    x, ws, f32_out = case["x"], case["ws"], case["f32_out"]
    m, k = x.shape
    outs = [torch.full((m, w.shape[1]), float("nan"),
                       dtype=torch.float32 if f32_out else x.dtype) for w, _ in ws]
    slots = max(GROUP, len(ws))  # a refused case may hold more weights
    ptrs = ctypes.c_void_p * slots
    err = lib.qtts_int8_matmul(
        x.data_ptr(), len(ws), ptrs(*[w.data_ptr() for w, _ in ws]),
        ptrs(*[s.data_ptr() for _, s in ws]), ptrs(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * slots)(*[w.shape[1] for w, _ in ws]), DTYPES[x.dtype], int(f32_out),
        m, k, None, None)
    return err, outs


def main(lib_path, cases_path, out_path):
    # One OS thread per emulated CUDA thread, hundreds at once: on half the
    # cores, at a lower priority, the emulation leaves the test suite's other
    # workers cores of their own (XLA's CPU collectives in the JAX package's
    # multi-device tests can lose a participant when every core is crowded).
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[: max(2, len(cores) // 2)])
    os.nice(10)
    lib = ctypes.CDLL(lib_path)
    lib.qtts_int8_matmul.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    cases = torch.load(cases_path)
    torch.save({name: run(lib, case) for name, case in cases.items()}, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])
