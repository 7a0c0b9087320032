"""Runs the host-emulated decode-attention library over a file of cases and
saves the outputs: ``python run_kernel.py LIB CASES OUT``.

Each case is a dict with q, k, v (a tensor, or the int8 dict cache {"i8",
"s"}), cur_len, valid_from, window and n_split, all on the CPU; the result
is (cudaError code, output). ``tests/test_torch_attention_emulated.py`` runs
this in a subprocess with a time limit."""

import ctypes
import os
import sys

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def run(lib, case):
    q, k, v = case["q"], case["k"], case["v"]
    b, h, hd = q.shape
    int8 = isinstance(k, dict)
    s_max, kv = (k["i8"] if int8 else k).shape[1:3]
    out = torch.full_like(q, float("nan"))
    tail = (case["cur_len"].data_ptr(), case["valid_from"].data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, h, kv, hd, s_max, case["window"], case["n_split"], hd ** -0.5,
            None)
    if int8:
        err = lib.qtts_decode_attention_int8(q.data_ptr(), k["i8"].data_ptr(), k["s"].data_ptr(),
                                             v["i8"].data_ptr(), v["s"].data_ptr(), *tail)
    else:
        err = lib.qtts_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), *tail)
    return err, out


def main(lib_path, cases_path, out_path):
    # One OS thread per emulated CUDA thread, hundreds at once: on half the
    # cores, at a lower priority, the emulation leaves the test suite's other
    # workers cores of their own (XLA's CPU collectives in the JAX package's
    # multi-device tests can lose a participant when every core is crowded).
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[: max(2, len(cores) // 2)])
    os.nice(10)
    lib = ctypes.CDLL(lib_path)
    ints = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    lib.qtts_decode_attention.argtypes = [ctypes.c_void_p] * 6 + ints
    lib.qtts_decode_attention_int8.argtypes = [ctypes.c_void_p] * 8 + ints
    cases = torch.load(cases_path)
    torch.save({name: run(lib, case) for name, case in cases.items()}, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])
