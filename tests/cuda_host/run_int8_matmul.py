"""Runs the host-emulated int8-matmul library over a file of cases and saves
the outputs: ``python run_int8_matmul.py LIB CASES OUT``.

Each case is a dict with x [M, K] (f32 or bf16), w int8 [K, N], s bf16
[1, N] and f32_out, on the CPU; the result is (cudaError code, output).
``tests/test_torch_int8_matmul.py`` runs this in a subprocess with a time
limit."""

import ctypes
import sys

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def run(lib, case):
    x, w, s, f32_out = case["x"], case["w"], case["s"], case["f32_out"]
    m, k = x.shape
    n = w.shape[1]
    out = torch.full((m, n), float("nan"), dtype=torch.float32 if f32_out else x.dtype)
    err = lib.qtts_int8_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                               DTYPES[x.dtype], int(f32_out), m, k, n, None)
    return err, out


def main(lib_path, cases_path, out_path):
    lib = ctypes.CDLL(lib_path)
    lib.qtts_int8_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    cases = torch.load(cases_path)
    torch.save({name: run(lib, case) for name, case in cases.items()}, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])
