"""x @ W for an int8 weight with per-column bf16 scales: the wrapper of the
hand-written CUDA kernel ``csrc/int8_matmul.cu`` and its plain PyTorch
version.

Not the port of a TPU kernel. The JAX package's ``_w_matmul`` leaves the
int8 -> activation-dtype convert to XLA, which fuses it into the dot, so that
only int8 bytes stream from HBM; eager PyTorch would cast each weight whole
on every call. The kernel reads each int8 weight once and widens it in
registers. It is bound by bytes: the int8 weight (plus x and y) over
3.35 TB/s.

``int8_matmul(x, w_i8, s)`` is ``_w_matmul``'s int8 branch: ``(x @ w_i8) *
s`` in x's dtype, the product rounded to x's dtype before the scale;
``f32_out=True`` gives the sub-talker LM heads' ``(x @ w_i8).float() *
s.float()``. x is [..., K] f32 or bf16, w_i8 [K, N] int8 and s [1, N] bf16
(``quantize_int8``'s layout). It launches the kernel for CUDA tensors (N a
multiple of 16, K at most ``MAX_K``; anything else raises) and takes
``int8_matmul_plain``, the cast-and-matmul, only for CPU tensors. bf16
activations take the tensor cores (K a multiple of 16), f32 ones the CUDA
cores. On the card a row's bits do not depend on the other rows of x: each
kernel sums in one order fixed by K and N. ``int8_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K split over at most 8 cluster ranks of 32 groups, each of at most 16
# weight rows (the kernel's kMaxSplit, kGroups and kMaxRows).
MAX_K = 8 * 32 * 16
_fns = {}


def _kernel_fn(name: str):
    if not _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        lib = load_library("int8_matmul")
        fn = lib.qtts_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns.update(matmul=fn)
    return _fns[name]


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, s: torch.Tensor,
                      f32_out: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weight cast whole to x's
    dtype, the matmul, then the scale (in x's dtype, or in f32)."""
    y = x @ w_i8.to(x.dtype)
    if f32_out:
        return y.float() * s.float()
    return y * s.to(x.dtype)


def _check(x: torch.Tensor, w_i8: torch.Tensor, s: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 activations, got {x.dtype}")
    if w_i8.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul takes an int8 weight and bf16 scales, got "
                        f"{w_i8.dtype}/{s.dtype}")
    if w_i8.dim() != 2 or x.shape[-1] != w_i8.shape[0]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and weight {tuple(w_i8.shape)} "
                         f"do not chain")
    k, n = w_i8.shape
    if s.numel() != n or n % 16 or not 1 <= k <= MAX_K or (x.dtype == torch.bfloat16 and k % 16):
        raise ValueError(f"int8_matmul takes N a multiple of 16, 1 <= K <= {MAX_K} (bf16: a "
                         f"multiple of 16) and [1, N] scales; got K {k}, N {n}, scales "
                         f"{tuple(s.shape)}")
    for t in (w_i8, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_matmul needs contiguous operands on one device")
    if w_i8.data_ptr() % 16:
        raise ValueError("int8_matmul reads weight rows 16 B at a time: the weight must "
                         "start 16 B-aligned")


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, s: torch.Tensor,
                f32_out: bool = False) -> torch.Tensor:
    """x [..., K] @ w_i8 [K, N] with the scales s [1, N]: [..., N] in x's
    dtype, or in f32 with ``f32_out``."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_i8, s, f32_out)

    _check(x, w_i8, s)
    k, n = w_i8.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32 if f32_out else x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    err = _kernel_fn("matmul")(
        x2.data_ptr(), w_i8.data_ptr(), s.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
        int(f32_out), m, k, n, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


int8_matmul.launches = 0
