"""x @ W for int8 weights with per-column bf16 scales: the wrapper of the
hand-written CUDA kernel ``csrc/int8_matmul.cu`` and its plain PyTorch
version.

Not the port of a TPU kernel. The JAX package's ``_w_matmul`` leaves the
int8 -> activation-dtype convert to XLA, which fuses it into the dot, so that
only int8 bytes stream from HBM; eager PyTorch would cast each weight whole
on every call. The kernel reads each int8 weight once and widens it in
registers. It is bound by bytes: the int8 weights (plus x and y) over
3.35 TB/s.

``int8_matmul(x, w_i8, s)`` is ``_w_matmul``'s int8 branch: ``(x @ w_i8) *
s`` in x's dtype, the product rounded to x's dtype before the scale;
``f32_out=True`` gives the sub-talker LM heads' ``(x @ w_i8).float() *
s.float()``. x is [..., K] f32 or bf16, w_i8 [K, N] int8 and s [1, N] bf16
(``quantize_int8``'s layout). ``int8_matmul_group(x, [(w_i8, s), ...])``
computes up to ``MAX_GROUP`` weights that read the same x in one launch
(q|k|v, gate|up) and returns their products in order; each is the bits of
its single launch. For CUDA tensors both launch the kernel (N a multiple of
16, K at most ``MAX_K``; anything else raises); the plain versions, the
cast-and-matmul, serve only CPU tensors. bf16 activations take the tensor
cores (K a multiple of 16), f32 ones the CUDA cores. On the card a row's bits
do not depend on the other rows of x: each kernel sums in one order fixed by
K alone. ``int8_matmul.launches`` counts the kernel's launches, single and
grouped.

A timed launch (``int8_matmul_group(..., timeline=)``, an int64 tensor of
``launch_blocks(...)`` x ``TIMELINE_SLOTS``) records each block's
global-timer stamps; ``timeline_breakdown`` summarises them.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import List, Sequence, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K split over at most 8 cluster ranks: the f32 kernel's 32 groups of at most
# 16 weight rows, the tensor-core kernel's 4 warps of at most 8 16-row steps.
MAX_K = 8 * 32 * 16
MAX_GROUP = 4
# The kernel's timeline slots, global-timer stamps in ns.
_STAMPS = ("start", "weights", "x", "products", "exchange", "stored")
TIMELINE_SLOTS = len(_STAMPS)
_fns = {}


def _kernel_fn(name: str):
    if not _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        lib = load_library("int8_matmul")
        fn = lib.qtts_int8_matmul
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        grid = lib.qtts_int8_matmul_grid
        grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
        grid.restype = ctypes.c_int
        _fns.update(matmul=fn, grid=grid)
    return _fns[name]


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, s: torch.Tensor,
                      f32_out: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weight cast whole to x's
    dtype, the matmul, then the scale (in x's dtype, or in f32)."""
    y = x @ w_i8.to(x.dtype)
    if f32_out:
        return y.float() * s.float()
    return y * s.to(x.dtype)


def int8_matmul_group_plain(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                            f32_out: bool = False) -> List[torch.Tensor]:
    """The grouped kernel's function in plain PyTorch: one
    ``int8_matmul_plain`` per weight."""
    return [int8_matmul_plain(x, w_i8, s, f32_out) for w_i8, s in weights]


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


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * MAX_GROUP)(*values)


def launch_blocks(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    """Blocks of the launch that ``int8_matmul_group(x, weights)`` makes on
    the card (the rows of its timeline)."""
    k = weights[0][0].shape[0]
    grid = (ctypes.c_int * 3)()
    err = _kernel_fn("grid")(_DTYPES[x.dtype], len(weights),
                             _ints([w.shape[1] for w, _ in weights]), x.numel() // k, k, grid)
    if err != 0:
        raise ValueError(f"int8_matmul: no launch for these shapes (cudaError {err})")
    return grid[0] * grid[1] * grid[2]


def int8_matmul_group(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      f32_out: bool = False,
                      timeline: torch.Tensor | None = None) -> List[torch.Tensor]:
    """x [..., K] @ each w_i8 [K, N_e] with its scales s [1, N_e], in one
    launch: a list of [..., N_e] in x's dtype, or in f32 with ``f32_out``.
    ``timeline``: None, or an int64 [launch_blocks(x, weights),
    TIMELINE_SLOTS] tensor on x's device that the launch fills."""
    if not x.is_cuda:
        return int8_matmul_group_plain(x, weights, f32_out)

    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"int8_matmul_group takes 1 to {MAX_GROUP} weights, got {len(weights)}")
    for w_i8, s in weights:
        _check(x, w_i8, s)
    k = weights[0][0].shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    m = x2.shape[0]
    dtype = torch.float32 if f32_out else x.dtype
    outs = [torch.empty((m, w.shape[1]), dtype=dtype, device=x.device) for w, _ in weights]
    if m == 0:
        return [o.reshape(*lead, o.shape[1]) for o in outs]
    if timeline is not None and (timeline.dtype != torch.int64 or timeline.device != x.device
                                 or not timeline.is_contiguous()
                                 or tuple(timeline.shape) != (launch_blocks(x2, weights),
                                                              TIMELINE_SLOTS)):
        raise ValueError(f"int8_matmul: timeline must be int64 [launch blocks, "
                         f"{TIMELINE_SLOTS}] on x's device")
    ptrs = ctypes.c_void_p * MAX_GROUP
    err = _kernel_fn("matmul")(
        x2.data_ptr(), len(weights), ptrs(*[w.data_ptr() for w, _ in weights]),
        ptrs(*[s.data_ptr() for _, s in weights]), ptrs(*[o.data_ptr() for o in outs]),
        _ints([w.shape[1] for w, _ in weights]), _DTYPES[x.dtype], int(f32_out), m, k,
        None if timeline is None else timeline.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return [o.reshape(*lead, o.shape[1]) for o in outs]


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, s: torch.Tensor,
                f32_out: bool = False) -> torch.Tensor:
    """x [..., K] @ w_i8 [K, N] with the scales s [1, N]: [..., N] in x's
    dtype, or in f32 with ``f32_out``."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_i8, s, f32_out)
    return int8_matmul_group(x, [(w_i8, s)], f32_out)[0]


int8_matmul.launches = 0


def timeline_breakdown(timeline: torch.Tensor) -> dict:
    """A timed launch's blocks summarised, in us: the spread of their starts,
    the median and largest of each phase (start -> weights landed -> x
    landed -> products done -> exchange done -> stored), and the launch's
    span (first start to last store)."""
    t = timeline.cpu().tolist()
    starts = [row[0] for row in t]
    out = {"blocks": len(t), "start_spread_us": (max(starts) - min(starts)) / 1e3,
           "span_us": (max(row[5] for row in t) - min(starts)) / 1e3}
    for i in range(1, len(_STAMPS)):
        d = [(row[i] - row[i - 1]) / 1e3 for row in t]
        out[f"{_STAMPS[i]}_us"] = {"median": statistics.median(d), "max": max(d)}
    return out
