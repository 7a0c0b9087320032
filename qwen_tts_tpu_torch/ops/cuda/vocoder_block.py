"""One vocoder block of the 12 Hz codec decoder: the wrapper of the
hand-written CUDA kernel ``csrc/vocoder_block.cu`` and its plain PyTorch
version.

A block is SnakeBeta → causal transposed conv (stride ``rate``, k = 2 *
rate) → three residual units (snake, K-tap dilated causal conv, snake, 1x1
conv, add; dilations 1/3/9), channels last. The codec's units have K = 7,
the TPU kernel was written for K = 3, and the kernel takes either. It
replaces the TPU kernel ``scripts/exp_pallas_vocoder.py::fused_block``: the
whole block in one launch, its activations kept in shared memory. It is bound by bf16
tensor-core operations (see the source's note) and takes bf16 only, like the
TPU kernel.

``vocoder_block`` launches the kernel for CUDA tensors (bf16, an input width
of at most ``MAX_C_IN`` channels, widths that are multiples of 16; anything
else raises) and takes ``vocoder_block_plain``, which runs at any widths and
dtypes, only for CPU tensors. ``vocoder_block.launches`` counts kernel
launches. Both take a block in the codec's parameter layout (``load_codec``:
``alpha``, ``beta``, flipped-tap ``tconv_w`` [2 * rate, C_in, C_out],
``tconv_b``, ``resunits``); ``pack_vocoder_block`` lists its tensors in the
order the kernel reads them, which reads them where they lie.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from qwen_tts_tpu_torch.ops.convs import causal_conv1d, causal_conv_transpose1d
from qwen_tts_tpu_torch.ops.snake import snake_beta

DILATIONS = (1, 3, 9)
# The widest block input the kernel takes: at the flagship dims blocks 2
# (384 -> 192) and 3 (192 -> 96), the two geometries of the TPU kernel.
MAX_C_IN = 384
MAX_TAPS = 16
_UNIT_VECTORS = ("alpha1", "beta1", "conv1_b", "alpha2", "beta2", "conv2_b")
_fns = {}


def _kernel_fn(name: str):
    if not _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        lib = load_library("vocoder_block")
        block = lib.qtts_vocoder_block
        block.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2
                          + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        block.restype = ctypes.c_int
        tile = lib.qtts_vocoder_block_tile
        tile.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
        tile.restype = ctypes.c_int
        _fns.update(block=block, tile=tile)
    return _fns[name]


def _pointers(tensors: list):
    """A host array of the tensors' device addresses."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _resunit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h = causal_conv1d(h, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    h = causal_conv1d(h, p["conv2_w"], p["conv2_b"])
    return x + h


def vocoder_block_plain(x: torch.Tensor, block: dict, rate: int,
                        dilations: Sequence[int] = DILATIONS) -> torch.Tensor:
    """The block in plain PyTorch, as the JAX codec computes it: x
    [B, T, C_in] → [B, T * rate, C_out] in x's dtype. In bf16 each snake
    reads and writes bf16, each conv sums in f32 and rounds once after its
    bias, the residual add rounds to bf16: the kernel's rounding points."""
    h = snake_beta(x, block["alpha"], block["beta"])
    h = causal_conv_transpose1d(h, block["tconv_w"], block["tconv_b"], stride=rate)
    for unit, dilation in zip(block["resunits"], dilations):
        h = _resunit(unit, h, dilation)
    return h


def pack_vocoder_block(block: dict) -> Tuple[list, list]:
    """The kernel's operands from a codec block, in the order it reads them,
    without copies (the kernel reads the loader's layouts and dtypes):
    weights (``tconv_w``, then each unit's ``conv1_w``, then each unit's
    ``conv2_w``) and per-channel vectors (``alpha``, ``beta``, ``tconv_b``,
    then per unit alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias)."""
    units = block["resunits"]
    weights = ([block["tconv_w"]] + [u["conv1_w"] for u in units]
               + [u["conv2_w"] for u in units])
    vectors = ([block["alpha"], block["beta"], block["tconv_b"]]
               + [u[k] for u in units for k in _UNIT_VECTORS])
    return weights, vectors


def _check(x: torch.Tensor, weights: list, vectors: list, rate: int,
           dilations: Sequence[int]) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"vocoder_block takes bfloat16 activations, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("vocoder_block: x must be a contiguous, 16-byte aligned [B, T, C_in]")
    b, t_in, c_in = x.shape
    if weights[0].dim() != 3 or len(weights) != 7 or len(dilations) != 3 or min(dilations) < 1:
        raise ValueError("vocoder_block takes a [K, C_in, C_out] transposed conv and three "
                         "residual units with dilations >= 1")
    k, w_in, c_out = weights[0].shape
    if k != 2 * rate:
        raise ValueError(f"vocoder_block needs a transposed conv of 2 * rate taps, got {k} "
                         f"for rate {rate}")
    if w_in != c_in or c_in > MAX_C_IN or c_in % 16 or c_out % 16:
        raise ValueError(f"vocoder_block takes C_in <= {MAX_C_IN}, C_in and C_out multiples "
                         f"of 16; got x width {c_in}, weights {w_in} -> {c_out}")
    taps = weights[1].shape[0]
    if not 1 <= taps <= MAX_TAPS:
        raise ValueError(f"vocoder_block takes 1..{MAX_TAPS} residual conv taps, got {taps}")
    if b < 1 or t_in < 1 or b > 65535:
        raise ValueError(f"vocoder_block: batch {b}, length {t_in} out of range")
    shapes = ([(k, c_in, c_out)] + [(taps, c_out, c_out)] * 3 + [(1, c_out, c_out)] * 3
              + [(c_in,)] * 2 + [(c_out,)] * (len(vectors) - 2))
    for i, (t, shape) in enumerate(zip(weights + vectors, shapes)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"vocoder_block: operand {i} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vocoder_block: operand {i} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous() or (i < 7 and t.data_ptr() % 32):
            raise ValueError(f"vocoder_block: operand {i} must be contiguous on {x.device}"
                             f"{' and 32-byte aligned' if i < 7 else ''}")


def kernel_tile(c_in: int, c_out: int, rate: int, taps: int,
                dilations: Sequence[int] = DILATIONS) -> Tuple[int, int, int]:
    """(extended rows, halo rows, dynamic shared bytes) of one CTA for a
    block geometry (``taps``: the residual convs' K) on the current card."""
    l_ext, halo, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _kernel_fn("tile")(c_in, c_out, rate, taps, *dilations, ctypes.byref(l_ext),
                             ctypes.byref(halo), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"vocoder_block has no tile for {c_in} -> {c_out}, rate {rate}: "
                           f"cudaError {err}")
    return l_ext.value, halo.value, smem.value


def vocoder_block(x: torch.Tensor, block: dict, rate: int,
                  dilations: Sequence[int] = DILATIONS) -> torch.Tensor:
    """One vocoder block: x [B, T_in, C_in] → [B, T_in * rate, C_out]."""
    if not x.is_cuda:
        return vocoder_block_plain(x, block, rate, dilations)

    weights, vectors = pack_vocoder_block(block)
    _check(x, weights, vectors, rate, dilations)
    b, t_in, c_in = x.shape
    c_out = weights[0].shape[2]
    out = torch.empty((b, t_in * rate, c_out), dtype=x.dtype, device=x.device)
    err = _kernel_fn("block")(
        x.data_ptr(), out.data_ptr(), _pointers(weights), _pointers(vectors), b, t_in, c_in,
        c_out, rate, weights[1].shape[0], *dilations,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"vocoder_block kernel launch failed: cudaError {err}")
    vocoder_block.launches += 1
    return out


vocoder_block.launches = 0
