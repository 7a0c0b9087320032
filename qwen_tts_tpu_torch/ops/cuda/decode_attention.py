"""Decode attention: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel
``qwen_tts_tpu/ops/pallas/decode_attention.py::pallas_attention_decode_step``
and also takes the runtime per-layer window that the trunk passes. It is bound
by bytes: ``B * n_valid * KV * hd * 2 * sizeof(dtype)`` over 3.35 TB/s; at the
main path's small caches launch latency bounds it in practice. The source
notes its design.

``decode_attention`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. ``decode_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from qwen_tts_tpu_torch.ops.attention import attention_decode_step

# "No window": positions >= cur_len - NO_WINDOW covers every cache slot.
NO_WINDOW = 2 ** 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8, 16)
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        fn = load_library("decode_attention").qtts_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    cur_len: torch.Tensor, valid_from: torch.Tensor, window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: everything in f32 (the kernel
    keeps the probabilities in f32 for the PV sum), output in q's dtype."""
    out = attention_decode_step(
        q.float(), k_cache.float(), v_cache.float(), cur_len=cur_len,
        valid_from=valid_from, sliding_window=window,
    )
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, H, hd]
    k_cache: torch.Tensor,  # [B, S_max, KV, hd] (already holds the new k)
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,  # int32 [B], length including the new token
    valid_from: torch.Tensor,  # int32 [B], first real position
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token GQA attention over ``[max(valid_from, cur_len - window),
    cur_len)`` of each row's cache. Returns [B, H, hd] in q's dtype."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, cur_len, valid_from, window)

    b, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if hd not in _HEAD_DIMS or h % kv or h // kv not in _GROUPS:
        raise ValueError(f"decode_attention: unsupported H={h} KV={kv} hd={hd}")
    if k_cache.shape != (b, s_max, kv, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("cur_len", cur_len), ("valid_from", valid_from)):
        if t.dtype != torch.int32 or t.shape != (b,) or t.device != q.device:
            raise ValueError(f"{name} must be int32 [{b}] on {q.device}")
    for t in (q, k_cache, v_cache, cur_len, valid_from):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention needs contiguous tensors on one device")
    window = NO_WINDOW if window is None else int(window)

    out = torch.empty_like(q)
    err = _kernel_fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur_len.data_ptr(),
        valid_from.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, kv, hd,
        s_max, window, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
