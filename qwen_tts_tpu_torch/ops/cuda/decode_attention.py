"""Decode attention: the wrappers of the hand-written CUDA kernel
``csrc/decode_attention.cu`` and their plain PyTorch versions.

The kernel replaces the TPU kernel
``qwen_tts_tpu/ops/pallas/decode_attention.py::pallas_attention_decode_step``
and also takes the runtime per-layer window that the trunk passes. One
template serves two cache types: a cache in the activation dtype
(``decode_attention``) and the int8 dict cache ``{"i8", "s"}`` of the serving
mode (``decode_attention_int8``), whose scales fold into the dots. It is bound
by bytes: ``B * n_valid * KV * hd * 2 * sizeof(cache element)`` (plus the
int8 cache's scales) over 3.35 TB/s. The source notes its design.

The kernel splits each row's valid range into chunks of ``CHUNK`` positions
counted from the row's first, deals them over the warps of ``n_split``
blocks (one cluster per (row, KV head)) and merges their partial softmaxes
inside the launch, in an order fixed by the row alone. ``choose_split`` is
the host's choice of ``n_split`` (from S_max only, so no device value is
read), ``split_ok`` says which ``n_split`` the kernel takes (powers of two up
to 8), and ``valid_range`` and ``split_share`` mirror, in the kernel's
integer arithmetic, how each warp finds its positions on the device; the
tests hold them to the kernel's contract. A row's bits do not depend on the
batch, on S_max or on where left padding puts the row in its cache.

Each wrapper launches the kernel for CUDA tensors and takes its plain version
only for CPU tensors. ``decode_attention.launches`` and
``decode_attention_int8.launches`` count the launches of each variant, and
``.splits`` counts them by ``n_split``. ``decode_attention`` hands a dict
cache to ``decode_attention_int8``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from qwen_tts_tpu_torch.ops.attention import KVCache, attention_decode_step

# "No window": positions >= cur_len - NO_WINDOW covers every cache slot.
NO_WINDOW = 2 ** 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8, 16)
# Splits per (row, KV head): at most one portable cluster of 8 blocks. At
# 16 a B=32 x 2080 launch was 1024 blocks, 1.55 waves of the 5 an SM that
# fit, and the int8 cache took 4.4x its byte bound (NVIDIA H100 80GB HBM3,
# 700 W); at 8 it is one wave.
MAX_SPLIT = 8
# Warps per block, and the positions of one chunk (the kernel's kWarps and
# kP): chunk j of a row goes to warp slot j mod (n_split * WARPS_PER_BLOCK).
# A row of at most CHUNK positions takes block 0's warps, an equal share
# each, one position at a time.
WARPS_PER_BLOCK = 4
CHUNK = 16
_fns = {}


def choose_split(s_max: int) -> int:
    """The kernel's n_split for a cache of ``s_max`` slots: the power of two
    of blocks whose warps cover ceil(S_max / CHUNK) chunks, at most
    MAX_SPLIT. Any row of the cache then has at most one chunk a warp, or,
    at MAX_SPLIT, the deal every longer row gets."""
    chunks = -(-s_max // CHUNK)
    blocks = -(-chunks // WARPS_PER_BLOCK)
    return min(MAX_SPLIT, 1 << max(blocks - 1, 0).bit_length())


def split_ok(n_split: int) -> bool:
    """Whether the kernel takes ``n_split``: a power of two up to MAX_SPLIT
    (the merge weighs the ranks by a shuffle tree over n_split lanes)."""
    return 1 <= n_split <= MAX_SPLIT and n_split & (n_split - 1) == 0


def valid_range(cur_len: int, valid_from: int, s_max: int, window: int = NO_WINDOW):
    """A row's attended range [lo, hi) as the kernel computes it:
    [max(valid_from, cur_len - window, 0), min(cur_len, S_max)), or [0, S_max)
    with every score masked when that is empty. Returns (lo, hi, empty)."""
    hi = min(cur_len, s_max)
    lo = max(valid_from, 0, cur_len - window)
    if lo >= hi:
        return 0, s_max, True
    return lo, hi, False


def split_share(lo: int, hi: int, n_split: int, rank: int, warp: int):
    """The positions warp ``warp`` of block ``rank`` takes of [lo, hi), as
    the [start, end) pieces it walks in order: a row of at most CHUNK
    positions in equal shares over block 0's warps (n * w / WARPS_PER_BLOCK,
    walked one position at a time); a longer row's chunks [lo + j CHUNK,
    lo + (j + 1) CHUNK) for j = slot, slot + n_split * WARPS_PER_BLOCK, ...
    with slot = rank * WARPS_PER_BLOCK + warp."""
    n = hi - lo
    if n <= CHUNK:
        if rank:
            return []
        start, end = lo + n * warp // WARPS_PER_BLOCK, lo + n * (warp + 1) // WARPS_PER_BLOCK
        return [(start, end)] if end > start else []
    slot, slots = rank * WARPS_PER_BLOCK + warp, n_split * WARPS_PER_BLOCK
    return [(lo + j * CHUNK, min(hi, lo + (j + 1) * CHUNK))
            for j in range(slot, -(-n // CHUNK), slots)]


def _kernel_fn(name: str, n_pointers: int):
    """The C entry ``name`` of the built library, with its ctypes signature:
    ``n_pointers`` pointers, then dtype, batch, heads, kv_heads, head_dim,
    s_max, window, n_split, scale and the stream."""
    if name not in _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        fn = getattr(load_library("decode_attention"), name)
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(q: torch.Tensor, cache_shape, cur_len: torch.Tensor,
           valid_from: torch.Tensor, tensors) -> None:
    """Raise on what the kernel does not take (the dtypes are checked by the
    caller)."""
    b, h, hd = q.shape
    s_max, kv = cache_shape[1], cache_shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16 queries, got {q.dtype}")
    if hd not in _HEAD_DIMS or h % kv or h // kv not in _GROUPS:
        raise ValueError(f"decode attention: unsupported H={h} KV={kv} hd={hd}")
    if tuple(cache_shape) != (b, s_max, kv, hd):
        raise ValueError(f"cache shape {tuple(cache_shape)} does not match q {tuple(q.shape)}")
    for name, t in (("cur_len", cur_len), ("valid_from", valid_from)):
        if t.dtype != torch.int32 or t.shape != (b,) or t.device != q.device:
            raise ValueError(f"{name} must be int32 [{b}] on {q.device}")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode attention needs contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in tensors if t.dim() in (3, 4)):
        raise ValueError("decode attention reads q and the cache rows 16 B at a time: q "
                         "and the caches must start 16 B-aligned")


def _launched(wrapper, n_split: int) -> None:
    wrapper.launches += 1
    wrapper.splits[n_split] = wrapper.splits.get(n_split, 0) + 1


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
    q: torch.Tensor,   # [B, H, hd]
    k_cache: KVCache,  # [B, S_max, KV, hd] (already holds the new k)
    v_cache: KVCache,
    cur_len: torch.Tensor,  # int32 [B], length including the new token
    valid_from: torch.Tensor,  # int32 [B], first real position
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token GQA attention over ``[max(valid_from, cur_len - window),
    cur_len)`` of each row's cache. Returns [B, H, hd] in q's dtype. An int8
    dict cache goes to ``decode_attention_int8``."""
    if isinstance(k_cache, dict):
        return decode_attention_int8(q, k_cache, v_cache, cur_len, valid_from, window)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, cur_len, valid_from, window)

    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes a cache in q's dtype, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} differ")
    _check(q, k_cache.shape, cur_len, valid_from, (q, k_cache, v_cache, cur_len, valid_from))
    b, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    n_split = choose_split(s_max)
    out = torch.empty_like(q)
    err = _kernel_fn("qtts_decode_attention", 6)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur_len.data_ptr(),
        valid_from.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, kv, hd, s_max,
        NO_WINDOW if window is None else int(window), n_split, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    _launched(decode_attention, n_split)
    return out


decode_attention.launches = 0
decode_attention.splits = {}


def decode_attention_int8_plain(
    q: torch.Tensor, k_cache: dict, v_cache: dict,
    cur_len: torch.Tensor, valid_from: torch.Tensor, window: Optional[int] = None,
) -> torch.Tensor:
    """The int8-cache kernel's function in plain PyTorch: the int8 branch of
    ``attention_decode_step`` in f32, output in q's dtype."""
    out = attention_decode_step(
        q.float(), k_cache, v_cache, cur_len=cur_len, valid_from=valid_from,
        sliding_window=window,
    )
    return out.to(q.dtype)


def decode_attention_int8(
    q: torch.Tensor,  # [B, H, hd]
    k_cache: dict,    # {"i8": int8 [B, S_max, KV, hd], "s": f32 [B, S_max, KV]}
    v_cache: dict,
    cur_len: torch.Tensor,
    valid_from: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``decode_attention`` over an int8 dict cache: the scales fold into
    the dots, accumulated in f32. Returns [B, H, hd] in q's dtype."""
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k_cache, v_cache, cur_len, valid_from, window)

    parts = (k_cache["i8"], k_cache["s"], v_cache["i8"], v_cache["s"])
    if any(t.dtype != torch.int8 for t in parts[::2]) or any(
            t.dtype != torch.float32 for t in parts[1::2]):
        raise TypeError("decode_attention_int8 takes int8 caches with float32 scales, got "
                        + "/".join(str(t.dtype) for t in parts))
    shape = k_cache["i8"].shape
    if v_cache["i8"].shape != shape or any(t.shape != shape[:-1] for t in parts[1::2]):
        raise ValueError("int8 caches and their scales [B, S_max, KV] do not match")
    _check(q, shape, cur_len, valid_from, (q, *parts, cur_len, valid_from))
    b, h, hd = q.shape
    n_split = choose_split(shape[1])
    out = torch.empty_like(q)
    err = _kernel_fn("qtts_decode_attention_int8", 8)(
        q.data_ptr(), *(t.data_ptr() for t in parts), cur_len.data_ptr(),
        valid_from.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, shape[2], hd,
        shape[1], NO_WINDOW if window is None else int(window), n_split, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_int8 kernel launch failed: cudaError {err}")
    _launched(decode_attention_int8, n_split)
    return out


decode_attention_int8.launches = 0
decode_attention_int8.splits = {}
