"""One sub-talker micro-step through the whole int8 trunk: the wrapper of the
hand-written CUDA kernel ``csrc/subtalker_step.cu`` and its plain PyTorch
version.

The kernel replaces the TPU kernel
``scripts/exp_pallas_subtalker_step.py::pallas_subtalker_trunk_step``: one
launch per micro-step runs all the layers (RMSNorm, int8 Q/K/V, QK-norm +
RoPE, the K/V row append, GQA attention over positions ``<= pos``, o-proj,
SwiGLU), with the residual held in f32 and every dot taking its f32 scale
after an f32 accumulation. It is bound by bytes: the int8 weights, 78.6 MB at
the flagship dims, once per launch (23.5 us at 3.35 TB/s). The source notes
its design.

The weights come from ``pack_subtalker_weights`` over the port's
``quantize_trunk_int8`` tree. The KV cache is the port's ``[L, B, G, KV, hd]``
in the activation dtype. ``subtalker_step`` launches the kernel for CUDA
tensors (flagship dims, float32 or bfloat16, 1 <= B <= 32; anything else
raises) and takes ``subtalker_step_plain``, which works at any dims, only for
CPU tensors. ``subtalker_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The dims the kernel is compiled for: layers, hidden, heads, KV heads,
# head dim, intermediate (the flagship sub-talker).
KERNEL_DIMS = (5, 1024, 16, 8, 128, 3072)
MAX_BATCH = 32
MAX_GROUPS = 64
_fns = {}


def _kernel_fn(name: str):
    if not _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        lib = load_library("subtalker_step")
        step = lib.qtts_subtalker_step
        step.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = lib.qtts_subtalker_step_scratch_floats
        scratch.argtypes = [ctypes.c_int]
        scratch.restype = ctypes.c_longlong
        shape = lib.qtts_subtalker_step_launch_shape
        shape.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
        shape.restype = ctypes.c_int
        _fns.update(step=step, scratch=scratch, shape=shape)
    return _fns[name]


def pack_subtalker_weights(trunk: dict) -> dict:
    """The kernel's operands from a ``quantize_trunk_int8`` trunk tree:
    [Wq|Wk|Wv] and [gate|up] concatenated along their output columns (int8
    values unchanged: the scales are per output column), the bf16 scales
    widened to f32 [L, N], the norms in the activation dtype."""
    def scales(*keys: str) -> torch.Tensor:
        return torch.cat([trunk[k + "_s"] for k in keys], dim=-1).float().squeeze(1).contiguous()

    def cat(*keys: str) -> torch.Tensor:
        return torch.cat([trunk[k + "_i8"] for k in keys], dim=-1).contiguous()

    return {
        "wqkv": cat("wq", "wk", "wv"), "qkv_s": scales("wq", "wk", "wv"),
        "wo": trunk["wo_i8"].contiguous(), "wo_s": scales("wo"),
        "wgu": cat("gate", "up"), "gu_s": scales("gate", "up"),
        "down": trunk["down_i8"].contiguous(), "down_s": scales("down"),
        **{k: trunk[k].contiguous()
           for k in ("input_norm", "post_attn_norm", "q_norm", "k_norm")},
    }


def _dims(packed: dict, k_cache: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """(L, D, H, KV, hd, I) from the operands' shapes."""
    n_layers, d, n_qkv = packed["wqkv"].shape
    kv, hd = k_cache.shape[3], k_cache.shape[4]
    return n_layers, d, n_qkv // hd - 2 * kv, kv, hd, packed["wgu"].shape[-1] // 2


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm of the f32 residual as the kernel rounds it: normed -> dtype,
    times the weight in dtype."""
    normed = (h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)).to(dtype)
    return w.to(dtype) * normed


def _head_norm_rope(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Per-head RMSNorm (normed -> dtype, x weight -> dtype) then RoPE in f32."""
    n = _rms(x, w, eps, dtype).float()
    half = n.shape[-1] // 2
    return n * cos + torch.cat([-n[..., half:], n[..., :half]], dim=-1) * sin


def subtalker_step_plain(
    packed: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, at any dims: products of
    dtype values accumulate in f32 and take the f32 scale after the dot; the
    residual stays f32 and is cast once at the end. Writes row ``pos`` of the
    caches in place; returns (hidden [B, D] in x's dtype, k_cache, v_cache)."""
    dtype = x.dtype
    n_layers, _, heads, kv, hd, inter = _dims(packed, k_cache)
    b = x.shape[0]
    n_q = heads * hd
    cos, sin = cos.float(), sin.float()
    h = x.float()
    for l in range(n_layers):
        xn = _rms(h, packed["input_norm"][l], eps, dtype).float()
        qkv = (xn @ packed["wqkv"][l].float()) * packed["qkv_s"][l]
        q = qkv[:, :n_q].view(b, heads, hd)
        k = qkv[:, n_q:n_q + kv * hd].view(b, kv, hd)
        v = qkv[:, n_q + kv * hd:].view(b, kv, hd)
        k_cache[l, :, pos] = _head_norm_rope(k, packed["k_norm"][l], cos, sin, eps, dtype).to(dtype)
        v_cache[l, :, pos] = v.to(dtype)
        q = _head_norm_rope(q, packed["q_norm"][l], cos, sin, eps, dtype).to(dtype)

        keys = k_cache[l, :, : pos + 1].float()    # [B, P, KV, hd]
        values = v_cache[l, :, : pos + 1].float()
        qg = q.float().view(b, kv, heads // kv, hd)
        scores = torch.einsum("bkgd,bjkd->bkgj", qg, keys) * hd ** -0.5
        probs = torch.softmax(scores, dim=-1).to(dtype).float()
        attn = torch.einsum("bkgj,bjkd->bkgd", probs, values).reshape(b, n_q).to(dtype)
        h = h + (attn.float() @ packed["wo"][l].float()) * packed["wo_s"][l]

        xn = _rms(h, packed["post_attn_norm"][l], eps, dtype).float()
        gu = (xn @ packed["wgu"][l].float()) * packed["gu_s"][l]
        act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(dtype).float()
        h = h + (act @ packed["down"][l].float()) * packed["down_s"][l]
    return h.to(dtype), k_cache, v_cache


def _check(packed: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"subtalker_step takes float32 or bfloat16, got {x.dtype}")
    dims = _dims(packed, k_cache)
    if dims != KERNEL_DIMS:
        raise ValueError(f"subtalker_step is built for (L, D, H, KV, hd, I) = {KERNEL_DIMS}, "
                         f"got {dims}")
    n_layers, d, heads, kv, hd, inter = dims
    b, groups = x.shape[0], k_cache.shape[2]
    if x.shape != (b, d) or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"x must be [B, {d}] with 1 <= B <= {MAX_BATCH}, got {tuple(x.shape)}")
    if not 1 <= groups <= MAX_GROUPS or not 0 <= pos < groups:
        raise ValueError(f"need 0 <= pos < G <= {MAX_GROUPS}, got pos {pos}, G {groups}")
    n_qkv = (heads + 2 * kv) * hd
    want = {
        "wqkv": ((n_layers, d, n_qkv), torch.int8), "qkv_s": ((n_layers, n_qkv), torch.float32),
        "wo": ((n_layers, heads * hd, d), torch.int8), "wo_s": ((n_layers, d), torch.float32),
        "wgu": ((n_layers, d, 2 * inter), torch.int8),
        "gu_s": ((n_layers, 2 * inter), torch.float32),
        "down": ((n_layers, inter, d), torch.int8), "down_s": ((n_layers, d), torch.float32),
        "input_norm": ((n_layers, d), x.dtype), "post_attn_norm": ((n_layers, d), x.dtype),
        "q_norm": ((n_layers, hd), x.dtype), "k_norm": ((n_layers, hd), x.dtype),
    }
    tensors = {**{k: packed[k] for k in want}, "cos": cos, "sin": sin,
               "k_cache": k_cache, "v_cache": v_cache}
    want.update(cos=((hd,), torch.float32), sin=((hd,), torch.float32),
                k_cache=((n_layers, b, groups, kv, hd), x.dtype),
                v_cache=((n_layers, b, groups, kv, hd), x.dtype))
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if t.dtype != dtype:
            raise TypeError(f"subtalker_step: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"subtalker_step: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"subtalker_step: {name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("subtalker_step: x must be contiguous")


def launch_shape(dtype: torch.dtype, batch: int) -> Tuple[int, int, int]:
    """(grid blocks, threads per block, dynamic shared bytes) of the
    cooperative launch for ``batch`` rows on the current card."""
    grid, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _kernel_fn("shape")(_DTYPES[dtype], batch, ctypes.byref(grid),
                              ctypes.byref(threads), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"subtalker_step launch shape failed: cudaError {err}")
    return grid.value, threads.value, smem.value


def subtalker_step(
    packed: dict,          # pack_subtalker_weights(quantize_trunk_int8(trunk))
    x: torch.Tensor,       # [B, D] micro-step input
    cos: torch.Tensor,     # [hd] f32 RoPE table at pos
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, G, KV, hd], row pos written in place
    v_cache: torch.Tensor,
    pos: int,              # micro-step position, shared by every row
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One micro-step through every layer of the int8 trunk. Returns
    (hidden [B, D] in x's dtype, k_cache, v_cache)."""
    if not x.is_cuda:
        return subtalker_step_plain(packed, x, cos, sin, k_cache, v_cache, pos, eps)

    _check(packed, x, cos, sin, k_cache, v_cache, pos)
    b = x.shape[0]
    out = torch.empty_like(x)
    scratch = torch.empty(_kernel_fn("scratch")(b), dtype=torch.float32, device=x.device)
    operands = (x, cos, sin, packed["wqkv"], packed["qkv_s"], packed["wo"], packed["wo_s"],
                packed["wgu"], packed["gu_s"], packed["down"], packed["down_s"],
                packed["input_norm"], packed["post_attn_norm"], packed["q_norm"],
                packed["k_norm"], k_cache, v_cache, out, scratch)
    err = _kernel_fn("step")(
        *(t.data_ptr() for t in operands), _DTYPES[x.dtype], b, k_cache.shape[2], int(pos),
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"subtalker_step kernel launch failed: cudaError {err}")
    subtalker_step.launches += 1
    return out, k_cache, v_cache


subtalker_step.launches = 0
