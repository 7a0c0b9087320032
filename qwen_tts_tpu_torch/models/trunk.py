"""GQA transformer trunk shared by the talker, the sub-talker and the codec's
pre-transformer (PyTorch counterpart of ``qwen_tts_tpu/models/trunk.py``).

Per layer: RMSNorm → Q/K/V → per-head QK-RMSNorm → RoPE → GQA attention →
o_proj (+ LayerScale) → residual → RMSNorm → SwiGLU (+ LayerScale) →
residual. Parameters are the JAX package's layout: a dict of tensors stacked
over a leading [L] axis, projections stored [in, out] so each is ``x @ w``.

The decode step writes the new token's K/V into a fixed-shape
``[L, B, S_max, KV, hd]`` cache **in place** and attends through the
hand-written decode-attention kernels (``ops/cuda/decode_attention.py``) for
CUDA tensors, their plain version for CPU tensors. A cache is a tensor or an
int8 dict ``{"i8", "s"}`` (``ops/attention.py``) that is quantized per token
and head as it is written.

``quantize_trunk_int8`` turns the projections into int8 with per-output-
channel bf16 scales (``<key>_i8`` / ``<key>_s``); every projection then
dequantizes at the matmul, ``(x @ w_i8) * s`` in the activation dtype,
through the hand-written int8 GEMM (``ops/cuda/int8_matmul.py``) for CUDA
tensors, which reads only the int8 bytes, and its plain version for CPU
tensors; the products that read one x (q|k|v, gate|up) are one launch.

``fuse_trunk_params`` joins Q|K|V into ``wqkv`` and gate|up into ``wgu``
(two products a layer instead of five); the trunk functions detect the fused
keys, float or int8, with the JAX package's precedence: separate int8
weights first, then fused ones, then separate float ones.

Tensor parallelism (``parallel/mesh.py``): a rank's ``TrunkDims`` count its
own heads, KV heads and intermediate width and carry the tp group
(``group``). With a group the functions call ``copy_to_tp`` before the
column-parallel products (q/k/v, gate/up) and ``reduce_from_tp`` after the
row-parallel ones (o, down), before the LayerScale and the residual add;
they reduce whenever they hold a group, whatever its size. The per-head
norms (and ``wk`` / ``wv`` where they are whole on every rank, ``kv_slice``)
go through ``copy_to_tp`` too: each rank applies them to its own heads, so
their gradients sum over the ranks. Without a group nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from qwen_tts_tpu_torch.config import placement_of
from qwen_tts_tpu_torch.ops.attention import KVCache, attention_prefill, int8_scale, quantize_kv
from qwen_tts_tpu_torch.ops.cuda.decode_attention import decode_attention
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul, int8_matmul_group
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import apply_rope
from qwen_tts_tpu_torch.parallel.comm import copy_to_tp, reduce_from_tp
from qwen_tts_tpu_torch.utils import normal_init


class TrunkDims(NamedTuple):
    num_layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    intermediate: int
    eps: float
    qk_norm: bool = True
    # Tensor parallelism: the tp group (None on one device or for a trunk
    # whole on every rank) and, where ``wk`` / ``wv`` are whole, the KV heads
    # [first, end) this rank keeps.
    group: object = None
    kv_slice: Optional[Tuple[int, int]] = None


def dims_of(cfg, qk_norm: bool = True) -> TrunkDims:
    """A talker's or code predictor's ``TrunkDims``, with the tp group and
    KV slice of the config's placement."""
    placement = placement_of(cfg)
    return TrunkDims(
        num_layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate=cfg.intermediate_size,
        eps=cfg.rms_norm_eps,
        qk_norm=qk_norm,
        group=None if placement is None else placement.tp_group,
        kv_slice=None if placement is None else placement.kv_slice,
    )


_PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "wqkv", "wgu")


def _layer(params: dict, l: int) -> dict:
    return {k: v[l] for k, v in params.items()}


def _layers(params: dict, num_layers: int) -> list:
    """The stacked weights split into per-layer dicts of views, each weight
    unbound once (its backward stacks the layers' gradients in one step,
    where indexing layer by layer would add a full-size gradient per
    layer)."""
    unbound = {k: v.unbind(0) for k, v in params.items()}
    return [{k: v[l] for k, v in unbound.items()} for l in range(num_layers)]


def init_trunk_params(generator: torch.Generator, dims: TrunkDims, dtype=torch.float32,
                      device=None) -> dict:
    """Random stacked trunk weights (training and tests without a
    checkpoint): projections N(0, 1/fan_in), norms ones; the JAX package's
    keys, shapes and dtypes."""
    l, d, h, kv, hd, i = (dims.num_layers, dims.hidden, dims.heads, dims.kv_heads,
                          dims.head_dim, dims.intermediate)

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    device = device if device is not None else generator.device
    params = {
        "wq": w((l, d, h * hd), d),
        "wk": w((l, d, kv * hd), d),
        "wv": w((l, d, kv * hd), d),
        "wo": w((l, h * hd, d), h * hd),
        "gate": w((l, d, i), d),
        "up": w((l, d, i), d),
        "down": w((l, i, d), i),
        "input_norm": torch.ones((l, d), dtype=dtype, device=device),
        "post_attn_norm": torch.ones((l, d), dtype=dtype, device=device),
    }
    if dims.qk_norm:
        params["q_norm"] = torch.ones((l, hd), dtype=dtype, device=device)
        params["k_norm"] = torch.ones((l, hd), dtype=dtype, device=device)
    return params


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per channel of the last axis (the max runs over axis
    -2): (int8 values, bf16 scales with that axis kept as 1). ``torch.round``
    rounds half to even, as ``jnp.round``; the values are the JAX package's
    bit for bit."""
    w = w.float()
    scale = int8_scale(w.abs().amax(dim=-2, keepdim=True))
    return torch.round(w / scale).to(torch.int8), scale.to(torch.bfloat16)


def fuse_trunk_params(params: dict) -> dict:
    """Q|K|V concatenated into ``wqkv`` [L, D, q + 2kv] and gate|up into
    ``wgu`` [L, D, 2I], the five separate weights dropped: one product each
    instead of five a layer. The trunk functions detect the fused keys."""
    fused = dict(params)
    fused["wqkv"] = torch.cat([params["wq"], params["wk"], params["wv"]], dim=-1)
    fused["wgu"] = torch.cat([params["gate"], params["up"]], dim=-1)
    for k in ("wq", "wk", "wv", "gate", "up"):
        del fused[k]
    return fused


def quantize_trunk_int8(params: dict) -> dict:
    """int8 projections with per-output-channel symmetric scales, stored
    bf16 whatever the model dtype (``<key>_i8`` [L, in, out], ``<key>_s``
    [L, 1, out]); fused weights too. A scale is per output column, so the
    int8 values and scales of a fused weight are those of its parts,
    concatenated."""
    out = dict(params)
    for k in _PROJECTIONS:
        if k in params:
            out[k + "_i8"], out[k + "_s"] = quantize_int8(out.pop(k))
    return out


def _w_matmul(layer: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """x @ W, dequantizing an int8 weight in the activation dtype."""
    if key + "_i8" in layer:
        return int8_matmul(x, layer[key + "_i8"], layer[key + "_s"])
    return x @ layer[key]


def _w_matmuls(layer: dict, keys: Sequence[str], x: torch.Tensor) -> list:
    """x @ W for each key, one int8 GEMM launch for int8 weights (each
    product the bits of its own ``_w_matmul``)."""
    if keys[0] + "_i8" in layer:
        return int8_matmul_group(x, [(layer[k + "_i8"], layer[k + "_s"]) for k in keys])
    return [x @ layer[k] for k in keys]


def _project_qkv(layer: dict, x: torch.Tensor, dims: TrunkDims):
    """x: [..., D] → q [..., H, hd], k/v [..., KV, hd] with QK-RMSNorm.
    Separate int8 weights (one grouped launch), else a fused ``wqkv`` (one
    product), else separate float weights."""
    if "wq_i8" in layer or "wqkv" not in layer and "wqkv_i8" not in layer:
        q, k, v = _w_matmuls(layer, ("wq", "wk", "wv"), x)
    else:
        q, k, v = _w_matmul(layer, "wqkv", x).split(
            [dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim,
             dims.kv_heads * dims.head_dim], dim=-1)
    q = q.unflatten(-1, (dims.heads, dims.head_dim))
    k = k.unflatten(-1, (-1, dims.head_dim))
    v = v.unflatten(-1, (-1, dims.head_dim))
    if getattr(dims, "kv_slice", None) is not None:
        first, end = dims.kv_slice
        k, v = k[..., first:end, :], v[..., first:end, :]
    if dims.qk_norm:
        q = rms_norm(q, layer["q_norm"], dims.eps)
        k = rms_norm(k, layer["k_norm"], dims.eps)
    return q, k, v


def _mlp(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: separate int8 weights (one grouped launch), else a fused
    ``wgu`` (one product), else separate float weights."""
    if "gate_i8" in layer or "wgu" not in layer and "wgu_i8" not in layer:
        gate, up = _w_matmuls(layer, ("gate", "up"), x)
    else:
        gate, up = _w_matmul(layer, "wgu", x).chunk(2, dim=-1)
    return _w_matmul(layer, "down", F.silu(gate) * up)


def _group(dims) -> object:
    """The tp group of ``dims`` (None for dims without the field, as the
    JAX package's, which the functions also take)."""
    return getattr(dims, "group", None)


def _tp_layer(layer: dict, dims: TrunkDims) -> dict:
    """``layer`` with the whole weights that each rank applies to its own
    heads behind ``copy_to_tp`` (their gradients sum over the tp group)."""
    group = _group(dims)
    if group is None:
        return layer
    keys = ("q_norm", "k_norm") + (("wk", "wv") if dims.kv_slice is not None else ())
    return {**layer, **{k: copy_to_tp(layer[k], group) for k in keys if k in layer}}


def _attn_out(layer: dict, attn: torch.Tensor, dims: TrunkDims) -> torch.Tensor:
    """o_proj (+ LayerScale) of the attention output [..., H, hd]."""
    out = reduce_from_tp(_w_matmul(layer, "wo", attn.flatten(-2)), _group(dims))
    return _maybe_scale(layer, "attn_scale", out)


def _mlp_out(layer: dict, h: torch.Tensor, dims: TrunkDims) -> torch.Tensor:
    """The post-attention norm, SwiGLU and LayerScale of the residual ``h``."""
    x = copy_to_tp(rms_norm(h, layer["post_attn_norm"], dims.eps), _group(dims))
    return _maybe_scale(layer, "mlp_scale", reduce_from_tp(_mlp(layer, x), _group(dims)))


def _maybe_scale(layer: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """LayerScale on a residual branch (codec pre-transformer only)."""
    if key in layer:
        return x * layer[key].to(x.dtype)
    return x


def trunk_prefill(
    params: dict,
    dims: TrunkDims,
    hidden: torch.Tensor,  # [B, S, D]
    cos: torch.Tensor,     # [B, S, hd] (already M-RoPE-merged if applicable)
    sin: torch.Tensor,
    *,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = real
    sliding_window: Optional[int] = None,
    layer_windows: Optional[Sequence[int]] = None,  # per-layer window
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B,S,D], k [L,B,S,KV,hd], v).

    ``sliding_window`` applies one window to every layer (codec transformer);
    ``layer_windows`` gives one per layer (talker sliding-window option, with a
    huge sentinel on full-attention layers). Mutually exclusive.

    ``remat`` (training) runs each layer under ``torch.utils.checkpoint``:
    the backward pass recomputes a layer's activations from its input
    instead of keeping them, so peak memory holds one layer's activations
    and every layer's input, at the cost of a second forward. Same values:
    the recomputation runs the same ops."""
    if sliding_window is not None and layer_windows is not None:
        raise ValueError("pass sliding_window or layer_windows, not both")
    cos4, sin4 = cos[:, :, None, :], sin[:, :, None, :]

    def layer_step(h, layer, window):
        layer = _tp_layer(layer, dims)
        x = copy_to_tp(rms_norm(h, layer["input_norm"], dims.eps), _group(dims))
        q, k, v = _project_qkv(layer, x, dims)
        q = apply_rope(q, cos4, sin4)
        k = apply_rope(k, cos4, sin4)
        attn = attention_prefill(q, k, v, pad_mask=pad_mask, sliding_window=window)
        h = h + _attn_out(layer, attn, dims)
        h = h + _mlp_out(layer, h, dims)
        return h, k, v

    ks, vs = [], []
    for l, layer in enumerate(_layers(params, dims.num_layers)):
        window = sliding_window if layer_windows is None else int(layer_windows[l])
        if remat:
            # Nothing in a layer draws random numbers: no RNG state to keep.
            hidden, k, v = torch.utils.checkpoint.checkpoint(
                layer_step, hidden, layer, window, use_reentrant=False,
                preserve_rng_state=False)
        else:
            hidden, k, v = layer_step(hidden, layer, window)
        ks.append(k)
        vs.append(v)
    return hidden, torch.stack(ks), torch.stack(vs)


def _cache_layer(cache: KVCache, l: int) -> KVCache:
    """Layer ``l`` of a stacked cache (tensor or int8 dict), as a view."""
    if isinstance(cache, dict):
        return {"i8": cache["i8"][l], "s": cache["s"][l]}
    return cache[l]


def _cache_write_token(cache: KVCache, l: int, rows: torch.Tensor,
                       write_pos: torch.Tensor, x: torch.Tensor) -> None:
    """Write one token's K or V [B, KV, hd] in place at (l, row,
    write_pos[row]); an int8 dict cache quantizes it per head."""
    if isinstance(cache, dict):
        q8, s = quantize_kv(x)
        cache["i8"][l, rows, write_pos] = q8
        cache["s"][l, rows, write_pos] = s.to(cache["s"].dtype)
    else:
        cache[l, rows, write_pos] = x.to(cache.dtype)


def trunk_decode_step(
    params: dict,
    dims: TrunkDims,
    hidden: torch.Tensor,  # [B, D] — the new token's embedding
    cos: torch.Tensor,     # [B, hd]
    sin: torch.Tensor,
    k_cache: KVCache,      # [L, B, S_max, KV, hd], updated in place
    v_cache: KVCache,
    cur_len: torch.Tensor,  # int32 [B] — length *including* this token
    *,
    valid_from: Optional[torch.Tensor] = None,  # int32 [B]
    sliding_window: Optional[int] = None,
    layer_windows: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, KVCache, KVCache]:
    """Single-token forward across all layers. Returns (hidden, k_cache,
    v_cache); the caches are the ones passed in, written at ``cur_len - 1``
    of each row."""
    if sliding_window is not None and layer_windows is not None:
        raise ValueError("pass sliding_window or layer_windows, not both")
    b = hidden.shape[0]
    rows = torch.arange(b, device=hidden.device)
    write_pos = cur_len.long() - 1
    if valid_from is None:
        valid_from = torch.zeros_like(cur_len)
    cos3, sin3 = cos[:, None, :], sin[:, None, :]
    for l in range(dims.num_layers):
        layer = _tp_layer(_layer(params, l), dims)
        x = copy_to_tp(rms_norm(hidden, layer["input_norm"], dims.eps), _group(dims))
        q, k, v = _project_qkv(layer, x, dims)
        q = apply_rope(q, cos3, sin3)
        k = apply_rope(k, cos3, sin3)
        _cache_write_token(k_cache, l, rows, write_pos, k)
        _cache_write_token(v_cache, l, rows, write_pos, v)
        window = sliding_window if layer_windows is None else int(layer_windows[l])
        attn = decode_attention(q, _cache_layer(k_cache, l), _cache_layer(v_cache, l),
                                cur_len, valid_from, window)
        hidden = hidden + _attn_out(layer, attn, dims)
        hidden = hidden + _mlp_out(layer, hidden, dims)
    return hidden, k_cache, v_cache
