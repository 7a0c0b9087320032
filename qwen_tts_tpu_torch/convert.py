"""Carry parameters across from the JAX package.

``convert_params`` takes the JAX package's ``(talker, subtalker, codec)``
parameter trees with numpy arrays as leaves (the caller applies ``np.asarray``
on the JAX side, so this module needs neither jax nor ``ml_dtypes``) and
returns the port's trees: the same keys, nesting and layouts, as tensors on
one device. Both packages then compute the same thing.

``convert_codec_v1_tree`` and ``convert_whisper_vq_tree`` do the same for the
25 Hz tokenizer: the DiT and BigVGAN decoder, and the Whisper-VQ encoder.
Their convs go from JAX's channels-last ``[K, C_in, C_out]`` to PyTorch's
``[C_out, C_in, K]``, and BigVGAN's flipped-tap transposed convs back to
``[C_in, C_out, K]``; the anti-aliasing ``_filters`` come along in float32.

``convert_encoder_tree`` carries the JAX speaker-encoder (ECAPA-TDNN) and
Mimi-encoder trees across in float32. JAX stores their convs channels-last
``[K, C_in, C_out]``; the port runs them channels-first on ``[C_out, C_in,
K]``, the checkpoint's own layout, so those leaves are transposed. The Mimi
tree's ``dilation`` and ``stride`` leaves are dropped: the port reads them
from the config.

``convert_vq_tree`` carries the EMA VQ trainer's trees across: a JAX
``VQState`` (its four buffers, ``inited`` staying bool) and the projection
params (or None), as the port's ``training.vq.VQState`` and dict.

Only floating weights take the requested dtype. Integer leaves (int8 weights
and tables of a quantized tree) keep their own dtype, and so do scales: the
``*_s`` weight scales, stored bf16 by ``quantize_trunk_int8`` whatever the
model dtype, and the f32 ``s`` of an int8 KV cache dict.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from qwen_tts_tpu_torch.training.vq import VQState
from qwen_tts_tpu_torch.utils import Device, resolve_device


def _is_scale(key: Optional[str]) -> bool:
    return key is not None and (key == "s" or key.endswith("_s"))


def _tensor(a: np.ndarray, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """numpy → tensor on ``device``; cast to ``dtype`` unless it is None."""
    a = np.array(a, order="C")  # an owned, writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def convert_tree(tree: Any, device: torch.device, dtype: torch.dtype,
                 key: Optional[str] = None) -> Any:
    """Map every array leaf of nested dicts/lists to a tensor: floating
    weights in ``dtype``, integer leaves and scales in their own dtype."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert_tree(v, device, dtype, key) for v in tree)
    a = np.asarray(tree)
    floating = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
    keep = not floating or _is_scale(key)
    return _tensor(a, device, None if keep else dtype)


def convert_params(
    talker: dict,
    subtalker: dict,
    codec: Optional[dict] = None,
    *,
    talker_dtype: torch.dtype = torch.bfloat16,
    codec_dtype: torch.dtype = torch.float32,
    device: Device = None,
) -> Tuple[dict, dict, Optional[dict]]:
    """JAX loader trees (numpy leaves) → the port's trees on ``device``
    (CUDA unless given)."""
    device = resolve_device(device)
    return (
        convert_tree(talker, device, talker_dtype),
        convert_tree(subtalker, device, talker_dtype),
        None if codec is None else convert_tree(codec, device, codec_dtype),
    )


# Conv-weight keys of the encoder trees (the 3-D ones are convs; ``fc_w`` and
# the SE block's ``w1``/``w2`` are linears, kept [in, out]).
_ENCODER_CONVS = ("w", "conv_w", "init_w", "final_w", "down_w")


def convert_encoder_tree(tree: Any, device: Device = None, key: Optional[str] = None) -> Any:
    """A JAX speaker-encoder or Mimi-encoder tree (numpy leaves) → the
    port's tree in float32 on ``device`` (CUDA unless given), convs
    transposed to ``[C_out, C_in, K]``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: convert_encoder_tree(v, device, k) for k, v in tree.items()
                if k not in ("dilation", "stride")}
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert_encoder_tree(v, device, key) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree, np.float32)
    if key in _ENCODER_CONVS and a.ndim == 3:
        a = a.transpose(2, 1, 0)
    return _tensor(a, device, torch.float32)


# The 25 Hz trees' conv leaves by key: JAX [K, C_in, C_out] (a leading axis
# for the AMP blocks' stacked pairs) → PyTorch [C_out, C_in, K].
_V1_CONVS = ("pre_w", "post_w", "pre_conv_w", "conv1_w", "conv2_w", "ds_w")


def _torch_layout(tree: Any, key: Optional[str] = None) -> Any:
    """numpy leaves of a 25 Hz tree re-laid out for the port."""
    if isinstance(tree, dict):
        return {k: _torch_layout(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_layout(v, key) for v in tree)
    a = np.asarray(tree)
    if key == "ups_w":  # flipped taps [K, C_in, C_out] → [C_in, C_out, K]
        return np.flip(a, axis=0).transpose(1, 2, 0)
    if key in _V1_CONVS:
        return np.swapaxes(a, -1, -3)
    return a


def convert_codec_v1_tree(tree: dict, dtype: torch.dtype = torch.float32,
                          device: Device = None) -> dict:
    """The JAX ``load_codec_v1`` tree (numpy leaves) → the port's, on
    ``device`` (CUDA unless given): weights in ``dtype``, the DiT's ECAPA and
    the anti-aliasing filters in float32."""
    device = resolve_device(device)
    dit = dict(tree["dit"])
    spk = dit.pop("spk_encoder")
    bigvgan = dict(tree["bigvgan"])
    filters = bigvgan.pop("_filters")
    out_dit = convert_tree(dit, device, dtype)
    out_dit["spk_encoder"] = convert_encoder_tree(spk, device)
    out_bigvgan = convert_tree(_torch_layout(bigvgan), device, dtype)
    out_bigvgan["_filters"] = convert_tree(filters, device, torch.float32)
    return {"dit": out_dit, "bigvgan": out_bigvgan}


def convert_whisper_vq_tree(tree: dict, device: Device = None) -> dict:
    """The JAX ``load_whisper_vq`` tree (numpy leaves) → the port's in
    float32 on ``device`` (CUDA unless given)."""
    return convert_tree(_torch_layout(tree), resolve_device(device), torch.float32)


def convert_vq_tree(state, params: Optional[dict] = None, device: Device = None
                    ) -> Tuple[VQState, Optional[dict]]:
    """A JAX ``VQState`` (any object with its four fields; numpy leaves)
    and its projection params → the port's, in float32 on ``device`` (CUDA
    unless given); ``inited`` stays bool."""
    device = resolve_device(device)
    fields = (convert_tree(getattr(state, k), device, torch.float32) for k in VQState._fields)
    return VQState(*fields), convert_tree(params, device, torch.float32) if params else None
