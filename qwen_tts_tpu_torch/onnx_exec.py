"""Eager ONNX graph executor over PyTorch ops (counterpart of
``qwen_tts_tpu/onnx_exec.py``).

Covers the operators that exported speaker-verification nets use (CAM++ /
D-TDNN: Conv, BatchNormalization, Relu/Sigmoid, pooling, Gemm / MatMul, the
shape plumbing), so the 25 Hz tokenizer's ``campplus.onnx`` runs without
onnxruntime.

Placement: graph inputs and floating initializers live on the executor's
device; integer initializers, constants and ``Shape``'s output live on the
host (CPU tensors). A node runs on the device when any of its inputs is
there, else on the host. So a shape chain (Shape → Gather → Concat →
Reshape) stays in host integers, and a value that must become a Python int
(a shape, axes, pads, split sizes) is never read back from the device: one
found there raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.io.onnx_graph import OnnxGraph, load_onnx_graph
from qwen_tts_tpu_torch.models.speaker import reflect_pad
from qwen_tts_tpu_torch.utils import Device, full_f32, resolve_device

_HOST = torch.device("cpu")
_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
                 6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
                 11: torch.float64}


def _on_device(v: torch.Tensor, device: torch.device) -> bool:
    return v.device.type == device.type and device.type != "cpu"


def _ints(v: torch.Tensor, device: torch.device, what: str) -> List[int]:
    """A host tensor's values as Python ints."""
    if _on_device(v, device):
        raise ValueError(f"{what} would be read back from the device; the executor keeps "
                         "shape values on the host")
    return [int(a) for a in v.reshape(-1).tolist()]


def _text(attr, default: str) -> str:
    v = attr if attr is not None else default
    return v.decode() if isinstance(v, bytes) else v


def _same_pads(size: int, k: int, stride: int, dilation: int, upper: bool):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    small = total // 2
    return (small, total - small) if upper else (total - small, small)


def _conv(x, w, b, attrs):
    """Conv with groups, strides, dilations, explicit or SAME pads (NCW /
    NCHW / NCDHW)."""
    spatial = x.ndim - 2
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * spatial)]
    groups = int(attrs.get("group", 1))
    pads = attrs.get("pads")
    auto_pad = _text(attrs.get("auto_pad"), "NOTSET")
    if pads is not None:
        per_axis = [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    elif auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        per_axis = [_same_pads(x.shape[2 + i], w.shape[2 + i], strides[i], dilations[i],
                               auto_pad == "SAME_UPPER") for i in range(spatial)]
    else:
        per_axis = [(0, 0)] * spatial
    flat = [p for lo_hi in reversed(per_axis) for p in lo_hi]  # F.pad: last axis first
    conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
    return conv(F.pad(x, flat), w.to(x.dtype), None if b is None else b.to(x.dtype),
                stride=strides, dilation=dilations, groups=groups)


def _pool(x, attrs, op):
    """MaxPool / AveragePool; the average counts only real samples (ONNX's
    default count_include_pad=0)."""
    spatial = x.ndim - 2
    ks = [int(k) for k in attrs["kernel_shape"]]
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * spatial))]
    flat = [p for i in reversed(range(spatial)) for p in (pads[i], pads[i + spatial])]
    if op == "MaxPool":
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[spatial - 1]
        return pool(F.pad(x, flat, value=-math.inf), ks, strides)
    pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[spatial - 1]
    total = pool(F.pad(x, flat), ks, strides)
    count = pool(F.pad(torch.ones_like(x), flat), ks, strides)
    return total / count


def _pad(x, pads, mode: str, value):
    """ONNX Pad over every axis: constant, reflect (as numpy's, any length)
    or edge."""
    nd = x.ndim
    for axis in range(nd):
        lo, hi = pads[axis], pads[axis + nd]
        if lo == hi == 0:
            continue
        x = x.movedim(axis, -1)
        if mode == "constant":
            x = F.pad(x, (lo, hi), value=value)
        elif mode == "reflect":
            x = reflect_pad(x, lo, hi)
        elif mode == "edge":
            idx = torch.arange(-lo, x.shape[-1] + hi, device=x.device).clamp(0, x.shape[-1] - 1)
            x = x.index_select(-1, idx)
        else:
            raise NotImplementedError(f"ONNX Pad mode {mode!r}")
        x = x.movedim(-1, axis)
    return x


def _gather(x, idx, axis: int):
    """jnp.take / ONNX Gather: indices of any shape, negatives from the end."""
    axis = axis % x.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _slice(x, starts, ends, axes, steps):
    for ax, st, en, sp in zip(axes, starts, ends, steps):
        ax = ax % x.ndim
        idx = range(*slice(st, en, sp).indices(x.shape[ax]))
        if sp == 1:
            x = x.narrow(ax, idx.start, len(idx))
        else:
            x = x.index_select(ax, torch.as_tensor(list(idx), dtype=torch.long,
                                                   device=x.device))
    return x


def _axes(node, vals, attrs, device, idx=1) -> Optional[List[int]]:
    """axes as an attribute (opset < 13) or an input (opset >= 13)."""
    if "axes" in attrs:
        return [int(a) for a in attrs["axes"]]
    if len(node.inputs) > idx and node.inputs[idx]:
        return _ints(vals[node.inputs[idx]], device, "axes")
    return None


def _div(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")  # ONNX integer division


_UNARY = {
    "Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh, "Sqrt": torch.sqrt,
    "Neg": torch.neg, "Exp": torch.exp, "Erf": torch.erf, "Identity": lambda a: a,
}
_BINARY = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": _div, "Pow": torch.pow,
    "MatMul": torch.matmul, "Equal": torch.eq,
}
_REDUCE = {"ReduceMean": torch.mean, "ReduceSum": torch.sum, "ReduceMax": torch.amax,
           "ReduceMin": torch.amin}


def _host_value(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def place_initializers(graph: OnnxGraph, device: torch.device) -> Dict[str, torch.Tensor]:
    """Floating initializers on ``device``, the others on the host."""
    out = {}
    for name, a in graph.initializers.items():
        t = _host_value(a)
        out[name] = t.to(device) if t.is_floating_point() else t
    return out


def run_graph(
    graph: OnnxGraph,
    feeds: Dict[str, np.ndarray],
    outputs: Optional[Sequence[str]] = None,
    *,
    device: Device,
    initializers: Optional[Dict[str, torch.Tensor]] = None,
) -> List[np.ndarray]:
    """Run ``graph`` on ``feeds`` (numpy) on ``device``; the outputs come
    back as numpy arrays. ``initializers``: ``place_initializers``' result
    for this graph and device, made here if None."""
    device = torch.device(device)
    vals: Dict[str, torch.Tensor] = dict(
        initializers if initializers is not None else place_initializers(graph, device))
    for k, v in feeds.items():
        vals[k] = torch.as_tensor(np.asarray(v), device=device)
    missing = [i for i in graph.inputs if i not in vals]
    if missing:
        raise ValueError(f"missing graph inputs: {missing}")

    with full_f32():
        for node in graph.nodes:
            vals.update(zip(node.outputs, _run_node(node, vals, device)))
    names = list(outputs) if outputs else graph.outputs
    return [vals[n].cpu().numpy() for n in names]


def _run_node(node, vals, device) -> List[torch.Tensor]:
    """One node's outputs. Its inputs move to the device if any of them is
    there."""
    a = node.attrs
    op = node.op_type
    i = [vals[n] if n else None for n in node.inputs]
    place = device if any(t is not None and _on_device(t, device) for t in i) else _HOST
    i = [None if t is None else t.to(place) for t in i]

    def ints(k: int, what: str) -> List[int]:
        return _ints(vals[node.inputs[k]], device, what)

    if op in _UNARY:
        return [_UNARY[op](i[0])]
    if op in _BINARY:
        return [_BINARY[op](i[0], i[1])]
    if op == "Conv":
        return [_conv(i[0], i[1], i[2] if len(i) > 2 else None, a)]
    if op == "BatchNormalization":
        x, scale, bias, mean, var = i[:5]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        eps = a.get("epsilon", 1e-5)
        return [(x - mean.reshape(shape)) * (scale.reshape(shape)
                                             / torch.sqrt(var.reshape(shape) + eps))
                + bias.reshape(shape)]
    if op == "Softmax":
        axis = int(a.get("axis", -1))
        e = torch.exp(i[0] - i[0].amax(dim=axis, keepdim=True))
        return [e / e.sum(dim=axis, keepdim=True)]
    if op == "Clip":
        lo = i[1] if len(i) > 1 and i[1] is not None else a.get("min")
        hi = i[2] if len(i) > 2 and i[2] is not None else a.get("max")
        return [i[0] if lo is None and hi is None else torch.clamp(i[0], lo, hi)]
    if op == "Gemm":
        x, w = i[0], i[1]
        if a.get("transA", 0):
            x = x.T
        if a.get("transB", 0):
            w = w.T
        out = a.get("alpha", 1.0) * (x @ w)
        if len(i) > 2 and i[2] is not None:
            out = out + a.get("beta", 1.0) * i[2]
        return [out]
    if op == "Concat":
        return [torch.cat(i, dim=int(a["axis"]))]
    if op == "Split":
        axis = int(a.get("axis", 0))
        if len(i) > 1 and i[1] is not None:
            sizes = ints(1, "split sizes")
        elif a.get("split") is not None:
            sizes = [int(s) for s in a["split"]]
        else:
            sizes = [i[0].shape[axis] // len(node.outputs)] * len(node.outputs)
        return list(torch.split(i[0], sizes, dim=axis))
    if op == "Reshape":
        shape = [i[0].shape[k] if s == 0 else s for k, s in enumerate(ints(1, "a shape"))]
        return [i[0].reshape(shape)]
    if op == "Transpose":
        perm = a.get("perm")
        return [i[0].permute(*(perm if perm is not None else reversed(range(i[0].ndim))))]
    if op == "Flatten":
        ax = int(a.get("axis", 1))
        return [i[0].reshape(int(np.prod(i[0].shape[:ax])), -1)]
    if op == "Unsqueeze":
        axes = _axes(node, vals, a, device)
        out = i[0]
        for ax in sorted(ax % (i[0].ndim + len(axes)) for ax in axes):
            out = out.unsqueeze(ax)
        return [out]
    if op == "Squeeze":
        axes = _axes(node, vals, a, device)
        return [i[0].squeeze(tuple(axes)) if axes else i[0].squeeze()]
    if op == "Shape":
        return [torch.tensor(list(i[0].shape), dtype=torch.int64)]
    if op == "Gather":
        return [_gather(i[0], i[1], int(a.get("axis", 0)))]
    if op == "Slice":
        if len(i) > 1:  # opset >= 10: starts/ends/axes/steps as inputs
            starts, ends = ints(1, "slice starts"), ints(2, "slice ends")
            axes = (ints(3, "slice axes") if len(i) > 3 and i[3] is not None
                    else list(range(len(starts))))
            steps = (ints(4, "slice steps") if len(i) > 4 and i[4] is not None
                     else [1] * len(starts))
        else:
            starts = [int(v) for v in a["starts"]]
            ends = [int(v) for v in a["ends"]]
            axes = [int(v) for v in a.get("axes", range(len(starts)))]
            steps = [1] * len(starts)
        return [_slice(i[0], starts, ends, axes, steps)]
    if op in _REDUCE:
        axes = _axes(node, vals, a, device)
        keep = bool(a.get("keepdims", 1))
        dims = tuple(axes) if axes else tuple(range(i[0].ndim))
        return [_REDUCE[op](i[0], dim=dims, keepdim=keep)]
    if op == "ReduceL2":
        axes = _axes(node, vals, a, device)
        dims = tuple(axes) if axes else tuple(range(i[0].ndim))
        return [torch.sqrt((i[0] * i[0]).sum(dim=dims, keepdim=bool(a.get("keepdims", 1))))]
    if op == "GlobalAveragePool":
        return [i[0].mean(dim=tuple(range(2, i[0].ndim)), keepdim=True)]
    if op in ("MaxPool", "AveragePool"):
        return [_pool(i[0], a, op)]
    if op == "Cast":
        return [i[0].to(_TORCH_DTYPES[int(a["to"])])]
    if op == "Constant":
        return [_host_value(np.asarray(a["value"]))]
    if op == "ConstantOfShape":
        fill = a.get("value")
        fill = (_host_value(np.asarray(fill).reshape(-1)[:1]) if fill is not None
                else torch.zeros(1, dtype=torch.float32))
        return [torch.full(ints(0, "a shape"), fill.item(), dtype=fill.dtype)]
    if op == "Expand":
        shape = np.broadcast_shapes(tuple(ints(1, "a shape")), tuple(i[0].shape))
        return [i[0].expand(shape)]
    if op == "Range":
        start, limit, delta = (vals[n] for n in node.inputs[:3])
        for v in (start, limit, delta):
            if _on_device(v, device):
                raise ValueError("Range bounds would be read back from the device")
        return [torch.arange(start.item(), limit.item(), delta.item(), dtype=start.dtype)]
    if op == "LeakyRelu":
        return [F.leaky_relu(i[0], a.get("alpha", 0.01))]
    if op == "PRelu":
        return [torch.where(i[0] > 0, i[0], i[1] * i[0])]
    if op == "Where":
        return [torch.where(i[0].bool(), i[1], i[2])]
    if op == "Pad":
        pads = ints(1, "pads") if len(i) > 1 else [int(v) for v in a["pads"]]
        value = 0.0
        if len(i) > 2 and i[2] is not None:
            fill = vals[node.inputs[2]]
            if _on_device(fill, device):
                raise ValueError("a pad value would be read back from the device")
            value = float(fill.reshape(-1)[0])
        return [_pad(i[0], pads, _text(a.get("mode"), "constant"), value)]
    raise NotImplementedError(
        f"ONNX op {op!r} (node {node.name!r}) not supported by the native executor")


class OnnxModel:
    """A loaded ONNX graph with its initializers placed, and a session-like
    ``run``. Runs on ``device`` (CUDA unless given)."""

    def __init__(self, path: str, device: Device = None):
        self.device = resolve_device(device)
        self.graph = load_onnx_graph(path)
        self.initializers = place_initializers(self.graph, self.device)
        self.input_names = self.graph.inputs
        self.output_names = self.graph.outputs

    def run(self, feeds: Dict[str, np.ndarray],
            outputs: Optional[Sequence[str]] = None) -> List[np.ndarray]:
        return run_graph(self.graph, feeds, outputs, device=self.device,
                         initializers=self.initializers)
