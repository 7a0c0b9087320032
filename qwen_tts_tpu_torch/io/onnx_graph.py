"""Minimal ONNX model reader (no `onnx` / `onnxruntime` dependency); the
port's own copy of ``qwen_tts_tpu/io/onnx_graph.py``. Pure Python and numpy:
initializers come out as numpy arrays, and the executor
(``qwen_tts_tpu_torch/onnx_exec.py``) places them.

Parses the protobuf wire format by hand — just the subset of ModelProto /
GraphProto / NodeProto / TensorProto / AttributeProto needed to run inference
graphs like the reference's CAM++ x-vector extractor (``campplus.onnx``,
modeling_qwen3_tts_tokenizer_v1.py:1426-1440). Field numbers follow
onnx/onnx.proto (public schema).

Wire format refresher: each field is a key varint ``(field_number << 3) |
wire_type`` followed by a payload; wire types used by ONNX are 0 (varint),
2 (length-delimited — strings, bytes, sub-messages, packed repeated
numerics), 1/5 (fixed 64/32-bit).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:  # pragma: no cover - groups are not used by ONNX
            raise ValueError(f"unsupported wire type {wire}")


def _packed_int64(payload) -> List[int]:
    out, pos = [], 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        # zig-zag is NOT used for int64 fields in ONNX (sint64 only)
        if v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


@dataclasses.dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]     # graph inputs that are NOT initializers
    outputs: List[str]


def _parse_tensor(buf) -> OnnxTensor:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:
                dims.extend(_packed_int64(val))
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4:
            if wire == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val))
                )
        elif field == 5:
            if wire == 0:
                int32_data.append(val)
            else:
                int32_data.extend(_packed_int64(val))
        elif field == 7:
            if wire == 0:
                v = val
                if v >= 1 << 63:
                    v -= 1 << 64
                int64_data.append(v)
            else:
                int64_data.extend(_packed_int64(val))
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 10:
            if wire == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", bytes(val))
                )
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported ONNX dtype {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np_dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, np_dtype).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype).reshape(dims)
    elif double_data:
        arr = np.asarray(double_data, np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return OnnxTensor(name, arr)


def _parse_attribute(buf) -> Tuple[str, object]:
    name = ""
    value: object = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[bytes] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 2 and wire == 5:
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            v = val
            if v >= 1 << 63:
                v -= 1 << 64
            value = v
        elif field == 4 and wire == 2:
            value = bytes(val)
        elif field == 5 and wire == 2:
            value = _parse_tensor(val).array
        elif field == 7:
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif field == 8:
            if wire == 0:
                ints.append(val if val < 1 << 63 else val - (1 << 64))
            else:
                ints.extend(_packed_int64(val))
        elif field == 9 and wire == 2:
            strings.append(bytes(val))
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = strings
    return name, value


def _parse_node(buf) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    name = ""
    attrs: Dict[str, object] = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif field == 3 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 4 and wire == 2:
            op_type = bytes(val).decode("utf-8")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _value_info_name(buf) -> str:
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            return bytes(val).decode("utf-8")
    return ""


def _parse_graph(buf) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            nodes.append(_parse_node(val))
        elif field == 5 and wire == 2:
            t = _parse_tensor(val)
            initializers[t.name] = t.array
        elif field == 11 and wire == 2:
            inputs.append(_value_info_name(val))
        elif field == 12 and wire == 2:
            outputs.append(_value_info_name(val))
    inputs = [n for n in inputs if n not in initializers]
    return OnnxGraph(nodes, initializers, inputs, outputs)


def load_onnx_graph(path: str) -> OnnxGraph:
    """Parse an .onnx file → OnnxGraph (nodes in topological file order,
    initializers as numpy arrays)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"{path}: no graph found (not an ONNX model?)")
