"""The port's ONNX reader and executor (``qwen_tts_tpu_torch/io/onnx_graph.py``,
``qwen_tts_tpu_torch/onnx_exec.py``) and its CAM++ x-vector front end
(``models/campplus.py``) against the JAX package's, on the CPU in f32.

The graphs are written by the protobuf writer of tests/test_onnx_native.py:
its D-TDNN graph and one small graph per operator family. Each output lies
within ``REL`` x max|JAX's| (at least ``ABS``) of JAX's ``run_graph`` on the
same feeds; the numpy front end equals JAX's bit for bit."""

import numpy as np
import pytest
import torch

from test_onnx_native import (
    _attr_f,
    _attr_s,
    _ld,
    _make_tdnn_onnx,
    _model,
    _node,
    _tensor,
    _vi,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.onnx_graph import load_onnx_graph as j_load_graph
from qwen_tts_tpu.models import campplus as jcam
from qwen_tts_tpu.onnx_exec import run_graph as j_run_graph
from qwen_tts_tpu_torch.io.onnx_graph import load_onnx_graph
from qwen_tts_tpu_torch.models import campplus as tcam
from qwen_tts_tpu_torch.onnx_exec import OnnxModel, run_graph

REL, ABS = 1e-5, 1e-6


def _attr_i(name: str, v: int) -> bytes:
    """An int attribute; a negative one as its 64-bit two's complement."""
    return _ld(5, _ld(1, name.encode()) + _vi(3, v % (1 << 64)))


def _attr_ints(name: str, vals) -> bytes:
    return _ld(5, _ld(1, name.encode()) + b"".join(_vi(8, v % (1 << 64)) for v in vals))


def _attr_t(name: str, arr: np.ndarray) -> bytes:
    return _ld(5, _ld(1, name.encode()) + _ld(5, _tensor("", arr)))


def _write(tmp_path, blob: bytes) -> str:
    p = tmp_path / "g.onnx"
    p.write_bytes(blob)
    return str(p)


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _i64(*v):
    return np.asarray(v, np.int64)


# (nodes, initializers as {name: array}, feeds, outputs) per operator family.
CASES = {
    "conv_same_upper": (
        [_node("Conv", ["x", "w"], ["y"], _attr_s("auto_pad", b"SAME_UPPER"),
               _attr_ints("strides", [2]))],
        {"w": _r(1, 6, 4, 3) / 3}, {"x": _r(2, 1, 4, 19)}, ["y"]),
    "conv2d_pads_groups": (
        [_node("Conv", ["x", "w", "b"], ["y"], _attr_ints("pads", [1, 2, 1, 2]),
               _attr_ints("strides", [2, 1]), _attr_i("group", 2),
               _attr_ints("dilations", [1, 2]))],
        {"w": _r(3, 4, 2, 3, 3) / 5, "b": _r(4, 4)}, {"x": _r(5, 2, 4, 11, 9)}, ["y"]),
    "gemm_matmul": (
        [_node("Gemm", ["x", "w", "c"], ["y"], _attr_i("transB", 1), _attr_f("alpha", 0.5),
               _attr_f("beta", 2.0)),
         _node("Gemm", ["xt", "w2"], ["y2"], _attr_i("transA", 1)),
         _node("MatMul", ["y", "m"], ["y3"])],
        {"w": _r(6, 5, 4), "c": _r(7, 5), "w2": _r(8, 4, 5), "m": _r(9, 5, 2)},
        {"x": _r(10, 3, 4), "xt": _r(11, 4, 3)}, ["y", "y2", "y3"]),
    "pooling": (
        [_node("MaxPool", ["x"], ["a"], _attr_ints("kernel_shape", [3, 3]),
               _attr_ints("strides", [2, 2]), _attr_ints("pads", [1, 1, 1, 1])),
         _node("AveragePool", ["x"], ["b"], _attr_ints("kernel_shape", [3, 3]),
               _attr_ints("strides", [2, 2]), _attr_ints("pads", [1, 1, 1, 1])),
         _node("GlobalAveragePool", ["x"], ["c"])],
        {}, {"x": _r(12, 1, 2, 8, 10)}, ["a", "b", "c"]),
    "split_slice_concat": (
        [_node("Split", ["x"], ["a", "b"], _attr_i("axis", 1), _attr_ints("split", [6, 4])),
         _node("Concat", ["b", "a"], ["y"], _attr_i("axis", 1)),
         _node("Slice", ["x", "st", "en", "ax", "sp"], ["s"]),
         _node("Split", ["x", "sz"], ["c", "d"], _attr_i("axis", -1))],
        {"st": _i64(1), "en": _i64(9), "ax": _i64(1), "sp": _i64(2), "sz": _i64(1, 3)},
        {"x": _r(13, 2, 10, 4)}, ["y", "s", "c", "d"]),
    "activations_and_pads": (
        [_node("PRelu", ["x", "slope"], ["a"]),
         _node("LeakyRelu", ["x"], ["b"], _attr_f("alpha", 0.02)),
         _node("Pad", ["x", "p"], ["c"], _attr_s("mode", b"reflect")),
         _node("Pad", ["x", "p"], ["d"], _attr_s("mode", b"edge")),
         _node("Pad", ["x", "p"], ["e"]),
         _node("Sigmoid", ["x"], ["f"]), _node("Tanh", ["x"], ["g"]),
         _node("Softmax", ["x"], ["h"], _attr_i("axis", 1)), _node("Erf", ["x"], ["k"]),
         _node("Exp", ["x"], ["l"]), _node("Neg", ["x"], ["m"]), _node("Relu", ["x"], ["n"]),
         _node("Clip", ["x", "lo", "hi"], ["o"]), _node("Identity", ["x"], ["q"]),
         _node("Clip", ["x"], ["r"])],
        {"slope": np.asarray([0.1, 0.2, 0.3], np.float32).reshape(3, 1),
         "p": _i64(0, 0, 2, 0, 0, 3), "lo": np.float32([-0.5]).reshape(()),
         "hi": np.float32([0.7]).reshape(())},
        {"x": _r(14, 2, 3, 9)}, list("abcdefghklmnoqr")),
    "arithmetic": (
        [_node("Mul", ["x", "x"], ["x2"]), _node("Sqrt", ["x2"], ["a"]),
         _node("Add", ["a", "c"], ["b"]), _node("Sub", ["b", "x"], ["d"]),
         _node("Div", ["d", "b"], ["e"]), _node("Pow", ["a", "two"], ["f"]),
         _node("Equal", ["x", "x"], ["eq"]), _node("Where", ["eq", "e", "f"], ["g"])],
        {"c": np.float32([1.5]), "two": np.float32([2.0])}, {"x": _r(15, 3, 4)},
        ["a", "b", "d", "e", "f", "g"]),
    "reduce_axes_inputs": (
        [_node("ReduceMean", ["x", "ax"], ["a"]), _node("ReduceL2", ["x", "ax"], ["b"]),
         _node("ReduceSum", ["x"], ["c"], _attr_ints("axes", [0, 2]), _attr_i("keepdims", 0)),
         _node("ReduceMax", ["x"], ["d"], _attr_ints("axes", [1])),
         _node("ReduceMin", ["x"], ["e"], _attr_ints("axes", [-1]))],
        {"ax": _i64(-1)}, {"x": _r(16, 2, 5, 7)}, list("abcde")),
    "shape_chain": (
        [_node("Shape", ["x"], ["shp"]),
         _node("Gather", ["shp", "i0"], ["n"], _attr_i("axis", 0)),
         _node("Unsqueeze", ["n"], ["n1"], _attr_ints("axes", [0])),
         _node("Concat", ["n1", "m1"], ["shape"], _attr_i("axis", 0)),
         _node("Reshape", ["x", "shape"], ["y"]),
         _node("Transpose", ["y"], ["yt"], _attr_ints("perm", [1, 0])),
         _node("Flatten", ["x"], ["fl"], _attr_i("axis", 2)),
         _node("Unsqueeze", ["y", "ax"], ["u"]), _node("Squeeze", ["u", "ax"], ["sq"]),
         _node("Concat", ["n1", "three"], ["shape2"], _attr_i("axis", 0)),
         _node("Cast", ["shape"], ["shape_f"], _attr_i("to", 1)),
         _node("ConstantOfShape", ["shape2"], ["ones"], _attr_t("value", np.float32([1.0]))),
         _node("ConstantOfShape", ["shape2"], ["zeros"]),
         _node("Constant", [], ["k"], _attr_t("value", np.float32([[2.0]]))),
         _node("Mul", ["ones", "k"], ["twos"]),
         _node("Expand", ["k", "shape2"], ["ex"]),
         _node("Range", ["r0", "r1", "r2"], ["rng"]),
         _node("Gather", ["x", "idx"], ["gx"], _attr_i("axis", 1))],
        {"i0": _i64(0).reshape(()), "m1": _i64(-1), "three": _i64(3), "ax": _i64(0), "r0": _i64(2).reshape(()),
         "r1": _i64(11).reshape(()), "r2": _i64(3).reshape(()), "idx": _i64(2, -1, 0)},
        {"x": _r(17, 2, 3, 4)}, ["shape", "y", "yt", "fl", "sq", "shape_f", "twos", "zeros",
                                 "ex", "rng", "gx"]),
}


def _case_blob(name):
    nodes, inits, feeds, outputs = CASES[name]
    return _model(nodes, [_tensor(k, v) for k, v in inits.items()],
                  list(inits) + list(feeds), outputs), feeds, outputs


def _hold(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.abs(g - w).max() <= max(REL * np.abs(w).max(), ABS)


def test_parser_golden_bytes(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = _write(tmp_path, _model([_node("Identity", ["a"], ["b"])], [_tensor("a", arr)],
                                   ["a"], ["b"]))
    g = load_onnx_graph(path)
    assert [n.op_type for n in g.nodes] == ["Identity"]
    np.testing.assert_array_equal(g.initializers["a"], arr)
    assert g.inputs == [] and g.outputs == ["b"]
    j = j_load_graph(path)
    assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in g.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.attrs) for n in j.nodes]


def test_tdnn_graph_matches_jax(tmp_path):
    blob, x, oracle = _make_tdnn_onnx(np.random.default_rng(0))
    path = _write(tmp_path, blob)
    m = OnnxModel(path, device="cpu")
    assert m.input_names == ["x"]
    (got,) = m.run({"x": x})
    _hold([got], j_run_graph(j_load_graph(path), {"x": x}))
    np.testing.assert_allclose(got, oracle(x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_operators_match_jax(tmp_path, name):
    blob, feeds, outputs = _case_blob(name)
    path = _write(tmp_path, blob)
    got = run_graph(load_onnx_graph(path), feeds, outputs, device="cpu")
    _hold(got, j_run_graph(j_load_graph(path), feeds, outputs))


def test_shape_values_stay_on_the_host(tmp_path):
    """On a device (``meta``: shapes without data) the shape chain runs in
    host integers, and a shape that would come from the device raises."""
    blob, feeds, _ = _case_blob("shape_chain")
    graph = load_onnx_graph(_write(tmp_path, blob))
    (shape,) = run_graph(graph, feeds, ["shape"], device="meta")
    np.testing.assert_array_equal(shape, [2, -1])
    nodes = [_node("ReduceSum", ["x"], ["s"], _attr_ints("axes", [0, 1])),
             _node("Cast", ["s"], ["si"], _attr_i("to", 7)),
             _node("Unsqueeze", ["si"], ["s1"], _attr_ints("axes", [0])),
             _node("Reshape", ["x", "s1"], ["y"])]
    graph = load_onnx_graph(_write(tmp_path, _model(nodes, [], ["x"], ["y"])))
    with pytest.raises(ValueError, match="read back from the device"):
        run_graph(graph, {"x": np.ones((2, 3), np.float32)}, device="meta")


def test_unknown_operator_raises(tmp_path):
    graph = load_onnx_graph(_write(tmp_path, _model([_node("Einsum", ["x"], ["y"])], [],
                                                    ["x"], ["y"])))
    with pytest.raises(NotImplementedError, match="Einsum"):
        run_graph(graph, {"x": np.ones(3, np.float32)}, device="cpu")


def test_front_end_equals_jax():
    np.testing.assert_array_equal(tcam.kaldi_mel_banks(), jcam.kaldi_mel_banks())
    wav = (0.3 * np.random.default_rng(42).standard_normal(5000)).astype(np.float32)
    np.testing.assert_array_equal(tcam.kaldi_fbank(wav), jcam.kaldi_fbank(wav))
    np.testing.assert_array_equal(tcam.sox_norm(wav), jcam.sox_norm(wav))
    assert tcam.kaldi_fbank(wav[:300]).shape == (0, 80)


def test_campplus_xvector_matches_jax(tmp_path):
    assert tcam.CampplusXVector.maybe_from_dir(str(tmp_path), device="cpu") is None
    rng = np.random.default_rng(1)
    blob, _, _ = _make_tdnn_onnx(rng)
    (tmp_path / "campplus.onnx").write_bytes(blob)
    got_x = tcam.CampplusXVector.maybe_from_dir(str(tmp_path), device="cpu")
    want_x = jcam.CampplusXVector.maybe_from_dir(str(tmp_path))
    assert got_x.model.device == torch.device("cpu")
    for n in (16000, 7100):
        wav = (0.3 * rng.standard_normal(n)).astype(np.float32)
        got, want = got_x.extract(wav), want_x.extract(wav)
        assert got.shape == (8,) and abs(np.linalg.norm(got) - 1.0) < 1e-5
        np.testing.assert_allclose(got, want, atol=1e-5)
    (tmp_path / "bad" / "campplus.onnx").parent.mkdir()
    (tmp_path / "bad" / "campplus.onnx").write_bytes(b"\x07\x00")
    with pytest.raises(ValueError, match="ONNX"):
        tcam.CampplusXVector.maybe_from_dir(str(tmp_path / "bad"), device="cpu")
