"""The port's checkpoint reader and loader against the JAX package's loader
on the tiny fixture checkpoint, leaf by leaf; and the weight carry-across
(``convert.py``) against the port's own loader."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu_torch.convert import convert_params
from qwen_tts_tpu_torch.io.loader import load_checkpoint as t_load
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors, save_file


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_loader_ckpt"))
    make_checkpoint(d)
    return d


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _bits(x) -> np.ndarray:
    """Exact comparison key: f32 as is, bf16 as its raw 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(torch_tree, jax_tree):
    t_leaves = list(_leaves(torch_tree))
    j_leaves = list(_leaves(jax_tree))
    assert [k for k, _ in t_leaves] == [k for k, _ in j_leaves]
    for (name, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), name
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)


@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)])
def test_loader_matches_jax_leaf_by_leaf(ckpt, dtypes):
    t_dtype, j_dtype = dtypes
    _, jt, js, jc, _ = j_load(ckpt, talker_dtype=j_dtype)
    cfg, tt, ts, tc, _ = t_load(ckpt, talker_dtype=t_dtype, device="cpu")
    assert cfg.talker.num_code_groups == 8
    for torch_tree, jax_tree in ((tt, jt), (ts, js), (tc, jc)):
        _assert_trees_equal(torch_tree, jax_tree)
    assert tt["norm"].dtype == t_dtype and tc["codebooks"].dtype == torch.float32


def test_convert_agrees_with_loader(ckpt):
    _, jt, js, jc, _ = j_load(ckpt, talker_dtype=jnp.bfloat16)
    ct, cs, cc = convert_params(
        *(_unflatten(tree) for tree in (jt, js, jc)), device="cpu")
    _, tt, ts, tc, _ = t_load(ckpt, device="cpu")
    for converted, loaded in ((ct, tt), (cs, ts), (cc, tc)):
        _assert_trees_equal(converted, loaded)


def _unflatten(tree):
    """The JAX tree with numpy leaves, as a caller hands it to convert."""
    if isinstance(tree, dict):
        return {k: _unflatten(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v) for v in tree]
    return np.asarray(tree)


def test_safetensors_round_trip_and_bf16(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a": torch.randn(3, 5, generator=g),
        "b": torch.randn(4, 2, generator=g).bfloat16(),
        "c": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "d": torch.zeros(0, 4),
    }
    save_file(tensors, str(tmp_path / "x.safetensors"))
    st = MultiSafeTensors(str(tmp_path))
    try:
        for name, want in tensors.items():
            got = st.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(st.get_f32("b").numpy(), tensors["b"].float().numpy())
    finally:
        st.close()


def test_loader_reads_fixture_like_numpy_reader(ckpt):
    """The torch reader sees the same bytes as the JAX package's numpy reader."""
    from qwen_tts_tpu.io.safetensors import MultiSafeTensors as NpReader

    a, b = MultiSafeTensors(ckpt), NpReader(ckpt)
    try:
        assert sorted(a.keys()) == sorted(b.keys())
        for name in list(a.keys())[:20]:
            np.testing.assert_array_equal(a.get(name).numpy(), b.get(name))
    finally:
        a.close()
        b.close()


def _info_tensors(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        f"f32.{seed}": torch.randn(3, 5, generator=g),
        f"bf16.{seed}": torch.randn(4, 2, 3, generator=g).bfloat16(),
        f"i8.{seed}": torch.randint(-128, 127, (7,), generator=g, dtype=torch.int8),
        f"i32.{seed}": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        f"empty.{seed}": torch.zeros(0, 4),
    }


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_info_reads_dtype_and_shape_from_the_header_as_jax(tmp_path, layout):
    """``info`` of both readers equals the JAX reader's for every key, of one
    file and of a directory of shards with an index; an unknown name raises
    ``KeyError`` as ``get`` does."""
    import json

    from qwen_tts_tpu.io.safetensors import MultiSafeTensors as JMulti
    from qwen_tts_tpu.io.safetensors import SafeTensorsFile as JFile
    from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile

    shards = [_info_tensors(0)] + ([_info_tensors(1)] if layout == "sharded" else [])
    names = [f"model-{i:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    for tensors, name in zip(shards, names):
        save_file(tensors, str(tmp_path / name))
    if layout == "sharded":
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": {k: n for t, n in zip(shards, names) for k in t}}, f)
    want_dtypes = {torch.float32: "F32", torch.bfloat16: "BF16", torch.int8: "I8",
                   torch.int32: "I32"}
    readers = [(MultiSafeTensors(str(tmp_path)), JMulti(str(tmp_path)))] + [
        (SafeTensorsFile(str(tmp_path / n)), JFile(str(tmp_path / n))) for n in names]
    try:
        multi, j_multi = readers[0]
        assert sorted(multi.keys()) == sorted(k for t in shards for k in t)
        for port, jax_reader in readers:
            for key in port.keys():
                info = port.info(key)
                assert info == jax_reader.info(key), key
                t = {k: v for s in shards for k, v in s.items()}[key]
                assert info == (want_dtypes[t.dtype], tuple(t.shape)), key
            with pytest.raises(KeyError):
                port.info("missing")
            with pytest.raises(KeyError):
                port.get("missing")
        with pytest.raises(KeyError):
            j_multi.info("missing")
    finally:
        for port, jax_reader in readers:
            port.close()
            jax_reader.close()
