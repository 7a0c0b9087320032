"""The port's 25 Hz random initialisers (``qwen_tts_tpu_torch/models/
codec_v1.py``: ``init_dit_params``, ``init_bigvgan_params``,
``init_codec_v1_params``; ``models/whisper_vq.py``: ``init_whisper_vq``)
against the JAX package's, on the CPU.

The trees have the keys, shapes and dtypes that ``convert_codec_v1_tree`` /
``convert_whisper_vq_tree`` make of the JAX initialisers' trees: at a narrow
config (``NARROW_V1`` / ``NARROW_VQ``) on real draws, and at the default
widths with nothing drawn (JAX through ``jax.eval_shape``, the port on the
``meta`` device, the conversion's tensors made on ``meta`` too). The draws
cannot match (the RNGs differ), so the distributions are held: each weight of
at least ``STD_MIN_ELEMENTS`` elements has a std within ``STD_REL`` of
1/sqrt(fan_in); constant leaves (biases, LayerNorm, SnakeBeta) and the
computed ones (the sinusoid positions, the anti-aliasing filters) equal JAX's
bit for bit.

Alone ~27 s on the CPU, most of it JAX compiling its initialisers; ~36 s
of worker time inside the tier-1 run (6 xdist workers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_codec_v1 import TINY_BIGVGAN, TINY_DIT
from test_whisper_vq import TINY as TINY_VQ
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.config import CodecV1Config as JCodecV1Config
from qwen_tts_tpu.models import codec_v1 as jv1
from qwen_tts_tpu.models import whisper_vq as jwvq
from qwen_tts_tpu_torch import convert
from qwen_tts_tpu_torch.config import BigVGANConfig, CodecV1Config, DiTConfig
from qwen_tts_tpu_torch.models import codec_v1 as tv1
from qwen_tts_tpu_torch.models import whisper_vq as twvq

# Wide enough that most weights have >= STD_MIN_ELEMENTS elements.
NARROW_DIT = dataclasses.replace(TINY_DIT, hidden_size=64, head_dim=16, emb_dim=64)
NARROW_BIGVGAN = dataclasses.replace(TINY_BIGVGAN, upsample_initial_channel=128,
                                     resblock_kernel_sizes=(3, 5),
                                     resblock_dilation_sizes=((1, 3), (1, 3)))
NARROW_V1 = JCodecV1Config(dit=NARROW_DIT, bigvgan=NARROW_BIGVGAN, decode_upsample_rate=16)
NARROW_VQ = dataclasses.replace(TINY_VQ, n_state=64, audio_vq_codebook_size=128,
                                audio_vq_codebook_dim=32)
STD_REL = 0.05
STD_MIN_ELEMENTS = 4096
# Leaves computed, not drawn: bit-equal to JAX's.
COMPUTED = ("positional_embedding", "up", "down")


def _port_v1(cfg) -> CodecV1Config:
    """The port's config of a JAX ``CodecV1Config``."""
    return CodecV1Config(dit=DiTConfig(**dataclasses.asdict(cfg.dit)),
                         bigvgan=BigVGANConfig(**dataclasses.asdict(cfg.bigvgan)),
                         decode_upsample_rate=cfg.decode_upsample_rate)


def _port_vq(cfg) -> twvq.WhisperVQConfig:
    return twvq.WhisperVQConfig(**dataclasses.asdict(cfg))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _specs(tree) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in _flat(tree).items()}


_J_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_codec(cfg, dtype, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jv1.init_codec_v1_params(k, cfg, _J_DTYPES[dtype]))(jax.random.PRNGKey(seed)))


def _jax_vq(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jwvq.init_whisper_vq(k, cfg))(jax.random.PRNGKey(seed)))


def _fan(path: str, shape) -> int:
    """fan_in of a drawn weight in the port's layout: linears ``[in, out]``,
    embeddings and the codebook ``[rows, dim]`` (dim), transposed convs
    ``[C_in, C_out, K]``, convs ``[(n,) C_out, C_in, K]``."""
    name = [p for p in path.split("/") if p and not p.isdigit()][-1]
    if name in ("codec_embed", "vq_embed"):
        return shape[-1]
    if name == "ups_w":
        return shape[0] * shape[2]
    if len(shape) >= 3:
        return shape[-2] * shape[-1]
    return shape[0]


def _hold_distributions(port: dict, want: dict) -> int:
    """Every leaf of ``port`` against the converted JAX tree ``want``:
    computed and constant leaves bit for bit, drawn weights by their std.
    Returns how many weights were held by their std."""
    held = 0
    for path, t in _flat(port).items():
        j = _flat(want)[path].float().numpy()
        got = t.float().numpy()
        if path.split("/")[-1] in COMPUTED or j.std() == 0:
            np.testing.assert_array_equal(got, j, err_msg=path)
            continue
        if t.numel() < STD_MIN_ELEMENTS:
            continue
        std = 1 / np.sqrt(_fan(path, t.shape))
        assert abs(got.std() / std - 1) < STD_REL, (path, got.std(), std)
        assert abs(got.mean()) < 5 * std / np.sqrt(t.numel()), path
        held += 1
    return held


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_v1_tree_is_the_converted_jax_tree(dtype):
    want = convert.convert_codec_v1_tree(_jax_codec(NARROW_V1, dtype), dtype, device="cpu")
    got = tv1.init_codec_v1_params(torch.Generator().manual_seed(1), _port_v1(NARROW_V1), dtype)
    assert _specs(got) == _specs(want)
    assert got["dit"]["spk_encoder"]["fc_w"].dtype == torch.float32  # as the loader keeps it
    assert sum(1 for k in _flat(got["bigvgan"]["resblocks"]) if "pre_conv_w" in k) == 4  # li <= 1
    if dtype == torch.float32:
        assert _hold_distributions(got, want) >= 25


def test_whisper_vq_tree_is_the_converted_jax_tree():
    want = convert.convert_whisper_vq_tree(_jax_vq(NARROW_VQ), device="cpu")
    got = twvq.init_whisper_vq(torch.Generator().manual_seed(1), _port_vq(NARROW_VQ))
    assert _specs(got) == _specs(want)
    assert {"ds_w", "ds_b", "vq_proj_in_w", "vq_proj_in_b"} <= set(got)
    assert _hold_distributions(got, want) >= 10
    # Without the downsampling conv and with the codebook at n_state: neither.
    bare = dataclasses.replace(NARROW_VQ, audio_vq_ds_rate=1, audio_vq_codebook_dim=64)
    got = twvq.init_whisper_vq(torch.Generator().manual_seed(1), _port_vq(bare))
    assert _specs(got) == _specs(convert.convert_whisper_vq_tree(_jax_vq(bare), device="cpu"))
    assert not {"ds_w", "ds_b", "vq_proj_in_w", "vq_proj_in_b"} & set(got)


def _meta_tensor(a, device, dtype):
    """``convert._tensor`` on the ``meta`` device: the shape and the dtype it
    would give, no copy of the data."""
    own = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.from_numpy(
        np.zeros(0, a.dtype)).dtype
    return torch.empty(a.shape, dtype=dtype if dtype is not None else own, device="meta")


def _shapes_only(tree):
    """A ``jax.eval_shape`` tree as numpy arrays of zero strides (no memory)."""
    return jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_widths_without_drawing(monkeypatch, dtype):
    """``CodecV1Config()`` and ``WhisperVQConfig()``: JAX's trees through
    ``jax.eval_shape``, converted onto ``meta``; the port's built on
    ``meta``. No weight is drawn on either side."""
    monkeypatch.setattr(convert, "_tensor", _meta_tensor)
    key = jax.random.PRNGKey(0)
    j_codec = jax.eval_shape(lambda k: jv1.init_codec_v1_params(
        k, JCodecV1Config(), _J_DTYPES[dtype]), key)
    want = convert.convert_codec_v1_tree(_shapes_only(j_codec), dtype, device="meta")
    got = tv1.init_codec_v1_params(torch.Generator().manual_seed(0), CodecV1Config(), dtype,
                                   device="meta")
    assert _specs(got) == _specs(want)
    assert all(t.is_meta for t in _flat(got).values())
    n = sum(t.numel() for t in _flat(got).values())
    assert n > 4e8, n
    j_vq = jax.eval_shape(lambda k: jwvq.init_whisper_vq(k, jwvq.WhisperVQConfig()), key)
    want = convert.convert_whisper_vq_tree(_shapes_only(j_vq), device="meta")
    got = twvq.init_whisper_vq(torch.Generator().manual_seed(0), twvq.WhisperVQConfig(),
                               device="meta")
    assert _specs(got) == _specs(want)


def test_seeds_repeat_and_differ():
    cfg, enc = _port_v1(NARROW_V1), _port_vq(NARROW_VQ)
    for init, c in ((tv1.init_codec_v1_params, cfg), (twvq.init_whisper_vq, enc)):
        a, b, other = (_flat(init(torch.Generator().manual_seed(s), c)) for s in (3, 3, 4))
        assert all(torch.equal(a[k], b[k]) for k in a)
        drawn = [k for k in a if a[k].float().std() > 0 and k.split("/")[-1] not in COMPUTED]
        assert drawn and not any(torch.equal(a[k], other[k]) for k in drawn)


def test_initialised_trees_decode_and_encode_finite():
    """``codec_v1_decode`` and Whisper-VQ's encode (trunk, then
    ``vq_encode``) on the initialised trees at the narrow config."""
    cfg, enc = _port_v1(NARROW_V1), _port_vq(NARROW_VQ)
    g = torch.Generator().manual_seed(5)
    params = tv1.init_codec_v1_params(g, cfg)
    r = np.random.default_rng(5)
    codes = torch.as_tensor(r.integers(0, cfg.dit.num_embeds + 1, (2, 9)))
    xv = torch.as_tensor(r.standard_normal((2, cfg.dit.enc_emb_dim)), dtype=torch.float32)
    mel = torch.as_tensor(0.3 * r.standard_normal((2, 7, cfg.dit.mel_dim)), dtype=torch.float32)
    wav = tv1.codec_v1_decode(params, cfg, codes, xv, mel, torch.Generator().manual_seed(0),
                              num_steps=2)
    assert wav.shape == (2, 9 * cfg.decode_upsample_rate) and torch.isfinite(wav).all()
    vq = twvq.init_whisper_vq(g, enc)
    clip = (0.2 * np.sin(np.linspace(0, 400, 9000))).astype(np.float32)
    feats = twvq.encode_features(vq, enc, [clip])[0]
    codes = twvq.vq_encode(vq, enc, feats)
    assert torch.isfinite(feats).all() and feats.shape[1] == enc.n_state
    assert codes.shape == (feats.shape[0],) and 0 <= int(codes.min())
    assert int(codes.max()) < enc.audio_vq_codebook_size
