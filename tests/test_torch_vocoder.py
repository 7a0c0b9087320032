"""The bf16 codec of the port against the JAX package's, on the CPU.

The SnakeBeta polynomial, one vocoder block's plain version (the CPU side of
the ``vocoder_block`` kernel) against the script's XLA composition and its
Pallas kernel in interpret mode, the loader's bf16 leaves, the whole bf16
``codec_decode`` / ``chunked_decode`` on the tiny fixture, and the rule that
routes blocks to the kernel. Inputs come from a numpy seed; parameters are
carried across from JAX."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread, tame_codec  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu.models import codec as j_codec
from qwen_tts_tpu.ops import snake as j_snake
from qwen_tts_tpu_torch.convert import convert_tree
from qwen_tts_tpu_torch.io.loader import load_checkpoint as t_load
from qwen_tts_tpu_torch.models import codec as t_codec
from qwen_tts_tpu_torch.ops import snake as t_snake
from qwen_tts_tpu_torch.ops.cuda import vocoder_block as vb
from qwen_tts_tpu_torch.ops.cuda.vocoder_block import vocoder_block, vocoder_block_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BF16_ULP = 2 ** -8  # bf16 keeps 8 significant bits


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def _np(t) -> np.ndarray:
    """A torch or JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _jax_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# --------------------------------------------------------------------------
# SnakeBeta in bf16
# --------------------------------------------------------------------------

def test_snake_bf16_matches_jax_polynomial():
    """The same f32 operations in the same order on both sides, each
    rounded, then one cast to bf16: equal results are expected; one bf16 ulp
    is allowed in case a compiler contracts a multiply-add."""
    r = np.random.default_rng(0)
    c = 64
    x = np.concatenate([
        3 * r.standard_normal((200, c)),                                     # activation scale
        r.integers(-400, 400, (200, c)) * np.pi / 2 + 1e-3 * r.standard_normal((200, c)),
        300 * r.standard_normal((200, c)),                                   # large |u|
    ]).astype(np.float32)
    alpha = np.exp(0.5 * r.standard_normal(c)).astype(np.float32)
    beta = np.exp(0.5 * r.standard_normal(c)).astype(np.float32)
    xt, at, bt = _bf16(x), _bf16(alpha), _bf16(beta)
    got = t_snake.snake_beta(xt, at, bt)
    want = j_snake.snake_beta(_jax_bf16(xt), _jax_bf16(at), _jax_bf16(bt))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=0)
    # f32 keeps the exact sin.
    x32 = torch.from_numpy(x[:200])
    np.testing.assert_allclose(
        t_snake.snake_beta(x32, torch.from_numpy(alpha), torch.from_numpy(beta)).numpy(),
        x[:200] + np.sin(x[:200] * alpha) ** 2 / (beta + 1e-9), atol=2e-5, rtol=1e-6)


# --------------------------------------------------------------------------
# One block: plain version against the TPU kernel's script
# --------------------------------------------------------------------------

def _vocoder_script():
    path = os.path.join(REPO, "scripts", "exp_pallas_vocoder.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_vocoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_block(params: dict) -> dict:
    """The script's stacked block parameters in the codec's block layout."""
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    units = [{"alpha1": p["u_a1"][i, 0], "beta1": p["u_b1"][i, 0], "conv1_w": p["u_w1"][i],
              "conv1_b": p["u_c1"][i, 0], "alpha2": p["u_a2"][i, 0], "beta2": p["u_b2"][i, 0],
              "conv2_w": p["u_w2"][i][None], "conv2_b": p["u_c2"][i, 0]} for i in range(3)]
    return {"alpha": p["alpha"], "beta": p["beta"], "tconv_w": p["tconv_w"],
            "tconv_b": p["tconv_b"], "resunits": units}


# Against the XLA composition the rounding points and the convs are the
# same, so only a sum in another order can move a value, by one bf16 ulp of
# the largest output. The Pallas kernel adds the transposed conv's two taps
# as two dots, so a few intermediates land one ulp apart and carry through
# the residual units (its own script measures ~1e-2 against XLA).
XLA_RTOL = BF16_ULP
PALLAS_RTOL = 2 ** -6


@pytest.mark.parametrize("c_in,c_out,rate", [(64, 32, 4), (32, 16, 3)])
def test_vocoder_block_plain_matches_xla_and_pallas(c_in, c_out, rate):
    mod = _vocoder_script()
    t_tile, halo, dils = 48, 32, (1, 3, 9)
    params = mod.make_params(jax.random.PRNGKey(rate), c_in, c_out, rate)
    block = _port_block(params)
    r = np.random.default_rng(rate)
    # Two of the Pallas kernel's tiles, then a ragged length (XLA only: the
    # Pallas wrapper takes whole tiles).
    for t_in, with_pallas in ((t_tile // rate * 2, True), (29, False)):
        x = _bf16(0.5 * r.standard_normal((2, t_in, c_in)))
        before = vocoder_block.launches
        got = _np(vocoder_block(x, block, rate))  # CPU tensor: the plain version
        assert vocoder_block.launches == before
        assert got.shape == (2, t_in * rate, c_out)
        xj = _jax_bf16(x)
        want = _np(mod.xla_block(xj, params, s=rate, dils=dils))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=XLA_RTOL * scale, rtol=0)
        if with_pallas:
            fused = _np(mod.fused_block(xj, params, s=rate, dils=dils, t_tile=t_tile,
                                        halo=halo, interpret=True))
            np.testing.assert_allclose(got, fused, atol=PALLAS_RTOL * scale, rtol=0)


# --------------------------------------------------------------------------
# The bf16 codec on the tiny fixture
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_vocoder_ckpt"))
    make_checkpoint(d)
    cfg, _, _, jc, _ = j_load(d, talker_dtype=jnp.float32, codec_dtype=jnp.bfloat16)
    _, _, _, tc, _ = t_load(d, talker_dtype=torch.float32, codec_dtype=torch.bfloat16,
                         device="cpu")
    return d, cfg.codec.decoder, jc, tc


def test_loader_bf16_codec_leaves_equal_jax(codecs):
    """``load_codec`` in bf16: the same leaves, bit for bit (snake
    parameters exponentiated in f32 then cast; flipped transposed-conv taps)."""
    _, _, jc, tc = codecs
    want = convert_tree(jax.tree_util.tree_map(np.asarray, jc), CPU, torch.bfloat16)
    flat_t, tree_t = jax.tree_util.tree_flatten(tc)
    flat_j, tree_j = jax.tree_util.tree_flatten(want)
    assert tree_t == tree_j
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


def test_loaded_bf16_blocks_are_the_kernels_operands(codecs):
    """The kernel reads a loaded bf16 block where it lies: its operands are
    the block's own tensors, in the dtypes, shapes and layout the wrapper's
    checks ask for; an f32 vector is refused."""
    _, dec, _, tc = codecs
    for block, rate in zip(tc["blocks"], dec.upsample_rates):
        weights, vectors = vb.pack_vocoder_block(block)
        assert weights[0] is block["tconv_w"] and vectors[0] is block["alpha"]
        assert len(weights) == 7 and len(vectors) == 3 + 6 * 3
        x = torch.zeros(1, 5, block["tconv_w"].shape[1], dtype=torch.bfloat16)
        vb._check(x, weights, vectors, rate, vb.DILATIONS)
        with pytest.raises(TypeError):
            vb._check(x, weights, vectors[:-1] + [vectors[-1].float()], rate, vb.DILATIONS)


def _stages(m, params: dict, dec, codes, convs):
    """Run the bf16 codec stage by stage through module ``m`` (the JAX codec
    or the port's), each stage fed by ``feed`` (teacher forcing)."""
    conv, tconv, block = convs
    yield "rvq", lambda h: m.rvq_dequantize(params, codes)
    yield "pre_conv", lambda h: conv(h, params["pre_conv_w"], params["pre_conv_b"])
    yield "transformer", lambda h: m.codec_transformer(params["transformer"], dec, h)
    for i, (st, f) in enumerate(zip(params["upsample"], dec.upsampling_ratios)):
        yield f"upsample{i}", lambda h, st=st, f=f: m._convnext_block(
            st["convnext"], tconv(h, st["tconv_w"], st["tconv_b"], stride=f))
    yield "vocoder_pre", lambda h: conv(h, params["vocoder_pre_w"], params["vocoder_pre_b"])
    for i, (b, rate) in enumerate(zip(params["blocks"], dec.upsample_rates)):
        yield f"block{i}", lambda h, b=b, rate=rate: block(h, b, rate)


def _jax_block(h, b, rate):
    from qwen_tts_tpu.ops.convs import causal_conv_transpose1d

    h = j_snake.snake_beta(h, b["alpha"], b["beta"])
    h = causal_conv_transpose1d(h, b["tconv_w"], b["tconv_b"], stride=rate)
    for unit, d in zip(b["resunits"], (1, 3, 9)):
        h = j_codec._resunit(unit, h, d)
    return h


# Teacher-forced, each stage given the JAX stage's input: the same rounding
# points, f32 sums in another order, so a value may land one bf16 ulp apart
# (two allowed, of the stage's largest value).
STAGE_RTOL = 2 * BF16_ULP
# Free-running, a one-ulp difference early grows through the random-weight
# decoder's ~20 convs and snakes (the fixture's JAX bf16 decode itself lies
# ~0.075 from its f32 decode, relative L2; the port's bf16 decode ~0.06 from
# JAX's): the whole waveform is held to a relative L2 distance.
CODEC_REL_L2 = 0.15


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_codec_stages_match_jax(codecs):
    from qwen_tts_tpu.ops import convs as jc_convs
    from qwen_tts_tpu_torch.ops import convs as tc_convs

    _, dec, jc, _ = codecs
    jc = tame_codec(jc)
    tc = convert_tree(jax.tree_util.tree_map(np.asarray, jc), CPU, torch.bfloat16)
    codes = np.random.default_rng(3).integers(0, dec.codebook_size, (2, 12, dec.num_quantizers))
    j_stages = _stages(j_codec, jc, dec, jnp.asarray(codes),
                       (jc_convs.causal_conv1d, jc_convs.causal_conv_transpose1d, _jax_block))
    t_stages = _stages(t_codec, tc, dec, torch.from_numpy(codes),
                       (tc_convs.causal_conv1d, tc_convs.causal_conv_transpose1d, vocoder_block))
    jh = None
    for (name, jf), (_, tf) in zip(j_stages, t_stages):
        th = None if jh is None else _bf16(_np(jh))
        got, jh = tf(th), jf(jh)
        assert got.dtype == torch.bfloat16, name
        want = _np(jh)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=STAGE_RTOL * np.abs(want).max(), err_msg=name)


def test_bf16_codec_decode_and_chunks_match_jax(codecs):
    _, dec, jc, _ = codecs
    jc = tame_codec(jc)
    tc = convert_tree(jax.tree_util.tree_map(np.asarray, jc), CPU, torch.bfloat16)
    codes = np.random.default_rng(3).integers(0, dec.codebook_size, (2, 12, dec.num_quantizers))
    jw = np.asarray(j_codec.codec_decode(jc, dec, jnp.asarray(codes)))
    tw = t_codec.codec_decode(tc, dec, torch.from_numpy(codes))
    assert tw.dtype == torch.float32 and tw.shape == jw.shape == (2, 12 * dec.total_upsample)
    assert np.isfinite(tw.numpy()).all() and np.abs(tw.numpy()).max() <= 1
    assert _rel_l2(tw.numpy(), jw) < CODEC_REL_L2
    assert 0.05 < np.mean(np.abs(jw) < 1)  # not all clamped

    jch = np.asarray(j_codec.chunked_decode(jc, dec, jnp.asarray(codes), chunk_size=5,
                                            left_context_size=3,
                                            decode_fn=jax.jit(j_codec.codec_decode,
                                                              static_argnums=1)))
    tch = t_codec.chunked_decode(tc, dec, torch.from_numpy(codes), chunk_size=5,
                                 left_context_size=3)
    assert tch.shape == jch.shape
    assert _rel_l2(tch.numpy(), jch) < CODEC_REL_L2


def _spy(monkeypatch):
    widths = []

    def spy(x, block, rate, dilations=(1, 3, 9)):
        widths.append(x.shape[-1])
        return vocoder_block_plain(x, block, rate, dilations)

    monkeypatch.setattr(t_codec, "vocoder_block", spy)
    return widths


def test_only_blocks_up_to_384_channels_reach_the_kernel(monkeypatch, tmp_path):
    """At decoder_dim 768 the block inputs are 768, 384, 192 and 96 wide:
    the last three reach ``vocoder_block`` in bf16, none in f32. (Random
    weights written with the smoke script's specs, loaded by the port.)"""
    import chip_smoke
    from qwen_tts_tpu_torch.config import CodecDecoderConfig
    from qwen_tts_tpu_torch.io.loader import load_codec
    from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors, save_file

    dec = CodecDecoderConfig(
        codebook_size=32, codebook_dim=16, hidden_size=32, latent_dim=32,
        num_attention_heads=2, num_key_value_heads=2, sliding_window=8,
        intermediate_size=32, num_hidden_layers=1, num_quantizers=2,
        upsample_rates=(2, 2, 2, 2), upsampling_ratios=(1,), decoder_dim=768)
    cfg = type("Cfg", (), {"codec": type("Codec", (), {"decoder": dec})})()
    gen = torch.Generator().manual_seed(0)
    save_file(chip_smoke.make_tensors(chip_smoke.codec_specs(cfg), torch.float32, gen),
              str(tmp_path / "model.safetensors"))
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (1, 2, 2)))
    for dtype, want in ((torch.bfloat16, [384, 192, 96]), (torch.float32, [])):
        st = MultiSafeTensors(str(tmp_path))
        try:
            params = load_codec(st, dec, dtype, CPU)
        finally:
            st.close()
        widths = _spy(monkeypatch)
        wav = t_codec.codec_decode(params, dec, codes)
        assert widths == want
        assert wav.shape == (1, 2 * dec.total_upsample) and torch.isfinite(wav).all()
