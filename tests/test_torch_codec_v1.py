"""The port's 25 Hz decoder (``qwen_tts_tpu_torch/models/codec_v1.py``: the
flow-matching DiT and BigVGAN) against the JAX package's, on the CPU in f32.

Both packages read one checkpoint (``make_tame_v1_checkpoint`` at
``TINY_V1``: BigVGAN's convs scaled so that the waveform stays inside the
clamp) and take the same numpy-seeded inputs and initial noise. Every result
must lie within ``REL`` x max|JAX's| of the JAX package's: f32 on both
sides, so only the order of the sums differs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_codec_v1 import TINY_V1
from torch_port_fixtures import make_tame_v1_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.loader_v1 import load_codec_v1 as j_load
from qwen_tts_tpu.models import codec_v1 as jv1
from qwen_tts_tpu.ops.convs import causal_conv1d as j_causal_conv1d
from qwen_tts_tpu_torch.config import CodecV1Config
from qwen_tts_tpu_torch.convert import convert_codec_v1_tree
from qwen_tts_tpu_torch.io.loader_v1 import load_codec_v1 as t_load
from qwen_tts_tpu_torch.models import codec_v1 as tv1
from qwen_tts_tpu_torch.ops.convs import causal_conv1d, causal_conv1d_cf

REL = 1e-4
B, T_CODE, T_REF = 2, 11, 9


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    """(directory, JAX params, port params on the CPU, port config)."""
    d = str(tmp_path_factory.mktemp("v1"))
    make_tame_v1_checkpoint(d, TINY_V1)
    with open(f"{d}/config.json") as f:
        cfg = CodecV1Config.from_dict(json.load(f))
    return d, j_load(d, TINY_V1), t_load(d, cfg, device="cpu"), cfg


def _inputs(seed: int):
    """codes [B, T] (the second row padded with -1), x-vectors, reference
    mels, initial noise."""
    r = np.random.default_rng(seed)
    dit = TINY_V1.dit
    codes = r.integers(0, dit.num_embeds + 1, (B, T_CODE))
    codes[1, 7:] = -1
    xv = r.standard_normal((B, dit.enc_emb_dim)).astype(np.float32)
    mel = (0.3 * r.standard_normal((B, T_REF, dit.mel_dim))).astype(np.float32)
    noise = r.standard_normal((B, T_CODE * dit.repeats, dit.mel_dim)).astype(np.float32)
    return codes, xv, mel, noise


def test_config_reads_the_jax_fixture(v1):
    _, _, _, cfg = v1
    assert cfg.dit.look_ahead_layers == TINY_V1.dit.look_ahead_layers
    assert cfg.bigvgan.resblock_dilation_sizes == TINY_V1.bigvgan.resblock_dilation_sizes
    assert cfg.bigvgan.total_upsample == TINY_V1.bigvgan.total_upsample == 8
    assert cfg.samples_per_code == 16 == cfg.decode_upsample_rate
    assert CodecV1Config().samples_per_code == 480 != CodecV1Config().decode_upsample_rate


def test_loader_tree_equals_the_converted_jax_tree(v1):
    _, jp, tp, _ = v1
    conv = convert_codec_v1_tree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")

    def same(a, b, path="root"):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), path

    same(tp, conv)
    assert tp["bigvgan"]["ups_w"][0].shape == (32, 16, 4)  # ConvTranspose1d [in, out, K]
    assert tp["bigvgan"]["pre_w"].shape == (32, 8, 5)      # Conv1d [out, in, K]


def test_bf16_load_keeps_the_filters_and_the_ecapa_in_f32(v1):
    d, _, _, cfg = v1
    tp = t_load(d, cfg, dtype=torch.bfloat16, device="cpu")
    assert tp["bigvgan"]["pre_w"].dtype == tp["dit"]["in_proj_w"].dtype == torch.bfloat16
    assert tp["bigvgan"]["_filters"]["up"].dtype == torch.float32
    assert tp["dit"]["spk_encoder"]["fc_w"].dtype == torch.float32


def test_rope_tables_and_the_halfsplit_permutation(v1):
    _, jp, tp, _ = v1
    for name in ("_interleaved_rope_tables", "_halfsplit_rope_tables"):
        for got, want in zip(getattr(tv1, name)(13, 8, 10000.0),
                             getattr(jv1, name)(13, 8, 10000.0)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(1).standard_normal((2, 13, 4, 8)).astype(np.float32)
    for rope, tables in (("_apply_rope_interleaved", "_interleaved_rope_tables"),
                         ("_apply_rope_halfsplit", "_halfsplit_rope_tables")):
        tc, ts = getattr(tv1, tables)(13, 8, 10000.0)
        jc, js = getattr(jv1, tables)(13, 8, 10000.0)
        got = getattr(tv1, rope)(_t(x), tc[None, :, None], ts[None, :, None])
        want = getattr(jv1, rope)(jnp.asarray(x), jc[None, :, None], js[None, :, None])
        _close(got.numpy(), want, 1e-6)
    heads, hd = TINY_V1.dit.num_attention_heads, TINY_V1.dit.head_dim
    got = tv1._rope_halfsplit_layer(tp["dit"]["layers"][0], heads, hd)
    want = jv1._rope_halfsplit_layer(jp["dit"]["layers"][0], heads, hd)
    for k in ("wq", "bq", "wk", "bk", "wv"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# (look_back, look_ahead) in blocks: a DiT layer looks one block back or
# ahead, or neither (DiTConfig's look_*_layers never share a layer).
WINDOWS = [(0, 0), (1, 0), (0, 1)]


@pytest.mark.parametrize("impl", tv1.ATTN_IMPLS)
def test_attention_matches_jax_and_the_dense_oracle(v1, impl):
    """Every form at each window and at lengths that do and do not fill the
    last block: equal to the JAX function of its name and to
    the dense masked oracle (interleaved rope, the checkpoint's weights)."""
    _, jp, tp, _ = v1
    dit = TINY_V1.dit
    heads, hd, block = dit.num_attention_heads, dit.head_dim, dit.block_size
    hs = impl in ("local_hs", "local_hs_bo", "chunked_hs")
    r = np.random.default_rng(2)
    for t in (12, 23):
        x = r.standard_normal((2, t, dit.hidden_size)).astype(np.float32)
        tables = "_halfsplit_rope_tables" if hs else "_interleaved_rope_tables"
        tc, ts = getattr(tv1, tables)(t, hd, dit.rope_theta)
        jc, js = getattr(jv1, tables)(t, hd, dit.rope_theta)
        oc, os_ = tv1._interleaved_rope_tables(t, hd, dit.rope_theta)
        t_layer, j_layer = tp["dit"]["layers"][0], jp["dit"]["layers"][0]
        if hs:
            t_layer = tv1._rope_halfsplit_layer(t_layer, heads, hd)
            j_layer = jv1._rope_halfsplit_layer(j_layer, heads, hd)
        for lb, la in WINDOWS:
            if impl.startswith("local"):
                got = tv1._dit_attention_local(t_layer, _t(x), tc, ts, lb, la, block, heads, hd,
                                               halfsplit=hs, batch_order=impl == "local_hs_bo")
                want = jv1._dit_attention_local(j_layer, jnp.asarray(x), jc, js, lb, la, block,
                                                heads, hd, halfsplit=hs,
                                                batch_order=impl == "local_hs_bo")
            else:
                got = tv1._dit_attention_chunked(t_layer, _t(x), tc, ts, lb, la, block, heads,
                                                 hd, halfsplit=hs)
                want = jv1._dit_attention_chunked(j_layer, jnp.asarray(x), jc, js, lb, la,
                                                  block, heads, hd, halfsplit=hs)
            _close(got.numpy(), want)
            oracle = tv1._dit_attention(tp["dit"]["layers"][0], _t(x), oc, os_,
                                        tv1._block_mask(t, block, lb, la), heads, hd)
            _close(got.numpy(), oracle.numpy())


@pytest.mark.parametrize("impl", ["local_hs", "local", "chunked"])
def test_dit_forward_matches_jax(v1, impl):
    _, jp, tp, _ = v1
    dit = TINY_V1.dit
    r = np.random.default_rng(3)
    t = 14
    args = [r.standard_normal((2, t, n)).astype(np.float32)
            for n in (dit.mel_dim, dit.enc_dim, dit.emb_dim, dit.enc_emb_dim)]
    ts = np.asarray([0.1, 0.7], np.float32)
    want = jv1.dit_forward(jp["dit"], dit, *map(jnp.asarray, args), jnp.asarray(ts),
                           attn_impl=impl)
    got = tv1.dit_forward(tp["dit"], dit, *map(_t, args), _t(ts), attn_impl=impl)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("guidance", [0.5, 0.0])
def test_dit_sample_matches_jax_under_shared_noise(v1, guidance):
    """With CFG (a doubled batch) and without it (guidance below 1e-5)."""
    _, jp, tp, _ = v1
    codes, xv, mel, noise = _inputs(4)
    codes = np.maximum(codes, 0)
    want = jv1.dit_sample(jp["dit"], TINY_V1.dit, jnp.asarray(codes), jnp.asarray(mel),
                          jnp.asarray(xv), jax.random.PRNGKey(0), guidance_scale=guidance,
                          noise=jnp.asarray(noise))
    got = tv1.dit_sample(tp["dit"], TINY_V1.dit, _t(codes), _t(mel), _t(xv),
                         guidance_scale=guidance, noise=_t(noise))
    _close(got.numpy(), want)


def test_euler_times_and_initial_noise():
    t = tv1.euler_times(10, -1.0)
    want = np.linspace(0.0, 1.0, 10).astype(np.float32)
    want = want + -1.0 * (np.cos(np.pi / 2 * want) - 1 + want)
    np.testing.assert_allclose(t.numpy(), want, atol=1e-6)
    a = tv1.initial_noise(2, 6, 8, torch.Generator().manual_seed(5))
    b = tv1.initial_noise(2, 6, 8, torch.Generator().manual_seed(5))
    assert a.shape == (2, 6, 8) and a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("aa_impl", tv1.AA_IMPLS)
def test_anti_aliased_snake_matches_jax(v1, aa_impl):
    _, jp, tp, _ = v1
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 19, 6)).astype(np.float32)  # JAX: [B, T, C]
    a = np.exp(0.1 * r.standard_normal(6)).astype(np.float32)
    b = np.exp(0.1 * r.standard_normal(6)).astype(np.float32)
    jf, tf = jp["bigvgan"]["_filters"], tp["bigvgan"]["_filters"]
    want = jv1._anti_aliased_snake(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jf["up"],
                                   jf["down"], aa_impl=aa_impl)
    got = tv1._anti_aliased_snake(_t(x).transpose(1, 2), _t(a), _t(b), tf["up"], tf["down"],
                                  aa_impl=aa_impl)
    _close(got.transpose(1, 2).numpy(), want)
    conv = tv1._anti_aliased_snake(_t(x).transpose(1, 2), _t(a), _t(b), tf["up"], tf["down"])
    _close(got.numpy(), conv.numpy())


def test_filters_and_convs_match_jax(v1):
    _, jp, tp, _ = v1
    np.testing.assert_array_equal(tv1.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jv1.kaiser_sinc_filter1d(0.25, 0.3, 12))
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 9, 32)).astype(np.float32)
    for li, rate in enumerate(TINY_V1.bigvgan.upsample_rates):
        jw, jb = jp["bigvgan"]["ups_w"][li], jp["bigvgan"]["ups_b"][li]
        if jw.shape[1] != x.shape[-1]:
            break
        want = jv1._conv_transpose_same(jnp.asarray(x), jw, jb, rate)
        got = tv1._conv_transpose_same(_t(x).transpose(1, 2), tp["bigvgan"]["ups_w"][li],
                                       tp["bigvgan"]["ups_b"][li], rate)
        assert got.shape[-1] == rate * x.shape[1]
        _close(got.transpose(1, 2).numpy(), want)
        x = np.asarray(want)
    blk_j, blk_t = jp["bigvgan"]["resblocks"][0], tp["bigvgan"]["resblocks"][0]
    h = r.standard_normal((2, 13, blk_j["conv1_w"].shape[-1])).astype(np.float32)
    for dilation in (1, 3):
        want = j_causal_conv1d(jnp.asarray(h), blk_j["conv1_w"][0], blk_j["conv1_b"][0],
                               dilation=dilation)
        got = causal_conv1d_cf(_t(h).transpose(1, 2), blk_t["conv1_w"][0], blk_t["conv1_b"][0],
                               dilation=dilation)
        _close(got.transpose(1, 2).numpy(), want)
        same = causal_conv1d(_t(h), _t(np.asarray(blk_j["conv1_w"][0])), blk_t["conv1_b"][0],
                             dilation=dilation)
        _close(got.transpose(1, 2).numpy(), same.numpy(), 1e-6)


@pytest.mark.parametrize("aa_impl", ["conv", "polyc"])
def test_bigvgan_forward_matches_jax(v1, aa_impl):
    _, jp, tp, _ = v1
    mel = (0.5 * np.random.default_rng(7).standard_normal((2, 10, 8)) - 2).astype(np.float32)
    want = jv1.bigvgan_forward(jp["bigvgan"], TINY_V1.bigvgan, jnp.asarray(mel), aa_impl=aa_impl)
    raw = tv1.bigvgan_forward(tp["bigvgan"], TINY_V1.bigvgan, _t(mel), aa_impl=aa_impl,
                              clamp=False)
    assert raw.shape == (2, 10 * TINY_V1.bigvgan.total_upsample)
    assert (raw.abs() < 1).float().mean() > 0.9  # the comparison is not of the clamp
    _close(raw.clamp(-1, 1).numpy(), want)
    got = tv1.bigvgan_forward(tp["bigvgan"], TINY_V1.bigvgan, _t(mel), aa_impl=aa_impl)
    np.testing.assert_array_equal(got.numpy(), raw.clamp(-1, 1).numpy())


@pytest.mark.parametrize("attn_impl,aa_impl", [("local_hs", "conv"), ("local", "poly"),
                                               ("chunked_hs", "polyc")])
def test_codec_v1_decode_matches_jax(v1, attn_impl, aa_impl):
    """Codes (padding -1 clamped to 0) → waveform, the whole decoder."""
    _, jp, tp, cfg = v1
    codes, xv, mel, noise = _inputs(8)
    want = jv1.codec_v1_decode(jp, TINY_V1, jnp.asarray(codes), jnp.asarray(xv),
                               jnp.asarray(mel), jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                               attn_impl=attn_impl, aa_impl=aa_impl)
    got = tv1.codec_v1_decode(tp, cfg, codes, xv, mel, noise=_t(noise), attn_impl=attn_impl,
                              aa_impl=aa_impl)
    assert got.shape == (B, T_CODE * cfg.samples_per_code)
    assert (np.abs(np.asarray(want)) < 1).mean() > 0.9
    _close(got.numpy(), want)


def test_unknown_impls_raise(v1):
    _, _, tp, cfg = v1
    codes, xv, mel, noise = _inputs(9)
    with pytest.raises(ValueError, match="attn_impl"):
        tv1.codec_v1_decode(tp, cfg, codes, xv, mel, noise=_t(noise), attn_impl="dense")
    with pytest.raises(ValueError, match="aa_impl"):
        tv1.codec_v1_decode(tp, cfg, codes, xv, mel, noise=_t(noise), aa_impl="fir")
    with pytest.raises(ValueError, match="attn_impl"):
        tv1.dit_prepare(tp["dit"], cfg.dit, 4, "chunk")
    with pytest.raises(ValueError, match="aa_impl"):
        tv1.bigvgan_forward(tp["bigvgan"], cfg.bigvgan, torch.zeros(1, 3, 8), aa_impl="Conv")


def test_a_code_above_num_embeds_raises(v1):
    _, _, tp, cfg = v1
    codes, xv, mel, noise = _inputs(10)
    codes[0, 3] = cfg.dit.num_embeds + 1
    with pytest.raises(ValueError, match=f"code {cfg.dit.num_embeds + 1} "):
        tv1.codec_v1_decode(tp, cfg, codes, xv, mel, noise=_t(noise))
    codes[0, 3] = cfg.dit.num_embeds  # the table's last row is a code
    assert tv1.codec_v1_decode(tp, cfg, codes, xv, mel, noise=_t(noise)).shape[0] == B
