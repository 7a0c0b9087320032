"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: on a host without a GPU every test skips. On the card:
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import math

import pytest
import torch

import chip_smoke
from qwen_tts_tpu_torch.models.subtalker import quantize_subtalker_tables_int8
from qwen_tts_tpu_torch.models.trunk import quantize_trunk_int8
from qwen_tts_tpu_torch.ops.attention import quantize_kv
from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
    NO_WINDOW,
    _kernel_fn,
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_plain,
    decode_attention_plain,
)
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
    KERNEL_DIMS,
    pack_subtalker_weights,
    subtalker_step,
    subtalker_step_plain,
)
from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
    vocoder_block,
    vocoder_block_plain,
)
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin

pytestmark = pytest.mark.cuda

# f32: summation order only. bf16: the output rounds to bf16 (8 bits of
# mantissa) on values of magnitude ~1, so a couple of ulps.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Decode attention over long caches averages many rows (|out| ~ 0.04), so
# bf16 is also held within one bf16 ulp of the largest reference value.
LONG_REL = 2 ** -7


def _assert_long_close(got, want, dtype, s_max):
    if dtype == torch.bfloat16 and s_max >= 1000:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= LONG_REL * want.float().abs().max().item(), err


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (heads, kv, hd, s_max): the path's talker and sub-talker caches, other
# group counts, and long talker caches (S_max 2080 = a 32-slot prefill bucket
# + 2048 new tokens) split over up to 16 blocks per (row, KV head).
ATTENTION_SHAPES = [(16, 2, 64, 97), (16, 8, 128, 16), (8, 8, 64, 40), (16, 1, 128, 33),
                    (16, 2, 64, 2080), (16, 8, 128, 2080), (16, 1, 128, 1000)]


def _rows(s_max, device):
    """cur_len / valid_from of 4 rows: the whole cache, one position, half the
    cache from a ragged start, and an empty row (uniform over S_max)."""
    cur_len = torch.tensor([s_max, 1, s_max // 2, 3], dtype=torch.int32, device=device)
    valid_from = torch.tensor([0, 0, 2, 3], dtype=torch.int32, device=device)
    return cur_len, valid_from


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 9, 700])
@pytest.mark.parametrize("heads,kv,hd,s_max", ATTENTION_SHAPES)
def test_decode_attention_kernel_matches_plain(device, heads, kv, hd, s_max, window, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    b = 4
    q = torch.randn(b, heads, hd, generator=g, device=device).to(dtype)
    k = torch.randn(b, s_max, kv, hd, generator=g, device=device).to(dtype)
    v = torch.randn(b, s_max, kv, hd, generator=g, device=device).to(dtype)
    cur_len, valid_from = _rows(s_max, device)
    before = decode_attention.launches
    got = decode_attention(q, k, v, cur_len, valid_from, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, cur_len, valid_from, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    _assert_long_close(got, want, dtype, s_max)


def test_decode_attention_rejects_what_it_does_not_take(device):
    q = torch.zeros(1, 16, 96, device=device)
    k = torch.zeros(1, 8, 2, 96, device=device)
    lens = torch.ones(1, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, lens, lens * 0)
    with pytest.raises(TypeError):
        decode_attention(q[..., :64].half().contiguous(), k[..., :64].half().contiguous(),
                         k[..., :64].half().contiguous(), lens, lens * 0)
    shifted = torch.zeros(1 + 8 * 2 * 64, device=device)[1:].view(1, 8, 2, 64)  # 4 B off
    with pytest.raises(ValueError):
        decode_attention(q[..., :64].contiguous(), shifted, shifted, lens, lens * 0)
    q_shifted = torch.zeros(1 + 16 * 64, device=device)[1:].view(1, 16, 64)  # contiguous, 4 B off
    with pytest.raises(ValueError):
        decode_attention(q_shifted, k[..., :64].contiguous(), k[..., :64].contiguous(), lens,
                         lens * 0)
    # The C entry itself takes only powers of two up to 16 for n_split: the
    # merge's shuffle tree would mix the queries' lanes at 3.
    q64, k64, zero = q[..., :64].contiguous(), k[..., :64].contiguous(), lens * 0
    out = torch.empty_like(q64)
    for n_split, want in ((3, 1), (6, 1), (32, 1), (2, 0)):  # 1 = cudaErrorInvalidValue
        err = _kernel_fn("qtts_decode_attention", 6)(
            q64.data_ptr(), k64.data_ptr(), k64.data_ptr(), lens.data_ptr(), zero.data_ptr(),
            out.data_ptr(), 0, 1, 16, 2, 64, 8, NO_WINDOW, n_split, 0.125,
            torch.cuda.current_stream().cuda_stream)
        assert err == want, (n_split, err)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 9, 700])
@pytest.mark.parametrize("heads,kv,hd,s_max", ATTENTION_SHAPES)
def test_decode_attention_int8_kernel_matches_plain(device, heads, kv, hd, s_max, window,
                                                    dtype):
    g = torch.Generator(device=device).manual_seed(1)
    b = 4
    q = torch.randn(b, heads, hd, generator=g, device=device).to(dtype)
    k_cache, v_cache = _int8_pair(g, b, s_max, kv, hd, device)
    cur_len, valid_from = _rows(s_max, device)
    before = (decode_attention.launches, decode_attention_int8.launches)
    got = decode_attention(q, k_cache, v_cache, cur_len, valid_from, window)  # dict: int8 kernel
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention_int8.launches) == (
        before[0], before[1] + 1)
    want = decode_attention_int8_plain(q, k_cache, v_cache, cur_len, valid_from, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    _assert_long_close(got, want, dtype, s_max)


def _int8_pair(g, b, s_max, kv, hd, device):
    return tuple({"i8": i8, "s": s} for i8, s in (
        quantize_kv(torch.randn(b, s_max, kv, hd, generator=g, device=device) * 3)
        for _ in range(2)))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("batch", [4, 32])
def test_decode_attention_two_launches_give_the_same_bits(device, batch, int8):
    """The splits merge in rank order inside the launch: no atomics, so the
    bits cannot depend on which block finishes first."""
    g = torch.Generator(device=device).manual_seed(2)
    s_max, kv, hd = 2080, 2, 64
    q = torch.randn(batch, 16, hd, generator=g, device=device).bfloat16()
    if int8:
        k, v = _int8_pair(g, batch, s_max, kv, hd, device)
    else:
        k, v = (torch.randn(batch, s_max, kv, hd, generator=g, device=device).bfloat16()
                for _ in range(2))
    cur_len = torch.tensor([s_max - 61 * i for i in range(batch)], dtype=torch.int32,
                           device=device)
    valid_from = torch.tensor([(7 * i) % 32 for i in range(batch)], dtype=torch.int32,
                              device=device)
    first = decode_attention(q, k, v, cur_len, valid_from)
    second = decode_attention(q, k, v, cur_len, valid_from)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_decode_attention_int8_rejects_what_it_does_not_take(device):
    q = torch.zeros(1, 16, 64, device=device)
    lens = torch.ones(1, dtype=torch.int32, device=device)
    i8 = torch.zeros(1, 8, 2, 64, dtype=torch.int8, device=device)
    s = torch.ones(1, 8, 2, device=device)
    with pytest.raises(TypeError):  # bf16 scales
        decode_attention_int8(q, {"i8": i8, "s": s.bfloat16()}, {"i8": i8, "s": s}, lens, lens * 0)
    with pytest.raises(ValueError):  # scales of the wrong shape
        decode_attention_int8(q, {"i8": i8, "s": s[:, :4]}, {"i8": i8, "s": s}, lens, lens * 0)
    with pytest.raises(ValueError):  # head dim 96
        i8_96 = torch.zeros(1, 8, 2, 96, dtype=torch.int8, device=device)
        decode_attention_int8(torch.zeros(1, 16, 96, device=device), {"i8": i8_96, "s": s},
                              {"i8": i8_96, "s": s}, lens, lens * 0)
    q_shifted = torch.zeros(1 + 16 * 64, device=device)[1:].view(1, 16, 64)  # 4 B off
    with pytest.raises(ValueError):
        decode_attention_int8(q_shifted, {"i8": i8, "s": s}, {"i8": i8, "s": s}, lens, lens * 0)


def _random_packed(device, dtype, seed):
    """A random int8 trunk at the kernel's dims, packed."""
    trunk = _random_trunk(device, seed)
    return pack_subtalker_weights(quantize_trunk_int8({k: v.to(dtype) for k, v in trunk.items()}))


def _random_trunk(device, seed):
    """A random f32 trunk at the kernel's dims."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_layers, d, h, kv, hd, inter = KERNEL_DIMS

    def w(*shape):
        return torch.randn(*shape, generator=g, device=device) / math.sqrt(shape[-2])

    def norm(*shape):
        return 1 + 0.1 * torch.randn(*shape, generator=g, device=device)

    trunk = {"wq": w(n_layers, d, h * hd), "wk": w(n_layers, d, kv * hd),
             "wv": w(n_layers, d, kv * hd), "wo": w(n_layers, h * hd, d),
             "gate": w(n_layers, d, inter), "up": w(n_layers, d, inter),
             "down": w(n_layers, inter, d), "input_norm": norm(n_layers, d),
             "post_attn_norm": norm(n_layers, d), "q_norm": norm(n_layers, hd),
             "k_norm": norm(n_layers, hd)}
    return trunk


# Relative to the largest reference value. f32: summation order only,
# through 5 layers. bf16: both sides round at the same points, but a sum in
# another order moves a value by a bf16 ulp (2^-8), and that carries through
# the later layers and the cache rows each side attends over.
STEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4, 32])
def test_subtalker_step_kernel_matches_plain(device, batch, dtype):
    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    groups, eps = 16, 1e-6
    packed = _random_packed(device, dtype, seed=batch)
    g = torch.Generator(device=device).manual_seed(100 + batch)
    shape = (n_layers, batch, groups, kv, hd)
    kc, vc = (torch.zeros(shape, dtype=dtype, device=device) for _ in range(2))
    kc_p, vc_p = kc.clone(), vc.clone()
    cos, sin = rope_cos_sin(torch.arange(groups, device=device), hd, 10000.0)
    before = subtalker_step.launches
    for pos in range(groups):
        x = torch.randn(batch, d, generator=g, device=device).to(dtype)
        got, kc_out, _ = subtalker_step(packed, x, cos[pos], sin[pos], kc, vc, pos, eps)
        torch.cuda.synchronize()
        assert kc_out is kc and got.dtype == dtype and got.shape == (batch, d)
        want, _, _ = subtalker_step_plain(packed, x, cos[pos], sin[pos], kc_p, vc_p, pos, eps)
        for a, ref in ((got, want), (kc[:, :, pos], kc_p[:, :, pos]),
                       (vc[:, :, pos], vc_p[:, :, pos])):
            torch.testing.assert_close(a.float(), ref.float(), rtol=0,
                                       atol=STEP_TOL[dtype] * ref.float().abs().max().item())
    assert subtalker_step.launches == before + groups
    assert not kc[:, :, groups:].any()  # nothing past the rows it was asked to write


def test_subtalker_step_rejects_what_it_does_not_take(device):
    packed = _random_packed(device, torch.bfloat16, seed=0)
    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    cos, sin = rope_cos_sin(torch.arange(4, device=device), hd, 10000.0)

    def call(x, kc, pos=0, pk=packed):
        return subtalker_step(pk, x, cos[0], sin[0], kc, kc.clone(), pos, 1e-6)

    x = torch.zeros(2, d, dtype=torch.bfloat16, device=device)
    kc = torch.zeros(n_layers, 2, 4, kv, hd, dtype=torch.bfloat16, device=device)
    with pytest.raises(TypeError):  # float16 activations
        call(x.half(), kc.half())
    with pytest.raises(TypeError):  # cache dtype other than x's
        call(x, kc.float())
    with pytest.raises(ValueError):  # position past the cache
        call(x, kc, pos=4)
    with pytest.raises(ValueError):  # more rows than the kernel takes
        call(torch.zeros(33, d, dtype=torch.bfloat16, device=device),
             torch.zeros(n_layers, 33, 4, kv, hd, dtype=torch.bfloat16, device=device))
    with pytest.raises(ValueError):  # other dims than the kernel is built for
        small = {k: v[:2] for k, v in packed.items()}
        call(x, kc[:2], pk=small)
    before = subtalker_step.launches
    with pytest.raises(ValueError):  # a dict that pack_subtalker_weights did not make
        call(x, kc, pk=dict(packed))
    with pytest.raises(ValueError):  # a pack of 2 layers
        two = {k: v[:2].bfloat16() for k, v in _random_trunk(device, 0).items()}
        call(x, kc, pk=pack_subtalker_weights(quantize_trunk_int8(two)))
    assert subtalker_step.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subtalker_step_two_launches_give_the_same_bits(device, dtype):
    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    packed = _random_packed(device, dtype, seed=7)
    g = torch.Generator(device=device).manual_seed(8)
    kc, vc = (torch.randn(n_layers, 4, 16, kv, hd, generator=g, device=device).to(dtype)
              for _ in range(2))
    x = torch.randn(4, d, generator=g, device=device).to(dtype)
    cos, sin = rope_cos_sin(torch.arange(16, device=device), hd, 10000.0)
    runs = [subtalker_step(packed, x, cos[9], sin[9], kc.clone(), vc.clone(), 9, 1e-6)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_quantizers_give_the_cpu_bits_on_the_card(device):
    """The int8 values and scales made on the card equal those made on the
    CPU (which equal the JAX package's): a division by a Python scalar would
    be a reciprocal multiply on the card, an ulp off at times."""
    g = torch.Generator().manual_seed(5)
    w = {"wq": torch.randn(2, 256, 512, generator=g) * 0.05,
         "embeds": torch.randn(3, 300, 256, generator=g),
         "lm_heads": torch.randn(3, 256, 300, generator=g)}
    kv = torch.randn(2, 7, 4, 64, generator=g) * 3
    for quantize, tree in ((quantize_trunk_int8, {"wq": w["wq"]}),
                           (quantize_subtalker_tables_int8,
                            {"embeds": w["embeds"], "lm_heads": w["lm_heads"]})):
        cpu = quantize(tree)
        card = quantize({k: v.to(device) for k, v in tree.items()})
        for k in cpu:
            assert torch.equal(card[k].cpu(), cpu[k]), k
    for a, b in zip(quantize_kv(kv.to(device)), quantize_kv(kv)):
        assert torch.equal(a.cpu(), b)


def random_vocoder_block(device, c_in, c_out, rate, seed, taps=7):
    """A random bf16 codec block on the card, as the smoke script makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    return chip_smoke.random_vocoder_block(g, c_in, c_out, rate, taps)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("t_in", [7, 45, 130])  # < one tile, ragged, several tiles
@pytest.mark.parametrize("taps", [7, 3])  # the codec's units; the TPU kernel's
@pytest.mark.parametrize("c_in,c_out,rate", [(384, 192, 4), (192, 96, 3), (64, 32, 4),
                                             (32, 16, 3)])
def test_vocoder_block_kernel_matches_plain(device, c_in, c_out, rate, taps, t_in, batch):
    block = random_vocoder_block(device, c_in, c_out, rate, seed=c_in + t_in, taps=taps)
    g = torch.Generator(device=device).manual_seed(batch)
    x = (0.5 * torch.randn(batch, t_in, c_in, generator=g, device=device)).bfloat16()
    before = vocoder_block.launches
    got = vocoder_block(x, block, rate)
    torch.cuda.synchronize()
    assert vocoder_block.launches == before + 1
    want = vocoder_block_plain(x, block, rate)
    assert got.shape == want.shape == (batch, t_in * rate, c_out) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=chip_smoke.VOCODER_TOL * want.float().abs().max().item())


def test_vocoder_block_rejects_what_it_does_not_take(device):
    block = random_vocoder_block(device, 64, 32, 4, seed=0)
    x = torch.zeros(1, 10, 64, dtype=torch.bfloat16, device=device)
    with pytest.raises(TypeError):  # f32 activations
        vocoder_block(x.float(), block, 4)
    with pytest.raises(ValueError):  # a wider input than the kernel takes
        wide = random_vocoder_block(device, 768, 384, 4, seed=1)
        vocoder_block(torch.zeros(1, 10, 768, dtype=torch.bfloat16, device=device), wide, 4)
    with pytest.raises(ValueError):  # not contiguous
        vocoder_block(torch.zeros(1, 64, 10, dtype=torch.bfloat16, device=device).transpose(1, 2),
                      block, 4)
    with pytest.raises(ValueError):  # K != 2 * rate
        vocoder_block(x, block, 3)
    before = vocoder_block.launches
    with pytest.raises(TypeError):  # f32 weights
        vocoder_block(x, {**block, "tconv_w": block["tconv_w"].float()}, 4)
    assert vocoder_block.launches == before


# The whole bf16 decode, relative L2 over the waveform: the kernel and the
# plain version differ by an ulp here and there (VOCODER_TOL), carried
# through the later blocks and the final conv. Measured 0.00184 on an NVIDIA
# H100 80GB HBM3 (700 W) with every sample unclipped; the limit sits a few
# times above that, low enough to catch a dropped bias or an extra rounding.
CODEC_REL_L2 = 0.01


def test_bf16_codec_decode_on_the_card_matches_the_plain_route(device, monkeypatch):
    """A bf16 codec at small widths on the card: the kernel route against the
    same decode with every block through ``vocoder_block_plain``."""
    import dataclasses
    import tempfile

    from torch_port_fixtures import tame_codec
    from qwen_tts_tpu_torch.config import CodecDecoderConfig
    from qwen_tts_tpu_torch.io.loader import load_codec
    from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors, save_file
    from qwen_tts_tpu_torch.models import codec as codec_mod

    dec = dataclasses.replace(
        CodecDecoderConfig(), codebook_size=64, codebook_dim=32, hidden_size=64, latent_dim=64,
        num_attention_heads=4, num_key_value_heads=4, intermediate_size=128,
        num_hidden_layers=2, num_quantizers=4, decoder_dim=256)
    cfg = type("Cfg", (), {"codec": type("C", (), {"decoder": dec})})()
    gen = torch.Generator(device=device).manual_seed(7)
    with tempfile.TemporaryDirectory() as d:
        save_file(chip_smoke.make_tensors(chip_smoke.codec_specs(cfg), torch.float32, gen),
                  d + "/model.safetensors")
        st = MultiSafeTensors(d)
        try:
            params = tame_codec(load_codec(st, dec, torch.bfloat16, device))
        finally:
            st.close()
    codes = torch.randint(0, dec.codebook_size, (2, 6, dec.num_quantizers), generator=gen,
                          device=device)
    before = vocoder_block.launches
    got = codec_mod.codec_decode(params, dec, codes)
    torch.cuda.synchronize()
    # decoder_dim 256: block inputs 256, 128, 64, 32, all <= 384.
    assert vocoder_block.launches == before + 4
    monkeypatch.setattr(codec_mod, "vocoder_block", vocoder_block_plain)
    want = codec_mod.codec_decode(params, dec, codes)
    assert got.shape == want.shape == (2, 6 * dec.total_upsample)
    assert torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"bf16 codec on the card, kernel vs plain route: relative L2 {rel:.3g}, "
          f"unclipped share {(want.abs() < 1).float().mean().item():.3f}")
    assert rel < CODEC_REL_L2
