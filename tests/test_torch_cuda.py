"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: on a host without a GPU every test skips. On the card:
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import math

import pytest
import torch

import chip_smoke
from qwen_tts_tpu_torch.models.subtalker import quantize_subtalker_tables_int8
from qwen_tts_tpu_torch.models.trunk import quantize_int8, quantize_trunk_int8
from qwen_tts_tpu_torch.ops.attention import quantize_kv
from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
    NO_WINDOW,
    _kernel_fn,
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_plain,
    decode_attention_plain,
)
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import (
    TIMELINE_SLOTS,
    int8_matmul,
    int8_matmul_group,
    int8_matmul_plain,
    launch_blocks,
    timeline_breakdown,
)
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import (
    KERNEL_DIMS,
    pack_subtalker_weights,
    subtalker_step,
    subtalker_step_plain,
)
from qwen_tts_tpu_torch.ops.cuda.vocoder_block import (
    column_splits,
    kernel_plan,
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
# (16, 2, 64, 161): the talker cache of chip_smoke's clone batch (prompt
# bucket 96 + 65 frames, split 4).
ATTENTION_SHAPES = [(16, 2, 64, 97), (16, 8, 128, 16), (8, 8, 64, 40), (16, 1, 128, 33),
                    (16, 2, 64, 161), (16, 2, 64, 2080), (16, 8, 128, 2080),
                    (16, 1, 128, 1000)]


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


@pytest.mark.parametrize("length", ["under", "at", "over", "first_packet"])
@pytest.mark.parametrize("c_in,c_out,rate,first_packet", [(384, 192, 4, 320),
                                                          (192, 96, 3, 1920)])
def test_vocoder_block_column_splits_give_the_bits_of_no_split(device, c_in, c_out, rate,
                                                               first_packet, length):
    """The codec's blocks 2 and 3 at B=1, a length one row under, at and over
    a tile and the stream's first packet (2 frames): every column split the
    kernel takes gives the bits of no split, within tolerance of the plain
    version; the plan's own choice splits the first packet."""
    block = random_vocoder_block(device, c_in, c_out, rate, seed=c_in + 7)
    tile = kernel_plan(c_in, c_out, rate, 7, 1, 64)["tile"]
    t_in = {"under": tile // rate - 1, "at": tile // rate, "over": tile // rate + 1,
            "first_packet": first_packet}[length]
    g = torch.Generator(device=device).manual_seed(t_in)
    x = (0.5 * torch.randn(1, t_in, c_in, generator=g, device=device)).bfloat16()
    want = vocoder_block_plain(x, block, rate)
    unsplit = vocoder_block(x, block, rate, split=1)
    torch.testing.assert_close(unsplit.float(), want.float(), rtol=0,
                               atol=chip_smoke.VOCODER_TOL * want.float().abs().max().item())
    for n in column_splits(c_in, c_out)[1:]:
        assert torch.equal(vocoder_block(x, block, rate, split=n), unsplit), n
    if length == "first_packet":
        assert kernel_plan(c_in, c_out, rate, 7, 1, t_in)["split"] > 1


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


# --------------------------------------------------------------------------
# A row's bits do not depend on the rows beside it
# --------------------------------------------------------------------------

# (B, S_max, row, left padding) placements of one row; every one must give
# the first one's bits. n = 60 positions fits S_max 97 (n_split 2) and 2080
# (8); n = 1500 is a long row at 2080 and 1600 (both 8, several chunks a
# warp).
INVARIANT_PLACEMENTS = {
    60: [(1, 97, 0, 0), (4, 97, 2, 30), (32, 97, 17, 5), (1, 2080, 0, 0), (4, 2080, 3, 1900),
         (32, 2080, 31, 700)],
    1500: [(1, 2080, 0, 0), (4, 2080, 1, 570), (32, 2080, 9, 33), (1, 1600, 0, 100)],
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", sorted(INVARIANT_PLACEMENTS))
def test_decode_attention_row_bits_do_not_depend_on_the_batch(device, n, int8):
    """One row's query, keys and values at B 1/4/32, S_max 97 and 2080, moved
    by left padding, with random rows around it: the same bits each time."""
    g = torch.Generator(device=device).manual_seed(n + int8)
    kv, hd = 2, 64
    q_row = torch.randn(16, hd, generator=g, device=device)
    k_row, v_row = (torch.randn(n, kv, hd, generator=g, device=device) * 3 for _ in range(2))
    outs = []
    for b, s_max, row, at in INVARIANT_PLACEMENTS[n]:
        q = torch.randn(b, 16, hd, generator=g, device=device)
        k, v = (torch.randn(b, s_max, kv, hd, generator=g, device=device) * 3 for _ in range(2))
        q[row], k[row, at:at + n], v[row, at:at + n] = q_row, k_row, v_row
        cur_len = torch.randint(1, s_max + 1, (b,), generator=g, device=device).int()
        valid_from = (cur_len // 3).int()
        cur_len[row], valid_from[row] = at + n, at
        if int8:
            k, v = _int8_caches_of(k, v)
        else:
            k, v = k.bfloat16(), v.bfloat16()
        outs.append(decode_attention(q.bfloat16(), k, v, cur_len, valid_from)[row])
    torch.cuda.synchronize()
    for out, placement in zip(outs[1:], INVARIANT_PLACEMENTS[n][1:]):
        assert torch.equal(out, outs[0]), placement


def _int8_caches_of(k, v):
    """Float K/V -> the int8 dict caches, quantized per token and head (a
    row's entries do not depend on the others)."""
    return tuple({"i8": i8, "s": s} for i8, s in (quantize_kv(t) for t in (k, v)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subtalker_step_row_bits_do_not_depend_on_the_batch(device, dtype):
    """One row's input and cache rows at B 1, 4 and 32 (row 0, 2 and 17):
    the same output and cache bits."""
    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    packed = _random_packed(device, dtype, seed=11)
    g = torch.Generator(device=device).manual_seed(12)
    pos = 9
    x_row = torch.randn(d, generator=g, device=device).to(dtype)
    kc_row, vc_row = (torch.randn(n_layers, 16, kv, hd, generator=g, device=device).to(dtype)
                      for _ in range(2))
    cos, sin = rope_cos_sin(torch.arange(16, device=device), hd, 10000.0)
    outs = []
    for b, row in ((1, 0), (4, 2), (32, 17)):
        x = torch.randn(b, d, generator=g, device=device).to(dtype)
        kc, vc = (torch.randn(n_layers, b, 16, kv, hd, generator=g, device=device).to(dtype)
                  for _ in range(2))
        x[row], kc[:, row], vc[:, row] = x_row, kc_row, vc_row
        out, kc, vc = subtalker_step(packed, x, cos[pos], sin[pos], kc, vc, pos, 1e-6)
        outs.append((out[row], kc[:, row], vc[:, row]))
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The int8-weight GEMM
# --------------------------------------------------------------------------

# (K, N, f32_out): the talker's projections at the flagship dims (q and o
# 1024 x 1024, k and v 1024 x 128, gate and up 1024 x 2048, down 2048 x
# 1024) and the sub-talker LM head (1024 x 2048, f32 logits).
INT8_MATMUL_SHAPES = [(1024, 1024, False), (1024, 128, False), (1024, 2048, False),
                      (2048, 1024, False), (1024, 2048, True)]
# bf16: the product rounds to bf16 after a sum in another order, one ulp
# (at most 2^-7 of the largest value), times the scale.
INT8_MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


def _int8_weight(g, k, n, device):
    return quantize_int8(torch.randn(k, n, generator=g, device=device) / math.sqrt(k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 32, 128])
@pytest.mark.parametrize("k,n,f32_out", INT8_MATMUL_SHAPES)
def test_int8_matmul_kernel_matches_plain(device, k, n, f32_out, m, dtype):
    g = torch.Generator(device=device).manual_seed(k + n + m)
    w_i8, s = _int8_weight(g, k, n, device)
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    before = int8_matmul.launches
    got = int8_matmul(x, w_i8, s, f32_out)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    want = int8_matmul_plain(x, w_i8, s, f32_out)
    assert got.dtype == want.dtype and got.shape == want.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=INT8_MATMUL_TOL[dtype] * want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,f32_out", INT8_MATMUL_SHAPES)
def test_int8_matmul_row_bits_do_not_depend_on_m(device, k, n, f32_out, dtype):
    g = torch.Generator(device=device).manual_seed(3)
    w_i8, s = _int8_weight(g, k, n, device)
    x = torch.randn(32, k, generator=g, device=device).to(dtype)
    full = int8_matmul(x, w_i8, s, f32_out)
    four = int8_matmul(x[:4].contiguous(), w_i8, s, f32_out)
    one = int8_matmul(x[17:18].contiguous(), w_i8, s, f32_out)
    torch.cuda.synchronize()
    assert torch.equal(four, full[:4])
    assert torch.equal(one, full[17:18])


# The talker layer's grouped launches: q|k|v and gate|up (K 1024).
INT8_GROUPS = [[(1024, 1024), (1024, 128), (1024, 128)], [(1024, 2048), (1024, 2048)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 32, 128])
@pytest.mark.parametrize("shapes", INT8_GROUPS)
def test_int8_matmul_group_is_its_single_launches(device, shapes, m, dtype):
    g = torch.Generator(device=device).manual_seed(len(shapes) + m)
    weights = [_int8_weight(g, k, n, device) for k, n in shapes]
    x = torch.randn(m, 1024, generator=g, device=device).to(dtype)
    before = int8_matmul.launches
    got = int8_matmul_group(x, weights)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    for (w_i8, s), y in zip(weights, got):
        assert torch.equal(y, int8_matmul(x, w_i8, s))
        want = int8_matmul_plain(x, w_i8, s)
        torch.testing.assert_close(y.float(), want.float(), rtol=0,
                                   atol=INT8_MATMUL_TOL[dtype] * want.float().abs().max().item())


def test_int8_matmul_timeline_stamps_every_block(device):
    g = torch.Generator(device=device).manual_seed(5)
    weights = [_int8_weight(g, k, n, device) for k, n in INT8_GROUPS[0]]
    x = torch.randn(4, 1024, generator=g, device=device).bfloat16()
    timeline = torch.zeros(launch_blocks(x, weights), TIMELINE_SLOTS, dtype=torch.int64,
                           device=device)
    got = int8_matmul_group(x, weights, timeline=timeline)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, int8_matmul_group(x, weights)))
    t = timeline.cpu()
    assert (t > 0).all() and (t[:, 1:] >= t[:, :-1]).all()
    assert timeline_breakdown(timeline)["blocks"] == timeline.shape[0] == 8 * 20


def test_int8_matmul_rejects_what_it_does_not_take(device):
    g = torch.Generator(device=device).manual_seed(0)
    w_i8, s = _int8_weight(g, 64, 48, device)
    x = torch.zeros(2, 64, device=device)
    before = int8_matmul.launches
    with pytest.raises(TypeError):  # float16 activations
        int8_matmul(x.half(), w_i8, s)
    with pytest.raises(TypeError):  # f32 scales
        int8_matmul(x, w_i8, s.float())
    with pytest.raises(ValueError):  # N not a multiple of 16
        int8_matmul(x, w_i8[:, :40].contiguous(), s[:, :40].contiguous())
    with pytest.raises(ValueError):  # bf16 activations with K not a multiple of 16
        w40, s40 = _int8_weight(g, 40, 48, device)
        int8_matmul(torch.zeros(2, 40, dtype=torch.bfloat16, device=device), w40, s40)
    with pytest.raises(ValueError):  # a weight that does not chain
        int8_matmul(torch.zeros(2, 32, device=device), w_i8, s)
    with pytest.raises(ValueError):  # K past the kernel's split
        big, big_s = _int8_weight(g, 4097, 16, device)
        int8_matmul(torch.zeros(1, 4097, device=device), big, big_s)
    assert int8_matmul.launches == before


def test_generate_batch_matches_single_on_the_card(device, tmp_path):
    """The port's counterpart of tests/test_generate.py's
    test_generate_batch_matches_single on the card: two prompts of the tiny
    config, f32, left-padded into one batch (bucket 4) and each alone, 5
    greedy tokens; each row's codes equal its solo codes. The heads are
    64 wide (the decode-attention kernel takes 64 and 128)."""
    import dataclasses

    import numpy as np

    from qwen_tts_tpu_torch.config import tiny_tts_config
    from qwen_tts_tpu_torch.generate import (
        GenerationParams, batch_prompts, build_prompt, generate_codes)
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    cfg = tiny_tts_config()
    tk = dataclasses.replace(
        cfg.talker, head_dim=64, mrope_section=(16, 8, 8),
        code_predictor=dataclasses.replace(cfg.talker.code_predictor, head_dim=64))
    cfg = dataclasses.replace(cfg, talker=tk)
    chip_smoke.write_checkpoint(str(tmp_path), cfg, seed=0, device=device.type)
    model = Qwen3TTSModel.from_pretrained(str(tmp_path), talker_dtype=torch.float32,
                                          device=device, load_tokenizer=False)
    role, tail = [1, 2, 3], [4, 5, 1, 2, 3]
    p1 = build_prompt(model.talker_params, model.cfg, role + list(range(10, 14)) + tail,
                      language="auto", speaker="aiden")
    p2 = build_prompt(model.talker_params, model.cfg, role + list(range(10, 17)) + tail,
                      language="english")
    # EOS banned (min_new_tokens past the budget): every row runs 5 frames.
    gp = dataclasses.replace(GenerationParams(max_new_tokens=5).greedy(), min_new_tokens=6)
    kw = dict(sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
              max_new_tokens=5, generator=None)

    def run(prompts):
        e, m, t, _ = batch_prompts(prompts, bucket=4)
        return generate_codes(model.talker_params, model.subtalker_params, model.cfg.talker,
                              e, m, t, **kw)

    before = decode_attention.launches
    both = run([p1, p2])
    assert decode_attention.launches > before  # the kernel ran
    for i, p in enumerate((p1, p2)):
        solo = run([p])
        n = int(solo.num_gen[0])
        assert n == int(both.num_gen[i]) == 4  # the budget-exhausted last frame trimmed
        np.testing.assert_array_equal(solo.codes[0, :n].cpu().numpy(),
                                      both.codes[i, :n].cpu().numpy())


def _tiny_card_model(device, tmp_path):
    """The tiny config with 64-wide heads (the decode-attention kernel takes
    64 and 128), f32, on the card."""
    import dataclasses

    from qwen_tts_tpu_torch.config import tiny_tts_config
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    cfg = tiny_tts_config()
    tk = dataclasses.replace(
        cfg.talker, head_dim=64, mrope_section=(16, 8, 8),
        code_predictor=dataclasses.replace(cfg.talker.code_predictor, head_dim=64))
    cfg = dataclasses.replace(cfg, talker=tk)
    chip_smoke.write_checkpoint(str(tmp_path), cfg, seed=0, device=device.type)
    return Qwen3TTSModel.from_pretrained(str(tmp_path), talker_dtype=torch.float32,
                                         device=device, load_tokenizer=False)


@pytest.mark.parametrize("batch", [1, 4])
def test_replayed_frames_equal_the_eager_frames(device, tmp_path, batch):
    """The decode loop by replays of one captured frame against the same
    loop run eagerly on the card: the same codes, buffer and state, bit for
    bit; after N replays each kernel counter has grown by N x the launches
    the frame captured."""
    import dataclasses

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs

    model = _tiny_card_model(device, tmp_path)
    tk = model.cfg.talker
    prompts = [gen_mod.build_prompt(model.talker_params, model.cfg,
                                    [1, 2, 3] + list(range(10, 10 + n)) + [4, 5, 1, 2, 3],
                                    language="auto", speaker="aiden")
               for n in (4, 7, 3, 9)[:batch]]
    e, m, t, _ = gen_mod.batch_prompts(prompts, bucket=8)
    # EOS banned: every row takes all 12 frames, so the loop replays 12.
    gp = dataclasses.replace(gen_mod.GenerationParams(max_new_tokens=12).greedy(),
                             min_new_tokens=13)
    args = (model.talker_params, model.subtalker_params, tk, gp.talker_sampling(),
            gp.subtalker_sampling())
    limit = torch.full((batch,), 12, dtype=torch.int32, device=device)

    def start():
        return gen_mod._prefill(model.talker_params, tk, e, m, sampling=gp.talker_sampling(),
                                max_cache_len=e.shape[1] + 12, generator=None)

    eager, eager_buf = gen_mod._decode_eager(*args, start(), t, limit, 12)
    graphs.clear()
    gen_mod._decode(*args, start(), t, limit, 1)  # captures the frame
    (kind, program), = graphs.programs()
    assert kind == "frame" and program.graph.launches["decode_attention"] == (
        tk.num_hidden_layers + tk.num_code_groups * tk.code_predictor.num_hidden_layers)
    before = decode_attention.launches
    replayed, buf = gen_mod._decode(*args, start(), t, limit, 12)
    assert decode_attention.launches - before == 12 * program.graph.launches["decode_attention"]
    torch.testing.assert_close(buf, eager_buf, rtol=0, atol=0)
    for f in ("token", "hidden", "presence", "eos", "num_gen"):
        torch.testing.assert_close(getattr(replayed, f), getattr(eager, f), rtol=0, atol=0)
    torch.testing.assert_close(replayed.k_cache, eager.k_cache, rtol=0, atol=0)
    graphs.clear()


# Voice clone on the card: the tiny config's Base variant (chip_smoke's
# writers: random ECAPA-TDNN and Mimi weights by name), f32.
TINY_MIMI = dict(num_filters=8, hidden_size=32, upsampling_ratios=(4, 3, 2), codebook_size=128,
                 codebook_dim=16, num_quantizers=8, num_hidden_layers=1, num_attention_heads=4,
                 num_key_value_heads=4, head_dim=8, intermediate_size=64, sliding_window=16,
                 vector_quantization_hidden_dimension=16)


class _TinyTokenizer:
    """Chat-template text → ids inside the tiny 512-row text vocab."""

    def __call__(self, text):
        ids = [1, 2, 3] + [10 + (ord(c) % 40) for c in text[:6]] + [4, 5]
        if text.endswith("assistant\n") and text.count("<|im_start|>") > 1:
            ids += [1, 2, 3]
        return {"input_ids": ids}


def _tiny_clone_models(device, tmp_path):
    """(card model, CPU model) of the tiny Base checkpoint, f32."""
    import dataclasses

    from qwen_tts_tpu_torch.config import MimiEncoderConfig, tiny_tts_config
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    cfg = tiny_tts_config()
    tk = dataclasses.replace(
        cfg.talker, head_dim=64, mrope_section=(16, 8, 8),
        code_predictor=dataclasses.replace(cfg.talker.code_predictor, head_dim=64))
    cfg = dataclasses.replace(cfg, talker=tk)
    chip_smoke.write_checkpoint(str(tmp_path), cfg, seed=0, device=device.type)
    base = str(tmp_path / "base")
    chip_smoke.write_base_checkpoint(str(tmp_path), base, cfg, MimiEncoderConfig(**TINY_MIMI),
                                     seed=1, device=device.type)
    models = []
    for dev in (device, "cpu"):
        m = Qwen3TTSModel.from_pretrained(base, talker_dtype=torch.float32, device=dev,
                                          load_tokenizer=False)
        m.tokenizer = _TinyTokenizer()
        models.append(m)
    return models


def _clone_clips():
    import numpy as np

    rng = np.random.default_rng(3)
    return [((0.2 * np.sin(np.linspace(0, n / 20, n)) + 0.05 * rng.standard_normal(n))
             .astype(np.float32), 24000) for n in (960, 2000, 3100)]


def test_clone_encoders_on_the_card_match_the_cpu(device, tmp_path):
    """x-vectors and Mimi codes of the same clips, card against CPU, within
    chip_smoke's tolerances (near-ties only)."""
    card, cpu = _tiny_clone_models(device, tmp_path)
    chip_smoke.check_clone_encoders(card, cpu, _clone_clips())


def test_clone_codes_on_the_card_equal_the_cpu_codes(device, tmp_path):
    """The card's ICL prompt as a voice file, loaded, and greedy
    generate_voice_clone codes on both devices: equal."""
    import numpy as np

    card, cpu = _tiny_clone_models(device, tmp_path)
    path = str(tmp_path / "voice.pt")
    card.save_voice_clone_prompt(
        card.create_voice_clone_prompt(_clone_clips()[:2], ref_text=["one", "two"]), path)
    prompt = card.load_voice_clone_prompt(path)
    kw = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0,
              max_new_tokens=6, min_new_tokens=7)
    texts, langs = ["hello there", "hi"], ["english", "auto"]
    before = decode_attention.launches
    codes = [np.stack(m.generate_codes_from_prompts(
        chip_smoke.clone_prompts(m, prompt, texts, langs), m._merge_params(**kw))[0])
        for m in (card, cpu)]
    assert decode_attention.launches > before  # the card's decode ran the kernel
    np.testing.assert_array_equal(codes[0], codes[1])
    wavs, _ = card.generate_voice_clone(texts, prompt, langs, **kw)
    up = card.cfg.codec.decode_upsample_rate
    assert [w.shape for w in wavs] == [(5 * up,)] * 2


def test_25hz_tokenizer_on_the_card_matches_the_cpu(device, tmp_path):
    """A tiny 25 Hz checkpoint (chip_smoke's writer), f32 on the card and on
    the CPU through ``chip_smoke.check_v1_parity``: codec_v1 decode (the
    DiT's mel, the waveform before the clamp) under one initial noise, and
    encode (Whisper-VQ codes with near ties only, reference mels,
    x-vectors), within phase 14's tolerances."""
    from qwen_tts_tpu_torch.config import BigVGANConfig, CodecV1Config, DiTConfig
    from qwen_tts_tpu_torch.models.whisper_vq import WhisperVQConfig

    dit = DiTConfig(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, head_dim=16,
                    look_ahead_layers=(1,), look_backward_layers=(0, 2), num_embeds=512,
                    enc_channels=(32, 32, 32, 32, 96), enc_attention_channels=16,
                    enc_se_channels=16, enc_dim=32, emb_dim=32)
    cfg = CodecV1Config(dit=dit, bigvgan=BigVGANConfig(upsample_initial_channel=128))
    enc = WhisperVQConfig(n_state=64, n_head=4, n_layer=2, audio_vq_layers=2,
                          audio_vq_codebook_size=256, audio_vq_codebook_dim=32)
    chip_smoke.write_v1_checkpoint(str(tmp_path), cfg, enc, seed=3, device=device.type)
    out = chip_smoke.check_v1_parity(str(tmp_path), "test")
    assert out["card"].device.type == "cuda"


# The serving engines on the card: per-row sampling inside a captured
# program, slot insertion in place, the segment report, the device lock.

@pytest.mark.parametrize("name", ["plain", "top_k", "top_p", "both"])
def test_sample_token_vec_equals_sample_token_in_a_captured_graph(device, name):
    """Rows that all hold one static config: ``sample_token_vec`` replayed
    in a CUDA graph draws ``sample_token``'s tokens, bit for bit, from the
    same generator state; greedy rows are the argmax."""
    from qwen_tts_tpu_torch import graphs
    from qwen_tts_tpu_torch.ops.sampling import SamplingConfig, sample_token
    from qwen_tts_tpu_torch.ops.sampling_vec import VecSampling, sample_token_vec

    cfg = {"plain": SamplingConfig(top_k=0), "top_k": SamplingConfig(temperature=0.7, top_k=20),
           "top_p": SamplingConfig(temperature=1.3, top_k=0, top_p=0.6),
           "both": SamplingConfig(temperature=0.9, top_k=50, top_p=0.8)}[name]
    g = torch.Generator(device=device).manual_seed(1)
    logits = torch.randn(8, 2048, generator=g, device=device) * 3
    vs = VecSampling.broadcast(cfg, 8, device)
    out = {}
    for side, fn in (("static", lambda gen: sample_token(logits, cfg, gen)),
                     ("vec", lambda gen: sample_token_vec(logits, vs, gen))):
        gen = torch.Generator(device=device)
        graph = graphs.Graph(lambda fn=fn, gen=gen: fn(gen), gen)
        tokens = []
        for seed in range(5):
            with graph.drawing_from(torch.Generator(device=device).manual_seed(seed)):
                graph.replay()
            tokens.append(graph.outputs.clone())
        out[side] = torch.stack(tokens)
    assert torch.equal(out["static"], out["vec"])
    vs.do_sample[::2] = False
    greedy = sample_token_vec(logits, vs, torch.Generator(device=device).manual_seed(0))
    assert torch.equal(greedy[::2], logits.argmax(-1)[::2])


def _tiny_engine(device, tmp_path, **kw):
    from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

    model = _tiny_card_model(device, tmp_path)
    return model, ContinuousBatchingEngine(model, **{**dict(
        num_slots=4, segment_frames=4, max_new_tokens=16, prefill_bucket=16, trailing_cap=32),
        **kw})


def _slot_request(model, n, frames):
    import dataclasses

    from qwen_tts_tpu_torch.continuous import _SlotRequest
    from qwen_tts_tpu_torch.generate import GenerationParams, build_prompt

    prompt = build_prompt(model.talker_params, model.cfg,
                          [1, 2, 3] + list(range(10, 10 + n)) + [4, 5, 1, 2, 3],
                          language="auto", speaker="aiden")
    params = dataclasses.replace(GenerationParams(max_new_tokens=frames + 1).greedy(),
                                 min_new_tokens=frames + 2)
    return _SlotRequest(prompt, params)


def _segment(engine):
    from qwen_tts_tpu_torch.generate import decode_segment

    engine._state, codes, report = decode_segment(
        engine.model.talker_params, engine.model.subtalker_params, engine.model.cfg.talker,
        engine._state, engine._trailing, sampling=engine._static_sampling[0],
        st_sampling=engine._static_sampling[1], segment=engine.segment_frames,
        step_limit=engine._limits, vec_sampling=engine._vec, st_vec_sampling=engine._st_vec,
        with_report=True)
    return codes, report


class _BigCopies(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts copies that write at least ``numel`` elements."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.count = numel, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten.copy_.default, torch.ops.aten._to_copy.default,
                    torch.ops.aten.clone.default) and args[0].numel() >= self.numel:
            self.count += 1
        return func(*args, **kwargs)


def test_admission_writes_one_row_of_the_pool_in_place(device, tmp_path):
    """The pool's state after a segment is the frame program's buffers; an
    admission writes its row into them (the cache's data_ptr unchanged, no
    copy of the whole cache), and the next segment loads no state."""
    from qwen_tts_tpu_torch import graphs

    graphs.clear()
    model, engine = _tiny_engine(device, tmp_path)
    engine._admit(0, _slot_request(model, 4, 12))
    _segment(engine)
    (kind, program), = [p for p in graphs.programs() if p[0] == "frame"]
    cache = engine._state.k_cache
    assert cache is program.state.k_cache and engine._state.token is program.state.token
    ptr, big = cache.data_ptr(), _BigCopies(cache.numel())
    with big:
        engine._admit(1, _slot_request(model, 7, 12))
        _segment(engine)
    assert engine._state.k_cache.data_ptr() == ptr and engine._state.k_cache is cache
    assert big.count == 0
    assert engine._state.num_gen.tolist()[:2] == [8, 4]
    graphs.clear()


def test_segment_report_survives_the_next_dispatch(device, tmp_path):
    """``with_report``: segment K's (num_gen, eos) read after segment K+1 is
    dispatched equal a read taken right after K, though K+1 has since
    rewritten the state's buffers."""
    from qwen_tts_tpu_torch import graphs

    graphs.clear()
    model, engine = _tiny_engine(device, tmp_path)
    engine._admit(0, _slot_request(model, 4, 12))
    engine._admit(2, _slot_request(model, 9, 6))
    _, report = _segment(engine)
    sync = (engine._state.num_gen.cpu(), engine._state.eos.cpu())
    _segment(engine)  # K+1, dispatched before K's report is read
    assert torch.equal(report[0].cpu(), sync[0]) and torch.equal(report[1].cpu(), sync[1])
    assert not torch.equal(engine._state.num_gen.cpu(), sync[0])
    graphs.clear()


def test_prompt_built_on_another_thread_during_a_capture(device, tmp_path):
    """A thread that builds prompts on the card (under ``device_lock``, as
    the engines' submitters do) while another captures a frame program: the
    capture neither fails nor changes its codes."""
    import threading

    from qwen_tts_tpu_torch import generate as gen_mod
    from qwen_tts_tpu_torch import graphs

    model = _tiny_card_model(device, tmp_path)
    prompts = [_slot_request(model, n, 8).prompt for n in (4, 7)]
    gp = _slot_request(model, 4, 8).params
    e, m, t, _ = gen_mod.batch_prompts(prompts, bucket=16)

    def codes():
        graphs.clear()  # each call captures its frame anew
        out = gen_mod.generate_codes(model.talker_params, model.subtalker_params,
                                     model.cfg.talker, e, m, t,
                                     sampling=gp.talker_sampling(),
                                     st_sampling=gp.subtalker_sampling(), max_new_tokens=9,
                                     generator=None)
        return out.codes.cpu()

    want = codes()
    stop, built, errors = threading.Event(), [], []

    def build_prompts():
        try:
            while not stop.is_set():
                with graphs.device_lock:
                    built.append(gen_mod.build_prompt(
                        model.talker_params, model.cfg, [1, 2, 3, 10, 11, 4, 5, 1, 2, 3],
                        language="english", speaker="aiden").embeds.sum().item())
        except Exception as exc:  # reported below
            errors.append(exc)

    thread = threading.Thread(target=build_prompts)
    thread.start()
    try:
        got = [codes() for _ in range(3)]
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors and len(built) > 0
    assert all(torch.equal(g, want) for g in got)
    assert len(set(built)) == 1
    graphs.clear()
