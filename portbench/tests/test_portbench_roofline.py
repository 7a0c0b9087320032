"""The yardstick's byte, operation and bound arithmetic against hand counts
at small shapes."""

import _paths  # noqa: F401
import pytest

import roofline as R


def test_bound_takes_the_larger_term():
    assert R.bound_s(3.35e12, 0, R.BF16_FLOPS) == (1.0, "bytes")
    assert R.bound_s(0, 989e12, R.BF16_FLOPS) == (1.0, "operations")


def test_int8_matmul_bytes_and_bound():
    # x [2, 4] bf16 = 16 B; weights 4x3 and 4x5 int8 = 32 B; scales 2*(3+5) = 16 B;
    # outputs 2*3*2 + 2*5*2 = 32 B.
    assert R.int8_matmul_bytes(2, 4, (3, 5)) == 16 + 32 + 16 + 32
    assert R.int8_matmul_bound_s(2, 4, (3, 5)) == pytest.approx(96 / 3.35e12)
    # At M = 10^6 the products bound it: 2*M*K*N at 989 TFLOP/s.
    m, k, n = 10 ** 6, 1024, 1024
    assert R.int8_matmul_bound_s(m, k, (n,)) == pytest.approx(
        max(R.int8_matmul_bytes(m, k, (n,)) / 3.35e12, 2 * m * k * n / 989e12))


def _trunk(layers=1, d=8, h=2, kv=1, hd=4, i=16):
    return {"num_hidden_layers": layers, "hidden_size": d, "num_attention_heads": h,
            "num_key_value_heads": kv, "head_dim": hd, "intermediate_size": i,
            "vocab_size": 32, "num_code_groups": 3}


def test_serving_frame_int8_launches_and_bound():
    t = dict(_trunk(layers=2), code_predictor_config=_trunk())
    assert R.serving_frame_int8_launches(t) == 2 * 4 + 2
    # One layer at M=1: qkv K=8 N=(8,4,4); o K=8 N=8; gu K=8 N=(16,16); down K=16 N=8.
    per_layer = (R.int8_matmul_bound_s(1, 8, (8, 4, 4)) + R.int8_matmul_bound_s(1, 8, (8,))
                 + R.int8_matmul_bound_s(1, 8, (16, 16)) + R.int8_matmul_bound_s(1, 16, (8,)))
    heads = 2 * R.int8_matmul_bound_s(1, 8, (32,), out_item=4)
    assert R.serving_frame_int8_bound_s(t, 1) == pytest.approx(2 * per_layer + heads)


def test_subtalker_step_bytes_by_hand():
    c = _trunk()
    # weights: qkv 8*16 + o 8*8 + gu 8*32 + down 16*8 = 576 B; scales 4*(16+8+32+8) = 256;
    # norms 2*(2*8 + 2*4) = 48; x in/out 2*1*8*2 = 32; rope 2*4*4 = 32;
    # cache at pos 3: read 2*1*1*3*4*2 = 48, write 2*1*1*4*2 = 16.
    moved = 576 + 256 + 48 + 32 + 32 + 48 + 16
    flops = 2 * 576 * 1 + 4 * 1 * 1 * 2 * 4 * 4
    assert R.subtalker_step_bound_s(c, 1, 3) == pytest.approx(
        max(moved / 3.35e12, flops / 989e12))


def test_attention_bound_by_hand():
    # 10 valid positions, KV 1, hd 4, bf16: 10 * (4*2) * 2 = 160 B; q in and out
    # 2*1*2*4*2 = 32 B; lengths 8 B. Operations 4*H*hd*valid = 320 at the f32 rate.
    assert R.attention_bound_s(1, 2, 1, 4, 10) == pytest.approx(200 / 3.35e12)
    t = dict(_trunk(layers=2), code_predictor_config=_trunk())
    assert R.batch_frame_attention_launches(t) == 2 + 3 * 1
    expect = 2 * R.attention_bound_s(1, 2, 1, 4, 10) + sum(
        R.attention_bound_s(1, 2, 1, 4, p + 1) for p in range(3))
    assert R.batch_frame_attention_bound_s(t, 1, 10) == pytest.approx(expect)


def test_vocoder_blocks_and_bound():
    dec = {"decoder_dim": 1536, "upsample_rates": [8, 5, 4, 3], "upsampling_ratios": [2, 2]}
    assert R.codec_kernel_blocks(dec) == [(2, 384, 192, 4, 160), (3, 192, 96, 3, 640)]
    b, t_in, ci, co, r = 1, 2, 4, 2, 2
    moved = 2 * b * (t_in * ci + t_in * r * co) + 2 * (2 * r * ci * co + 3 * 8 * co * co) \
        + 2 * (2 * ci + 19 * co)
    flops = 2 * b * t_in * r * (2 * ci * co + 3 * 8 * co * co)
    assert R.vocoder_block_bound_s(b, t_in, ci, co, r) == pytest.approx(
        max(moved / 3.35e12, flops / 989e12))


def test_frame_flops_by_hand():
    t = dict(_trunk(), code_predictor_config=_trunk())
    proj = 8 * (8 + 2 * 4) + 8 * 8 + 3 * 8 * 16
    talker = 2 * proj + 4 * 2 * 4 * 5 + 2 * 8 * 32
    sub = sum(2 * proj + 4 * 2 * 4 * (p + 1) for p in range(3)) + 2 * 2 * 8 * 32
    assert R.frame_flops(t, 5) == talker + sub
    assert R.frames_flops(t, 4, 2) == R.frame_flops(t, 5) + R.frame_flops(t, 6)
