"""The benchmark's frozen yardstick: the card's published peaks, the bytes
and operations each hand-written kernel must move and compute for the shapes
a cell runs, and the operations of a whole frame of the model.

Copied from the builders' chip checks (``chip_smoke.py`` ``_attention_bytes``,
``_bound``, ``subtalker_step_bound``, ``vocoder_block_bound``, ``_int8_bytes``)
and written from shapes alone, so that a later change to the program cannot
move the yardstick. A bound is the larger of bytes over the memory bandwidth
and operations over the peak of the unit that computes them; each input byte
is read once and each output byte written once, whatever a kernel reads
again.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12   # the int8 kernels multiply on the bf16 tensor cores too
F32_FLOPS = 67e12     # CUDA cores, no TF32


def bound_s(bytes_moved: float, flops: float, peak: float) -> Tuple[float, str]:
    """(least seconds, what bounds it)."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = flops / peak
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# --------------------------------------------------------------------------
# int8 GEMM (ops/cuda/int8_matmul.py): x [M, K] bf16 @ int8 [K, N] * bf16
# scales [N]; the products run on the bf16 tensor cores.
# --------------------------------------------------------------------------

def int8_matmul_bytes(m: int, k: int, ns, x_item: int = 2, out_item: int = 2) -> int:
    """One launch reading x once, each int8 weight and its bf16 scales once,
    writing each output once (``ns``: the output widths of one grouped
    launch)."""
    return m * k * x_item + sum(k * n + 2 * n + m * n * out_item for n in ns)


def int8_matmul_bound_s(m: int, k: int, ns, out_item: int = 2) -> float:
    flops = sum(2 * m * k * n for n in ns)
    return bound_s(int8_matmul_bytes(m, k, ns, out_item=out_item), flops, BF16_FLOPS)[0]


def talker_int8_launches(t: dict, m: int):
    """The int8 GEMM launches of one serving talker step at M rows: per
    layer q|k|v, o, gate|up, down, as (K, widths, output item)."""
    d, q, kv, i = (t["hidden_size"], t["num_attention_heads"] * t["head_dim"],
                   t["num_key_value_heads"] * t["head_dim"], t["intermediate_size"])
    layer = [(d, (q, kv, kv), 2), (q, (d,), 2), (d, (i, i), 2), (i, (d,), 2)]
    return layer * t["num_hidden_layers"]


def serving_frame_int8_bound_s(t: dict, b: int) -> float:
    """Least seconds of the int8 GEMMs of one serving frame at batch ``b``:
    the talker's step and the sub-talker's G-1 int8 LM heads (f32 out)."""
    c = t["code_predictor_config"]
    total = sum(int8_matmul_bound_s(b, k, ns, item) for k, ns, item in talker_int8_launches(t, b))
    heads = c["num_code_groups"] - 1
    return total + heads * int8_matmul_bound_s(b, c["hidden_size"], (c["vocab_size"],), 4)


def serving_frame_int8_launches(t: dict) -> int:
    return 4 * t["num_hidden_layers"] + t["code_predictor_config"]["num_code_groups"] - 1


# --------------------------------------------------------------------------
# The fused sub-talker micro-step (ops/cuda/subtalker_step.py)
# --------------------------------------------------------------------------

def subtalker_step_bound_s(c: dict, b: int, pos: int, item: int = 2) -> float:
    """One micro-step at batch ``b`` and position ``pos``: the int8 weights,
    their f32 scales and the norms read once, x in and out, cache rows
    0..pos-1 read and row pos written, against the products at the bf16
    tensor-core rate."""
    l, d, h, kv, hd, i = (c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"],
                          c["num_key_value_heads"], c["head_dim"], c["intermediate_size"])
    q, kvd = h * hd, kv * hd
    widths = {"qkv": (d, q + 2 * kvd), "wo": (q, d), "gu": (d, 2 * i), "down": (i, d)}
    weights = l * sum(k * n for k, n in widths.values())
    scales = 4 * l * sum(n for _, n in widths.values())
    norms = item * l * (2 * d + 2 * hd)
    cache_read = 2 * l * b * pos * kvd * item
    cache_write = 2 * l * b * kvd * item
    moved = weights + scales + norms + 2 * b * d * item + 2 * hd * 4 + cache_read + cache_write
    flops = 2 * weights * b + 4 * l * b * h * (pos + 1) * hd
    return bound_s(moved, flops, BF16_FLOPS)[0]


def serving_frame_subtalker_bound_s(c: dict, b: int) -> float:
    return sum(subtalker_step_bound_s(c, b, pos) for pos in range(c["num_code_groups"]))


# --------------------------------------------------------------------------
# Decode attention (ops/cuda/decode_attention.py), float cache
# --------------------------------------------------------------------------

def attention_bound_s(b: int, h: int, kv: int, hd: int, valid: int, q_item: int = 2,
                      cache_item: int = 2, scales: bool = False) -> float:
    """One launch over ``valid`` cache positions in all (summed over the
    batch rows): the valid K/V rows (and their f32 scales) read once, q in,
    the output out, cur_len and valid_from; QK and PV at the f32 rate."""
    per_pos = kv * (hd * cache_item + (4 if scales else 0)) * 2
    moved = valid * per_pos + 2 * b * h * hd * q_item + 8 * b
    flops = 4 * h * hd * valid
    return bound_s(moved, flops, F32_FLOPS)[0]


def batch_frame_attention_bound_s(t: dict, b: int, talker_valid: int) -> float:
    """The float-cache decode attention of one bf16 frame at batch ``b``:
    the talker's layers over ``talker_valid`` valid positions summed over
    the rows, and the sub-talker's G positions x layers over 1..G."""
    c = t["code_predictor_config"]
    talker = t["num_hidden_layers"] * attention_bound_s(
        b, t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"], talker_valid)
    sub = sum(c["num_hidden_layers"] * attention_bound_s(
        b, c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"], b * (pos + 1))
        for pos in range(c["num_code_groups"]))
    return talker + sub


def batch_frame_attention_launches(t: dict) -> int:
    c = t["code_predictor_config"]
    return t["num_hidden_layers"] + c["num_code_groups"] * c["num_hidden_layers"]


# --------------------------------------------------------------------------
# The fused vocoder block (ops/cuda/vocoder_block.py), bf16
# --------------------------------------------------------------------------

def vocoder_block_bound_s(b: int, t_in: int, c_in: int, c_out: int, rate: int,
                          taps: int = 7) -> float:
    """One block: the bf16 input read once, the output written once, the
    weights and per-channel vectors read once; the transposed conv (2 taps
    of c_in x c_out per output row) and the three residual units
    (``taps``-tap and 1x1 convs) at the bf16 tensor-core rate. The SnakeBeta
    passes on the CUDA cores are not counted, so the bound is a floor."""
    t_out = t_in * rate
    rows = b * t_out
    weights = 2 * (2 * rate * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    vectors = 2 * (2 * c_in + 19 * c_out)
    moved = 2 * b * (t_in * c_in + t_out * c_out) + weights + vectors
    flops = 2 * rows * (2 * c_in * c_out + 3 * (taps + 1) * c_out * c_out)
    return bound_s(moved, flops, BF16_FLOPS)[0]


def codec_kernel_blocks(dec: dict, max_c_in: int = 384):
    """The (block index, c_in, c_out, rate, upsample before it) of the
    vocoder blocks that run as the fused kernel in a bf16 codec (input
    width at most ``max_c_in``)."""
    out, up = [], 1
    for r in dec["upsampling_ratios"]:
        up *= r
    for i, rate in enumerate(dec["upsample_rates"]):
        c_in, c_out = dec["decoder_dim"] // 2 ** i, dec["decoder_dim"] // 2 ** (i + 1)
        if c_in <= max_c_in:
            out.append((i, c_in, c_out, rate, up))
        up *= rate
    return out


def codec_call_vocoder_bound_s(dec: dict, b: int, frames) -> float:
    """The fused vocoder blocks of one ``codec_decode`` call per entry of
    ``frames`` (the frames of each chunk decoded), batch ``b``."""
    return sum(vocoder_block_bound_s(b, t * up, c_in, c_out, rate)
               for t in frames for _, c_in, c_out, rate, up in codec_kernel_blocks(dec))


# --------------------------------------------------------------------------
# The useful operations of one frame of one row (step_mfu)
# --------------------------------------------------------------------------

def trunk_flops_per_token(d: int, h: int, kv: int, hd: int, i: int, layers: int,
                          depth_sum: int) -> int:
    """Products of ``layers`` decoder layers for one token, attention over
    ``depth_sum`` positions summed over the layers' calls (QK and PV)."""
    proj = d * (h * hd + 2 * kv * hd) + h * hd * d + 3 * d * i
    return 2 * proj * layers + 4 * h * hd * depth_sum


def frame_flops(t: dict, depth: int) -> int:
    """One frame of one row: the talker's step at cache ``depth`` (its LM
    head included) and the sub-talker's G positions with its G-1 heads."""
    c = t["code_predictor_config"]
    talker = trunk_flops_per_token(
        t["hidden_size"], t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"],
        t["intermediate_size"], t["num_hidden_layers"], depth * t["num_hidden_layers"])
    talker += 2 * t["hidden_size"] * t["vocab_size"]
    g = c["num_code_groups"]
    sub = sum(trunk_flops_per_token(
        c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
        c["intermediate_size"], c["num_hidden_layers"], (pos + 1) * c["num_hidden_layers"])
        for pos in range(g))
    sub += (g - 1) * 2 * c["hidden_size"] * c["vocab_size"]
    return talker + sub


def frames_flops(t: dict, prefix: int, frames: int) -> int:
    """The frames 0..frames-1 of one row after a prompt of ``prefix``
    positions (frame n attends over prefix + n + 1)."""
    return sum(frame_flops(t, prefix + n + 1) for n in range(frames))

