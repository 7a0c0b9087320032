"""The offline step's share of the card's bf16 peak: the least time the
useful products of the calls' frames need at 989 TFLOP/s, over the calls'
wall (prompts, decode and codec)."""

import roofline

UNIT = "%"


def read(layer: dict):
    if layer["kind"] != "batch" or layer["calls_s"] <= 0:
        return None
    return layer["flops"] / roofline.BF16_FLOPS / layer["calls_s"] * 100
