"""The serving step's share of the card's bf16 peak: the least time the
useful products of the frames streamed in the window need at 989 TFLOP/s
(the int8 kernels multiply on the bf16 tensor cores), over the segments'
host wall."""

import roofline

UNIT = "%"


def read(layer: dict):
    if layer["kind"] != "serve" or layer["stats"]["time_segment_s"] <= 0 or layer["flops"] <= 0:
        return None
    return layer["flops"] / roofline.BF16_FLOPS / layer["stats"]["time_segment_s"] * 100
