"""``int8_matmul``'s share of its roofline in the serving frame: over the
frame replays of a profiled sub-window, the least time of their int8 GEMM
launches (the talker's four a layer and the sub-talker's int8 LM heads, at
the pool's batch) over those launches' device time."""

import roofline
import subwindow

UNIT = "%"


def read(layer: dict):
    sub = layer.get("trace")
    if layer["kind"] != "serve" or not sub or sub.get("incomplete"):
        return None
    t = layer["cfg"]["talker_config"]
    b = layer["mix"]["engine"]["slots"]
    want = roofline.serving_frame_int8_launches(t)
    key = subwindow.KERNELS["int8_matmul"]
    frames = [r for r in sub["red"].graph_replays()
              if any(subwindow.KERNELS["subtalker_step"] in k[2] for k in r)]
    mine = [[k for k in r if key in k[2]] for r in frames]
    if not mine or any(len(m) != want for m in mine):
        return None
    seconds = sum(e - s for m in mine for s, e, _, _ in m) * 1e-9
    return len(mine) * roofline.serving_frame_int8_bound_s(t, b) / seconds * 100
