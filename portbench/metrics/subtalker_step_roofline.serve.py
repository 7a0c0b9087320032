"""``subtalker_step``'s share of its roofline in the serving frame: over
the frame replays of a profiled sub-window, the least time of the G
micro-steps at the pool's batch over their device time."""

import roofline
import subwindow

UNIT = "%"


def read(layer: dict):
    sub = layer.get("trace")
    if layer["kind"] != "serve" or not sub or sub.get("incomplete"):
        return None
    c = layer["cfg"]["talker_config"]["code_predictor_config"]
    b = layer["mix"]["engine"]["slots"]
    key = subwindow.KERNELS["subtalker_step"]
    mine = [[k for k in r if key in k[2]] for r in sub["red"].graph_replays()]
    mine = [m for m in mine if m]
    if not mine or any(len(m) != c["num_code_groups"] for m in mine):
        return None
    seconds = sum(e - s for m in mine for s, e, _, _ in m) * 1e-9
    return len(mine) * roofline.serving_frame_subtalker_bound_s(c, b) / seconds * 100
