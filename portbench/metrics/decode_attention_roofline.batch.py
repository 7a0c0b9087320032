"""The float-cache ``decode_attention``'s share of its roofline in the
offline frame: over the frame replays of a profiled sub-window, the least
time of their launches (the talker's layers over each row's valid cache,
the sub-talker's positions) over their device time. Every row of a batch
advances together, so a replay's frame index gives each row's depth."""

import roofline
import subwindow
import sut

UNIT = "%"


def read(layer: dict):
    sub = layer.get("trace")
    if layer["kind"] != "batch" or not sub or sub.get("incomplete"):
        return None
    t = layer["cfg"]["talker_config"]
    key = subwindow.KERNELS["decode_attention"]
    per = roofline.batch_frame_attention_launches(t)
    mine = [[k for k in r if key in k[2]] for r in sub["replays"]]
    mine = [m for m in mine if m]
    if not mine or any(len(m) != per for m in mine):
        return None
    limits = [f + 1 for f in sub["call"]["frames"]]
    plen = sut.prompt_len(layer["cfg"])
    bound = 0.0
    for j in range(len(mine)):
        n = sub["first_frame"] + j
        valid = sum(plen + min(n, lim) + 1 for lim in limits)
        bound += roofline.batch_frame_attention_bound_s(t, len(limits), valid)
    seconds = sum(e - s for m in mine for s, e, _, _ in m) * 1e-9
    return bound / seconds * 100
