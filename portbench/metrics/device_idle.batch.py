"""The share of a profiled sub-window of the offline window (the deepest frames of a call, the loop's end and the codec) in which no
kernel ran on the card: 1 - the union of the kernels' intervals over the
sub-window's wall. Read only from a sub-window that kept every launch."""

UNIT = "%"


def read(layer: dict):
    sub = layer.get("trace")
    if layer["kind"] != "batch" or not sub or sub.get("incomplete"):
        return None
    red = sub["red"]
    return (1.0 - red.busy_s / red.window_s) * 100
