"""Host milliseconds a decode segment takes (its frames replayed over
every slot, the dispatch and the wait for its results):
``stats``' ``time_segment_s`` over the segments of the measured window."""

UNIT = "ms"


def read(layer: dict):
    if layer["kind"] != "serve" or layer["stats"]["segments"] <= 0:
        return None
    return layer["stats"]["time_segment_s"] / layer["stats"]["segments"] * 1e3
