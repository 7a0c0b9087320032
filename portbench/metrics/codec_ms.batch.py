"""Milliseconds of a call's ``decode_codes`` (the bf16 codec over the
call's rows, in chunks), the mean over the calls of the window."""

UNIT = "ms"


def read(layer: dict):
    if layer["kind"] != "batch" or not layer["codec_s"]:
        return None
    return sum(layer["codec_s"]) / len(layer["codec_s"]) * 1e3
