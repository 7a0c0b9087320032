"""Milliseconds a decode step takes in an offline batch: the wall of the
calls' ``generate_codes_from_prompts`` (prefill included, ending in its
host read) over their decode steps (frame replays, counted by the
float-cache decode-attention launches a frame)."""

UNIT = "ms"


def read(layer: dict):
    if layer["kind"] != "batch" or layer["steps"] <= 0:
        return None
    return layer["frame_s"] / layer["steps"] * 1e3
