"""``vocoder_block``'s share of its roofline in the offline codec: over
the call's ``decode_codes`` inside a profiled sub-window, the least time of
the fused blocks' launches (each chunk of the call's rows) over their
device time."""

import roofline
from reference.model import chunk_spans

UNIT = "%"


def read(layer: dict):
    sub = layer.get("trace")
    if layer["kind"] != "batch" or not sub or sub.get("incomplete"):
        return None
    red = sub["red"]
    if red.count("vocoder_block") == 0:
        return None
    mix = layer["mix"]
    dec = layer["cfg"]["speech_tokenizer"]["decoder_config"]
    frames = sub["call"]["frames"]
    bucket = mix["codec_bucket"]
    t_max = -(-max(frames) // bucket) * bucket
    chunks = [end - start + ctx for start, end, ctx in chunk_spans(t_max, 300, 25)]
    bound = roofline.codec_call_vocoder_bound_s(dec, len(frames), chunks)
    return bound / red.seconds("vocoder_block") * 100
