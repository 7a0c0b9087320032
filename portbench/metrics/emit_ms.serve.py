"""Host milliseconds a streamed chunk takes (the slot's codec window
decoded and handed to the client's callback): ``stats``' ``time_emit_s``
over the chunks emitted in the measured window."""

UNIT = "ms"


def read(layer: dict):
    if layer["kind"] != "serve" or layer["emits"] <= 0:
        return None
    return layer["stats"]["time_emit_s"] / layer["emits"] * 1e3
