"""Host milliseconds an admission takes (the B=1 eager prefill and the
slot's row written into the pool): ``ContinuousBatchingEngine.stats``'s
``time_admit_s`` over the admissions of the measured window."""

UNIT = "ms"


def read(layer: dict):
    if layer["kind"] != "serve" or layer["stats"]["requests"] <= 0:
        return None
    return layer["stats"]["time_admit_s"] / layer["stats"]["requests"] * 1e3
