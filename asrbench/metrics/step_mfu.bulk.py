"""The bulk window's least time (AM FLOPs at the float32 peak, decoder
bytes at the HBM peak) over its wall time."""

from asrbench.readers import step_mfu


def read(rec):
    if rec.get("kind") != "bulk":
        return None
    return step_mfu(rec)
