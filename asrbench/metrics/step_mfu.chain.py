"""The chain window's least time (the planned TDNN-F and fbank FLOPs at
the float32 peak, the decoder's counted bytes at the HBM peak) over its
wall time."""

from asrbench.readers import step_mfu


def read(rec):
    if rec.get("kind") != "bulk_chain":
        return None
    return step_mfu(rec)
