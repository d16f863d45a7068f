"""The BLSTM window's least time (the planned AM and fbank FLOPs at the
float32 peak, the decoder's counted bytes at the HBM peak) over its wall
time."""

from asrbench.readers import step_mfu


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm":
        return None
    return step_mfu(rec)
