"""The recurrence kernel's share of its roofline over the traced BLSTM
window: its least time (`blstm_counts.recurrence_least_s`: the FLOPs at
the FP32 peak or the compulsory bytes at the HBM peak, whichever is
larger, one launch a layer, direction and batch, over the rows each
direction steps in Kaldi's chunk windows) over the profiler's time of its
launches (`lstm_recurrence_kernel`)."""

from asrbench.readers import traced
from asrbench.trace import kernel_seconds


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" or not traced(rec) \
            or not rec.get("recurrence_least_s"):
        return None
    secs = kernel_seconds(rec["trace"], "lstm_recurrence")
    if secs <= 0:
        return None
    return 100.0 * rec["recurrence_least_s"] / secs
