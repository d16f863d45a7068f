"""The recurrence kernel's share of its roofline over the traced window:
its least time (`lstm_counts.recurrence_least_s`: the FLOPs at the FP32
peak or the compulsory bytes at the HBM peak, whichever is larger, over
the steps the valid outputs need) over the profiler's time of its
launches (`lstm_recurrence_kernel`)."""

from asrbench.readers import traced
from asrbench.trace import kernel_seconds


def read(rec):
    if rec.get("kind") != "bulk_chain_lstm" or not traced(rec) \
            or not rec.get("recurrence_least_s"):
        return None
    secs = kernel_seconds(rec["trace"], "lstm_recurrence")
    if secs <= 0:
        return None
    return 100.0 * rec["recurrence_least_s"] / secs
