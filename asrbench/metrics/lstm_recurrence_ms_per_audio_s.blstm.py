"""Recurrence milliseconds per audio second on the chain BLSTM: the
CUDA-event seconds of the program's `am.recurrence` spans (one a layer,
direction and batch: the recurrence kernel's launches over the batch's
chunk windows), summed, over the window's audio."""


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" \
            or not rec.get("recurrence_device_s"):
        return None
    return 1e3 * rec["recurrence_device_s"] / rec["audio_s"]
