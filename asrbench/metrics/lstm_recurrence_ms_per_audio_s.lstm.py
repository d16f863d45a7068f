"""Recurrence milliseconds per audio second: the CUDA-event seconds of the
program's `am.recurrence` spans (one a LSTM layer and batch: the
recurrence kernel's launch), summed, over the window's audio."""


def read(rec):
    if rec.get("kind") != "bulk_chain_lstm" \
            or not rec.get("recurrence_device_s"):
        return None
    return 1e3 * rec["recurrence_device_s"] / rec["audio_s"]
