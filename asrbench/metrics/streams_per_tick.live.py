"""Streams advanced a live tick: chunk steps of 20 frames, summed over
the streams, over the window's ticks (the batch the live path forms)."""


def read(rec):
    if rec.get("kind") != "live" or not rec["ticks"]:
        return None
    return rec["stream_steps"] / rec["ticks"]
