"""Milliseconds a decoded 30 ms frame step: the CUDA-event seconds of the
program's `decode.frames` spans (a chunk's replay and its copies) over
the frames they stepped."""


def read(rec):
    if rec.get("kind") != "bulk_chain" or not rec.get("frames_device_s"):
        return None
    return 1e3 * rec["frames_device_s"] / rec["frames_stepped"]
