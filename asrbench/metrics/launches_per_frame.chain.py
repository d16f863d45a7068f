"""Device kernels the chain cell's traced window launched, per decoder
frame stepped (30 ms frames)."""

from asrbench.readers import traced


def read(rec):
    if rec.get("kind") != "bulk_chain" or not traced(rec) \
            or not rec.get("frames_stepped"):
        return None
    return rec["trace"]["launches"] / rec["frames_stepped"]
