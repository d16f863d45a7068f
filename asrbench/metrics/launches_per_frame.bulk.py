"""Device kernels the traced window launched, per decoder frame stepped."""

from asrbench.readers import traced


def read(rec):
    if rec.get("kind") != "bulk" or not traced(rec):
        return None
    return rec["trace"]["launches"] / rec["frames_stepped"]
