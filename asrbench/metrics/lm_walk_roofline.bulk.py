"""`lm_walk`'s share of its bandwidth roofline over the traced window."""

from asrbench.readers import roofline


def read(rec):
    if rec.get("kind") != "bulk":
        return None
    return roofline(rec, "lm_walk")
