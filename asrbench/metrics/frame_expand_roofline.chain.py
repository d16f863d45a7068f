"""`frame_expand`'s share of its bandwidth roofline over the chain cell's
traced window."""

from asrbench.readers import roofline


def read(rec):
    if rec.get("kind") != "bulk_chain":
        return None
    return roofline(rec, "frame_expand")
