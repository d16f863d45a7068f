"""`frame_select`'s share of its bandwidth roofline over the chain cell's
traced window (7,000-slot rows)."""

from asrbench.readers import roofline


def read(rec):
    if rec.get("kind") != "bulk_chain":
        return None
    return roofline(rec, "frame_select")
