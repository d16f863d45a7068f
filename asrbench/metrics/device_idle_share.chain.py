"""Share of the traced chain window in which the card ran nothing."""

from asrbench.readers import idle_share


def read(rec):
    if rec.get("kind") != "bulk_chain":
        return None
    return idle_share(rec)
