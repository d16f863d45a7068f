"""Share of the traced bulk window in which the card ran nothing."""

from asrbench.readers import idle_share


def read(rec):
    if rec.get("kind") != "bulk":
        return None
    return idle_share(rec)
