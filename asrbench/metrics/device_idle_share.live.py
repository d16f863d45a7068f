"""Share of the traced live window in which the card ran nothing."""

from asrbench.readers import idle_share


def read(rec):
    if rec.get("kind") != "live":
        return None
    return idle_share(rec)
