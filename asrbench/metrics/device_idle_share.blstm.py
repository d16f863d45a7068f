"""Share of the traced BLSTM window in which the card ran nothing."""

from asrbench.readers import idle_share


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm":
        return None
    return idle_share(rec)
