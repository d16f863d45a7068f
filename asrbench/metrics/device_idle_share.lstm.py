"""Share of the traced TDNN-LSTM window in which the card ran nothing."""

from asrbench.readers import idle_share


def read(rec):
    if rec.get("kind") != "bulk_chain_lstm":
        return None
    return idle_share(rec)
