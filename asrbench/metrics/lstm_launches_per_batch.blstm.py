"""Recurrence kernel launches a batch on the chain BLSTM: the counter
`lstm_recurrence_launches` over the window's batches (one a layer and
direction: 6 for three BLSTM layers); none without a device trace (a
run without a card launches no kernel)."""

from asrbench.readers import traced


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" or not traced(rec) \
            or not rec.get("batches"):
        return None
    return rec["lstm_recurrence_launches"] / rec["batches"]
