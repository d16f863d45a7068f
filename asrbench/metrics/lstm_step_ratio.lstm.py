"""The recurrence steps the program ran over those its valid outputs
need: the counters `lstm_steps` over `lstm_steps_needed` across the
window (1.0: no padded step; above it, steps over the bucket's
padding)."""


def read(rec):
    if rec.get("kind") != "bulk_chain_lstm" \
            or not rec.get("lstm_steps_needed"):
        return None
    return rec["lstm_steps"] / rec["lstm_steps_needed"]
