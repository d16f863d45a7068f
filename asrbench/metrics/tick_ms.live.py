"""Milliseconds a live tick: the wall time of the window's
`process_batch` + `partials` calls over their number."""


def read(rec):
    if rec.get("kind") != "live" or not rec["ticks"]:
        return None
    return 1e3 * rec["tick_s"] / rec["ticks"]
