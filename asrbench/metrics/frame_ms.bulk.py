"""Milliseconds a decoder frame: the wall time of the window's
`BatchDecoder.decode` calls over every frame they stepped."""


def read(rec):
    if rec.get("kind") != "bulk":
        return None
    return 1e3 * rec["decode_s"] / rec["frames_stepped"]
