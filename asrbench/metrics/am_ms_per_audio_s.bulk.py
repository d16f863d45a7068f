"""AM milliseconds per audio second: CUDA events around the window's
`batched_logp` calls (fbank + AM), summed, over the audio they carried."""


def read(rec):
    if rec.get("kind") != "bulk":
        return None
    return 1e3 * rec["am_s"] / rec["audio_s"]
