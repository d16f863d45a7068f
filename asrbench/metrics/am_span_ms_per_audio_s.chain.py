"""AM milliseconds per audio second on a chain model: the CUDA-event
seconds of the program's `logp` spans (fbank + TDNN-F, each window call
of `batched_logp`), summed, over the audio they carried."""


def read(rec):
    if rec.get("kind") != "bulk_chain" or not rec.get("logp_device_s"):
        return None
    return 1e3 * rec["logp_device_s"] / rec["audio_s"]
