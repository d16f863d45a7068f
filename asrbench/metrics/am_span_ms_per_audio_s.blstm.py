"""AM milliseconds per audio second on the chain BLSTM: the CUDA-event
seconds of the program's `logp` spans (fbank, the chunk windows' gather,
the BLSTM over them, the output affine at the kept rows and their
scatter, each window call of `batched_logp`), summed, over the audio
they carried."""


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" or not rec.get("logp_device_s"):
        return None
    return 1e3 * rec["logp_device_s"] / rec["audio_s"]
