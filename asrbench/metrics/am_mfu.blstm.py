"""The BLSTM's share of the float32 peak: the benchmark's planned AM
FLOPs of the window's batches (`blstm_counts`: Kaldi's chunk windows,
each quantity where the outputs need it, the output affine at the kept
rows, and the fbank at the valid rows) at the card's FP32 rate over the
device seconds of the program's `logp` spans."""


def read(rec):
    if rec.get("kind") != "bulk_chain_blstm" or not rec.get("logp_device_s"):
        return None
    least = rec["am_flops"] / rec["peaks"]["fp32_flops_per_s"]
    return 100.0 * least / rec["logp_device_s"]
