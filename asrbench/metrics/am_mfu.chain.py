"""The TDNN-F's share of the float32 peak: the benchmark's planned AM
FLOPs of the window's valid output rows (`chain_counts`: the stack and the
fbank) at the card's FP32 rate over the device seconds of the program's
`logp` spans."""


def read(rec):
    if rec.get("kind") != "bulk_chain" or not rec.get("logp_device_s"):
        return None
    least = rec["am_flops"] / rec["peaks"]["fp32_flops_per_s"]
    return 100.0 * least / rec["logp_device_s"]
