"""FLOPs the TDNN-F stack enqueued over its plan: the program's
`am_flops` counter over the window, over the benchmark's planned FLOPs an
output row (`chain_counts.stack_flops_per_frame`) times the output rows
the stack put out (the program's `am_rows_subsampled`).  1 where the
stride-3 layers run on the subsampled grid (a little above: the context
rows), about 2.2 where every layer runs at every 10 ms frame."""


def read(rec):
    if rec.get("kind") != "bulk_chain" or not rec.get("am_rows_subsampled"):
        return None
    return rec["program_am_flops"] / (rec["am_rows_subsampled"]
                                      * rec["stack_flops_per_frame"])
