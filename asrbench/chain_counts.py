"""The chain cell's FLOP counts, from the configuration's widths alone:
the yardstick for `am_flop_ratio.chain`, `am_mfu.chain` and
`step_mfu.chain` (beside `counts.py`, whose decoder bytes the chain kind
also counts).

The plan is the least the TDNN-F's equations need for one output row,
every `frame_subsampling_factor` f input frames: lda, tdnn1 and the
blocks before the first whose stride f divides run at every 10 ms frame
(f rows an output row), the rest once an output row.  A linear costs two
FLOPs a multiply-add; the elementwise work (bias, ReLU, batchnorm, the
bypass) is not counted, as the program's own `am_flops` counter does not
count it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from asrbench.chain_gen import tdnnf_shapes


def stack_flops(am: Dict, num_pdfs: int) -> Tuple[float, float]:
    """(FLOPs a 10 ms row of the full-rate part, FLOPs an output row of
    the subsampled part)."""
    f = am["frame_subsampling_factor"]
    sh = tdnnf_shapes(am, num_pdfs)

    def mm(i, o):
        return 2.0 * i * o

    full = mm(*sh["lda"]) + mm(*sh["tdnn1"])
    sub = 0.0
    subsampled = False
    for s, (i1, o1, i2, o2) in zip(am["time_strides"], sh["blocks"]):
        subsampled = subsampled or s % f == 0
        cost = mm(i1, o1) + mm(i2, o2)
        if subsampled:
            sub += cost
        else:
            full += cost
    sub += sum(mm(*sh[k]) for k in ("prefinal_l", "w1", "w2", "output"))
    return full, sub


def stack_flops_per_frame(am: Dict, num_pdfs: int) -> float:
    """The AM stack's planned FLOPs an output row."""
    full, sub = stack_flops(am, num_pdfs)
    return am["frame_subsampling_factor"] * full + sub


def frontend_flops_per_frame(am: Dict, num_bins: int = 40) -> float:
    """The fbank's FLOPs an output row (`counts.am_flops_per_frame`'s FFT
    and mel bank, f times); the MFCC's DCT is folded into lda."""
    per = 5 * 512 * math.log2(512) + 3 * 257 + 2 * 257 * num_bins
    return am["frame_subsampling_factor"] * per
