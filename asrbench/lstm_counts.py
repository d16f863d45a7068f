"""The TDNN-LSTM cell's counts, from the configuration's widths and the
utterances' lengths alone: the yardstick for `am_mfu.lstm`,
`step_mfu.lstm` and `lstm_recurrence_roofline.lstm`.

The plan is the least the equations need for one output row, every
f = `frame_subsampling_factor` input frames: lda and the TDNN layers read
at every frame (those before the first layer computed only at every f-th
frame: lda, tdnn1, tdnn2) f times, the rest once (tdnn3, which reads
tdnn2 at the frames between, and every layer after it).  An LSTMP layer
is its W_all [in + R, 4C] and its projection [C, R + P].  A linear costs
two FLOPs a multiply-add; the elementwise work is not counted, as the
program's `am_flops` counter does not count it.

The recurrence's least time, per LSTMP layer and batch, over the steps
the valid outputs need (each utterance's own: its output rows plus the
rows of context the layers after the LSTM read), is the larger of
- FLOPs at the FP32 peak: a step of a batch row is the recurrent half of
  W_all, 2 R 4C, the projection, 2 C (R + P), and the cell's elementwise
  work, `CELL_FLOPS` a cell;
- compulsory bytes at the HBM peak: W_r, W_rp, b_rp and the peepholes
  once a launch, each step's gate inputs (4C) read once, and r, p and c
  (R + P + C) written once, float32.
It depends on the widths and the lengths, not on the implementation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from asrbench.lstm_gen import layer_shapes

# The cell's elementwise FLOPs a step: the four gate-input adds, s c(t-1),
# three peephole multiply-adds, three sigmoids and two tanh (one FLOP
# each), c(t)'s two multiplies and add, and m(t)'s multiply.
CELL_FLOPS = 4 + 1 + 6 + 5 + 3 + 1


def first_subsampled(am: Dict) -> int:
    """Index in `am["layers"]` of the first layer computed only at every
    f-th frame: the layer before which the frames between are last read
    (offsets that are not multiples of f)."""
    f = am["frame_subsampling_factor"]
    last = max((i for i, x in enumerate(am["layers"])
                if x["kind"] == "tdnn" and any(o % f for o in x["offsets"])),
               default=-1)
    return max(last, 0)


def stack_flops(am: Dict, num_pdfs: int):
    """(FLOPs a 10 ms row of the full-rate part, FLOPs an output row of
    the subsampled part)."""
    shapes = layer_shapes(am, num_pdfs)
    cut = 1 + first_subsampled(am)  # shapes[0] is lda
    full = sum(2.0 * i * o for _, _, mats in shapes[:cut] for i, o in mats)
    sub = sum(2.0 * i * o for _, _, mats in shapes[cut:] for i, o in mats)
    return full, sub


def stack_flops_per_frame(am: Dict, num_pdfs: int) -> float:
    """The AM stack's planned FLOPs an output row."""
    full, sub = stack_flops(am, num_pdfs)
    return am["frame_subsampling_factor"] * full + sub


def context_after(am: Dict) -> List[int]:
    """Per LSTMP layer, the rows of context the layers after it read
    beyond the output rows (at its rate): their offsets' span over f."""
    f = am["frame_subsampling_factor"]
    out, rows = [], 0
    for x in reversed(am["layers"]):
        if x["kind"] == "lstmp":
            out.append(rows)
        else:
            rows += (max(x["offsets"]) - min(x["offsets"])) // f
    return out[::-1]


def recurrence_steps(am: Dict, rows: Sequence[int]) -> List[List[int]]:
    """Per LSTMP layer, each utterance's steps its valid outputs need, for
    utterances of `rows` output rows."""
    return [[n + extra for n in rows] for extra in context_after(am)]


def recurrence_least_s(am: Dict, batches: Sequence[Sequence[int]],
                       peaks: Dict) -> float:
    """The recurrences' least time over batches of utterances of the
    given output rows (one launch a layer and batch; see the module
    docstring)."""
    c, r = am["cell_dim"], am["recurrent_projection_dim"]
    oc = r + am["non_recurrent_projection_dim"]
    per_step_flops = 2.0 * r * 4 * c + 2.0 * c * oc + CELL_FLOPS * c
    once = 4.0 * (r * 4 * c + c * oc + oc + 3 * c)
    per_step_bytes = 4.0 * (4 * c + oc + c)
    total = 0.0
    for rows in batches:
        for steps in recurrence_steps(am, rows):
            n = sum(steps)
            total += max(n * per_step_flops / peaks["fp32_flops_per_s"],
                         (once + n * per_step_bytes)
                         / peaks["hbm_bytes_per_s"])
    return total
