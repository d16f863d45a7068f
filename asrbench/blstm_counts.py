"""The BLSTM cell's counts, from the configuration's widths, its chunk
settings and the utterances' lengths alone: the yardstick for
`am_mfu.blstm`, `step_mfu.blstm` and `lstm_recurrence_roofline.blstm`.

The plan is what Kaldi computes (`nnet-am-decodable-simple.cc`): each
utterance of S output rows (f = `frame_subsampling_factor` frames a row)
cut into chunks of `frames_per_chunk` / f kept rows, each chunk's window
adding extra_left_context // f rows before them and extra_right_context
// f after (the `_initial` and `_final` settings at the utterance's edges,
where >= 0), every quantity computed only where the outputs need it:
lda and both directions of every BLSTM layer but the last at every row
of the window, the last layer's forward LSTMP at the rows up to the last
kept one and its backward LSTMP from the first kept one, the output
affine at the kept rows.  An LSTMP is its W_all [in + R, 4C] and its
projection [C, R + P]; a linear costs two FLOPs a multiply-add, the
elementwise work is not counted (as the program's `am_flops` does not
count it); the fbank is `chain_counts`'s, at the valid rows.

The recurrence's least time, one launch a layer, direction and batch,
over the rows that direction steps in the plan, is the larger of
- FLOPs at the FP32 peak: a step of a row is the recurrent half of W_all,
  2 R 4C, the projection, 2 C (R + P), and `lstm_counts.CELL_FLOPS` a
  cell;
- compulsory bytes at the HBM peak: W_r, W_rp, b_rp and the peepholes
  once a launch, each step's gate inputs (4C) read once, and r, p and c
  (R + P + C) written once, float32.
It depends on the widths, the settings and the lengths, not on the
implementation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from asrbench.blstm_gen import layer_shapes
from asrbench.lstm_counts import CELL_FLOPS


def chunk_rows(rows: int, chunk: Dict, factor: int
               ) -> List[Tuple[int, int, int]]:
    """An utterance's chunks as (left, kept, right) rows."""
    per = -(-chunk["frames_per_chunk"] // factor)
    out = []
    for first in range(0, rows, per):
        kept = min(per, rows - first)
        left = chunk["extra_left_context"]
        if first == 0 and chunk["extra_left_context_initial"] >= 0:
            left = chunk["extra_left_context_initial"]
        right = chunk["extra_right_context"]
        if first + kept == rows and chunk["extra_right_context_final"] >= 0:
            right = chunk["extra_right_context_final"]
        out.append((left // factor, kept, right // factor))
    return out


def windows(am: Dict, chunk: Dict, rows: Sequence[int]
            ) -> List[Tuple[int, int, int]]:
    """Every chunk of utterances of the given output rows."""
    f = am["frame_subsampling_factor"]
    return [c for n in rows for c in chunk_rows(n, chunk, f)]


def direction_rows(am: Dict, chunk: Dict, rows: Sequence[int]
                   ) -> List[Tuple[int, int]]:
    """Per BLSTM layer, the (forward, backward) rows its LSTMPs step over
    every chunk of the utterances."""
    ws = windows(am, chunk, rows)
    whole = sum(l + k + r for l, k, r in ws)
    out = [(whole, whole)] * (len(am["layers"]) - 1)
    out.append((sum(l + k for l, k, _ in ws), sum(k + r for _, k, r in ws)))
    return out


def stack_flops(am: Dict, chunk: Dict, num_pdfs: int,
                rows: Sequence[int]) -> float:
    """The stack's planned FLOPs for utterances of the given output rows
    (lda, the BLSTMs and the output; no fbank)."""
    shapes = layer_shapes(am, num_pdfs)
    ws = windows(am, chunk, rows)
    whole = sum(l + k + r for l, k, r in ws)
    (_, _, [lda]), *body, (_, _, [out]) = shapes
    total = 2.0 * lda[0] * lda[1] * whole
    for (_, _, (w_f, p_f, w_b, p_b)), (fw, bw) in zip(
            body, direction_rows(am, chunk, rows)):
        total += 2.0 * fw * (w_f[0] * w_f[1] + p_f[0] * p_f[1])
        total += 2.0 * bw * (w_b[0] * w_b[1] + p_b[0] * p_b[1])
    return total + 2.0 * out[0] * out[1] * sum(rows)


def recurrence_least_s(am: Dict, chunk: Dict,
                       batches: Sequence[Sequence[int]],
                       peaks: Dict) -> float:
    """The recurrences' least time over batches of utterances of the
    given output rows (see the module docstring)."""
    c, r = am["cell_dim"], am["recurrent_projection_dim"]
    oc = r + am["non_recurrent_projection_dim"]
    per_step_flops = 2.0 * r * 4 * c + 2.0 * c * oc + CELL_FLOPS * c
    once = 4.0 * (r * 4 * c + c * oc + oc + 3 * c)
    per_step_bytes = 4.0 * (4 * c + oc + c)
    total = 0.0
    for rows in batches:
        for pair in direction_rows(am, chunk, rows):
            for n in pair:
                total += max(n * per_step_flops / peaks["fp32_flops_per_s"],
                             (once + n * per_step_bytes)
                             / peaks["hbm_bytes_per_s"])
    return total
