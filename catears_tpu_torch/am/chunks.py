"""Kaldi's chunked evaluation of an acoustic model whose stack has a
backward recurrence (the chain BLSTM), which cannot be run looped: its
backward direction needs the future.

Kaldi (`nnet3/nnet-am-decodable-simple.cc`, `DecodableNnetSimple::
EnsureFrameIsComputed`) cuts an utterance of S = ceil(T / f) output rows
(f the frame subsampling factor) into chunks of `frames_per_chunk` input
frames, rounded up to a multiple of f, that is cs = frames_per_chunk / f
output rows: chunk k keeps the rows k cs .. min((k + 1) cs, S) - 1.  Each
chunk is computed on its own, from zero recurrent state, over an input
window that adds `extra_left_context` frames before its first output
frame and `extra_right_context` after its last, beside the model's own
context; at the utterance's start the left one is
`extra_left_context_initial` and at its end the right one
`extra_right_context_final` where those are >= 0.  Input frames outside
the utterance are its edge frames repeated.  A layer at f frames a row is
computed at the rows whose own input the window holds: e rows of extra
context, e = extra // f, on each side.  So each recurrence of the chunk
runs over the rows first - e_l .. last + e_r, the forward one from the
first of them and the backward one from the last.

`ChunkOptions` holds the settings under Kaldi's option names;
`plan_chunks` cuts a batch of utterances into one batch of windows,
padded to the widest; `ChunkPlan.upload` puts the integers the card needs
(the windows' input frames, each window's rows, the kept rows' places) on
the card in one copy.  `AcousticModel.forward_padded` gathers every
window's input in one gather, runs the stack over the windows (each
backward chain from its window's own last row, `am.nnet.blstmp`), takes
the kept rows only through the layers after the last recurrence (the
output affine) and scatters them into [B, rows_max, P]; spans `am.chunks`
(chunks, window, batch; part gather or scatter), counters `am_chunks`,
`am_chunk_rows` (windows x the widest window's rows: what the
recurrences step, padding included) and `am_chunk_rows_needed` (the
windows' own rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.utils.errors import CorruptionError

OPTION_NAMES = ("frames_per_chunk", "extra_left_context",
                "extra_right_context", "extra_left_context_initial",
                "extra_right_context_final")


@dataclass(frozen=True)
class ChunkOptions:
    """Kaldi's decode settings for chunked evaluation, in input frames
    (`nnet3-latgen-faster --frames-per-chunk ...`); the initial and final
    contexts -1: the extra contexts apply at the edges too."""

    frames_per_chunk: int
    extra_left_context: int = 0
    extra_right_context: int = 0
    extra_left_context_initial: int = -1
    extra_right_context_final: int = -1

    def __post_init__(self):
        if self.frames_per_chunk < 1 or self.extra_left_context < 0 \
                or self.extra_right_context < 0 \
                or self.extra_left_context_initial < -1 \
                or self.extra_right_context_final < -1:
            raise CorruptionError(f"chunk settings {self}: frames_per_chunk "
                                  f">= 1, extra contexts >= 0 (-1 at the "
                                  f"edges: as elsewhere)")

    @classmethod
    def from_config(cls, conf: Configuration) -> Optional["ChunkOptions"]:
        """The settings a configuration gives (None where it sets no
        `frames_per_chunk`; the others default as Kaldi's)."""
        if not conf.has("frames_per_chunk"):
            extra = [k for k in OPTION_NAMES[1:] if conf.has(k)]
            if extra:
                raise CorruptionError(f"{', '.join(extra)} without "
                                      f"frames_per_chunk")
            return None
        return cls(*(conf.get_int(k, d) for k, d in zip(
            OPTION_NAMES, (None, 0, 0, -1, -1))))

    def rows_per_chunk(self, factor: int) -> int:
        """Output rows a chunk keeps: frames_per_chunk rounded up to a
        multiple of the subsampling factor, over it."""
        return -(-self.frames_per_chunk // factor)


@dataclass
class ChunkPlan:
    """A batch's chunks, in utterance order and chunk order: for each, its
    utterance, its first kept output row, its kept rows and its rows of
    extra context left and right (at the output rate)."""

    utt: np.ndarray
    first: np.ndarray
    kept: np.ndarray
    left: np.ndarray
    right: np.ndarray
    factor: int
    rows_max: int  # the longest utterance's output rows

    @property
    def chunks(self) -> int:
        return int(self.utt.size)

    @property
    def rows(self) -> np.ndarray:
        """Each window's rows."""
        return self.left + self.kept + self.right

    @property
    def width(self) -> int:
        """The widest window's rows (every window is padded to it)."""
        return int(self.rows.max())

    def upload(self, frames: Sequence[int], left_context: int,
               right_context: int, padded_len: int, device) -> "ChunkIndex":
        """The card's indices, made from one host array in one copy.
        `frames`: each utterance's valid frames; the input is the batch's
        context-padded features, [B, padded_len, D] with utterance frame t
        at row t + left_context.  The kept rows' places: window row
        (chunk x width + left + j) and output row (utt x rows_max + first
        + j)."""
        f, w = self.factor, self.width
        span = f * (w - 1) + 1 + left_context + right_context
        start = f * (self.first - self.left) - left_context
        last = np.asarray(frames, np.int64)[self.utt] - 1
        reps = self.kept
        j = np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps,
                                                   reps)
        n = np.repeat(np.arange(self.chunks), reps)
        src = n * w + self.left[n] + j
        dst = self.utt[n] * self.rows_max + self.first[n] + j
        host = np.concatenate([start, last, self.utt, self.rows, src,
                               dst]).astype(np.int64)
        dev = torch.from_numpy(host).to(device)
        c = self.chunks
        start_d, last_d, utt_d, rows_d = dev[:4 * c].view(4, c)
        offs = torch.arange(span, device=dev.device)
        frame = torch.minimum(torch.clamp(start_d[:, None] + offs[None, :],
                                          min=0), last_d[:, None])
        rows_in = frame + left_context + utt_d[:, None] * padded_len
        k = reps.sum()
        return ChunkIndex(rows_in, utt_d, rows_d, dev[4 * c:4 * c + k],
                          dev[4 * c + k:])


@dataclass
class ChunkIndex:
    """On the card: each window's input rows in the flattened padded
    features [chunks, span], each window's utterance and rows [chunks],
    and the kept rows' sources and destinations [kept]."""

    rows_in: torch.Tensor
    utt: torch.Tensor
    rows: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor


def plan_chunks(out_rows: Sequence[int], opts: ChunkOptions,
                factor: int) -> ChunkPlan:
    """Cut utterances of the given output rows into Kaldi's chunks (the
    module docstring); an utterance of no row has no chunk."""
    cs = opts.rows_per_chunk(factor)
    initial = opts.extra_left_context_initial
    final = opts.extra_right_context_final
    cols = [[], [], [], [], []]
    for u, s in enumerate(out_rows):
        for first in range(0, s, cs):
            kept = min(cs, s - first)
            left = opts.extra_left_context
            if first == 0 and initial >= 0:
                left = initial
            right = opts.extra_right_context
            if first + kept == s and final >= 0:
                right = final
            for col, v in zip(cols, (u, first, kept, left // factor,
                                     right // factor)):
                col.append(v)
    if not cols[0]:
        raise ValueError("plan_chunks: no utterance has an output row")
    utt, first, kept, left, right = (np.asarray(c, np.int64) for c in cols)
    return ChunkPlan(utt, first, kept, left, right, factor,
                     max(out_rows))
