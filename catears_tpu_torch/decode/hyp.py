"""Host-side backtrace of decoder backpointer traces -> word sequences
(port of catears_tpu/decode/hyp.py).

The decoder emits a per-frame backpointer trace (prev_slot, words); the
host walks it backwards from the best final slot.  `backtrace` walks in
Python, or in the native library from 64 frames on, as the JAX package's;
`IncrementalBacktracker` refreshes a streaming partial hypothesis by
walking only the frames since the last refresh; `assemble_words` turns the
device backtrace of the batch path into a transcript.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from catears_tpu_torch.decode.oracle import Hypothesis
from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst


@dataclass
class HostTrace:
    """One frame's compact trace for one utterance (numpy FrameTrace)."""

    prev_slot: np.ndarray  # i32 [K]
    words: np.ndarray  # i32 [K, W] newest-first, 0-padded


def backtrace(traces: List[HostTrace], slot: int) -> List[int]:
    """Follow prev_slot links from `slot` in the last trace to the root."""
    if not traces:
        return []
    if len(traces) >= 64:
        # Long utterances: the native C++ walker beats the per-frame Python
        # loop once stacking the traces is amortized.
        from catears_tpu_torch.utils import native
        if native.available():
            prev = np.stack([t.prev_slot for t in traces])
            words = np.stack([t.words for t in traces])
            out = native.backtrace(prev, words, slot)
            if out is not None:
                return out
    words_rev: List[int] = []
    cur = slot
    for f in range(len(traces) - 1, -1, -1):
        t = traces[f]
        for w in t.words[cur]:
            if w > 0:
                words_rev.append(int(w))
        cur = int(t.prev_slot[cur])
        if cur < 0:
            break
    return words_rev[::-1]


def assemble_words(frame_words: np.ndarray) -> List[int]:
    """[T, W] device-backtrace output -> transcript word-id list.

    Each frame's W slots are newest-first, so the forward transcript walks
    frames in order and reverses within each frame.
    """
    out: List[int] = []
    for row in frame_words:
        out.extend(int(w) for w in row[::-1] if w > 0)
    return out


class IncrementalBacktracker:
    """Amortized-O(1) partial hypotheses over a growing trace list.

    Backpointer chains are functional (a given (frame, slot) pair always
    denotes the same history), so each refresh walks backwards only until
    it reaches a (frame, slot) on the previous refresh's path, then splices
    the memoized word prefix.  Hypothesis paths share long prefixes across
    refreshes, so the walk usually covers just the frames decoded since the
    last one (a full walk per refresh makes a long stream O(T^2)).
    """

    def __init__(self) -> None:
        self._path_slot: List[int] = []  # slot read at frame f on the path
        self._wcount: List[int] = []  # words emitted by frames [0..f]
        self._words: List[int] = []  # the path's full word sequence

    def best_words(self, traces: List[HostTrace], slot: int) -> List[int]:
        t = len(traces)
        suffix_rev: List[int] = []  # words of the newly-walked frames, rev
        new_slots: List[int] = []  # slots visited, newest frame first
        cur = slot
        splice = -1  # frame index whose memoized prefix we reuse
        for f in range(t - 1, -1, -1):
            if f < len(self._path_slot) and self._path_slot[f] == cur:
                splice = f
                break
            new_slots.append(cur)
            tr = traces[f]
            for w in tr.words[cur]:
                if w > 0:
                    suffix_rev.append(int(w))
            cur = int(tr.prev_slot[cur])
            if cur < 0:
                break  # chain rooted: frames below contribute nothing
        start = t - len(new_slots)  # first frame the walk visited
        if splice >= 0:
            prefix_count = self._wcount[splice]
            del self._path_slot[start:]
            del self._wcount[start:]
        else:
            prefix_count = 0
            # Rooted walk: frames below `start` are off-path; sentinel
            # slots (-2) never match a real slot in a future walk.
            self._path_slot = [-2] * start
            self._wcount = [0] * start
        words = self._words[:prefix_count] + suffix_rev[::-1]
        self._words = words
        count = prefix_count
        for i, s in enumerate(reversed(new_slots)):
            tr = traces[start + i]
            count += int(np.count_nonzero(tr.words[s] > 0))
            self._path_slot.append(s)
            self._wcount.append(count)
        return words


def best_path(
    traces: List[HostTrace],
    states: np.ndarray,  # i32 [K] final beam HCLG states
    lm_states: np.ndarray,  # i32 [K]
    costs: np.ndarray,  # f32 [K]
    fst: FlatFst,
    delta_lm: Optional[DeltaLmFst] = None,
    end_of_stream: bool = True,
    tracker: Optional[IncrementalBacktracker] = None,
) -> Hypothesis:
    """Pick the best final token and backtrace it (Decoder::BestPath).

    Pass a persistent `tracker` when calling repeatedly over a growing
    trace list (streaming partial hypotheses): the walk then costs the
    frames since the last call instead of the whole stream.
    """
    total = costs.astype(np.float64).copy()
    if end_of_stream:
        valid = states >= 0
        idx = np.where(valid, states, 0)
        total += np.where(valid, fst.final[idx], np.inf)
        if delta_lm is not None:
            for i in np.nonzero(valid & np.isfinite(total))[0]:
                total[i] += delta_lm.final(int(lm_states[i]))
    total[states < 0] = np.inf
    if not np.isfinite(total).any():
        return Hypothesis([], 0.0)
    best_slot = int(np.argmin(total))
    words = (tracker.best_words(traces, best_slot) if tracker is not None
             else backtrace(traces, best_slot))
    return Hypothesis(words, float(total[best_slot]))
