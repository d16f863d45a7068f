"""Host-side backtrace of decoder backpointer traces -> word sequences
(port of catears_tpu/decode/hyp.py).

The decoder emits a per-frame backpointer trace (prev_slot, words); the
host walks it backwards from the best final slot, which `pick_final`
chooses for every decoder.  `backtrace` walks in Python, or in the native
library from 64 frames on, as the JAX package's;
`IncrementalBacktracker` refreshes a streaming partial hypothesis by
walking only the frames since the last refresh; `assemble_words_batch`
turns the device backtrace of the batch path into transcripts, one numpy
pass for the batch (`assemble_words`: one utterance).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence

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


def assemble_words_batch(frame_words: np.ndarray,
                         rows: Sequence[int]) -> List[List[int]]:
    """[B, T, W] device-backtrace output -> B transcript word-id lists, in
    one numpy pass over the batch.

    Utterance u reads its first `rows[u]` frames.  Each frame's W slots are
    newest-first, so the forward transcript walks frames in order and
    reverses within each frame; the ids > 0 are the words.
    """
    fw = np.asarray(frame_words)
    b, t, w = fw.shape
    flat = fw[:, :, ::-1].reshape(b, t * w)
    keep = ((flat > 0)
            & (np.arange(t * w) < np.asarray(rows, np.int64)[:, None] * w))
    counts = keep.sum(axis=1).tolist()
    words = flat[keep].tolist()  # row-major: utterance by utterance
    ends = itertools.accumulate(counts)
    return [words[e - n:e] for e, n in zip(ends, counts)]


def assemble_words(frame_words: np.ndarray) -> List[int]:
    """[T, W] device-backtrace output -> transcript word-id list (one
    utterance of `assemble_words_batch`, all T frames)."""
    fw = np.asarray(frame_words)
    return assemble_words_batch(fw[None], [fw.shape[0]])[0]


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


def pick_final(states: np.ndarray, lms: np.ndarray, costs: np.ndarray,
               final: np.ndarray, delta_lm: Optional[DeltaLmFst],
               end_of_stream: bool = True, fallback: bool = False):
    """Each row's best final token over [B, K] beam rows (Decoder::BestPath
    for a batch): (slot [B] int64, total [B] float64, empty [B] bool).

    The float64 total is the cost, plus the graph's `final` weight of live
    slots at end of stream, plus the delta-LM final of the slots still
    finite (taken once per LM state of the batch); dead slots are +inf and
    the first minimum wins.  A row with no finite total is `empty` (slot 0,
    total 0), unless `fallback` takes its cheapest live token regardless of
    final weight and reports that cost.
    """
    ok = states >= 0
    total = costs.astype(np.float64)
    if end_of_stream:
        total += np.where(ok, final[np.where(ok, states, 0)], np.inf)
        if delta_lm is not None:
            live = ok & np.isfinite(total)
            uniq, inv = np.unique(lms[live], return_inverse=True)
            lm_final = np.array([delta_lm.final(int(s)) for s in uniq],
                                np.float64)
            total[live] += lm_final[inv.ravel()]
    total[~ok] = np.inf
    empty = ~np.isfinite(total).any(axis=1)
    if fallback:
        total = np.where(empty[:, None], np.where(ok, costs, np.inf), total)
        empty = np.zeros_like(empty)
    slot = np.argmin(total, axis=1)
    best = np.take_along_axis(total, slot[:, None], axis=1)[:, 0]
    slot[empty] = 0
    best[empty] = 0.0
    return slot, best, empty


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
    """Pick the best final token (`pick_final` on one row) and backtrace it
    (Decoder::BestPath).

    Pass a persistent `tracker` when calling repeatedly over a growing
    trace list (streaming partial hypotheses): the walk then costs the
    frames since the last call instead of the whole stream.
    """
    slot, total, empty = pick_final(states[None], lm_states[None],
                                    costs[None], fst.final, delta_lm,
                                    end_of_stream)
    if empty[0]:
        return Hypothesis([], 0.0)
    best_slot = int(slot[0])
    words = (tracker.best_words(traces, best_slot) if tracker is not None
             else backtrace(traces, best_slot))
    return Hypothesis(words, float(total[0]))
