"""WFST graph layer: flat CSR arc tables (the port's copy of
catears_tpu/graph/fst.py).

Host-side (numpy) FSTs used for loading and the decoder's host work; the
device tables are built from them by `graph/device.py`.

Behavioral parity targets:
  - `FlatFst` ~ reference `Fst` (pk::fst_0; src/fst.cc:51-173)
  - `LmFst` backoff semantics (src/fst.cc:199-251): a missing ilabel follows
    the state's epsilon backoff arc (always the first arc of the span, input
    label 0) recursively, accumulating its weight; final weights follow the
    backoff chain too.
  - `DeltaLmFst` (src/fst.cc:253-290): big-LM G' score minus unigram G score
    (vector lookup), auto-transducing <s> at start and </s> at final.

Arcs are stored sorted by (state, ilabel); each state's span is
[offsets[s], offsets[s+1]).  Epsilon (ilabel 0) arcs therefore form a prefix
of every span, which the device decoder exploits to split emitting/epsilon
expansion without flag gathers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from catears_tpu_torch.io.binfmt import RawFst, read_pkfst_file
from catears_tpu_torch.io.openfst import ConstFst, read_const_fst_file
from catears_tpu_torch.io.symbols import SymbolTable

INF = np.float32(np.inf)


@dataclass
class FlatFst:
    """Immutable WFST over flat CSR arrays (arcs sorted by (state, ilabel))."""

    start: int
    final: np.ndarray  # f32 [S], +inf for non-final
    offsets: np.ndarray  # i64 [S+1]
    arc_next: np.ndarray  # i32 [A]
    arc_ilabel: np.ndarray  # i32 [A]
    arc_olabel: np.ndarray  # i32 [A]
    arc_weight: np.ndarray  # f32 [A]

    @property
    def num_states(self) -> int:
        return self.final.size

    @property
    def num_arcs(self) -> int:
        return self.arc_next.size

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, start, final, state_of_arc, arc_next, arc_ilabel,
                    arc_olabel, arc_weight) -> "FlatFst":
        """Build from unsorted parallel arc arrays."""
        final = np.asarray(final, np.float32)
        state_of_arc = np.asarray(state_of_arc, np.int64)
        order = np.lexsort((np.asarray(arc_ilabel), state_of_arc))
        state_sorted = state_of_arc[order]
        n_states = final.size
        counts = np.bincount(state_sorted, minlength=n_states)
        offsets = np.zeros(n_states + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(
            start=int(start),
            final=final,
            offsets=offsets,
            arc_next=np.asarray(arc_next, np.int32)[order],
            arc_ilabel=np.asarray(arc_ilabel, np.int32)[order],
            arc_olabel=np.asarray(arc_olabel, np.int32)[order],
            arc_weight=np.asarray(arc_weight, np.float32)[order],
        )

    def to_raw(self) -> RawFst:
        """Inverse of from_raw: pk::fst_0 image (first_arc = -1 if arcless)."""
        has = self.offsets[:-1] < self.offsets[1:]
        first = np.where(has, self.offsets[:-1], -1).astype(np.int32)
        return RawFst(start=self.start, final=self.final,
                      first_arc=first, arc_next=self.arc_next,
                      arc_ilabel=self.arc_ilabel, arc_olabel=self.arc_olabel,
                      arc_weight=self.arc_weight)

    @classmethod
    def from_raw(cls, raw: RawFst) -> "FlatFst":
        """From a pk::fst_0 file image (already (state, ilabel)-sorted)."""
        n_states = raw.num_states
        n_arcs = raw.num_arcs
        # first_arc is -1 for arcless states: forward-fill from the right to
        # recover CSR offsets (reference CountArcs scan, src/fst.cc:113-129).
        offsets = np.empty(n_states + 1, np.int64)
        offsets[n_states] = n_arcs
        nxt = n_arcs
        first = raw.first_arc
        for s in range(n_states - 1, -1, -1):
            if first[s] >= 0:
                nxt = first[s]
            offsets[s] = nxt
        return cls(
            start=raw.start,
            final=raw.final.copy(),
            offsets=offsets,
            arc_next=raw.arc_next.copy(),
            arc_ilabel=raw.arc_ilabel.copy(),
            arc_olabel=raw.arc_olabel.copy(),
            arc_weight=raw.arc_weight.copy(),
        )

    @classmethod
    def from_const_fst(cls, cf: ConstFst) -> "FlatFst":
        """From an OpenFST ConstFst (arc order re-sorted by (state, ilabel))."""
        state_of_arc = np.repeat(
            np.arange(cf.num_states, dtype=np.int64), cf.arc_count)
        return cls.from_arrays(cf.start, cf.final, state_of_arc, cf.arc_next,
                               cf.arc_ilabel, cf.arc_olabel, cf.arc_weight)

    @classmethod
    def read(cls, path: str) -> "FlatFst":
        """Load either format by sniffing the file magic.

        ConstFst parsing prefers the native C++ parser when available.
        """
        with open(path, "rb") as fd:
            head = fd.read(9)
        if head == b"pk::fst_0":
            return cls.from_raw(read_pkfst_file(path))
        from catears_tpu_torch.utils import native
        if native.available():
            with open(path, "rb") as fd:
                parsed = native.parse_const_fst(fd.read())
            if parsed is not None:
                start, final, pos, cnt, arcs = parsed
                state_of_arc = np.repeat(
                    np.arange(final.size, dtype=np.int64), cnt)
                return cls.from_arrays(
                    start, final, state_of_arc, arcs[:, 3], arcs[:, 0],
                    arcs[:, 1], arcs[:, 2].view(np.float32))
        return cls.from_const_fst(read_const_fst_file(path))

    # -- queries (host side) -----------------------------------------------

    def arc_range(self, state: int) -> Tuple[int, int]:
        return int(self.offsets[state]), int(self.offsets[state + 1])

    def num_eps(self, state: int) -> int:
        lo, hi = self.arc_range(state)
        return int(np.searchsorted(self.arc_ilabel[lo:hi], 1))

    def get_arc(self, state: int, ilabel: int) -> Optional[int]:
        """Arc index of (state, ilabel) via binary search, or None."""
        lo, hi = self.arc_range(state)
        pos = lo + int(np.searchsorted(self.arc_ilabel[lo:hi], ilabel))
        if pos < hi and self.arc_ilabel[pos] == ilabel:
            return pos
        return None

    def final_weight(self, state: int) -> float:
        return float(self.final[state])


class LmFst(FlatFst):
    """Backoff LM as an FST: epsilon arc = backoff (always first in span)."""

    @classmethod
    def read_lm(cls, path: str) -> "LmFst":
        base = FlatFst.read(path)
        return cls(**base.__dict__)

    def _backoff_arc(self, state: int) -> Optional[int]:
        lo, hi = self.arc_range(state)
        if lo < hi and self.arc_ilabel[lo] == 0:
            return lo
        return None

    def get_arc_backoff(self, state: int, ilabel: int):
        """(next_state, weight) following backoff chain, or None."""
        assert ilabel != 0, "invalid ilabel"
        weight = 0.0
        while True:
            pos = self.get_arc(state, ilabel)
            if pos is not None:
                return int(self.arc_next[pos]), weight + float(self.arc_weight[pos])
            bo = self._backoff_arc(state)
            if bo is None:
                return None
            weight += float(self.arc_weight[bo])
            state = int(self.arc_next[bo])

    def final_backoff(self, state: int) -> float:
        weight = 0.0
        while True:
            final = float(self.final[state])
            if math.isfinite(final):
                return final + weight
            bo = self._backoff_arc(state)
            if bo is None:
                return float("inf")
            weight += float(self.arc_weight[bo])
            state = int(self.arc_next[bo])


class DeltaLmFst:
    """On-the-fly rescoring FST: big-LM G' minus unigram-G cost vector."""

    def __init__(self, small_lm: np.ndarray, lm: LmFst,
                 symbol_table: SymbolTable):
        self.small_lm = np.asarray(small_lm, np.float32)
        self.lm = lm
        self.bos_id = symbol_table.bos_id
        self.eos_id = symbol_table.eos_id

    def start_state(self) -> int:
        hit = self.lm.get_arc_backoff(self.lm.start, self.bos_id)
        if hit is None:
            return self.lm.start
        return hit[0]

    def get_arc(self, state: int, ilabel: int):
        hit = self.lm.get_arc_backoff(state, ilabel)
        if hit is None:
            return None
        next_state, weight = hit
        return next_state, weight - float(self.small_lm[ilabel])

    def final(self, state: int) -> float:
        hit = self.lm.get_arc_backoff(state, self.eos_id)
        if hit is None:
            return float("inf")
        next_state, weight = hit
        return (self.lm.final_backoff(next_state) + weight
                - float(self.small_lm[self.eos_id]))
