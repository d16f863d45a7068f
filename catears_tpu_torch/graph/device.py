"""Device-resident WFST and delta-LM tables and the vectorized LM walk (port
of catears_tpu/graph/device.py).

`DeviceFst.build` lays an HCLG (eps-free or closed after graph.transform,
or raw) out as the same integer tables the JAX decoder gathers from, byte
for byte, then moves them to a torch device:

* `emit_block [S, G*5 + 8]` (classic row) — every state's first G remaining
  emitting arcs ++ the state_packed lanes ++ its extracted first emitting
  self-loop (has, olabel, weight_bits, pdf); or, for eps-removed G=2 graphs
  whose fields fit, the compact 9-lane row:
    0: next0 | pdf0 << 20        1: w0 bits (f32)
    2: next1 | pdf1 << 20        3: w1 bits
    4: olabel0 | olabel1 << 16   5: olabel2_0 | olabel2_1 << 16
    6: w_self bits
    7: self_pdf | self_has << 12 | n_emit << 13
    8: emit_over_lo
* `over_packed [Ro, Gc*5]` — emitting arcs beyond the first G (CSR overflow).
* `eps_packed [Re, Ge*5]` — epsilon arcs (the closure rounds' CSR; in
  eps-removed graphs only the init closure's).
* `state_packed [S, 4]` — (eps_row_lo, n_eps, emit_over_lo, n_emit).

Each arc is 5 int32 lanes (next, olabel, weight_bits, pdf, lane4), with
lane4 = the composed second olabel on emitting arcs of an eps-removed graph
and the destination's packed epsilon metadata (eps_row_lo << 9 | n_eps)
otherwise.

The hot/cold emit split: `build(hot_rows=H)` copies rows [0, H) of the
classic emit_block into `emit_hot`, and with BeamConfig.cold_expand_size
the decoder serves the tokens on states below H from it (pair with
graph.transform.hot_order).  `compact=False` or `hot_rows > 0` keeps the
classic row.

`DeviceLm.build` lays a delta-LM G' out as the JAX DeviceLm's tables (dense
state-0 arcs, two-choice bucketed arc hash, per-state backoff arcs), byte
for byte; `lm_propagate` walks (state, label) lanes through them, and
`lm_propagate_capped` walks only the word-emitting lanes, compacted: on
the card in one launch of csrc/lm_walk.cu, on the CPU by their plain
versions (`*_ref`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst
from catears_tpu_torch.kernels import check_launch, kernel_library
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import CorruptionError

# emit_hot is None unless the tables were built with hot_rows > 0.
TABLES = ("final", "state_packed", "over_packed", "eps_packed", "emit_block",
          "emit_hot")
LM_TABLES = ("hash_tab", "state_tab", "small_lm", "uni_next", "uni_weight")
_LM_DTYPES = (torch.int32, torch.int32, torch.float32, torch.int32,
              torch.float32)
_U32 = 0xFFFFFFFF


def _per_state_arc_counts(fst: FlatFst):
    """(n_eps, n_emit) int64 [S]: per-state epsilon / emitting arc counts,
    n_emit excluding each state's first emitting self-loop."""
    n_all = np.diff(fst.offsets.astype(np.int64))
    state_of_arc = np.repeat(np.arange(fst.num_states), n_all)
    is_eps = fst.arc_ilabel == 0
    n_eps = np.bincount(state_of_arc[is_eps],
                        minlength=fst.num_states).astype(np.int64)
    has_self = np.zeros(fst.num_states, bool)
    has_self[state_of_arc[~is_eps & (fst.arc_next == state_of_arc)]] = True
    return n_eps, n_all - n_eps - has_self.astype(np.int64)


def expansion_bounds(fst: FlatFst, group: int, beam_size: int,
                     distinct_states: bool = True,
                     csr_group: Optional[int] = None,
                     eps_group: Optional[int] = None) -> Tuple[int, int]:
    """Worst-case (expand_size, eps_expand_size) for a beam of K tokens:
    the sum of the K largest per-state CSR row counts (K * max rows when
    tokens may share a state)."""
    gc = csr_group or group
    ge = eps_group or group
    n_eps, n_emit = _per_state_arc_counts(fst)
    over_rows = -(-np.maximum(n_emit - group, 0) // gc)
    eps_rows = -(-n_eps // ge)

    def worst(rows: np.ndarray) -> int:
        if rows.size == 0:
            return 0
        if not distinct_states:
            return beam_size * int(rows.max())
        k = min(beam_size, rows.size)
        top = np.partition(rows, rows.size - k)[rows.size - k:]
        return int(top.sum())

    return gc * worst(over_rows), ge * worst(eps_rows)


def _eps_depth(fst: FlatFst, bound: int = 16) -> Optional[int]:
    """Longest epsilon-arc chain, or None if cyclic/deeper than bound."""
    is_eps = fst.arc_ilabel == 0
    state_of_arc = np.repeat(np.arange(fst.num_states),
                             np.diff(fst.offsets))
    src = state_of_arc[is_eps]
    dst = fst.arc_next[is_eps]
    if src.size == 0:
        return 0
    depth = np.zeros(fst.num_states, np.int64)
    for _ in range(bound + 1):
        new = depth.copy()
        np.maximum.at(new, src, depth[dst] + 1)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    return None  # cyclic or deeper than bound


@dataclasses.dataclass(frozen=True)
class DeviceFst:
    """HCLG graph as torch tables on one device (see module docstring)."""

    start: int
    final: torch.Tensor  # f32 [S]
    state_packed: torch.Tensor  # i32 [S, 4]
    over_packed: torch.Tensor  # i32 [Ro, csr_group*5]
    eps_packed: torch.Tensor  # i32 [Re, eps_group*5]
    emit_block: torch.Tensor  # i32 [S, group*5 + 8] or [S, 9] compact
    eps_depth: Optional[int]  # longest eps chain, None if unbounded
    group: int  # arcs per per-token block row
    csr_group: int  # arcs per overflow CSR gather row
    eps_group: int  # arcs per epsilon CSR gather row
    eps_meta_ok: bool  # dest eps metadata packs into one lane
    max_emit_fanout: int  # max non-self emitting arcs of any state
    eps_removed: bool = False  # lane 4 of emitting arcs = second olabel
    has_emit_olabel: bool = True
    emit_compact: bool = False
    # The hot/cold emit split: a copy of emit_block's first hot_rows rows
    # (None and 0 without it).
    emit_hot: Optional[torch.Tensor] = None
    hot_rows: int = 0

    ARC_LANES = 5

    @classmethod
    def build(cls, fst: FlatFst, tid2pdf: np.ndarray, group: int = 4,
              eps_depth_cap: Optional[int] = None,
              csr_group: Optional[int] = None,
              eps_group: Optional[int] = None,
              olabel2: Optional[np.ndarray] = None,
              hot_rows: int = 0,
              compact: Optional[bool] = None,
              device: Device = "cuda") -> "DeviceFst":
        """The tables the JAX DeviceFst.build makes from the same
        arguments, placed on `device` (the card unless the CPU is asked
        for)."""
        device = resolve_device(device)
        arrays, meta = build_arrays(fst, tid2pdf, group=group,
                                    eps_depth_cap=eps_depth_cap,
                                    csr_group=csr_group, eps_group=eps_group,
                                    olabel2=olabel2, hot_rows=hot_rows,
                                    compact=compact)
        return cls.from_numpy(arrays, meta, device=device)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                   device: Device = "cuda") -> "DeviceFst":
        """From numpy tables (e.g. np.asarray of a JAX DeviceFst's fields;
        a missing or None emit_hot means no hot/cold split) and its static
        fields."""
        device = resolve_device(device)
        tensors = {name: torch.tensor(np.asarray(arrays[name])).to(device)
                   for name in TABLES if arrays.get(name) is not None}
        return cls(start=int(arrays["start"]), **tensors, **meta)

    @property
    def num_states(self) -> int:
        return self.state_packed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.emit_block.device


def build_arrays(fst: FlatFst, tid2pdf: np.ndarray, group: int = 4,
                 eps_depth_cap: Optional[int] = None,
                 csr_group: Optional[int] = None,
                 eps_group: Optional[int] = None,
                 olabel2: Optional[np.ndarray] = None,
                 hot_rows: int = 0,
                 compact: Optional[bool] = None):
    """The numpy tables + static fields of DeviceFst.build."""
    gc = csr_group or group
    ge = eps_group or group
    s = fst.num_states
    offsets = fst.offsets.astype(np.int64)
    n_all = np.diff(offsets)
    # ilabel==0 arcs prefix each (state, ilabel)-sorted span.
    state_of_arc = np.repeat(np.arange(s), n_all)
    is_eps = fst.arc_ilabel == 0
    n_eps = np.bincount(state_of_arc[is_eps], minlength=s).astype(np.int64)
    tid2pdf = np.asarray(tid2pdf, np.int32)
    # Every emitting ilabel must be a valid transition-id.
    bad = ~is_eps & ((fst.arc_ilabel < 0) | (fst.arc_ilabel >= tid2pdf.size))
    if bad.any():
        i = int(np.argmax(bad))
        raise CorruptionError(
            f"FST arc {i} has ilabel {int(fst.arc_ilabel[i])} outside "
            f"the transition table [0, {tid2pdf.size})")
    arc_pdf = np.where(is_eps, 0,
                       tid2pdf[np.minimum(fst.arc_ilabel, tid2pdf.size - 1)]
                       ).astype(np.int32)

    # Each state's FIRST emitting self-loop goes to dedicated lanes; any
    # further self-loops stay ordinary arcs.
    is_self = ~is_eps & (fst.arc_next == state_of_arc)
    self_states, first_pos = np.unique(state_of_arc[is_self],
                                       return_index=True)
    self_idx = np.flatnonzero(is_self)[first_pos]
    extracted = np.zeros(fst.num_arcs, bool)
    extracted[self_idx] = True
    keep = ~is_eps & ~extracted  # remaining emitting arcs
    n_emit = np.bincount(state_of_arc[keep], minlength=s).astype(np.int64)

    # Epsilon arcs and emitting overflow (beyond the first G) each get their
    # own flat table, spans padded to row boundaries.
    n_over = np.maximum(n_emit - group, 0)
    eps_rows = -(-n_eps // ge)
    over_rows = -(-n_over // gc)
    eps_row_lo = np.concatenate([[0], np.cumsum(eps_rows)])[:-1]
    emit_over_lo = np.concatenate([[0], np.cumsum(over_rows)])[:-1]
    n_eps_rows = max(int(eps_rows.sum()), 1)
    n_over_rows = max(int(over_rows.sum()), 1)

    # Destination epsilon metadata packed into one lane.
    eps_meta_ok = bool(n_eps.max(initial=0) < 512
                       and eps_rows.sum() < 2 ** 22)
    if eps_meta_ok:
        dst_meta = (eps_row_lo[fst.arc_next] << 9
                    | n_eps[fst.arc_next]).astype(np.int32)
    else:
        dst_meta = np.zeros(fst.num_arcs, np.int32)
    if olabel2 is not None:
        lane4 = np.where(is_eps, dst_meta, np.asarray(olabel2, np.int32))
    else:
        lane4 = dst_meta
    packed = np.stack([
        fst.arc_next, fst.arc_olabel,
        fst.arc_weight.view(np.int32), arc_pdf,
        lane4,
    ], axis=1).astype(np.int32)
    lanes = packed.shape[1]
    self_arc = np.zeros((s, 4), np.int32)
    self_arc[self_states, 0] = 1  # has
    self_arc[self_states, 1:] = packed[self_idx, 1:4]

    rank = np.arange(fst.num_arcs) - np.repeat(offsets[:-1], n_all)
    # rank among REMAINING emitting arcs of the state
    cum = np.cumsum(keep)
    before = np.concatenate([[0], cum])[offsets[:-1]]
    emit_rank = cum - 1 - before[state_of_arc]
    in_block = keep & (emit_rank < group)
    in_over = keep & (emit_rank >= group)
    dest_eps = eps_row_lo[state_of_arc] * ge + rank
    dest_over = emit_over_lo[state_of_arc] * gc + emit_rank - group
    eps_flat = np.zeros((n_eps_rows * ge, lanes), np.int32)
    eps_flat[dest_eps[is_eps]] = packed[is_eps]
    over_flat = np.zeros((n_over_rows * gc, lanes), np.int32)
    over_flat[dest_over[in_over]] = packed[in_over]
    block = np.zeros((s * group, lanes), np.int32)
    block[state_of_arc[in_block] * group
          + emit_rank[in_block]] = packed[in_block]

    state_packed = np.stack([eps_row_lo, n_eps, emit_over_lo, n_emit],
                            axis=1).astype(np.int32)
    emit_block_np = np.concatenate(
        [block.reshape(s, group * lanes), state_packed, self_arc], axis=1)
    # Compact 9-lane row: eps-removed G=2 graphs whose fields fit, unless
    # compact=False or the hot/cold split asks for the classic row.
    emit_compact = (compact is not False) and bool(
        olabel2 is not None and group == 2 and hot_rows == 0
        and s < 2 ** 20
        and arc_pdf.max(initial=0) < 4096
        and int(self_arc[:, 3].max(initial=0)) < 4096
        and fst.arc_olabel.max(initial=0) < 65536
        and int(np.asarray(olabel2).max(initial=0)) < 65536
        and int(n_emit.max(initial=0)) < 1024
        and int(self_arc[:, 1].max(initial=0)) == 0)
    if emit_compact:
        blk = block.reshape(s, group, lanes).astype(np.int64)
        sa = self_arc.astype(np.int64)
        pack = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)  # noqa: E731
                          .view(np.int32))
        emit_block_np = np.stack([
            pack(blk[:, 0, 0] | (blk[:, 0, 3] << 20)),
            pack(blk[:, 0, 2]),
            pack(blk[:, 1, 0] | (blk[:, 1, 3] << 20)),
            pack(blk[:, 1, 2]),
            pack(blk[:, 0, 1] | (blk[:, 1, 1] << 16)),
            pack(blk[:, 0, 4] | (blk[:, 1, 4] << 16)),
            pack(sa[:, 2]),
            pack(sa[:, 3] | (sa[:, 0] << 12)
                 | (n_emit.astype(np.int64) << 13)),
            emit_over_lo.astype(np.int32),
        ], axis=1)
    hot_rows = min(hot_rows, s)
    depth = _eps_depth(fst)
    if eps_depth_cap is not None:
        depth = eps_depth_cap if depth is None else min(depth, eps_depth_cap)
    arrays = {
        "start": np.int32(fst.start),
        "final": np.asarray(fst.final, np.float32),
        "state_packed": state_packed,
        "over_packed": over_flat.reshape(n_over_rows, gc * lanes),
        "eps_packed": eps_flat.reshape(n_eps_rows, ge * lanes),
        "emit_block": emit_block_np,
        "emit_hot": emit_block_np[:hot_rows].copy() if hot_rows else None,
    }
    meta = dict(
        eps_depth=depth,
        group=group,
        csr_group=gc,
        eps_group=ge,
        eps_meta_ok=eps_meta_ok,
        max_emit_fanout=int(n_emit.max(initial=0)),
        eps_removed=olabel2 is not None,
        has_emit_olabel=bool((~is_eps & (fst.arc_olabel > 0)).any()),
        emit_compact=emit_compact,
        hot_rows=hot_rows,
    )
    return arrays, meta


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 lanes a in [0, 2^32) and a constant
    c < 2^32, split into 16-bit halves of c so that every intermediate stays
    below 2^48 (int64 overflow is never relied on)."""
    lo = (a * (c & 0xFFFF)) & _U32
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _lm_hash(s: torch.Tensor, l: torch.Tensor, seed, mask: int):
    """Deterministic (state, label) bucket hash, bit for bit the JAX
    _lm_hash's uint32 arithmetic.

    torch has no uint32 multiply, so the lanes are int64 holding values
    masked to 32 bits: every product is reduced mod 2^32 by _mul_u32, and
    `>>` acts on non-negative values, where it is a logical shift.  `seed`
    is an int or an int64 tensor of per-lane seeds.  The table build
    (numpy arrays through CPU tensors) and the device lookup share this
    function, so they agree on every device.
    """
    s = s.to(torch.int64) & _U32
    l = l.to(torch.int64) & _U32
    h = _mul_u32(s, 0x9E3779B1) ^ _mul_u32(l, 0x85EBCA77) ^ seed
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x2C1B3C6D)
    h = h ^ (h >> 13)
    return (h & mask).to(torch.int32)


def _lm_hash_np(ks: np.ndarray, kl: np.ndarray, seed: int,
                mask: int) -> np.ndarray:
    return _lm_hash(torch.from_numpy(np.ascontiguousarray(ks)),
                    torch.from_numpy(np.ascontiguousarray(kl)), seed,
                    mask).numpy()


@dataclasses.dataclass(frozen=True)
class DeviceLm:
    """Backoff LM G' for delta-LM rescoring, as torch tables on one device.

    uni_next/uni_weight: state 0's arcs as a dense per-label table;
    hash_tab: every other (state, label > 0) arc in a two-choice 4-slot
    bucketed hash, rows [s0..s3, l0..l3, n0..n3, w0..w3] with empty slots
    s = -1 and the bucket's overflow bit on the sign of l0; state_tab: per
    state (backoff next or -1, backoff weight bits).
    """

    hash_tab: torch.Tensor  # i32 [B, 16]
    state_tab: torch.Tensor  # i32 [S, 2]
    small_lm: torch.Tensor  # f32 [V] unigram costs to subtract
    start: int  # DeltaLmFst start state (post-<s>)
    uni_next: torch.Tensor  # i32 [V] state-0 next (-1 = no arc)
    uni_weight: torch.Tensor  # f32 [V] state-0 weight
    max_backoff: int
    hash_seed1: int
    hash_seed2: int
    hash_mask: int  # buckets - 1 (a power of two)

    @classmethod
    def build(cls, delta: DeltaLmFst, max_backoff: int = 8,
              device: Device = "cuda") -> "DeviceLm":
        """The tables the JAX DeviceLm.build makes from `delta`, placed on
        `device` (the card unless the CPU is asked for)."""
        device = resolve_device(device)
        arrays, meta = lm_arrays(delta, max_backoff)
        return cls.from_numpy(arrays, meta, device=device)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                   device: Device = "cuda") -> "DeviceLm":
        """From numpy tables (e.g. np.asarray of a JAX DeviceLm's fields)
        and its static fields."""
        device = resolve_device(device)
        tensors = {name: torch.tensor(np.asarray(arrays[name])).to(device)
                   for name in LM_TABLES}
        return cls(start=int(arrays["start"]), **tensors, **meta)

    @staticmethod
    def _build_hash(ks, kl, kn, kw, slots: int = 4):
        """Greedy two-choice placement; doubles the table on failure.

        First-choice buckets fill to `slots`; displaced keys set their
        first bucket's overflow bit and go to their second-choice bucket,
        so a lookup probes a second bucket only when the first says so.
        """
        n = ks.size
        if n == 0:
            # A unigram-only G' hashes nothing: every lookup resolves from
            # the dense state-0 table or misses into the backoff walk.
            b = 256
            tab = np.concatenate([np.full((b, slots), -1, np.int32),
                                  np.zeros((b, 3 * slots), np.int32)],
                                 axis=1)
            return tab, 0x1234, 0x9876, b - 1
        b = 1 << max(8, int(np.ceil(np.log2(max(1, n / 2)))))
        for attempt in range(8):
            seed1, seed2 = 0x1234 + attempt, 0x9876 + 3 * attempt
            mask = b - 1
            h1 = _lm_hash_np(ks, kl, seed1, mask)
            h2 = _lm_hash_np(ks, kl, seed2, mask)
            ss = np.full((b, slots), -1, np.int32)
            ll = np.zeros((b, slots), np.int32)
            nn = np.zeros((b, slots), np.int32)
            ww = np.zeros((b, slots), np.int32)
            overflow = np.zeros(b, bool)

            def rank_in_bucket(h):
                order = np.argsort(h, kind="stable")
                hs = h[order]
                first = np.concatenate([[0], np.flatnonzero(
                    hs[1:] != hs[:-1]) + 1])
                start_of = np.zeros(n, np.int64)
                start_of[first] = first
                np.maximum.accumulate(start_of, out=start_of)
                out = np.empty(n, np.int64)
                out[order] = np.arange(n) - start_of
                return out

            r1 = rank_in_bucket(h1)
            place1 = r1 < slots
            ss[h1[place1], r1[place1]] = ks[place1]
            ll[h1[place1], r1[place1]] = kl[place1]
            nn[h1[place1], r1[place1]] = kn[place1]
            ww[h1[place1], r1[place1]] = kw[place1]
            rest = ~place1
            overflow[h1[rest]] = True
            used = np.bincount(h1[place1], minlength=b)
            h2r = h2[rest]
            r2 = rank_in_bucket(np.where(rest, h2, -1))[rest] \
                if rest.any() else np.zeros(0, np.int64)
            slot2 = used[h2r] + r2
            if (slot2 < slots).all():
                ss[h2r, slot2] = ks[rest]
                ll[h2r, slot2] = kl[rest]
                nn[h2r, slot2] = kn[rest]
                ww[h2r, slot2] = kw[rest]
                ll[overflow, 0] = np.int32(
                    ll[overflow, 0].astype(np.int64) - 2**31)
                tab = np.concatenate([ss, ll, nn, ww], axis=1)
                return tab, seed1, seed2, mask
            b *= 2
        raise CorruptionError("delta-LM hash build failed to converge")


def lm_arrays(delta: DeltaLmFst, max_backoff: int = 8):
    """The numpy tables + static fields of DeviceLm.build."""
    lm = delta.lm
    starts = lm.offsets[:-1]
    nonempty = lm.offsets[:-1] < lm.offsets[1:]
    has_backoff = np.zeros(lm.num_states, bool)
    has_backoff[nonempty] = lm.arc_ilabel[starts[nonempty]] == 0
    # Per-state backoff arc (the epsilon-first convention).
    bo_next = np.full(lm.num_states, -1, np.int32)
    bo_wbits = np.zeros(lm.num_states, np.int32)
    bo_states = np.flatnonzero(has_backoff)
    bo_pos = lm.offsets[bo_states]
    bo_next[bo_states] = lm.arc_next[bo_pos]
    bo_wbits[bo_states] = np.asarray(lm.arc_weight[bo_pos],
                                     np.float32).view(np.int32)
    state_tab = np.stack([bo_next, bo_wbits], axis=1)
    # Dense state-0 table indexed by label.
    n_sym = max(int(lm.arc_ilabel.max(initial=0)) + 1,
                int(np.asarray(delta.small_lm).size), 1)
    uni_next = np.full(n_sym, -1, np.int32)
    uni_weight = np.zeros(n_sym, np.float32)
    lo0, hi0 = int(lm.offsets[0]), int(lm.offsets[1])
    lab0 = lm.arc_ilabel[lo0:hi0]
    uni_next[lab0] = lm.arc_next[lo0:hi0]
    uni_weight[lab0] = lm.arc_weight[lo0:hi0]
    # Hash every remaining (state >= 1, label >= 1) arc.
    state_of_arc = np.repeat(
        np.arange(lm.num_states),
        np.diff(lm.offsets.astype(np.int64))).astype(np.int32)
    sel = (lm.arc_ilabel > 0) & (state_of_arc != 0)
    ks, kl = state_of_arc[sel], lm.arc_ilabel[sel].astype(np.int32)
    kn = lm.arc_next[sel].astype(np.int32)
    kw = np.asarray(lm.arc_weight[sel], np.float32).view(np.int32)
    tab, seed1, seed2, mask = DeviceLm._build_hash(ks, kl, kn, kw)
    arrays = {
        "hash_tab": tab,
        "state_tab": state_tab,
        "small_lm": np.asarray(delta.small_lm, np.float32),
        "start": np.int32(delta.start_state()),
        "uni_next": uni_next,
        "uni_weight": uni_weight,
    }
    meta = dict(max_backoff=max_backoff, hash_seed1=seed1, hash_seed2=seed2,
                hash_mask=mask)
    return arrays, meta


def compact_mask(keep: torch.Tensor, cols: List[torch.Tensor], c2: int):
    """Order-preserving compaction of the kept lanes of [..., N] into c2
    slots: survivors in lane order, the first c2 of them kept.

    The JAX version books survivors with a segmented TPU sort; here each
    kept lane's cumsum rank is its slot and one scatter places it.  Returns
    (compacted columns [..., c2], valid [..., c2], total survivors [...]
    int32, src lane index [..., c2] int64); slots past `total` read lane 0
    (mask them with `valid`).
    """
    n = keep.shape[-1]
    kept = keep.to(torch.int64)
    rank = torch.cumsum(kept, dim=-1) - 1
    total = kept.sum(dim=-1)
    # Unkept and past-capacity lanes all land in one spare slot, cut off.
    dest = torch.where(keep & (rank < c2), rank, c2)
    lanes = torch.arange(n, device=keep.device).expand(dest.shape)
    src = torch.zeros(keep.shape[:-1] + (c2 + 1,), dtype=torch.int64,
                      device=keep.device)
    src = src.scatter(-1, dest, lanes.contiguous())[..., :c2]
    valid = torch.arange(c2, device=keep.device) < total[..., None]
    src = torch.where(valid, src, 0)
    return ([torch.gather(c, -1, src) for c in cols], valid,
            total.to(torch.int32), src)


def lm_propagate_capped(dlm: DeviceLm, states: torch.Tensor,
                        labels: torch.Tensor, cap: int):
    """lm_propagate over only the active (label > 0) lanes of [..., E],
    compacted into `cap` slots.

    Returns (next_states, delta_weights, needed [...] int32): `needed` is
    the number of active lanes; where it exceeds cap, the lanes past the
    first cap keep their state with weight 0 (wrong results, as in JAX), so
    the caller must flag the overflow.  cap <= 0 (or >= E) walks every lane
    and still reports `needed`.

    CPU tensors take the plain version (lm_propagate_capped_ref); CUDA
    tensors launch the hand-written kernel (csrc/lm_walk.cu: the
    compaction, each lane's walk to its own end and the write-back in one
    launch) or raise.  `lm_propagate_capped.launches` counts its launches.
    """
    if states.device.type == "cpu":
        return lm_propagate_capped_ref(dlm, states, labels, cap)
    return _lm_walk(dlm, states, labels, cap, lm_propagate_capped)


lm_propagate_capped.launches = 0


def lm_propagate_capped_ref(dlm: DeviceLm, states: torch.Tensor,
                            labels: torch.Tensor, cap: int,
                            work: Optional[Dict[str, int]] = None):
    """Plain version of lm_propagate_capped: compact_mask, the static
    masked walk (lm_propagate_ref) and a scatter back, as JAX does.  With
    `work`, lm_propagate_ref counts the walk's table reads into it."""
    active = labels > 0
    needed = torch.sum(active, dim=-1, dtype=torch.int32)
    e = states.shape[-1]
    if cap <= 0 or cap >= e:
        ns, w = lm_propagate_ref(dlm, states, labels, work)
        return ns, w, needed
    (sub_states, sub_labels), sub_ok, _total, lane = compact_mask(
        active, [states, labels], cap)
    ns, w = lm_propagate_ref(dlm, torch.where(sub_ok, sub_states, 0),
                             torch.where(sub_ok, sub_labels, 0), work)
    # Scatter back; invalid slots go to a spare lane that is cut off, so
    # lane 0 keeps its own result.
    lane = torch.where(sub_ok, lane, e)
    spare = states.shape[:-1] + (1,)
    out_s = torch.cat([states, states.new_zeros(spare)], -1).scatter(
        -1, lane, torch.where(sub_ok, ns, 0))[..., :e]
    out_w = torch.zeros(states.shape[:-1] + (e + 1,), dtype=torch.float32,
                        device=states.device).scatter(
        -1, lane, torch.where(sub_ok, w, 0.0))[..., :e]
    return out_s, out_w, needed


def lm_iterations(dlm: DeviceLm) -> int:
    """The walk's static iteration count: a lane visits at most
    max_backoff + 1 states and probes each at most twice."""
    return 2 * (dlm.max_backoff + 1)


def lm_propagate(dlm: Optional[DeviceLm], states: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized DeltaLmFst.get_arc with the backoff walk, over lanes of
    any shape.

    states, labels: int32.  Returns (next_states, delta_weights): label-0
    lanes and full backoff misses keep their state with weight 0.  CPU
    tensors take the plain version (lm_propagate_ref); CUDA tensors launch
    csrc/lm_walk.cu uncapped or raise.  `lm_propagate.launches` counts its
    launches.
    """
    if dlm is None:
        return states, torch.zeros_like(states, dtype=torch.float32)
    if states.device.type == "cpu":
        return lm_propagate_ref(dlm, states, labels)
    ns, w, _needed = _lm_walk(dlm, states, labels, 0, lm_propagate)
    return ns, w


lm_propagate.launches = 0


_LM_WALK_ARGTYPES = {"catears_lm_walk": [ctypes.c_void_p] * 11
                     + [ctypes.c_int] * 6 + [ctypes.c_uint32] * 3
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def _lm_walk(dlm: DeviceLm, states: torch.Tensor, labels: torch.Tensor,
             cap: int, wrapper):
    """One launch of csrc/lm_walk.cu over [..., E] lanes on the card:
    (next_states, delta_weights, needed [...]), counted on
    `wrapper.launches`.  Raises on what the kernel does not take."""
    what = wrapper.__name__
    if states.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {states.device}")
    if (states.dtype != torch.int32 or labels.dtype != torch.int32
            or states.shape != labels.shape or states.dim() < 1
            or labels.device != states.device):
        raise ValueError(f"{what}: states and labels must be int32 tensors "
                         f"of one shape on one device")
    if not (states.is_contiguous() and labels.is_contiguous()):
        raise ValueError(f"{what}: states and labels must be contiguous")
    tables = [getattr(dlm, name) for name in LM_TABLES]
    for name, t, dtype in zip(LM_TABLES, tables, _LM_DTYPES):
        if (t.device != states.device or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{what}: DeviceLm.{name} must be a contiguous "
                             f"{dtype} tensor on {states.device}")
    e = states.shape[-1]
    rows = math.prod(states.shape[:-1])
    walkers = e if cap <= 0 or cap >= e else cap
    out_s = torch.empty_like(states)
    out_w = torch.empty(states.shape, dtype=torch.float32,
                        device=states.device)
    needed = torch.empty(states.shape[:-1], dtype=torch.int32,
                         device=states.device)
    if rows:
        lanes = torch.empty((rows, walkers), dtype=torch.int32,
                            device=states.device)
        lib = kernel_library("lm_walk", _LM_WALK_ARGTYPES)
        with torch.cuda.device(states.device):
            rc = lib.catears_lm_walk(
                states.data_ptr(), labels.data_ptr(),
                *(t.data_ptr() for t in tables), out_s.data_ptr(),
                out_w.data_ptr(), needed.data_ptr(), lanes.data_ptr(), rows,
                e, walkers, dlm.small_lm.shape[0], dlm.uni_next.shape[0],
                dlm.state_tab.shape[0], dlm.hash_seed1, dlm.hash_seed2,
                dlm.hash_mask, dlm.max_backoff, lm_iterations(dlm),
                torch.cuda.current_stream().cuda_stream)
        check_launch(lib, rc, what)
        wrapper.launches += 1
    return out_s, out_w, needed


def lm_propagate_ref(dlm: DeviceLm, states: torch.Tensor,
                     labels: torch.Tensor,
                     work: Optional[Dict[str, int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of lm_propagate.  With `work` (a bound's input, read
    from the device), it adds the walk's lanes ("walked") and table reads:
    hash-row probes ("probes") and backoff-row reads ("misses").

    The JAX walk is a while_loop until no lane is active; here the loop
    runs a static lm_iterations(dlm) = 2 * (max_backoff + 1) times, with no
    read of the device.  The result is identical:
      * a lane visits at most max_backoff + 1 states (the walk fails on the
        backoff taken when max_backoff backoffs were already taken);
      * it probes each state at most twice: the first-choice bucket, then
        the second only on the first bucket's overflow bit, and never again
        from phase 2;
      * an inactive lane is a fixed point of the body (found_now, retry,
        bo_ok and miss are all false), so the iterations past its end, or
        past every lane's end, change nothing.
    """
    l_c = torch.clamp(labels, 0, dlm.uni_next.shape[0] - 1).long()
    uni_nxt = dlm.uni_next[l_c]
    uni_w = dlm.uni_weight[l_c]
    n_state = dlm.state_tab.shape[0]
    active0 = labels > 0
    active = active0
    cur = torch.where(active0, states, 0)
    weight = torch.zeros_like(states, dtype=torch.float32)
    done = torch.zeros_like(active0)
    failed = torch.zeros_like(active0)
    phase2 = torch.zeros_like(active0)
    bo_it = torch.zeros_like(states)
    # Built once: a Python scalar in torch.where costs ops every iteration.
    # torch.full fills on the device (no host copy, so no synchronize).
    seed1 = torch.full((), dlm.hash_seed1, dtype=torch.int64,
                       device=states.device)
    seed2 = torch.full((), dlm.hash_seed2, dtype=torch.int64,
                       device=states.device)
    if work is not None:
        work["walked"] = work.get("walked", 0) + int(active0.sum())
    for _ in range(lm_iterations(dlm)):
        # One probe round: the bucket row gather + 4-slot compare (the
        # second-choice bucket in phase 2); state 0 reads the dense table.
        at0 = cur == 0
        h = _lm_hash(cur, labels, torch.where(phase2, seed2, seed1),
                     dlm.hash_mask)
        row = dlm.hash_tab[h.long()]  # [..., 16]
        rs, rl = row[..., 0:4], row[..., 4:8]
        ov = rl[..., 0] < 0  # the overflow bit rides l0's sign
        match = (rs == cur[..., None]) & (
            (rl & 0x7FFFFFFF) == labels[..., None])
        hit = torch.where(at0, uni_nxt >= 0, match.any(dim=-1))
        nxt = torch.where(at0, uni_nxt, torch.sum(
            torch.where(match, row[..., 8:12], 0), dim=-1,
            dtype=torch.int32))
        w = torch.where(at0, uni_w, torch.sum(
            torch.where(match, row[..., 12:16], 0), dim=-1,
            dtype=torch.int32).view(torch.float32))
        need2 = ~hit & ~at0 & ov & ~phase2
        found_now = active & hit
        retry = active & need2
        miss = active & ~hit & ~need2
        if work is not None:
            for key, lanes in (("probes", active & ~at0), ("misses", miss)):
                work[key] = work.get(key, 0) + int(lanes.sum())
        # Misses follow the state's backoff arc, if it has one.
        st = dlm.state_tab[torch.clamp(cur, 0, n_state - 1).long()]
        bo_next = st[..., 0]
        bo_w = st[..., 1].contiguous().view(torch.float32)
        bo_ok = miss & (bo_next >= 0)
        cur = torch.where(found_now, nxt, torch.where(bo_ok, bo_next, cur))
        weight = torch.where(found_now, weight + w,
                             torch.where(bo_ok, weight + bo_w, weight))
        done = done | found_now
        over = bo_ok & (bo_it >= dlm.max_backoff)
        failed = failed | (miss & (bo_next < 0)) | over
        active = (bo_ok & ~over) | retry
        bo_it = bo_it + bo_ok.to(bo_it.dtype)
        phase2 = retry
    # get_arc success: subtract the unigram cost.
    sub = dlm.small_lm[torch.clamp(labels, 0,
                                   dlm.small_lm.shape[0] - 1).long()]
    ok = active0 & done & ~failed
    return (torch.where(ok, cur, states),
            torch.where(ok, weight - sub, torch.zeros_like(weight)))
