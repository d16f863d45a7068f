"""Batched frame-synchronous Viterbi beam search with optional delta-LM
rescoring (port of catears_tpu/decode/beam.py).

The JAX decoder vmaps one utterance's frame step and scans it over frames;
here the batch dimension is written out (every beam array is [B, K]) and
the scan is a Python loop over frames.  Semantics follow the JAX code
statement by statement, so per-frame states, LM states, costs,
backpointers, words, overflow flags and high-water marks are identical:

  frame = expand emitting arcs (extracted self-loop + first-G block row +
          CSR overflow) -> cost = token + arc weight - am_scale*logp[pdf]
          (+ the delta-LM walks of the arc's output labels) -> exact dedup
          by (state, lm) (min cost, stable) + top-K + beam threshold;
          then, unless the graph is eps-removed, the epsilon closure;
          padded and dead frames keep the previous beam.

The exact variants of the frame, as in JAX: `select_compact` (the frame's
one selection compacts the beam-threshold survivors of its dedup sort
before the top-K, `_select_compacted`) and the hot/cold emit split (tokens
on states below DeviceFst.hot_rows read the small emit_hot table, the
others are compacted into cold_expand_size lanes that read emit_block,
`_hot_cold_rows`).  Both overflow loudly: the sticky flag and hiwater
slots 3 and 4.

The three graph modes of graph.transform.prepare_decode_graph:
* eps-removed: `_eps_free_step`, one selection per frame: on a card the
  expansion with its acoustic term is one launch of csrc/frame_expand.cu
  (`expand_emitting`, the hot/cold split included) and the selection with
  its beam threshold one of csrc/frame_select.cu (`select_beam`, with or
  without select_compact; the rows whose frame is invalid masked, so
  that they cost the kernel nothing); on the CPU their plain versions
  `expand_emitting_ref` / `select_beam_ref`;
* a static epsilon depth (closed graphs, depth 1; raw graphs of depth <=
  max_eps_iters): `_emitting_step` + `_eps_closure_fused`, one merge
  selection per round with the trace composed in place;
* any other depth: `_emitting_step` + `_eps_closure` over a backpointer
  arena + `_resolve_chains`.  The JAX closure is a while_loop that stops
  after the first round accepting no candidate; here all max_eps_iters
  rounds run, with no read of the device.  A round after that stop changes
  nothing: no candidate wins, so the merge keeps the same entries in the
  same (cost, state, lm) order, its empty slots keep their backpointers
  (they are the beam's own state -1 entries, taken in slot order), and the
  arena block it writes is zeros, as an unwritten block is.  So every
  later round sees the same input, and the result is the JAX one.

Notes on matching the reference bit for bit:
* Sorts: `lax.sort` is stable and compares floats as IEEE numbers (-0.0 ==
  +0.0).  LM off, the dedup sort on (state, cost) is one stable sort of an
  int64 key (state in the high half, order-preserving cost bits in the low
  half, -0.0 folded onto +0.0).  LM on, (state, lm, cost) needs about 94
  bits, so it is two stable passes, least significant key first: by the
  cost key, then by (state, lm) in one int64.  The prune is a stable sort
  of the effective costs.  Payloads are gathered from the unsorted
  columns.
* Acoustic term: a plain gather logp[b, pdf] (the JAX one-hot matmul
  lookup is exact, and so is a gather).  XLA contracts `cost - am_scale *
  logp` (`_eps_free_step`) and `cost + (-am_scale * logp)`
  (`_emitting_step`) into one fused multiply-add; `_fms` computes that
  single rounding exactly, in float64 with round-to-odd, on any device.
  The LM weights are then added one walk at a time, as JAX adds them.
* Integer fields are int32 as in JAX; logical shifts are `>>` plus the
  field's mask, since torch's `>>` on int32 is arithmetic.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from catears_tpu_torch.graph.device import (DeviceFst, DeviceLm,
                                            compact_mask,
                                            lm_propagate_capped)
from catears_tpu_torch.kernels import check_launch, kernel_library

INF = float("inf")
SENTINEL_STATE = 2**30  # sorts after every real state
I32 = torch.int32


@dataclass(frozen=True)
class BeamConfig:
    """Static decoder geometry (the JAX BeamConfig's fields and
    defaults)."""

    beam_size: int = 4096  # K: max active tokens
    expand_size: int = 8192  # emitting-arc CSR overflow capacity
    eps_expand_size: int = 8192  # epsilon-closure expansion capacity
    # Delta-LM walk capacity: the word-emitting lanes of an expansion are
    # compacted into this many slots before the walk; 0 walks every lane.
    # Truncation sets the overflow flag (hiwater slot 2).
    lm_expand_size: int = 0
    # > 0: the frame's selection compacts the post-dedup beam-threshold
    # survivors into max(select_compact, beam_size) lanes before the top-K
    # (exact; more survivors set the overflow flag, hiwater slot 3, which
    # reports the demand even at 0).  0: the classic full-width sorts.
    select_compact: int = 0
    # The hot/cold emit split (DeviceFst.hot_rows > 0): tokens on cold
    # states are compacted into this many lanes before the emit_block
    # gather (exact; more cold tokens set the overflow flag, hiwater slot
    # 4).  0: one gather of emit_block.
    cold_expand_size: int = 0
    max_eps_iters: int = 6  # closure round bound
    beam: float = 16.0  # beam width
    am_scale: float = 0.1  # acoustic scale

    def arena_rows(self, dfst: DeviceFst) -> int:
        """Backpointer arena rows of the dynamic closure: one block of K
        for the emitting step, one per closure round."""
        return (1 + _closure_rounds(self, dfst)) * self.beam_size


def _closure_rounds(cfg: BeamConfig, dfst: DeviceFst) -> int:
    if dfst.eps_depth is not None and dfst.eps_depth <= cfg.max_eps_iters:
        return dfst.eps_depth
    return cfg.max_eps_iters


class BeamState(NamedTuple):
    """A batch of beams; slots sorted by cost, state == -1 when empty."""

    states: torch.Tensor  # i32 [B, K] HCLG state
    lm: torch.Tensor  # i32 [B, K] delta-LM state (0: LM off)
    costs: torch.Tensor  # f32 [B, K] +inf when empty
    bp: torch.Tensor  # i32 [B, K] slot ids
    overflow: torch.Tensor  # bool [B], sticky expansion-overflow flag
    hiwater: torch.Tensor  # i32 [B, 5] capacity high-water marks


class FrameTrace(NamedTuple):
    """Per-frame backpointers: prev_slot [..., K] in the previous frame's
    beam (-1 at the decode root) and words [..., K, W] newest-first."""

    prev_slot: torch.Tensor
    words: torch.Tensor


class Cands(NamedTuple):
    """Expansion candidates, [B, E] each (optional fields None)."""

    tok: torch.Tensor  # i32 source beam slot
    valid: torch.Tensor  # bool
    cost: torch.Tensor  # f32 token cost + arc weight
    next_state: torch.Tensor  # i32
    olabel: torch.Tensor  # i32
    pdf: torch.Tensor  # i32
    eps: Optional[torch.Tensor]  # i32 lane 4 (olabel2 / dest eps meta)
    lm: Optional[torch.Tensor]  # i32 the source token's LM state
    bp: Optional[torch.Tensor]
    overflow: torch.Tensor  # bool [B]
    needed: torch.Tensor  # i32 [B] arc slots this expansion wanted
    # The hot/cold split's cold-token truncation flag and demand [B] (the
    # emitting pass; None without the split and on the CSR passes).
    cold_over: Optional[torch.Tensor] = None
    cold_needed: Optional[torch.Tensor] = None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-utterance gather: x [B, N], idx [B, E] -> [B, E]."""
    return torch.gather(x, 1, idx.long())


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 lanes."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _fms(c: torch.Tensor, a: float, x: torch.Tensor) -> torch.Tensor:
    """float32(c - float32(a) * x) with ONE rounding (a fused multiply-add).

    The product of two float32s is exact in float64; the float64 sum is
    rounded to odd (TwoSum error + nudge), which makes the final rounding
    to float32 correct.
    """
    p = x.to(torch.float64) * -float(np.float32(a))
    cd = c.to(torch.float64)
    s = cd + p
    bv = s - cd
    err = (cd - (s - bv)) + (p - bv)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, INF, -INF).to(torch.float64)
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _sort_key_f32(c: torch.Tensor) -> torch.Tensor:
    """Cost values with -0.0 folded onto +0.0 (IEEE-equal, as lax.sort)."""
    return torch.where(c == 0, torch.zeros_like(c), c)


def _ordered_i64(c: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> [0, 2^32) int64 key; every NaN sorts
    after +inf, as lax.sort's canonical NaN does (a NaN with its sign bit
    set would otherwise sort before -inf)."""
    c = torch.where(torch.isnan(c), torch.full_like(c, float("nan")), c)
    bits = _sort_key_f32(c).view(I32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return ordered.to(torch.int64) + 2**31


def _dedup_sort(states, lms, costs):
    """The stable (state[, lm], cost, index) sort of [B, N] candidates and
    its dedup mask: (s_iota, s_states, s_costs, first), `first` marking the
    cheapest entry of each (state, lm) group."""
    if lms is None:
        key = states.to(torch.int64) * 2**32 + _ordered_i64(costs)
        s_iota = torch.sort(key, dim=1, stable=True).indices
    else:
        # Two stable passes, least significant key first: (state, lm,
        # cost, index) order, as the JAX 3-key stable sort.
        c_iota = torch.sort(_ordered_i64(costs), dim=1, stable=True).indices
        key = states.to(torch.int64) * 2**32 + (lms.to(torch.int64) + 2**31)
        s_iota = _take(c_iota, torch.sort(_take(key, c_iota), dim=1,
                                          stable=True).indices)
    s_states = _take(states, s_iota)
    s_costs = _take(costs, s_iota)
    first = torch.ones_like(s_states, dtype=torch.bool)
    first[:, 1:] = s_states[:, 1:] != s_states[:, :-1]
    if lms is not None:
        s_lms = _take(lms, s_iota)
        first[:, 1:] |= s_lms[:, 1:] != s_lms[:, :-1]
    return s_iota, s_states, s_costs, first


def _select_out(states, lms, costs_k, iota_k, payloads):
    """The kept K slots: (states, lms, costs, *payload_columns) gathered at
    iota_k, empty (state -1, lm 0, cost +inf) where costs_k is not finite
    (the payload columns are not masked, as in JAX)."""
    valid = torch.isfinite(costs_k)
    return (
        torch.where(valid, _take(states, iota_k), -1),
        (torch.zeros_like(iota_k, dtype=I32) if lms is None
         else torch.where(valid, _take(lms, iota_k), 0)),
        torch.where(valid, costs_k, INF),
    ) + tuple(_take(p, iota_k) for p in payloads)


def _select_best(cfg: BeamConfig, states, lms, costs, payloads,
                 compact: bool = False):
    """Dedup by (state, lm) keeping the minimum cost, then exact top-K by
    cost.  Returns ((states, lms, costs, *payload_columns), overflow [B] or
    None (the classic sorts, which cannot truncate), demand [B]).

    compact=True only where the caller applies the beam threshold to the
    selected beam at once (the emitting and eps-free steps; the closure
    merges keep beam entries unconditionally).  There it reports the
    survivor demand, and with cfg.select_compact set and narrower than the
    candidates it runs `_select_compacted`; otherwise the classic sorts.
    """
    c2 = _compact_width(cfg, states.shape[1])
    if compact and c2:
        return _select_compacted(cfg, c2, states, lms, costs, payloads)
    out, demand = _select_sorts(cfg, states, lms, costs, payloads,
                                report_demand=compact)
    return out, None, demand


def _compact_width(cfg: BeamConfig, n: int) -> int:
    """The select_compact lanes of a selection over n candidates, or 0
    when it runs the classic sorts."""
    c2 = max(cfg.select_compact, cfg.beam_size) if cfg.select_compact else 0
    return c2 if 0 < c2 < n else 0


def _select_compacted(cfg: BeamConfig, c2: int, states, lms, costs,
                      payloads):
    """The dedup sort, then the survivors compacted into c2 lanes before
    the prune.

    Only a candidate that wins its (state, lm) group and meets the beam
    threshold cost <= min + beam can reach the beam (the caller applies
    that threshold next, and dedup keeps each group's minimum), so those
    are compacted in dedup-sort order.  c2 > K: a stable sort by cost of
    the c2 lanes (ties by dedup position, the classic key), then the first
    K.  c2 == K: no second sort; the beam comes back in dedup (state)
    order, which is why the callers take min(costs), not costs[:, 0].
    More survivors than c2 set the overflow flag; demand = survivors.
    """
    k = cfg.beam_size
    s_iota, s_states, s_costs, first = _dedup_sort(states, lms, costs)
    mn = torch.amin(costs, dim=1, keepdim=True)
    # isfinite guards a dead beam, where INF <= INF + beam would keep
    # every live lane.
    keep = (first & (s_states < SENTINEL_STATE) & torch.isfinite(s_costs)
            & (s_costs <= mn + cfg.beam))
    (c_cost, c_iota), c_valid, total, _src = compact_mask(
        keep, [s_costs, s_iota], c2)
    c_cost = torch.where(c_valid, c_cost, INF)
    if c2 > k:
        order = torch.sort(_sort_key_f32(c_cost), dim=1,
                           stable=True).indices[:, :k]
        sel_cost, sel_iota = _take(c_cost, order), _take(c_iota, order)
    else:
        sel_cost, sel_iota = c_cost, c_iota
    sel_iota = torch.where(torch.isfinite(sel_cost), sel_iota, 0)
    return (_select_out(states, lms, sel_cost, sel_iota, payloads),
            total > c2, total)


def _select_sorts(cfg: BeamConfig, states, lms, costs, payloads,
                  report_demand: bool = False):
    """Exact dedup by (state, lm) (min cost, earliest wins ties) + top-K by
    cost; lms None means LM off (dedup by state, lms out all 0).

    Returns ((states, lms, costs, *payload_columns) at the kept K slots,
    demand [B]): demand = post-dedup beam-threshold survivor count when
    report_demand is set, else 0.
    """
    k = cfg.beam_size
    s_iota, s_states, s_costs, first = _dedup_sort(states, lms, costs)
    eff_cost = torch.where(first & (s_states < SENTINEL_STATE), s_costs,
                           torch.full_like(s_costs, INF))
    if report_demand:
        mn = torch.amin(costs, dim=1, keepdim=True)
        demand = torch.sum(torch.isfinite(eff_cost)
                           & (eff_cost <= mn + cfg.beam), dim=1).to(I32)
    else:
        demand = torch.zeros(states.shape[0], dtype=I32,
                             device=states.device)
    order = torch.sort(_sort_key_f32(eff_cost), dim=1,
                       stable=True).indices[:, :k]
    return (_select_out(states, lms, _take(eff_cost, order),
                        _take(s_iota, order), payloads), demand)


def _expand_csr(table: torch.Tensor, g: int, capacity: int, row_lo, n_arcs,
                costs, lms, bps, need_lm: bool, need_bp: bool,
                need_eps: bool) -> Cands:
    """CSR expansion over per-source spans (row_lo in grouped-row units).

    Slot -> source ownership: a scatter-max of span starts + cummax fill
    for beam-sized source sets, binary search over the cumsum otherwise
    (the JAX code's two branches, which leave different `tok` values on
    dead lanes).
    """
    b, k = row_lo.shape
    dev = row_lo.device
    n_slots = -(-capacity // g)
    capacity = n_slots * g
    span_rows = (n_arcs + (g - 1)) // g
    cum = torch.cumsum(span_rows, dim=1).to(I32)
    cum_before = cum - span_rows
    rows_needed = cum[:, -1]
    overflow = rows_needed > n_slots
    slots = _arange(k, dev).expand(b, k)
    if k <= 2 * n_slots:
        # Spans starting past the last slot are dropped (JAX mode="drop"):
        # they scatter into one spare column that is cut off.
        owner = torch.full((b, n_slots + 1), -1, dtype=I32, device=dev)
        idx = torch.where(cum_before < n_slots, cum_before, n_slots)
        owner.scatter_reduce_(1, idx.long(),
                              torch.where(span_rows > 0, slots, -1),
                              reduce="amax", include_self=True)
        tok = torch.cummax(owner[:, :n_slots], dim=1).values
    else:
        s_ids = _arange(n_slots, dev)
        tok = torch.searchsorted(cum, s_ids.expand(b, n_slots).contiguous(),
                                 right=True).to(I32)
        tok = torch.where(s_ids[None, :] < rows_needed[:, None], tok, -1)
    tok_c = torch.clamp(tok, 0, k - 1)

    base = _take(row_lo - cum_before, tok_c)
    limit = _take(n_arcs + g * cum_before, tok_c)
    tok_cost = _take(costs, tok_c)
    s = _arange(n_slots, dev)
    row_idx = torch.clamp(base + s, 0, table.shape[0] - 1)
    ap = table[row_idx.long()].reshape(b, n_slots, g, DeviceFst.ARC_LANES)
    lanes = _arange(g, dev)
    valid_e = (tok[:, :, None] >= 0) & (
        g * s[None, :, None] + lanes < limit[:, :, None])
    weight = ap[..., 2].contiguous().view(torch.float32)
    cost = (tok_cost[:, :, None] + weight).reshape(b, capacity)

    def rep(x):
        return torch.repeat_interleave(x, g, dim=1)

    return Cands(
        tok=rep(tok_c),
        valid=valid_e.reshape(b, capacity),
        cost=cost,
        next_state=ap[..., 0].reshape(b, capacity),
        olabel=ap[..., 1].reshape(b, capacity),
        pdf=ap[..., 3].reshape(b, capacity),
        eps=ap[..., 4].reshape(b, capacity) if need_eps else None,
        lm=rep(_take(lms, tok_c)) if need_lm else None,
        bp=rep(_take(bps, tok_c)) if need_bp else None,
        overflow=overflow,
        needed=(rows_needed * g).to(I32),
    )


def _expand_eps_carried(dfst: DeviceFst, beam: BeamState, capacity: int,
                        eps_meta: torch.Tensor, need_lm: bool,
                        need_eps: bool) -> Cands:
    """Epsilon expansion from carried per-slot packed eps metadata
    (eps_row_lo << 9 | n_eps)."""
    eps_lo = eps_meta >> 9
    n = torch.where(beam.states >= 0, eps_meta & 511, 0)
    return _expand_csr(dfst.eps_packed, dfst.eps_group, capacity, eps_lo, n,
                       beam.costs, beam.lm, beam.bp, need_lm, True, need_eps)


def _splits_hot_cold(cfg: BeamConfig, dfst: DeviceFst) -> bool:
    """Whether the emitting expansion runs the hot/cold split."""
    return bool(dfst.hot_rows) and cfg.cold_expand_size > 0


def _hot_cold_rows(cfg: BeamConfig, dfst: DeviceFst, state_c: torch.Tensor,
                   valid_tok: torch.Tensor):
    """The classic emit rows [B, K, lanes] of the hot/cold split: tokens on
    states below dfst.hot_rows (and empty slots) read emit_hot; the cold
    tokens are compacted, in slot order, into min(cold_expand_size, K)
    lanes that read emit_block and are placed back in their slots.  Cold
    tokens past those lanes keep emit_hot's row 0 (a wrong row, flagged).
    Returns (rows, cold_over [B], cold_needed [B])."""
    b, k = state_c.shape
    cap = min(cfg.cold_expand_size, k)
    is_hot = state_c < dfst.hot_rows
    eb = dfst.emit_hot[torch.where(is_hot, state_c, 0).long()]
    cold_mask = valid_tok & ~is_hot
    cold_needed = torch.sum(cold_mask, dim=1, dtype=I32)
    (cold_states,), cold_ok, _total, lane = compact_mask(cold_mask,
                                                         [state_c], cap)
    rows = dfst.emit_block[torch.where(cold_ok, cold_states, 0).long()]
    # Empty compact lanes write to a spare slot that is cut off (JAX's
    # mode="drop"); the filled ones hold distinct slots.
    lane = torch.where(cold_ok, lane, k)[..., None].expand(-1, -1,
                                                           eb.shape[2])
    eb = torch.cat([eb, eb[:, :1]], dim=1).scatter(1, lane, rows)[:, :k]
    return eb, cold_needed > cap, cold_needed


def _expand(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState, capacity: int,
            emitting: bool, need_lm: bool, need_bp: bool,
            need_eps: bool = False) -> Cands:
    """Expand the beam's arcs: for emitting arcs the extracted self-loop and
    the first-G block (one row gather per token, or the hot/cold split's
    two) + the CSR overflow pass; for epsilon arcs the state_packed-driven
    CSR pass."""
    k = cfg.beam_size
    g = dfst.group
    b = beam.states.shape[0]
    dev = beam.states.device
    state_c = torch.clamp(beam.states, 0, dfst.num_states - 1)
    valid_tok = beam.states >= 0
    if not emitting:
        sp = dfst.state_packed[state_c.long()]  # [B, K, 4]
        n_eps = torch.where(valid_tok, sp[..., 1], 0)
        return _expand_csr(dfst.eps_packed, dfst.eps_group, capacity,
                           sp[..., 0], n_eps, beam.costs, beam.lm, beam.bp,
                           need_lm, need_bp, need_eps)

    cold_over = cold_needed = None
    if dfst.emit_compact:
        eb = dfst.emit_block[state_c.long()]  # [B, K, 9] row gather
        blk_next = torch.stack([eb[..., 0] & 0xFFFFF, eb[..., 2] & 0xFFFFF],
                               -1)
        blk_pdf = torch.stack([_srl(eb[..., 0], 20), _srl(eb[..., 2], 20)],
                              -1)
        blk_wbits = torch.stack([eb[..., 1], eb[..., 3]], -1)
        blk_ol = torch.stack([eb[..., 4] & 0xFFFF, _srl(eb[..., 4], 16)], -1)
        blk_l4 = torch.stack([eb[..., 5] & 0xFFFF, _srl(eb[..., 5], 16)], -1)
        self_has = _srl(eb[..., 7], 12) & 1
        self_ol = torch.zeros_like(state_c)  # packable guarantees 0
        self_wbits = eb[..., 6]
        self_pdf = eb[..., 7] & 0xFFF
        n_emit_raw = _srl(eb[..., 7], 13) & 0x3FF
        over_lo = eb[..., 8]
        eps_meta_self = torch.zeros_like(state_c)  # compact => eps_removed
    else:
        if _splits_hot_cold(cfg, dfst):
            eb, cold_over, cold_needed = _hot_cold_rows(cfg, dfst, state_c,
                                                        valid_tok)
        else:
            eb = dfst.emit_block[state_c.long()]  # [B, K, G*5 + 8]
        lanes_a = DeviceFst.ARC_LANES
        sp = eb[..., g * lanes_a:g * lanes_a + 4]
        sf = eb[..., g * lanes_a + 4:]
        blk = eb[..., :g * lanes_a].reshape(b, k, g, lanes_a)
        blk_next = blk[..., 0]
        blk_ol = blk[..., 1]
        blk_wbits = blk[..., 2]
        blk_pdf = blk[..., 3]
        blk_l4 = blk[..., 4]
        self_has = sf[..., 0]
        self_ol = sf[..., 1]
        self_wbits = sf[..., 2]
        self_pdf = sf[..., 3]
        n_emit_raw = sp[..., 3]
        over_lo = sp[..., 2]
        # A self-loop's destination is its own state, whose epsilon
        # metadata is in the state lanes; in eps_removed mode lane 4 is the
        # composed second olabel, which a true self-loop never has.
        eps_meta_self = (torch.zeros_like(state_c) if dfst.eps_removed
                         else (sp[..., 0] << 9) | sp[..., 1])
    n_emit = torch.where(valid_tok, n_emit_raw, 0)
    lanes = _arange(g, dev)
    valid_a = lanes[None, None, :] < n_emit[..., None]
    slots = _arange(k, dev).expand(b, k)
    blk_w = blk_wbits.contiguous().view(torch.float32)
    self_w = self_wbits.contiguous().view(torch.float32)

    def flat(x):
        return x.reshape(b, k * g)

    def repk(x):
        return torch.repeat_interleave(x, g, dim=1)

    def cat(x, y):
        return torch.cat([x, y], dim=1)

    pass_sa = Cands(
        tok=cat(slots, repk(slots)),
        valid=cat(valid_tok & (self_has > 0), flat(valid_a)),
        cost=cat(beam.costs + self_w, flat(beam.costs[..., None] + blk_w)),
        next_state=cat(state_c, flat(blk_next)),
        olabel=cat(self_ol, flat(blk_ol)),
        pdf=cat(self_pdf, flat(blk_pdf)),
        eps=cat(eps_meta_self, flat(blk_l4)) if need_eps else None,
        lm=cat(beam.lm, repk(beam.lm)) if need_lm else None,
        bp=cat(beam.bp, repk(beam.bp)) if need_bp else None,
        overflow=torch.zeros(b, dtype=torch.bool, device=dev),
        needed=torch.zeros(b, dtype=I32, device=dev),
        cold_over=cold_over,
        cold_needed=cold_needed,
    )
    # CSR overflow pass for states with fanout > G (skipped when every
    # state's fanout fits the block).
    if dfst.max_emit_fanout <= g:
        return pass_sa
    pass_b = _expand_csr(dfst.over_packed, dfst.csr_group, capacity, over_lo,
                         torch.clamp(n_emit - g, min=0), beam.costs, beam.lm,
                         beam.bp, need_lm, need_bp, need_eps)

    def cat_opt(x, y):
        return cat(x, y) if x is not None else None

    return Cands(
        tok=cat(pass_sa.tok, pass_b.tok),
        valid=cat(pass_sa.valid, pass_b.valid),
        cost=cat(pass_sa.cost, pass_b.cost),
        next_state=cat(pass_sa.next_state, pass_b.next_state),
        olabel=cat(pass_sa.olabel, pass_b.olabel),
        pdf=cat(pass_sa.pdf, pass_b.pdf),
        eps=cat_opt(pass_sa.eps, pass_b.eps),
        lm=cat_opt(pass_sa.lm, pass_b.lm),
        bp=cat_opt(pass_sa.bp, pass_b.bp),
        overflow=pass_b.overflow,
        needed=pass_b.needed,
        cold_over=cold_over,
        cold_needed=cold_needed,
    )


def _acoustic(logp: torch.Tensor, pdf: torch.Tensor) -> torch.Tensor:
    """logp[b, pdf] as a gather; out-of-range pdfs read 0.0, as the JAX
    one-hot lookup does."""
    p = logp.shape[1]
    inside = (pdf >= 0) & (pdf < p)
    vals = _take(logp, torch.clamp(pdf, 0, p - 1))
    return torch.where(inside, vals, torch.zeros_like(vals))


def _max_at(hiwater: torch.Tensor, slot: int, value: torch.Tensor):
    out = hiwater.clone()
    out[:, slot] = torch.maximum(out[:, slot], value.to(I32))
    return out


def _or(flag: torch.Tensor, other: Optional[torch.Tensor]) -> torch.Tensor:
    return flag if other is None else flag | other


def _emit_telemetry(beam: BeamState, c: Cands):
    """(overflow, hiwater) after an emitting expansion: its CSR overflow
    (slot 0) and, with the hot/cold split, its cold tokens (slot 4)."""
    overflow = beam.overflow | c.overflow
    hiwater = _max_at(beam.hiwater, 0, c.needed)
    if c.cold_over is not None:
        overflow = overflow | c.cold_over
        hiwater = _max_at(hiwater, 4, c.cold_needed)
    return overflow, hiwater


def _lm(cfg: BeamConfig, dlm: DeviceLm, lm: torch.Tensor,
        olabel: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Capped delta-LM walk + (overflow [B], needed [B]) for the beam
    telemetry.  Invalid expansion lanes carry garbage table reads for
    olabel: they are masked so they neither walk nor count (`valid` None:
    the caller's labels are 0 on those lanes already)."""
    if valid is not None:
        olabel = torch.where(valid, olabel, 0)
    ns, w, needed = lm_propagate_capped(dlm, lm, olabel, cfg.lm_expand_size)
    if cfg.lm_expand_size > 0:
        over = needed > cfg.lm_expand_size
    else:
        over = torch.zeros_like(needed, dtype=torch.bool)
    return ns, w, over, needed


class EmitCands(NamedTuple):
    """The emitting candidates of an eps-removed frame, [B, E] each, in
    the plain expansion's lane order (K self-loops, K*G first-G block
    lanes, then the CSR overflow slots), acoustic term included.  Dead
    lanes hold state SENTINEL_STATE, cost +inf and 0 in the other
    columns."""

    state: torch.Tensor  # i32
    cost: torch.Tensor  # f32 token + arc weight - am_scale * logp[pdf]
    tok: torch.Tensor  # i32 source beam slot
    olabel: torch.Tensor  # i32 the arc's output label
    olab2: torch.Tensor  # i32 its composed second output label
    lm: Optional[torch.Tensor]  # i32 the source token's LM state
    overflow: torch.Tensor  # bool [B] the CSR pass truncated
    needed: torch.Tensor  # i32 [B] CSR arc slots wanted (hiwater slot 0)
    # The hot/cold split's cold-token truncation flag and demand [B]
    # (hiwater slot 4); None without the split.
    cold_over: Optional[torch.Tensor] = None
    cold_needed: Optional[torch.Tensor] = None


def emit_lanes(cfg: BeamConfig, dfst: DeviceFst) -> int:
    """Candidate lanes per row of the eps-free frame's expansion and
    selection: K self-loops, K * G first-G block arcs and the CSR
    overflow capacity (expand_size in whole csr_group slots)."""
    k, g, gc = cfg.beam_size, dfst.group, dfst.csr_group
    n_slots = -(-cfg.expand_size // gc) if dfst.max_emit_fanout > g else 0
    return k + k * g + n_slots * gc


def expand_emitting(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState,
                    logp: torch.Tensor, need_lm: bool,
                    row_valid: Optional[torch.Tensor] = None) -> EmitCands:
    """The eps-free frame's expansion: every live token's self-loop, its
    first-G block arcs and its CSR overflow arcs, with
    cost = fma(-am_scale, logp[b, pdf], token cost + arc weight).
    `row_valid`, a contiguous bool [B] tensor on the beam's device (None:
    every row), masks rows: a masked row's per-row outputs are those of a
    row whose every token is dead (overflow False, needed 0, cold_over
    False, cold_needed 0), and the kernel does no work for it and leaves
    its [E] lanes unwritten (the plain version gives them a dead row's
    lanes: state SENTINEL_STATE, cost +inf, the rest 0).  Only a caller
    whose readers of the lanes skip the same rows may pass one: the
    selection under the same row_valid does.

    CPU tensors take the plain version (expand_emitting_ref); CUDA tensors
    launch the hand-written kernel (csrc/frame_expand.cu: one thread per
    candidate lane, slot owners by a binary search over the tokens' span
    prefix sums, the hot/cold split's rows from a count of the cold tokens
    before each slot) or raise.  `expand_emitting.launches` counts the
    launches.
    """
    states = beam.states
    dev = states.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"expand_emitting: unsupported device {dev}")
    b, k = states.shape
    g, gc = dfst.group, dfst.csr_group
    row_w = dfst.emit_block.shape[1]
    compact = bool(dfst.emit_compact)
    if not dfst.eps_removed:
        raise ValueError("expand_emitting: takes an eps-removed graph")
    # The split reads classic rows; a compact row ignores it, as _expand.
    split = _splits_hot_cold(cfg, dfst) and not compact
    if row_w != (9 if compact else g * DeviceFst.ARC_LANES + 8) or (
            compact and g != 2):
        raise ValueError(f"expand_emitting: an emit_block row of {row_w} "
                         f"lanes is neither the compact G=2 row nor the "
                         f"classic G*5 + 8 row (G = {g})")
    tensors = {"states": (states, I32), "costs": (beam.costs, torch.float32),
               "logp": (logp, torch.float32),
               "emit_block": (dfst.emit_block, I32),
               "over_packed": (dfst.over_packed, I32)}
    if need_lm:
        tensors["lm"] = (beam.lm, I32)
    if split:
        tensors["emit_hot"] = (dfst.emit_hot, I32)
    for name, (t, dtype) in tensors.items():
        if t is None or t.device != dev or t.dtype != dtype:
            raise ValueError(f"expand_emitting: {name} must be a {dtype} "
                             f"tensor on {dev}")
    if split and (dfst.emit_hot.dim() != 2 or dfst.emit_hot.shape[1] != row_w
                  or dfst.emit_hot.shape[0] < 1):
        raise ValueError(f"expand_emitting: emit_hot must hold rows of "
                         f"{row_w} lanes")
    if (k != cfg.beam_size or tuple(beam.costs.shape) != (b, k)
            or (need_lm and tuple(beam.lm.shape) != (b, k))
            or logp.dim() != 2 or logp.shape[0] != b):
        raise ValueError(f"expand_emitting: needs beam [B, {cfg.beam_size}] "
                         f"and logp [B, P]; got {tuple(states.shape)}, "
                         f"{tuple(logp.shape)}")
    if row_valid is not None and (
            row_valid.device != dev or row_valid.dtype != torch.bool
            or tuple(row_valid.shape) != (b,)
            or not row_valid.is_contiguous()):
        raise ValueError("expand_emitting: row_valid must be a contiguous "
                         "bool [B] tensor on the beam's device")
    if dev.type == "cpu":
        return expand_emitting_ref(cfg, dfst, beam, logp, need_lm, row_valid)
    if not (dfst.emit_block.is_contiguous()
            and dfst.over_packed.is_contiguous()
            and (not split or dfst.emit_hot.is_contiguous())):
        raise ValueError("expand_emitting: the graph's tables must be "
                         "contiguous")
    # The beam is contiguous on the decode path; logp may be a frame of a
    # [T, B, P] view (row stride T * P), which the kernel reads in place.
    states, costs = states.contiguous(), beam.costs.contiguous()
    lms = beam.lm.contiguous() if need_lm else None
    if logp.stride(1) != 1:
        logp = logp.contiguous()
    csr = dfst.max_emit_fanout > g
    n_slots = -(-cfg.expand_size // gc) if csr else 0
    if csr and dfst.over_packed.shape[0] < 1:
        raise ValueError("expand_emitting: no over_packed rows")
    e = emit_lanes(cfg, dfst)

    def out(dtype, shape=(b, e)):
        return torch.empty(shape, dtype=dtype, device=dev)

    c = EmitCands(out(I32), out(torch.float32), out(I32), out(I32),
                  out(I32), out(I32) if need_lm else None,
                  out(torch.bool, (b,)), out(I32, (b,)),
                  out(torch.bool, (b,)) if split else None,
                  out(I32, (b,)) if split else None)
    if b:
        lib = kernel_library("frame_expand", _EXPAND_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.catears_frame_expand(
                states.data_ptr(), costs.data_ptr(),
                lms.data_ptr() if need_lm else None,
                dfst.emit_block.data_ptr(), dfst.over_packed.data_ptr(),
                logp.data_ptr(), *(x.data_ptr() if x is not None else None
                                   for x in c[:8]),
                dfst.emit_hot.data_ptr() if split else None,
                *(x.data_ptr() if x is not None else None for x in c[8:]),
                None if row_valid is None else row_valid.data_ptr(),
                dfst.hot_rows if split else 0,
                min(cfg.cold_expand_size, k) if split else 0,
                b, k, e, g, row_w, int(compact), dfst.num_states, gc,
                dfst.over_packed.shape[0], n_slots, int(csr), logp.shape[1],
                logp.stride(0), float(np.float32(cfg.am_scale)),
                torch.cuda.current_stream().cuda_stream)
        check_launch(lib, rc, "expand_emitting")
        _EXPAND_COUNTER.launches += 1
    return c


# The launches are counted on the function object itself, held here so
# that a caller who swaps the module's name for a wrapper of it does not
# take the count.
expand_emitting.launches = 0
_EXPAND_COUNTER = expand_emitting
_EXPAND_ARGTYPES = {"catears_frame_expand": [ctypes.c_void_p] * 18
                    + [ctypes.c_int] * 15 + [ctypes.c_float,
                                             ctypes.c_void_p]}


def expand_emitting_ref(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState,
                        logp: torch.Tensor, need_lm: bool,
                        row_valid: Optional[torch.Tensor] = None
                        ) -> EmitCands:
    """Plain version of expand_emitting: _expand (the hot/cold split
    included), _acoustic and _fms, with the dead lanes masked; a row that
    row_valid masks gets a dead row's lanes and per-row outputs."""
    c = _expand(cfg, dfst, beam, cfg.expand_size, True, need_lm=need_lm,
                need_bp=False, need_eps=True)
    cost = _fms(c.cost, cfg.am_scale, _acoustic(logp, c.pdf))
    v = c.valid
    if row_valid is not None:
        v = v & row_valid[:, None]

    def live(x):
        return torch.where(v, x, 0)

    def row(x):
        return (x if row_valid is None or x is None
                else torch.where(row_valid, x, torch.zeros_like(x)))

    return EmitCands(torch.where(v, c.next_state, SENTINEL_STATE),
                     torch.where(v, cost, INF), live(c.tok), live(c.olabel),
                     live(c.eps), live(c.lm) if need_lm else None,
                     row(c.overflow), row(c.needed), row(c.cold_over),
                     row(c.cold_needed))


class Selected(NamedTuple):
    """The eps-free frame's new beam [B, K] and trace: slots in cost
    order; a slot not kept holds state -1, cost +inf, prev_slot 0 and
    words 0 (its lm is the winner's while the winner's cost is finite);
    with select_compact at c2 == K the slots are in (state, lm) order."""

    states: torch.Tensor
    lms: torch.Tensor
    costs: torch.Tensor
    prev_slot: torch.Tensor
    words: torch.Tensor  # [B, K, 2] newest-first: (olab2, olabel)
    overflow: Optional[torch.Tensor]  # bool [B]: select_compact truncated
    demand: torch.Tensor  # i32 [B] (hiwater slot 3)


def select_geometry(e: int) -> Tuple[int, int, bool]:
    """(CTAs a row's cluster takes, log2 of its table's slots, whether the
    table lives in shared memory) of csrc/frame_select.cu over e lanes: a
    function of the shape alone.  The table has more than e * 4/3 slots
    (at least 16); its slices of at most _SELECT_SLICE_BYTES (16 B a slot)
    take the CTAs' shared memory, 8 CTAs where that does, else 16; a
    larger table keeps 16 slices in global scratch."""
    log2cap = max(4, (e + e // 3).bit_length())
    table = 16 << log2cap
    for cluster in (8, 16):
        if table // cluster <= _SELECT_SLICE_BYTES:
            return cluster, log2cap, True
    return 16, log2cap, False


def select_row_log2cap(live: int, e: int) -> int:
    """Log2 of the table slots csrc/frame_select.cu gives a row with
    `live` live lanes (state < SENTINEL_STATE) of e: on the shared path
    the shape's table (select_geometry(e)); on the global path the least
    power of two above 4/3 of the live lanes, at least the cluster's C
    slots and at most the shape's cap."""
    cluster, log2cap, shared = select_geometry(e)
    if shared:
        return log2cap
    return min(log2cap, max(cluster.bit_length() - 1,
                            (live + live // 3).bit_length()))


def select_clusters(e: int, k: int) -> int:
    """The clusters of select_beam's launch over [B, e] lanes at beam k
    that the current card holds at once (cudaOccupancyMaxActiveClusters):
    the rows one wave of the kernel takes."""
    cluster, log2cap, shared = select_geometry(e)
    lib = kernel_library("frame_select", _SELECT_ARGTYPES)
    n = ctypes.c_int(0)
    rc = lib.catears_frame_select_clusters(k, log2cap,
                                           cluster.bit_length() - 1,
                                           int(shared), ctypes.addressof(n))
    check_launch(lib, rc, "select_clusters")
    return n.value


def select_beam(cfg: BeamConfig, state: torch.Tensor,
                lm: Optional[torch.Tensor], cost: torch.Tensor,
                w1: Optional[torch.Tensor], w2: Optional[torch.Tensor],
                tok: torch.Tensor, olab2: torch.Tensor,
                olabel: torch.Tensor,
                stamps: Optional[torch.Tensor] = None,
                row_valid: Optional[torch.Tensor] = None) -> Selected:
    """The eps-free frame's selection over [B, E] candidates: cost + w1 +
    w2 (each optional, added in that order), exact dedup by (state, lm)
    (lm None: LM off), exact top-K by cost (with cfg.select_compact, of
    the beam-threshold survivors compacted first), the beam threshold.
    `row_valid`, a contiguous bool [B] tensor on the candidates' device
    (None: every row), masks rows: a masked row's outputs are those of a
    row whose every lane is dead (states -1, lms 0, costs +inf, prev_slot
    0, words 0, demand 0, overflow False), and the kernel does no work
    for it.

    CPU tensors take the plain version (select_beam_ref); CUDA tensors
    launch the hand-written kernel (csrc/frame_select.cu: one thread-block
    cluster per row, select_geometry(E); group winners by 64-bit CASes in
    a table partitioned over the cluster's shared memory, each lane routed
    to the CTA that owns its home slot; radix selects from the
    candidates' common prefix; per-CTA sorts merged by rank; on the
    global-table path each row's table sized to its live lanes,
    select_row_log2cap) or raise.  `select_beam.launches` counts the
    launches.  `stamps`, an int64 [B, SELECT_STAMPS] CUDA tensor, has the
    kernel write each row's phase times and table slots (see
    frame_select.cu); the decode path passes none.
    """
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"select_beam: unsupported device {state.device}")
    if state.dim() != 2:
        raise ValueError(f"select_beam: needs [B, E] candidates; got "
                         f"{tuple(state.shape)}")
    b, e = state.shape
    k = cfg.beam_size
    columns = {"state": (state, I32), "lm": (lm, I32),
               "cost": (cost, torch.float32), "w1": (w1, torch.float32),
               "w2": (w2, torch.float32), "tok": (tok, I32),
               "olab2": (olab2, I32), "olabel": (olabel, I32)}
    for name, (t, dtype) in columns.items():
        if t is not None and (t.device != state.device or t.dtype != dtype
                              or tuple(t.shape) != (b, e)):
            raise ValueError(f"select_beam: {name} must be a {dtype} "
                             f"[B, E] tensor on {state.device}")
    if stamps is not None and (
            stamps.device != state.device or state.device.type != "cuda"
            or stamps.dtype != torch.int64
            or tuple(stamps.shape) != (b, SELECT_STAMPS)
            or not stamps.is_contiguous()):
        raise ValueError(f"select_beam: stamps must be a contiguous int64 "
                         f"[B, {SELECT_STAMPS}] tensor on the candidates' "
                         f"CUDA device")
    if row_valid is not None and (
            row_valid.device != state.device or row_valid.dtype != torch.bool
            or tuple(row_valid.shape) != (b,)
            or not row_valid.is_contiguous()):
        raise ValueError("select_beam: row_valid must be a contiguous bool "
                         "[B] tensor on the candidates' device")
    if state.device.type == "cpu":
        return select_beam_ref(cfg, state, lm, cost, w1, w2, tok, olab2,
                               olabel, row_valid)
    if not all(t.is_contiguous() for t, _ in columns.values()
               if t is not None):
        raise ValueError("select_beam: the candidates must be contiguous")
    if not 1 <= k <= _SELECT_MAX_K or e >= 2**30:
        raise ValueError(f"select_beam: the kernel takes a beam of "
                         f"1..{_SELECT_MAX_K} slots over < 2^30 lanes; got "
                         f"{k}, {e}")
    dev = state.device
    c2 = _compact_width(cfg, e)
    out = Selected(torch.empty((b, k), dtype=I32, device=dev),
                   torch.empty((b, k), dtype=I32, device=dev),
                   torch.empty((b, k), dtype=torch.float32, device=dev),
                   torch.empty((b, k), dtype=I32, device=dev),
                   torch.empty((b, k, 2), dtype=I32, device=dev),
                   torch.empty(b, dtype=torch.bool, device=dev) if c2
                   else None,
                   torch.empty(b, dtype=I32, device=dev))
    if b:
        cluster, log2cap, shared = select_geometry(e)
        table = None if shared else torch.empty(
            (b, 1 << log2cap, 2), dtype=torch.int64, device=dev)
        lib = kernel_library("frame_select", _SELECT_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.catears_frame_select(
                *(t.data_ptr() if t is not None else None
                  for t, _ in columns.values()),
                *(x.data_ptr() for x in out[:5]), out.demand.data_ptr(),
                out.overflow.data_ptr() if c2 else None,
                None if table is None else table.data_ptr(),
                None if stamps is None else stamps.data_ptr(),
                None if row_valid is None else row_valid.data_ptr(), b, e,
                k, c2, log2cap, cluster.bit_length() - 1, int(shared),
                float(np.float32(cfg.beam)),
                torch.cuda.current_stream().cuda_stream)
        check_launch(lib, rc, "select_beam")
        _SELECT_COUNTER.launches += 1
    return out


select_beam.launches = 0
_SELECT_COUNTER = select_beam  # as _EXPAND_COUNTER
_SELECT_MAX_K = 8192  # the beam widths the kernel is built and tested for
_SELECT_SLICE_BYTES = 128 * 1024  # frame_select.cu kSliceBytes
SELECT_STAMPS = 16  # frame_select.cu kStamps
_SELECT_ARGTYPES = {"catears_frame_select": [ctypes.c_void_p] * 18
                    + [ctypes.c_int] * 7 + [ctypes.c_float,
                                            ctypes.c_void_p],
                    "catears_frame_select_clusters": [ctypes.c_int] * 4
                    + [ctypes.c_void_p]}


def select_beam_ref(cfg: BeamConfig, state: torch.Tensor,
                    lm: Optional[torch.Tensor], cost: torch.Tensor,
                    w1: Optional[torch.Tensor], w2: Optional[torch.Tensor],
                    tok: torch.Tensor, olab2: torch.Tensor,
                    olabel: torch.Tensor,
                    row_valid: Optional[torch.Tensor] = None) -> Selected:
    """Plain version of select_beam: _select_best (the classic sorts, or
    select_compact's compaction) and the beam threshold; a row that
    row_valid masks has every lane dead (state SENTINEL_STATE, cost +inf).

    JAX's keep is `costs <= min + beam` alone, so a row with no finite
    slot (min = +inf) keeps the payloads of whatever entries fill its
    slots; _frame_step throws that frame away (its beam died).  Here such
    slots hold prev_slot 0 and words 0, as the kernel writes them."""
    for w in (w1, w2):
        if w is not None:
            cost = cost + w
    if row_valid is not None:
        state = torch.where(row_valid[:, None], state, SENTINEL_STATE)
        cost = torch.where(row_valid[:, None], cost, INF)
    (states, lms, costs, prev, w0, w1_), overflow, demand = _select_best(
        cfg, state, lm, cost, [tok, olab2, olabel], compact=True)
    # min, not costs[:, 0]: a compacted selection returns the beam in
    # dedup (state) order.
    cutoff = torch.amin(costs, dim=1, keepdim=True) + cfg.beam
    keep = (costs <= cutoff) & torch.isfinite(costs)
    return Selected(
        torch.where(keep, states, -1), lms, torch.where(keep, costs, INF),
        torch.where(keep, prev, 0),
        torch.stack([torch.where(keep, w0, 0), torch.where(keep, w1_, 0)],
                    dim=2), overflow, demand)


def _eps_free_step(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                   beam: BeamState, logp: torch.Tensor,
                   frame_valid: Optional[torch.Tensor] = None):
    """One-selection frame for eps-removed graphs: expand emitting arcs
    (each carrying up to two output labels) with the acoustic term
    (expand_emitting), with an LM the two delta-LM walks, then one exact
    dedup + top-K + beam threshold (select_beam): on a card two hand
    kernels, with or without the hot/cold split and select_compact.
    `frame_valid` [B] (None: every row) reaches select_beam as its
    row_valid, and with no LM expand_emitting too: the rows whose frame is
    invalid, which the caller throws away, get a dead row's selection,
    and on a card cost either kernel nothing.  With an LM the expansion
    runs every row: the delta-LM walks read every lane.

    Returns (beam', prev_slot [B, K], words [B, K, 2] newest-first).
    """
    c = expand_emitting(cfg, dfst, beam, logp, dlm is not None,
                        row_valid=frame_valid if dlm is None else None)
    overflow, hiwater = _emit_telemetry(beam, c)
    lm_state = w1 = w2 = None
    if dlm is not None:
        # Two LM transitions in sequence, each weight added on its own as
        # JAX adds it: the emitting olabel (statically absent when no
        # emitting arc carries one), then the composed olabel2.
        if dfst.has_emit_olabel:
            lm1, w1, over1, need1 = _lm(cfg, dlm, c.lm, c.olabel)
        else:
            lm1 = c.lm
            over1 = torch.zeros_like(overflow)
            need1 = torch.zeros_like(c.needed)
        lm_state, w2, over2, need2 = _lm(cfg, dlm, lm1, c.olab2)
        overflow = overflow | over1 | over2
        hiwater = _max_at(hiwater, 2, torch.maximum(need1, need2))
    s = select_beam(cfg, c.state, lm_state, c.cost, w1, w2, c.tok, c.olab2,
                    c.olabel, row_valid=frame_valid)
    k = cfg.beam_size
    new_beam = BeamState(
        s.states, s.lms, s.costs,
        _arange(k, s.states.device).expand_as(s.states).contiguous(),
        _or(overflow, s.overflow), _max_at(hiwater, 3, s.demand))
    return new_beam, s.prev_slot, s.words


def _emitting_step(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                   beam: BeamState, logp: torch.Tensor):
    """Relax all emitting arcs of a graph that keeps its epsilon arcs; the
    closure follows.  One LM walk (the emitting olabel) whenever a G' is
    present.  With a static closure depth the destinations' packed eps
    metadata rides the selection, so the closure needs no state gather.

    Returns (beam', parent [B, K], olab0 [B, K], cutoff [B, 1], eps_info):
    beam.bp is the identity, eps_info is (eps_meta,) or ().
    """
    need_eps = (dfst.eps_depth is not None
                and 0 < dfst.eps_depth <= cfg.max_eps_iters
                and dfst.eps_meta_ok)
    c = _expand(cfg, dfst, beam, cfg.expand_size, True,
                need_lm=dlm is not None, need_bp=False, need_eps=need_eps)
    cost = _fms(c.cost, cfg.am_scale, _acoustic(logp, c.pdf))
    overflow, hiwater = _emit_telemetry(beam, c)
    lm_state = None
    if dlm is not None:
        lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm, c.olabel,
                                                 c.valid)
        cost = cost + lm_w
        overflow = overflow | lm_over
        hiwater = _max_at(hiwater, 2, lm_needed)
    cand_state = torch.where(c.valid, c.next_state, SENTINEL_STATE)
    cand_cost = torch.where(c.valid, cost, INF)
    payloads = [c.tok, c.olabel] + ([c.eps] if need_eps else [])
    (states, lms, costs, parent, olab, *eps_info), sel_over, sel_needed = \
        _select_best(cfg, cand_state, lm_state, cand_cost, payloads,
                     compact=True)
    cutoff = torch.amin(costs, dim=1, keepdim=True) + cfg.beam
    keep = costs <= cutoff
    states = torch.where(keep, states, -1)
    costs = torch.where(keep, costs, INF)
    new_beam = BeamState(
        states, lms, costs,
        _arange(cfg.beam_size, states.device).expand_as(states).contiguous(),
        _or(overflow, sel_over), _max_at(hiwater, 3, sel_needed))
    return (new_beam, parent, torch.where(keep, olab, 0), cutoff,
            tuple(eps_info))


def _eps_closure_fused(cfg: BeamConfig, dfst: DeviceFst,
                       dlm: Optional[DeviceLm], beam: BeamState,
                       parent: torch.Tensor, olab0: torch.Tensor,
                       eps_info: Tuple, cutoff: float):
    """Static-depth epsilon closure with inline trace composition: each
    round extends every chain by one hop, so the per-slot (prev_slot,
    words) trace is composed with one row gather per round and no arena.
    beam.bp must be the identity, as _emitting_step returns it.

    Returns (beam', prev_slot [B, K], words [B, K, rounds+1] newest-first).
    """
    k = cfg.beam_size
    rounds = _closure_rounds(cfg, dfst)
    prev = parent
    words = olab0[..., None]
    dev = beam.states.device
    slots = _arange(k, dev).expand_as(beam.states)
    use_meta = dfst.eps_meta_ok
    for j in range(rounds):
        carry_eps = use_meta and j + 1 < rounds
        if use_meta:
            (eps_meta,) = eps_info
            c = _expand_eps_carried(dfst, beam, cfg.eps_expand_size,
                                    eps_meta, need_lm=dlm is not None,
                                    need_eps=carry_eps)
        else:
            c = _expand(cfg, dfst, beam, cfg.eps_expand_size, False,
                        need_lm=dlm is not None, need_bp=True)
        cost = c.cost
        overflow = beam.overflow | c.overflow
        hiwater = _max_at(beam.hiwater, 1, c.needed)
        m_lms = None
        if dlm is not None:
            lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm,
                                                     c.olabel, c.valid)
            cost = cost + lm_w
            overflow = overflow | lm_over
            hiwater = _max_at(hiwater, 2, lm_needed)
            m_lms = torch.cat([beam.lm, lm_state], dim=1)
        valid_e = c.valid & (cost <= cutoff)
        cand_state = torch.where(valid_e, c.next_state, SENTINEL_STATE)
        cand_cost = torch.where(valid_e, cost, INF)
        m_states = torch.cat([beam.states, cand_state], dim=1)
        m_costs = torch.cat([beam.costs, cand_cost], dim=1)
        # Carried entries point at their own slot, candidates at their
        # source slot + k (one payload carries is_cand too).
        m_ref = torch.cat([slots, c.bp + k], dim=1)
        m_olab = torch.cat([torch.zeros_like(slots), c.olabel], dim=1)
        payloads = [m_ref, m_olab]
        if carry_eps:
            payloads.append(torch.cat([eps_meta, c.eps], dim=1))
        (states, lms, costs, ref_enc, olab, *eps_out), sel_needed = \
            _select_sorts(cfg, m_states, m_lms, m_costs, payloads)
        eps_info = tuple(eps_out)
        iscand = ref_enc >= k
        r = torch.clamp(torch.where(iscand, ref_enc - k, ref_enc), 0, k - 1)
        row = torch.cat([prev[..., None], words], dim=2)
        row = torch.gather(row, 1, r.long()[..., None].expand(
            -1, -1, row.shape[2]))
        accepted = iscand & (states >= 0)
        prev = row[..., 0]
        zero = torch.zeros_like(row[..., :1])
        words = torch.where(accepted[..., None],
                            torch.cat([olab[..., None], row[..., 1:]], 2),
                            torch.cat([row[..., 1:], zero], 2))
        beam = BeamState(states, lms, costs, slots.contiguous(), overflow,
                         _max_at(hiwater, 3, sel_needed))
    return beam, prev, words


def _arena_from_emit(cfg: BeamConfig, dfst: DeviceFst, parent: torch.Tensor,
                     olab: torch.Tensor) -> torch.Tensor:
    """Arena [B, rows, 2] of the dynamic closure, block 0 from the
    emitting step.  Rows are packed (parent_enc, olabel); parent_enc =
    -(prev_slot + 1) marks a previous-frame reference."""
    b, k = parent.shape
    arena = torch.zeros((b, cfg.arena_rows(dfst), 2), dtype=I32,
                        device=parent.device)
    arena[:, :k, 0] = -(parent + 1)
    arena[:, :k, 1] = olab
    return arena


def _static_depth(cfg: BeamConfig, dfst: DeviceFst) -> bool:
    return dfst.eps_depth is not None and dfst.eps_depth <= cfg.max_eps_iters


def _eps_closure(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                 beam: BeamState, arena: torch.Tensor, cutoff):
    """Bounded epsilon closure over the backpointer arena (graphs without a
    static depth): max_eps_iters rounds of expand the beam's epsilon arcs
    -> merge beam + candidates (beam entries first, so a cost tie keeps
    the beam entry) -> one selection; round j's accepted candidates get
    arena block 1 + j.  No round reads the device (module docstring)."""
    k = cfg.beam_size
    m = arena.shape[1]
    slots = _arange(k, arena.device)
    for j in range(cfg.max_eps_iters):
        c = _expand(cfg, dfst, beam, cfg.eps_expand_size, False,
                    need_lm=dlm is not None, need_bp=True)
        cost = c.cost
        overflow = beam.overflow | c.overflow
        hiwater = _max_at(beam.hiwater, 1, c.needed)
        m_lms = None
        if dlm is not None:
            lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm,
                                                     c.olabel, c.valid)
            cost = cost + lm_w
            overflow = overflow | lm_over
            hiwater = _max_at(hiwater, 2, lm_needed)
            m_lms = torch.cat([beam.lm, lm_state], dim=1)
        valid_e = c.valid & (cost <= cutoff)
        m_states = torch.cat([beam.states, torch.where(
            valid_e, c.next_state, SENTINEL_STATE)], dim=1)
        m_costs = torch.cat([beam.costs, torch.where(valid_e, cost, INF)],
                            dim=1)
        # Candidate refs are offset by the arena's row count, so one
        # payload column also says which entries are candidates.
        m_ref = torch.cat([beam.bp, c.bp + m], dim=1)
        m_olab = torch.cat([torch.zeros_like(beam.bp), c.olabel], dim=1)
        (states, lms, costs, ref_enc, olab), sel_needed = _select_sorts(
            cfg, m_states, m_lms, m_costs, [m_ref, m_olab])
        iscand = ref_enc >= m
        ref = torch.where(iscand, ref_enc - m, ref_enc)
        accepted = iscand & (states >= 0)
        base = (1 + j) * k
        arena[:, base:base + k, 0] = torch.where(accepted, ref, 0)
        arena[:, base:base + k, 1] = torch.where(accepted, olab, 0)
        beam = BeamState(states, lms, costs,
                         torch.where(accepted, base + slots, ref), overflow,
                         _max_at(hiwater, 3, sel_needed))
    return beam, arena


def _resolve_chains(cfg: BeamConfig, dfst: DeviceFst, bp: torch.Tensor,
                    arena: torch.Tensor):
    """Walk each slot's same-frame arena chain -> (prev_slot [B, K],
    words [B, K, W] newest-first), W = 1 + the closure rounds."""
    if dfst.eps_depth is not None:
        hops = min(dfst.eps_depth, cfg.max_eps_iters) + 1
    else:
        hops = cfg.max_eps_iters + 1
    b, k = bp.shape
    prev_slot = torch.full((b, k), -1, dtype=I32, device=bp.device)
    cur = bp
    active = torch.ones((b, k), dtype=torch.bool, device=bp.device)
    words = []
    for _ in range(hops):
        row = torch.gather(arena, 1, cur.long()[..., None].expand(b, k, 2))
        p, o = row[..., 0], row[..., 1]
        words.append(torch.where(active, o, 0))
        prev_slot = torch.where(active & (p < 0), -p - 1, prev_slot)
        step = active & (p >= 0)
        cur = torch.where(step, p, cur)
        active = step
    return prev_slot, torch.stack(words, dim=2)


def _frame_step(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                beam: BeamState, logp: torch.Tensor,
                frame_valid: torch.Tensor):
    """One decode frame for a batch; identity where frame_valid is False.

    If an utterance's beam dies (no token survives), its previous beam is
    frozen so the best path still returns the last partial hypothesis.
    """
    if dfst.eps_removed:
        # frame_valid as the caller holds it: in a captured chunk a view of
        # the runner's static mask, so that each replay reads its own.
        new_beam, prev_slot, words = _eps_free_step(cfg, dfst, dlm, beam,
                                                    logp, frame_valid)
    else:
        new_beam, parent, olab0, cutoff, eps_info = _emitting_step(
            cfg, dfst, dlm, beam, logp)
        if _static_depth(cfg, dfst):
            new_beam, prev_slot, words = _eps_closure_fused(
                cfg, dfst, dlm, new_beam, parent, olab0, eps_info, cutoff)
        else:
            arena = _arena_from_emit(cfg, dfst, parent, olab0)
            new_beam, arena = _eps_closure(cfg, dfst, dlm, new_beam, arena,
                                           cutoff)
            prev_slot, words = _resolve_chains(cfg, dfst, new_beam.bp,
                                               arena)
    # Overflow only counts on real frames.
    overflow = torch.where(frame_valid, new_beam.overflow, beam.overflow)
    died = ~torch.isfinite(new_beam.costs[:, 0])
    frame_valid = frame_valid & ~died
    fv = frame_valid[:, None]
    slots = _arange(cfg.beam_size, beam.states.device).expand_as(beam.states)
    out_beam = BeamState(torch.where(fv, new_beam.states, beam.states),
                         torch.where(fv, new_beam.lm, beam.lm),
                         torch.where(fv, new_beam.costs, beam.costs),
                         slots.contiguous(), overflow,
                         torch.where(fv, new_beam.hiwater, beam.hiwater))
    trace = FrameTrace(
        prev_slot=torch.where(fv, prev_slot, slots),
        words=torch.where(fv[..., None], words, torch.zeros_like(words)),
    )
    return out_beam, trace


def init_beam_batch(cfg: BeamConfig, batch: int, dfst: DeviceFst,
                    dlm: Optional[DeviceLm] = None
                    ) -> Tuple[BeamState, FrameTrace]:
    """Root token (LM state dlm.start) + initial epsilon closure, tiled to
    [B] utterances (the JAX make_init_beam + init_beam_batch)."""
    k = cfg.beam_size
    dev = dfst.device
    # Slot 0 set by fill_: assigning a Python number to an element of a
    # card's tensor copies it from the host and waits for the card.
    states = torch.full((1, k), -1, dtype=I32, device=dev)
    states[0, 0].fill_(dfst.start)
    lms = torch.zeros((1, k), dtype=I32, device=dev)
    if dlm is not None:
        lms[0, 0].fill_(dlm.start)
    costs = torch.full((1, k), INF, dtype=torch.float32, device=dev)
    costs[0, 0].fill_(0.0)
    bp = _arange(k, dev)[None]
    beam = BeamState(states, lms, costs, bp,
                     torch.zeros(1, dtype=torch.bool, device=dev),
                     torch.zeros((1, 5), dtype=I32, device=dev))
    if _static_depth(cfg, dfst):
        sp = dfst.state_packed[torch.clamp(states, 0,
                                           dfst.num_states - 1).long()]
        eps_info = ((sp[..., 0] << 9)
                    | torch.where(states >= 0, sp[..., 1], 0),)
        beam, _, words = _eps_closure_fused(cfg, dfst, dlm, beam, bp,
                                            torch.zeros_like(bp), eps_info,
                                            INF)
    else:
        # Root entries end the backtrace: parent slot of a frame that does
        # not exist.
        arena = _arena_from_emit(cfg, dfst, bp, torch.zeros_like(bp))
        beam, arena = _eps_closure(cfg, dfst, dlm, beam, arena, INF)
        _, words = _resolve_chains(cfg, dfst, beam.bp, arena)
    trace = FrameTrace(torch.full((1, k), -1, dtype=I32, device=dev), words)
    beam = BeamState(beam.states, beam.lm, beam.costs, bp, beam.overflow,
                     beam.hiwater)

    def tile(x):
        return x.expand((batch,) + tuple(x.shape[1:])).contiguous()

    return (BeamState(*(tile(x) for x in beam)),
            FrameTrace(*(tile(x) for x in trace)))


def decode_chunk(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState,
                 logp: torch.Tensor, frame_valid: torch.Tensor,
                 dlm: Optional[DeviceLm] = None):
    """Run a [C, B, P] chunk of log-prob frames through the decoder
    (rescored by the delta-LM when dlm is given).

    Returns (beam', FrameTrace stacked [C, B, ...]).
    """
    prevs: List[torch.Tensor] = []
    words: List[torch.Tensor] = []
    for f in range(logp.shape[0]):
        beam, tr = _frame_step(cfg, dfst, dlm, beam, logp[f],
                               frame_valid[f])
        prevs.append(tr.prev_slot)
        words.append(tr.words)
    return beam, FrameTrace(torch.stack(prevs), torch.stack(words))


def backtrace_device(traces: FrameTrace,
                     best_slots: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] traces + [B] slots -> [B, T, W] words (frame-indexed,
    newest-first within a frame; see hyp.assemble_words).

    CPU tensors take the plain version (backtrace_device_ref); CUDA tensors
    launch the hand-written kernel (csrc/backtrace.cu: one thread per
    utterance chases its backpointers over all T frames in one launch) or
    raise.  The kernel's output is contiguous; the plain version's is a
    transposed view with the same values.  `backtrace_device.launches`
    counts its launches.
    """
    prev, words = traces
    if words.device.type == "cpu":
        return backtrace_device_ref(traces, best_slots)
    if words.device.type != "cuda":
        raise ValueError(f"backtrace_device: unsupported device "
                         f"{words.device}")
    t, b, k, w = words.shape
    if (prev.dtype != I32 or words.dtype != I32 or k < 1
            or tuple(prev.shape) != (t, b, k)
            or tuple(best_slots.shape) != (b,)
            or best_slots.dtype not in (torch.int32, torch.int64)
            or prev.device != words.device
            or best_slots.device != words.device):
        raise ValueError(f"backtrace_device: needs int32 prev_slot [T, B, K] "
                         f"and words [T, B, K >= 1, W] and integer "
                         f"best_slots [B] on one device; got "
                         f"{tuple(prev.shape)} {prev.dtype}, "
                         f"{tuple(words.shape)} {words.dtype}, "
                         f"{tuple(best_slots.shape)} {best_slots.dtype}")
    if not (prev.is_contiguous() and words.is_contiguous()):
        raise ValueError("backtrace_device: the traces must be contiguous")
    out = torch.empty((b, t, w), dtype=I32, device=words.device)
    if not out.numel():
        return out
    best = best_slots.to(I32).contiguous()
    lib = kernel_library("backtrace", _BACKTRACE_ARGTYPES)
    with torch.cuda.device(words.device):
        rc = lib.catears_backtrace(prev.data_ptr(), words.data_ptr(),
                                   best.data_ptr(), out.data_ptr(), t, b, k,
                                   w, torch.cuda.current_stream().cuda_stream)
    check_launch(lib, rc, "backtrace_device")
    backtrace_device.launches += 1
    return out


backtrace_device.launches = 0
_BACKTRACE_ARGTYPES = {"catears_backtrace": [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def backtrace_device_ref(traces: FrameTrace,
                         best_slots: torch.Tensor) -> torch.Tensor:
    """Plain version of backtrace_device: JAX's reverse scan step as a
    Python loop over the T frames."""
    prev, words = traces
    t, b, _, w = words.shape
    slot = torch.clamp(best_slots.to(torch.int64), min=0)
    active = torch.ones(b, dtype=torch.bool, device=words.device)
    out = torch.zeros((t, b, w), dtype=words.dtype, device=words.device)
    for f in range(t - 1, -1, -1):
        wf = torch.gather(words[f], 1, slot[:, None, None].expand(b, 1, w))
        out[f] = torch.where(active[:, None], wf[:, 0], 0)
        nxt = torch.gather(prev[f], 1, slot[:, None])[:, 0].to(torch.int64)
        step = active & (nxt >= 0)
        slot = torch.where(step, nxt, slot)
        active = step
    return out.transpose(0, 1)
