"""Offline graph transforms that trade arcs for decode-loop rounds, and
the state renumberings (the port's copy of catears_tpu/graph/transform.py).

`close_epsilons` adds the min-plus transitive closure of the epsilon
subgraph as direct arcs (keeping the originals), so the device epsilon
closure provably completes in ONE relaxation round.  mkgraph HCLGs chain
epsilons word-end -> LM-history -> backoff-root (depth 2-3 per LM order).

`remove_epsilons` goes one step further: it composes every EMITTING arc
with its destination's (closed) epsilon span, producing an eps-FREE frame
loop — the per-frame epsilon closure disappears entirely, and with it a
full dedup+top-K selection pass.  On TPU the selection sorts cost per
bitonic STAGE (~log^2 N), nearly independent of N at beam shapes
(scripts/frameprof.py round-3 measurements), so eliminating a whole
selection beats any candidate-count tuning.  Composed arcs carry up to
TWO output labels (emit olabel then eps-path olabel) — exactly the two
word lanes the frame trace already has.  The epsilon arcs stay in the
graph for the INIT closure (root state) only.

The reference resolves the same chains dynamically with a worklist
(reference src/decoder.cc:240-292); a TPU decoder pays per ROUND, not per
arc, which makes the offline trades profitable.

Exactness: every epsilon path u => x with total weight w and at most one
non-epsilon output label o becomes a direct arc (u, x, eps, o, w), deduped
by (u, x, o) keeping the minimum weight.  Reachable (state, cost) sets and
transcripts are identical; only the number of relaxation rounds needed to
saturate them changes.  If any epsilon path carries two or more output
labels (not produced by mkgraph), or the epsilon subgraph has non-trivial
zero-weight cycles deeper than `max_rounds`, the transforms bail and
return the input unchanged.

The renumberings (`bfs_order`, `frequency_order`, `hot_order`, applied by
`renumber_states`) relabel states for the locality of the emit-table
gathers; they change no transcript.  `hot_order` pairs with
`DeviceFst.build(hot_rows=...)`, the hot/cold emit split.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from catears_tpu_torch.graph.fst import FlatFst


def _dedup_min(src, dst, olab, wgt):
    """Keep the min-weight arc per (src, dst, olab); returns sorted-by-key."""
    order = np.lexsort((wgt, olab, dst, src))
    src, dst, olab, wgt = src[order], dst[order], olab[order], wgt[order]
    first = np.ones(src.size, bool)
    first[1:] = ((src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
                 | (olab[1:] != olab[:-1]))
    return src[first], dst[first], olab[first], wgt[first]


def close_epsilons(fst: FlatFst, max_rounds: int = 8,
                   growth_limit: float = 0.5) -> Tuple[FlatFst, bool]:
    """Epsilon-closure arcs for depth-1 relaxation.

    Returns (new_fst, ok).  ok=False (input returned) when closure cannot
    be represented (multi-olabel paths / no convergence / growth beyond
    `growth_limit` of the total arc count).
    """
    n = fst.num_states
    state_of_arc = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(fst.offsets))
    is_eps = fst.arc_ilabel == 0
    if not is_eps.any():
        return fst, True
    esrc = state_of_arc[is_eps]
    edst = fst.arc_next[is_eps].astype(np.int64)
    eolab = fst.arc_olabel[is_eps].astype(np.int64)
    ewgt = fst.arc_weight[is_eps].astype(np.float64)

    # CSR over the ORIGINAL eps arcs, for joining closure frontiers.
    order = np.argsort(esrc, kind="stable")
    j_src, j_dst = esrc[order], edst[order]
    j_olab, j_wgt = eolab[order], ewgt[order]
    eps_of = np.zeros(n + 1, np.int64)
    np.add.at(eps_of[1:], j_src, 1)
    np.cumsum(eps_of, out=eps_of)

    # Relative growth limit with an absolute floor so tiny graphs (where
    # closure can triple a handful of eps arcs) are never rejected.
    budget = max(int(fst.num_arcs * growth_limit), 4096)
    csrc, cdst, colab, cwgt = _dedup_min(esrc, edst, eolab, ewgt)
    for _ in range(max_rounds):
        # Join every closure arc u=>v with every original eps arc v->x.
        counts = eps_of[cdst + 1] - eps_of[cdst]
        has = counts > 0
        if not has.any():
            break
        rep = np.repeat(np.arange(csrc.size), counts)
        starts = np.repeat(eps_of[cdst], counts)
        seg0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(counts.sum()) - np.repeat(seg0, counts)
        vx = starts + within
        if np.any((colab[rep] != 0) & (j_olab[vx] != 0)):
            return fst, False  # a path would carry two output labels
        nsrc = csrc[rep]
        ndst = j_dst[vx]
        nolab = np.where(colab[rep] != 0, colab[rep], j_olab[vx])
        nwgt = cwgt[rep] + j_wgt[vx]
        m_src, m_dst, m_olab, m_wgt = _dedup_min(
            np.concatenate([csrc, nsrc]), np.concatenate([cdst, ndst]),
            np.concatenate([colab, nolab]), np.concatenate([cwgt, nwgt]))
        if m_src.size - esrc.size > budget:
            return fst, False
        converged = (m_src.size == csrc.size
                     and np.array_equal(m_src, csrc)
                     and np.array_equal(m_dst, cdst)
                     and np.array_equal(m_olab, colab)
                     and np.allclose(m_wgt, cwgt, rtol=0, atol=0))
        csrc, cdst, colab, cwgt = m_src, m_dst, m_olab, m_wgt
        if converged:
            break
    else:
        return fst, False  # did not converge within max_rounds

    keep = ~is_eps
    out = FlatFst.from_arrays(
        fst.start, fst.final,
        np.concatenate([state_of_arc[keep], csrc]),
        np.concatenate([fst.arc_next[keep].astype(np.int64), cdst]),
        np.concatenate([fst.arc_ilabel[keep].astype(np.int64),
                        np.zeros_like(csrc)]),
        np.concatenate([fst.arc_olabel[keep].astype(np.int64), colab]),
        np.concatenate([fst.arc_weight[keep].astype(np.float64),
                        cwgt]).astype(np.float32))
    return out, True


def remove_epsilons(fst: FlatFst, growth_limit: float = 1.0
                    ) -> Tuple[FlatFst, Optional[np.ndarray], bool]:
    """Compose emitting arcs with their dest's eps span -> eps-free frames.

    Input must already be epsilon-CLOSED (depth 1: every eps target one
    arc away at min weight).  For each emitting arc a = (s -i-> d, o1, w1)
    and eps arc (d -> x, o2, w2), adds (s -i-> x, o1 then o2, w1 + w2).
    The original arcs (emitting AND epsilon) are kept: stopping at d is a
    valid token position, and the eps arcs still serve the decode-root
    initialization closure — the frame loop just never expands them.

    Returns (fst2, olabel2, ok): olabel2 is int32 [A2] with the composed
    arcs' SECOND (eps-path) output label, 0 elsewhere.  ok=False (input
    returned, olabel2 None) when composed growth exceeds `growth_limit`
    of the arc count.
    """
    n = fst.num_states
    state_of_arc = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(fst.offsets))
    is_eps = fst.arc_ilabel == 0
    if not is_eps.any():
        return fst, np.zeros(fst.num_arcs, np.int32), True
    # CSR over eps arcs by source state
    esrc = state_of_arc[is_eps]
    edst = fst.arc_next[is_eps].astype(np.int64)
    eolab = fst.arc_olabel[is_eps].astype(np.int64)
    ewgt = fst.arc_weight[is_eps].astype(np.float64)
    order = np.argsort(esrc, kind="stable")
    edst, eolab, ewgt = edst[order], eolab[order], ewgt[order]
    eps_of = np.zeros(n + 1, np.int64)
    np.add.at(eps_of[1:], esrc, 1)
    np.cumsum(eps_of, out=eps_of)

    emit = np.flatnonzero(~is_eps)
    d = fst.arc_next[emit].astype(np.int64)
    counts = eps_of[d + 1] - eps_of[d]
    total = int(counts.sum())
    if total > max(int(fst.num_arcs * growth_limit), 4096):
        return fst, None, False
    rep = np.repeat(emit, counts)  # composed arc's emitting parent
    starts = np.repeat(eps_of[d], counts)
    seg0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(seg0, counts)
    vx = starts + within  # eps arc index (in sorted-eps order)

    c_src = state_of_arc[rep]
    c_next = edst[vx]
    c_ilabel = fst.arc_ilabel[rep].astype(np.int64)
    c_olab1 = fst.arc_olabel[rep].astype(np.int64)
    c_olab2 = eolab[vx]
    c_wgt = fst.arc_weight[rep].astype(np.float64) + ewgt[vx]

    # Dedup composed arcs by (src, ilabel, next, o1, o2) keeping min
    # weight — distinct eps paths to the same target collapse.
    key = np.lexsort((c_wgt, c_olab2, c_olab1, c_next, c_ilabel, c_src))
    c_src, c_next, c_ilabel = c_src[key], c_next[key], c_ilabel[key]
    c_olab1, c_olab2, c_wgt = c_olab1[key], c_olab2[key], c_wgt[key]
    first = np.ones(c_src.size, bool)
    first[1:] = ((c_src[1:] != c_src[:-1]) | (c_next[1:] != c_next[:-1])
                 | (c_ilabel[1:] != c_ilabel[:-1])
                 | (c_olab1[1:] != c_olab1[:-1])
                 | (c_olab2[1:] != c_olab2[:-1]))
    c_src, c_next, c_ilabel = c_src[first], c_next[first], c_ilabel[first]
    c_olab1, c_olab2, c_wgt = c_olab1[first], c_olab2[first], c_wgt[first]

    all_src = np.concatenate([state_of_arc, c_src])
    all_next = np.concatenate([fst.arc_next.astype(np.int64), c_next])
    all_il = np.concatenate([fst.arc_ilabel.astype(np.int64), c_ilabel])
    all_o1 = np.concatenate([fst.arc_olabel.astype(np.int64), c_olab1])
    all_o2 = np.concatenate([np.zeros(fst.num_arcs, np.int64), c_olab2])
    all_w = np.concatenate([fst.arc_weight.astype(np.float64), c_wgt])
    # from_arrays sorts by (state, ilabel); replicate its ordering for
    # the aligned olabel2 column.
    sort_order = np.lexsort((all_il, all_src))
    out = FlatFst.from_arrays(fst.start, fst.final, all_src, all_next,
                              all_il, all_o1, all_w.astype(np.float32))
    return out, all_o2[sort_order].astype(np.int32), True


def bfs_order(fst: FlatFst) -> np.ndarray:
    """Breadth-first state order from the start state.

    Returns perm int32 [S] with perm[old_id] = new_id; unreachable states
    keep their relative order after the reachable ones.  States that share
    a decode frontier (trie prefixes, HMM chains at one depth) get nearby
    row ids.
    """
    n = fst.num_states
    order = np.full(n, -1, np.int64)
    seen = np.zeros(n, bool)
    frontier = np.array([fst.start], np.int64)
    seen[fst.start] = True
    nxt = 0
    while frontier.size:
        order[frontier] = np.arange(nxt, nxt + frontier.size)
        nxt += frontier.size
        # Every successor of the frontier, deduped, the unseen ones.
        lo = fst.offsets[frontier]
        hi = fst.offsets[frontier + 1]
        idx = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
        succ = np.unique(fst.arc_next[idx].astype(np.int64))
        succ = succ[~seen[succ]]
        seen[succ] = True
        frontier = succ
    rest = np.flatnonzero(order < 0)
    order[rest] = np.arange(nxt, nxt + rest.size)
    return order.astype(np.int32)


def frequency_order(counts: np.ndarray, tie_break: np.ndarray = None
                    ) -> np.ndarray:
    """Visit-frequency state order: the most visited states get the lowest
    ids.  counts [S] are per-state visit counts from a calibration decode;
    equal counts are ordered by tie_break (default: the state id)."""
    n = counts.shape[0]
    tb = tie_break if tie_break is not None else np.arange(n)
    rank = np.lexsort((tb, -counts.astype(np.int64)))
    perm = np.empty(n, np.int32)
    perm[rank] = np.arange(n, dtype=np.int32)
    return perm


def hot_order(counts: np.ndarray, hot_rows: int, seed: int = 0
              ) -> np.ndarray:
    """Hot/cold layout permutation: the `hot_rows` most visited states get
    ids [0, hot_rows), shuffled within that region by
    RandomState(seed), and the rest keep their relative order after them.
    Pair with DeviceFst.build(hot_rows=...), which copies those rows into
    the small emit_hot table."""
    n = counts.shape[0]
    h = min(hot_rows, n)
    top = np.argsort(-counts.astype(np.int64), kind="stable")[:h]
    shuffled = top[np.random.RandomState(seed).permutation(h)]
    perm = np.empty(n, np.int32)
    perm[shuffled] = np.arange(h, dtype=np.int32)
    is_hot = np.zeros(n, bool)
    is_hot[top] = True
    rest = np.flatnonzero(~is_hot)
    perm[rest] = (h + np.arange(rest.size)).astype(np.int32)
    return perm


def renumber_states(fst: FlatFst, perm: np.ndarray) -> FlatFst:
    """Apply a state permutation (perm[old] = new): an exact relabeling.
    Output labels are untouched, so transcripts are identical."""
    n = fst.num_states
    state_of_arc = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(fst.offsets))
    final = np.empty_like(fst.final)
    final[perm] = fst.final
    return FlatFst.from_arrays(
        start=int(perm[fst.start]), final=final,
        state_of_arc=perm[state_of_arc].astype(np.int64),
        arc_next=perm[fst.arc_next],
        arc_ilabel=fst.arc_ilabel,
        arc_olabel=fst.arc_olabel,
        arc_weight=fst.arc_weight)


def prepare_decode_graph(fst: FlatFst) -> Tuple[
        FlatFst, Optional[np.ndarray], str]:
    """One decision point for the decode-graph transform pipeline.

    Returns (fst2, olabel2, mode):
      mode == 'eps_free': olabel2 aligned with fst2's arcs; the frame loop
        runs with NO epsilon closure (decode.beam._eps_free_step) — the
        Decoder, the oracle, bench.py and the profiling scripts all key
        their semantics off this single function.
      mode == 'closed':   closure succeeded but composition would blow up;
        depth-1 fused closure path.
      mode == 'raw':      eps subgraph not closable (cyclic/deep); dynamic
        fallback paths.
    """
    closed, ok = close_epsilons(fst)
    if not ok:
        return fst, None, "raw"
    removed, olab2, ok2 = remove_epsilons(closed)
    if not ok2:
        return closed, None, "closed"
    return removed, olab2, "eps_free"
