"""The algorithms of the eps-free frame's two kernels, held to JAX on the CPU.

csrc/frame_expand.cu (decode/beam.py::expand_emitting on the card) and
csrc/frame_select.cu (decode/beam.py::select_beam) run only on a CUDA card.
Here a numpy model of each kernel, written as the kernel runs it, is
compared bit for bit with the JAX package's functions and with the port's
plain versions:

* the expansion: one thread per candidate lane in the plain lane order
  (K self-loops, K*G block lanes, the CSR slots); a CSR slot's owner by a
  binary search over the tokens' inclusive span-row sums; both emit row
  layouts; the hot/cold split's rows from a count of the cold tokens
  before each slot; cost = fma(-am_scale, logp[pdf], token cost + arc weight) with
  one rounding each; held to JAX's `_expand` + `_acoustic_lookup` and
  `_eps_free_step`'s acoustic line under jax.jit, on the valid lanes (the
  two JAX ownership branches differ on the dead ones);
* the selection: the row's group table split into one slice per CTA of
  a cluster (C = 1, 8, 16), each group claimed from its home slot with the
  probe running on into the next CTA's slice, in any lane order; the
  winner by a min over (order-preserving cost bits, lane); each CTA's
  candidates; radix selects of 8 bits a pass that start past the digits
  every candidate shares and sum the CTAs' histograms; each CTA's sorted
  keys merged by rank (a key's slot is its place in its own list plus the
  peers' keys below it); the threshold; with select_compact the
  beam-threshold survivors, the c2-th of them in (state, lm) order by a
  radix select first; held to JAX's `_select_best` (`_select_sorts` or
  `_select_compacted`) + `_eps_free_step`'s threshold on adversarial
  rows, on rows whose costs tie in bulk, and on rows whose groups all hash
  into one CTA's slice; the same at every table capacity from a row's
  own width (`select_row_log2cap`, the global-table path's rule) up to
  the shape's;
* the row mask: select_beam_ref gives a masked row a dead row's outputs
  and every other row the unmasked call's, and BatchDecoder, whose frame
  step masks each row by its frame's valid flag, equals JAX's decoder on
  a ragged batch.

The card's tests (tests/test_torch_cuda.py) hold each kernel to the same
plain versions bit for bit.
"""

import bisect
import dataclasses
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, SELECT_HASH, adversarial_rows, assert_same,
                           beam_rows, dfst_from_jax, dlm_from_jax,
                           group_home, random_beam, tied_rows, to_np,
                           with_live_lanes)
from catears_tpu.decode import beam as jbeam
from catears_tpu.graph.device import DeviceFst as JaxDeviceFst
from catears_tpu.graph.device import DeviceLm as JaxDeviceLm
from catears_tpu.graph.transform import prepare_decode_graph
from catears_tpu.tools.biggraph import make_big_lm, make_trie_graph, plant_logp
from catears_tpu_torch.decode import beam as tbeam

SENTINEL = tbeam.SENTINEL_STATE
ORD_POS_INF = 0xFF800000  # the order-preserving bits of +inf
ORD_NEG_INF = 0x007FFFFF  # and of -inf
SIGN = 0x80000000


# -- the numpy model of csrc/frame_expand.cu -------------------------------

def fma32(a, x, c):
    """float32(c - float32(a) * x) rounded once, from exact rationals."""
    a, x, c = np.float32(a), np.float32(x), np.float32(c)
    if not (np.isfinite(x) and np.isfinite(c)):
        return np.float32(np.float64(c) - np.float64(a) * np.float64(x))
    exact = Fraction(float(c)) - Fraction(float(a)) * Fraction(float(x))
    f = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))):
        if not np.isfinite(cand):
            continue
        d = abs(Fraction(float(cand)) - exact)
        even = (int(np.array(cand).view(np.uint32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return np.float32(best[1])


def expand_model(states, costs, lms, emit, over, logp, k, g, gc, compact,
                 n_slots, csr, am_scale, emit_hot=None, cold_cap=0,
                 row_valid=None):
    """The kernel's lanes, row by row: (state, cost, tok, olabel, olab2,
    lm or None, overflow, needed, cold_over or None, cold_needed or None)
    as numpy arrays; emit_hot given: the hot/cold split with cold_cap
    cold lanes.  A row that row_valid masks leaves at once with a dead
    row's per-row outputs; its lanes, which the kernel does not write,
    hold a dead row's here."""
    b = states.shape[0]
    e = k + k * g + n_slots * gc
    num_states, p = emit.shape[0], logp.shape[1]
    o_state = np.full((b, e), SENTINEL, np.int32)
    o_cost = np.full((b, e), np.inf, np.float32)
    o_tok, o_ol, o_ol2, o_lm = (np.zeros((b, e), np.int32) for _ in range(4))
    overflow = np.zeros(b, bool)
    needed = np.zeros(b, np.int32)
    split = emit_hot is not None
    hot_rows = emit_hot.shape[0] if split else 0
    cold_over = np.zeros(b, bool)
    cold_needed = np.zeros(b, np.int32)

    def srl(x, n):
        return int(np.uint32(np.int32(x).view(np.uint32)) >> np.uint32(n))

    def clamp(s):
        return min(max(int(s), 0), num_states - 1)

    for r in range(b):
        if row_valid is not None and not row_valid[r]:
            continue
        st, co = states[r], costs[r]
        lm = lms[r] if lms is not None else np.zeros(k, np.int32)
        # Each token's row: the split's from the cold tokens before it.
        cold = (st >= 0) & (np.minimum(np.maximum(st, 0), num_states - 1)
                            >= hot_rows)
        before = np.cumsum(cold) - cold
        if split:
            cold_needed[r] = cold.sum()
            cold_over[r] = cold.sum() > cold_cap
        rows = []
        for t in range(k):
            sc = clamp(st[t])
            if not split:
                rows.append(emit[sc])
            elif sc < hot_rows:
                rows.append(emit_hot[sc])
            elif st[t] >= 0 and before[t] < cold_cap:
                rows.append(emit[sc])
            else:
                rows.append(emit_hot[0])

        def row_of(t):
            return rows[t]

        def n_emit(t):
            if st[t] < 0:
                return 0
            x = rows[t]
            return srl(x[7], 13) & 0x3FF if compact else int(x[g * 5 + 3])

        def put(i, nxt, t, w_bits, pdf, ol, ol2):
            c = np.float32(co[t] + np.int32(w_bits).view(np.float32))
            lp = logp[r, pdf] if 0 <= pdf < p else np.float32(0.0)
            o_state[r, i], o_cost[r, i] = nxt, fma32(am_scale, lp, c)
            o_tok[r, i], o_ol[r, i], o_ol2[r, i] = t, ol, ol2
            o_lm[r, i] = lm[t]

        cum = np.cumsum([-(-max(n_emit(t) - g, 0) // gc) for t in range(k)])
        rows_needed = int(cum[-1]) if csr else 0
        needed[r] = rows_needed * gc
        overflow[r] = rows_needed > n_slots
        for t in range(k):  # the self-loop lanes
            s, row = int(st[t]), row_of(t)
            if compact:
                has, ol, w, pdf = (srl(row[7], 12) & 1, 0, row[6],
                                   int(row[7]) & 0xFFF)
            else:
                has, ol, w, pdf = row[g * 5 + 4:g * 5 + 8]
            if s >= 0 and has > 0:
                put(t, min(s, num_states - 1), t, w, pdf, ol, 0)
        for t in range(k):  # the first-G block lanes
            row = row_of(t)
            for j in range(min(n_emit(t), g)):
                if compact:
                    nw = int(row[2 * j])
                    nxt, pdf, w = nw & 0xFFFFF, srl(nw, 20), row[2 * j + 1]
                    ol = srl(row[4], 16) if j else int(row[4]) & 0xFFFF
                    l4 = srl(row[5], 16) if j else int(row[5]) & 0xFFFF
                else:
                    nxt, ol, w, pdf, l4 = row[j * 5:j * 5 + 5]
                put(k + t * g + j, nxt, t, w, pdf, ol, l4)
        for slot in range(min(n_slots, rows_needed)):  # the CSR lanes
            lo, hi = 0, k - 1  # binary search: first t with cum[t] > slot
            while lo < hi:
                mid = (lo + hi) // 2
                if cum[mid] > slot:
                    hi = mid
                else:
                    lo = mid + 1
            t = lo
            rr = slot - (int(cum[t - 1]) if t else 0)
            row = row_of(t)
            over_lo = int(row[8]) if compact else int(row[g * 5 + 2])
            ri = min(max(over_lo + rr, 0), over.shape[0] - 1)
            for j in range(gc):
                if rr * gc + j < n_emit(t) - g:
                    nxt, ol, w, pdf, l4 = over[ri, j * 5:j * 5 + 5]
                    put(k + k * g + slot * gc + j, nxt, t, w, pdf, ol, l4)
    return (o_state, o_cost, o_tok, o_ol, o_ol2,
            o_lm if lms is not None else None, overflow, needed,
            cold_over if split else None, cold_needed if split else None)


# -- the numpy model of csrc/frame_select.cu -------------------------------

def ordered(c):
    """Order-preserving uint32 cost bits: -0.0 == +0.0, NaN after +inf."""
    u = np.asarray(c, np.float32).view(np.uint32).copy()
    u[c == 0] = 0
    u[np.isnan(c)] = 0x7FC00000
    return np.where(u & SIGN, ~u, u | SIGN).astype(np.uint32)


def unordered(u):
    """The float32 of ordered bits (-0.0 comes back as +0.0)."""
    u = int(u)
    bits = u & 0x7FFFFFFF if u & SIGN else ~u & 0xFFFFFFFF
    return np.array([bits], np.uint32).view(np.float32)[0]


def radix_select(slices, want, passes):
    """The kernel's radix select over each CTA's [n, 3] uint32 keys (their
    words in the order searched): (prefix, masks) such that exactly the
    `want` least keys are <= prefix under the masks.  The digits that every
    key shares (where the AND and the OR of the keys agree: the common
    prefix of the least and the greatest key) are fixed first; each pass
    sums the CTAs' histograms of one digit and takes the bucket holding
    the rank.  `passes` gets (the first digit searched, the digits fixed
    when the select ended)."""
    keys = np.concatenate(slices)
    an = np.bitwise_and.reduce(keys, axis=0)
    on = np.bitwise_or.reduce(keys, axis=0)
    pre, msk = [0, 0, 0], [0, 0, 0]
    d0 = 0
    while d0 < 12:
        w, shift = d0 >> 2, 24 - 8 * (d0 & 3)
        if ((int(an[w]) ^ int(on[w])) >> shift) & 0xFF:
            break
        pre[w] |= int(an[w]) & (0xFF << shift)
        msk[w] |= 0xFF << shift
        d0 += 1
    rank = want
    for d in range(d0, 12):
        w, shift = d >> 2, 24 - 8 * (d & 3)
        hist = np.zeros(256, np.int64)
        for part in slices:  # each CTA's histogram, summed over DSMEM
            match = np.ones(len(part), bool)
            for i in range(3):
                match &= ((part[:, i] ^ pre[i]) & msk[i]) == 0
            hist += np.bincount((part[match, w] >> shift) & 0xFF,
                                minlength=256)
        cum = np.cumsum(hist)  # the warp's prefix scan
        bucket = int(np.argmax(cum >= rank))
        rank -= int(cum[bucket] - hist[bucket])
        pre[w] |= bucket << shift
        msk[w] |= 0xFF << shift
        if hist[bucket] == rank:
            passes.append((d0, d + 1))
            return pre, msk
    raise AssertionError("the radix select did not end")


def at_most(keys, pre, msk):
    """keys under the masks <= the prefix, lexicographically."""
    a = [keys[:, i] & np.uint32(msk[i]) for i in range(3)]
    p = [np.uint32(x) for x in pre]
    return ((a[0] < p[0]) | ((a[0] == p[0]) & ((a[1] < p[1])
            | ((a[1] == p[1]) & (a[2] <= p[2])))))


BY_COST = [0, 1, 2]  # the key words (cost, state, lm) most significant first
BY_GROUP = [1, 2, 0]  # the same words in (state, lm) order


def claim_groups(state, lm, ck, log2cap, order):
    """The row's open-addressing table after every live lane's claim, in
    the lane order `order` (the kernel's atomics come in any order): slot
    -> (key, winner), the winner the least (cost bits << 32 | lane), a key
    probing on from its home slot into the next CTA's slice and round the
    table.  Returns ({slot: [key, winner]}, the longest probe)."""
    cap = 1 << log2cap
    table, longest = {}, 0
    for i in order:
        if state[i] >= SENTINEL:
            continue
        key = (((int(state[i]) ^ SIGN) & 0xFFFFFFFF) << 32) | (
            int(lm[i]) & 0xFFFFFFFF)
        h = ((key * SELECT_HASH) & (2**64 - 1)) >> (64 - log2cap)
        probe = 0
        while h in table and table[h][0] != key:
            h, probe = (h + 1) % cap, probe + 1
        longest = max(longest, probe)
        v = (int(ck[i]) << 32) | int(i)
        slot = table.setdefault(h, [key, v])
        slot[1] = min(slot[1], v)
    return table, longest


def select_model(state, lm, cost, w1, w2, tok, olab2, olabel, k, beam,
                 passes=None, c2=0, cluster=8, seed=0, stats=None,
                 log2cap=None):
    """(states, lms, costs, prev_slot, words, demand, overflow) of the
    kernel, row by row: a cluster of `cluster` CTAs per row, each owning a
    slice of the group table; c2: BeamConfig.select_compact; seed: the
    order the lanes claim in; log2cap: each row's table (a list, one per
    row; None: the kernel's, select_row_log2cap of the row's live lanes).
    stats, a dict, gets the most CTAs whose slices held a row's groups and
    the longest probe."""
    passes = [] if passes is None else passes
    stats = {} if stats is None else stats
    b, e = state.shape
    c2 = max(c2, k) if c2 else 0  # the lanes, as _compact_width
    c2 = c2 if c2 < e else 0
    if log2cap is None:
        log2cap = [tbeam.select_row_log2cap(int((row < SENTINEL).sum()), e)
                   for row in state]
    rng = np.random.RandomState(seed)
    out_s = np.full((b, k), -1, np.int32)
    out_l = np.zeros((b, k), np.int32)
    out_c = np.full((b, k), np.inf, np.float32)
    out_p = np.zeros((b, k), np.int32)
    out_w = np.zeros((b, k, 2), np.int32)
    demand = np.zeros(b, np.int32)
    overflow = np.zeros(b, bool)
    for r in range(b):
        c = cost[r].copy()
        for w in (w1, w2):
            if w is not None:
                c = (c + w[r]).astype(np.float32)
        lmr = lm[r] if lm is not None else np.zeros(e, np.int32)
        ck = ordered(c)
        slice_ = (1 << log2cap[r]) // cluster
        table, longest = claim_groups(state[r], lmr, ck, log2cap[r],
                                      rng.permutation(e))
        # Each CTA's slice: its occupied slots as (cost bits, state, lm,
        # lane) keys.
        slices = []
        for q in range(cluster):
            got = [(v >> 32, key >> 32, (key & 0xFFFFFFFF) ^ SIGN,
                    v & 0xFFFFFFFF) for h, (key, v) in sorted(table.items())
                   if h // slice_ == q]
            slices.append(np.array(got, np.uint32).reshape(-1, 4))
        stats["ctas"] = max(stats.get("ctas", 0),
                            sum(len(x) > 0 for x in slices))
        stats["probe"] = max(stats.get("probe", 0), longest)
        mn = np.float32(np.nan) if np.isnan(c).any() else (
            unordered(ck.min()) if e else np.float32(np.inf))
        cut = np.float32(mn + np.float32(beam))

        def survives(x):
            if np.isnan(cut):
                return np.zeros(len(x), bool)
            return (x > ORD_NEG_INF) & (x < ORD_POS_INF) & (
                x <= ordered(np.float32([cut]))[0])

        demand[r] = sum(int(survives(x[:, 0]).sum()) for x in slices)
        overflow[r] = bool(c2) and demand[r] > c2
        cands = [x[survives(x[:, 0])] if c2 else x[x[:, 0] < ORD_POS_INF]
                 for x in slices]
        n_in = sum(len(x) for x in cands)
        if c2 and n_in > c2:  # the first c2 in (state, lm) order
            pre, msk = radix_select([x[:, BY_GROUP] for x in cands], c2,
                                    passes)
            cands = [x[at_most(x[:, BY_GROUP], pre, msk)] for x in cands]
            n_in = c2
            assert sum(len(x) for x in cands) == c2
        group_order = bool(c2) and c2 <= k
        if not group_order and n_in > k:
            pre, msk = radix_select([x[:, BY_COST] for x in cands], k,
                                    passes)
            cands = [x[at_most(x[:, BY_COST], pre, msk)] for x in cands]
            assert sum(len(x) for x in cands) == k
        order = BY_GROUP if group_order else BY_COST
        # Each CTA sorts its keys; a key's slot is its local rank plus the
        # peers' keys below it.
        lists = [sorted(tuple(int(v) for v in key[order]) + (int(key[3]),)
                        for key in x) for x in cands]
        slots = {}
        for q, mine in enumerate(lists):
            for i, key in enumerate(mine):
                slots[i + sum(bisect.bisect_left(peer, key)
                              for p, peer in enumerate(lists) if p != q)] = key
        assert sorted(slots) == list(range(len(slots)))
        fin = [ok for ok in (key[order.index(0)] for key in slots.values())
               if ORD_NEG_INF < ok < ORD_POS_INF]
        if fin:
            cutoff = np.float32(unordered(min(fin)) + np.float32(beam))
        for j, key in slots.items():
            i = key[3]
            if not np.isfinite(c[i]):
                continue
            out_l[r, j] = lmr[i] if lm is not None else 0
            if c[i] <= cutoff:
                out_s[r, j], out_c[r, j], out_p[r, j] = state[r, i], c[i], \
                    tok[r, i]
                out_w[r, j] = (olab2[r, i], olabel[r, i])
    return out_s, out_l, out_c, out_p, out_w, demand, overflow


# -- JAX references --------------------------------------------------------

def jax_select(k, beam, state, lm, cost, w1, w2, tok, olab2, olabel,
               select_compact=0):
    """JAX's `_select_best` (compact=True: `_select_sorts` with the demand,
    or `_select_compacted`) + `_eps_free_step`'s threshold, vmapped over
    rows; a row's prev_slot and words are zeroed where its cost is not
    finite (see select_beam_ref)."""
    cfg = jbeam.BeamConfig(beam_size=k, beam=beam,
                           select_compact=select_compact)
    has_lm, has_w1, has_w2 = lm is not None, w1 is not None, w2 is not None

    def one(s, l, c, a1, a2, t, o2, o1):
        if has_w1:
            c = c + a1
        if has_w2:
            c = c + a2
        (states, lms, costs, prev, x0, x1), over, demand = \
            jbeam._select_best(cfg, s, l if has_lm else None, c, [t, o2, o1],
                               compact=True)
        cutoff = jnp.min(costs) + cfg.beam
        keep = costs <= cutoff
        fin = keep & jnp.isfinite(costs)
        return (jnp.where(keep, states, -1), lms,
                jnp.where(keep, costs, jbeam.INF), jnp.where(fin, prev, 0),
                jnp.stack([jnp.where(fin, x0, 0), jnp.where(fin, x1, 0)], 1),
                demand, over)

    zeros = np.zeros_like(cost)
    args = [state, lm if has_lm else state, cost,
            w1 if has_w1 else zeros, w2 if has_w2 else zeros, tok, olab2,
            olabel]
    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in args))]


def port_select(k, beam, *cols, wrapper=tbeam.select_beam_ref,
                select_compact=0):
    cfg = tbeam.BeamConfig(beam_size=k, beam=beam,
                           select_compact=select_compact)
    t = [None if c is None else torch.from_numpy(np.ascontiguousarray(c))
         for c in cols]
    s = wrapper(cfg, *t)
    over = (np.zeros(len(cols[0]), bool) if s.overflow is None
            else to_np(s.overflow))
    return [to_np(x) for x in (s.states, s.lms, s.costs, s.prev_slot,
                                s.words, s.demand)] + [over], s


SELECT_NAMES = ("states", "lms", "costs", "prev_slot", "words", "demand",
                "overflow")


def _stack(rows, lm_on, weights):
    cols = [np.stack(c) for c in zip(*rows)]
    if not lm_on:
        cols[1] = None
    if weights == "none":
        cols[3] = cols[4] = None
    elif weights == "w2":
        cols[3] = None
    return cols


CLUSTERS = [1, 8, 16]  # CTAs a row's cluster takes (frame_select.cu: 8, 16)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("lm_on,weights", [(False, "none"), (True, "both"),
                                           (True, "w2")])
def test_select_model_matches_jax_on_adversarial_rows(lm_on, weights,
                                                      cluster):
    """Every adversarial row, bit for bit: the kernel's model (its table
    partitioned over `cluster` CTAs) against JAX's sorts + threshold, and
    the port's plain version against the model."""
    k, beam = 8, 16.0
    rows = adversarial_rows(1)
    cols = _stack(list(rows.values()), lm_on, weights)
    passes = []
    got = select_model(*cols, k, beam, passes=passes, cluster=cluster,
                       seed=cluster)
    ref = jax_select(k, beam, *cols)
    for name, x, y in zip(SELECT_NAMES, ref, got):
        assert_same(x, y, name)
    plain, _ = port_select(k, beam, *cols)
    for name, x, y in zip(SELECT_NAMES, got, plain):
        assert_same(x, y, f"select_beam_ref {name}")
    names_rows = list(rows)
    states, costs = got[0], got[2]
    finite = np.isfinite(costs).sum(1)
    by = dict(zip(names_rows, finite))
    assert by["few"] < k and by["exactly-k"] == k and by["dead"] == 0
    assert (states[names_rows.index("sentinel")] < SENTINEL).all()
    assert costs[names_rows.index("neg-inf"), 0] == np.inf
    row = names_rows.index("threshold")
    past = ~np.isfinite(costs[row]) & (got[1][row] != 0)
    assert past.any() == lm_on  # winners past the threshold keep their lm
    assert passes  # the radix select ran


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("seed,lm_on", [(2, False), (3, True), (4, True)])
def test_select_model_radix_digits(seed, lm_on, cluster):
    """More winners than K whose costs tie in bulk: the radix select runs
    on into the state (and lm) digits; the model, JAX and the plain
    version agree bit for bit."""
    k = 64
    cols = tied_rows(seed, lm_on)
    passes = []
    got = select_model(*cols, k, 16.0, passes=passes, cluster=cluster,
                       seed=seed)
    for name, x, y in zip(SELECT_NAMES, jax_select(k, 16.0, *cols), got):
        assert_same(x, y, name)
    plain, _ = port_select(k, 16.0, *cols)
    for x, y in zip(got, plain):
        assert_same(x, y)
    # The select ended past the cost word (digits 0-3 of the key).
    assert max(end for _, end in passes) > 4


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("c2", [8, 13, 90])
@pytest.mark.parametrize("lm_on,weights", [(False, "none"), (True, "both")])
def test_select_model_compact_matches_jax(c2, lm_on, weights, cluster):
    """select_compact on every adversarial row, bit for bit: the kernel's
    model against JAX's `_select_compacted` + threshold, and the port's
    plain version against the model.  c2 == K returns the beam in (state,
    lm) order; rows with more survivors than c2 set the overflow flag."""
    k, beam = 8, 16.0
    cols = _stack(list(adversarial_rows(1).values()), lm_on, weights)
    got = select_model(*cols, k, beam, c2=c2, cluster=cluster, seed=c2)
    ref = jax_select(k, beam, *cols, select_compact=c2)
    for name, x, y in zip(SELECT_NAMES, ref, got):
        assert_same(x, y, name)
    plain, _ = port_select(k, beam, *cols, select_compact=c2)
    for name, x, y in zip(SELECT_NAMES, got, plain):
        assert_same(x, y, f"select_beam_ref {name}")
    assert got[6].any() == (c2 < 90)  # the "many" row overflows
    if c2 == k:  # (state, lm) order, not cost order
        for st_row in got[0]:
            assert (np.diff(st_row[st_row >= 0]) >= 0).all()
        assert any((np.diff(c[np.isfinite(c)]) < 0).any() for c in got[2])


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("seed,lm_on,c2", [(2, False, 64), (3, True, 64),
                                           (4, True, 150), (5, False, 3000)])
def test_select_model_compact_radix_digits(seed, lm_on, c2, cluster):
    """More survivors than c2 (and than K) on rows whose costs tie in
    bulk: the (state, lm) radix select, then the cost one; the model, JAX
    and the plain version agree bit for bit."""
    k = 64
    cols = tied_rows(seed, lm_on)
    passes = []
    got = select_model(*cols, k, 16.0, passes=passes, c2=c2,
                       cluster=cluster, seed=seed)
    for name, x, y in zip(SELECT_NAMES,
                          jax_select(k, 16.0, *cols, select_compact=c2), got):
        assert_same(x, y, name)
    plain, _ = port_select(k, 16.0, *cols, select_compact=c2)
    for name, x, y in zip(SELECT_NAMES, got, plain):
        assert_same(x, y, f"select_beam_ref {name}")
    assert got[6].any() == (c2 < 3000)
    assert passes


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("lm_on,c2", [(False, 0), (True, 0), (True, 64),
                                      (False, 200)])
def test_select_model_one_slice_row(lm_on, c2, cluster):
    """Rows whose (state, lm) groups all hash into CTA 0's table slice: the
    claims probe on into the next slices (at 8 and 16 CTAs the groups fill
    several), and the model still equals JAX and the plain version bit for
    bit, in any claim order."""
    k = 64
    cols = beam_rows(6, 2, 3000, lm_on, weights=lm_on, one_slice=True)
    live = cols[0] < SENTINEL
    assert (group_home(cols[0][live], None if cols[1] is None
                       else cols[1][live], 4) == 0).all()
    ref = jax_select(k, 16.0, *cols, select_compact=c2)
    plain, _ = port_select(k, 16.0, *cols, select_compact=c2)
    for seed in (0, 1):
        stats = {}
        got = select_model(*cols, k, 16.0, c2=c2, cluster=cluster,
                           seed=seed, stats=stats)
        for name, x, y in zip(SELECT_NAMES, ref, got):
            assert_same(x, y, name)
        for name, x, y in zip(SELECT_NAMES, got, plain):
            assert_same(x, y, f"select_beam_ref {name}")
        slice_ = (1 << tbeam.select_geometry(3000)[1]) // cluster
        if cluster > 1:  # the groups spilled from CTA 0 into its peers
            assert stats["probe"] > slice_ and stats["ctas"] >= 2
    assert np.isfinite(got[2]).sum() == 2 * k


def test_select_model_common_prefix_cuts_the_passes():
    """On a beam-like row (costs 100-120, no ties in bulk) the cost select
    starts past the digits every candidate shares (the sign and exponent
    of the costs), so it runs fewer passes than the digits it fixes; the
    model still equals JAX bit for bit."""
    k = 256
    cols = beam_rows(8, 2, 3000, True)
    passes = []
    got = select_model(*cols, k, 16.0, passes=passes)
    for name, x, y in zip(SELECT_NAMES, jax_select(k, 16.0, *cols), got):
        assert_same(x, y, name)
    assert len(passes) == 2
    for start, end in passes:
        assert 1 <= start < end <= 4  # within the cost word
        assert end - start < end  # the common prefix saved a pass


def test_select_geometry():
    """The kernel's cluster and table storage follow the shape alone: 8
    CTAs with shared slices up to 65,536 slots (the bench's 38,912 lanes),
    16 up to 131,072, then 16 slices in global memory; more slots than 4/3
    of the lanes."""
    assert tbeam.select_geometry(38912) == (8, 16, True)
    assert tbeam.select_geometry(49152) == (16, 17, True)
    assert tbeam.select_geometry(98303) == (16, 17, True)
    assert tbeam.select_geometry(100000) == (16, 18, False)
    assert tbeam.select_geometry(1) == (8, 4, True)
    for e in (1, 96, 2000, 38912, 10**6):
        c, log2cap, shared = tbeam.select_geometry(e)
        assert (1 << log2cap) > e + e // 3
        assert shared == ((16 << log2cap) // c <= 128 * 1024)


def test_select_row_log2cap():
    """A row's table on the global path: more slots than 4/3 of its live
    lanes, at least the cluster's C = 16, at most select_geometry(e)'s cap,
    and the least power of two that does; on the shared path the shape's
    table whatever the row holds."""
    e = 209_416  # bulk-chain's lanes
    cluster, cap, shared = tbeam.select_geometry(e)
    assert (cluster, cap, shared) == (16, 19, False)
    assert tbeam.select_row_log2cap(142_304, e) == 18  # its fullest frame
    assert tbeam.select_row_log2cap(e, e) == cap
    assert tbeam.select_row_log2cap(0, e) == 4
    assert tbeam.select_row_log2cap(11, e) == 4  # 16 slots > 14.67
    assert tbeam.select_row_log2cap(12, e) == 5  # 16 slots = 4/3 of 12
    for live in list(range(0, 200)) + [98_303, 98_304, 157_062, 157_063, e]:
        got = tbeam.select_row_log2cap(live, e)
        assert 4 <= got <= cap
        assert 3 * (1 << got) > 4 * live or got == cap
        assert got == 4 or 3 * (1 << (got - 1)) <= 4 * live
    for e in (96, 38_912, 98_303):  # the shared table: the shape's
        _, cap, shared = tbeam.select_geometry(e)
        assert shared
        assert {tbeam.select_row_log2cap(n, e) for n in (0, 1, e)} == {cap}


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("lm_on,c2", [(False, 0), (True, 0), (True, 150),
                                      (False, 64)])
def test_select_model_same_at_every_row_capacity(lm_on, c2, cluster):
    """Rows of one live lane, a few and every lane: the kernel's model
    gives the same outputs, bit for bit, at every table capacity from the
    row's own width (select_row_log2cap's rule) up to the shape's, and
    they equal JAX's and the plain version's.  Where the groups land
    changes with the capacity; the winners do not."""
    k, e = 64, 3000
    cols = with_live_lanes(beam_rows(14, 4, e, lm_on, weights=lm_on),
                           [1, 20, None, 700], 14)
    live = (cols[0] < SENTINEL).sum(1)
    assert live.tolist() == [1, 20, e, 700]
    own = [max(cluster.bit_length() - 1, int(n + n // 3).bit_length())
           for n in live]
    shape = tbeam.select_geometry(e)[1]
    assert own == [cluster.bit_length() - 1, 5, shape, 10]
    ref = jax_select(k, 16.0, *cols, select_compact=c2)
    plain, _ = port_select(k, 16.0, *cols, select_compact=c2)
    for name, x, y in zip(SELECT_NAMES, ref, plain):
        assert_same(x, y, f"select_beam_ref {name}")
    for at in range(min(own), shape + 1):
        got = select_model(*cols, k, 16.0, c2=c2, cluster=cluster, seed=at,
                           log2cap=[max(at, o) for o in own])
        for name, x, y in zip(SELECT_NAMES, ref, got):
            assert_same(x, y, f"capacity 2^{at}: {name}")
    kept = np.isfinite(ref[2]).sum(1).tolist()
    assert kept[0] == 1 and 1 < kept[1] <= 20 and kept[2:] == [k, k]


ROW_MASKS = {"none": [True] * 5, "all": [False] * 5,
             "mixed": [True, False, True, False, False],
             "one": [False, False, False, True, False]}


@pytest.mark.parametrize("mask", list(ROW_MASKS))
@pytest.mark.parametrize("case,lm_on,weights,c2", [
    ("beam", False, "none", 0), ("beam", True, "both", 0),
    ("beam", True, "w2", 150), ("adversarial", False, "none", 8),
    ("adversarial", True, "both", 13), ("adversarial", True, "w2", 0)])
def test_select_beam_ref_row_valid(case, lm_on, weights, c2, mask):
    """select_beam_ref with row_valid: each masked row gets exactly the
    outputs of the same row with every lane dead (states -1, lms 0, costs
    +inf, prev_slot 0, words 0, demand 0, overflow False), and each
    unmasked row those of the call without a mask, bit for bit; LM off
    and on, w1 / w2, select_compact 0 and > 0, every row masked or
    none."""
    if case == "beam":
        k = 64
        cols = beam_rows(15, 5, 3000, lm_on, weights=weights != "none")
        if weights == "w2":
            cols[3] = None
    else:
        k = 8
        rows = adversarial_rows(2)
        names = ["ties", "inf-nan", "threshold", "many", "dead"]
        cols = _stack([rows[n] for n in names], lm_on, weights)
    valid = np.array(ROW_MASKS[mask])
    got, sel = port_select(k, 16.0, *cols, select_compact=c2,
                           wrapper=functools.partial(
                               tbeam.select_beam_ref,
                               row_valid=torch.from_numpy(valid)))
    full, _ = port_select(k, 16.0, *cols, select_compact=c2)
    dead_cols = [None if c is None else c.copy() for c in cols]
    dead_cols[0][:] = SENTINEL
    dead_cols[2][:] = np.inf
    dead, _ = port_select(k, 16.0, *dead_cols, select_compact=c2)
    for name, x, y, z in zip(SELECT_NAMES, got, full, dead):
        assert_same(y[valid], x[valid], f"unmasked {name}")
        assert_same(z[~valid], x[~valid], f"masked {name}")
    assert (sel.overflow is None) == (not c2)
    assert (got[0][~valid] == -1).all() and not got[1][~valid].any()
    assert np.isinf(got[2][~valid]).all() and not got[3][~valid].any()
    assert not got[4][~valid].any() and not got[5][~valid].any()
    assert not got[6][~valid].any()
    # The public name takes the same plain version on the CPU.
    pub, _ = port_select(k, 16.0, *cols, select_compact=c2,
                         wrapper=functools.partial(
                             tbeam.select_beam,
                             row_valid=torch.from_numpy(valid)))
    for name, x, y in zip(SELECT_NAMES, got, pub):
        assert_same(x, y, f"select_beam {name}")


# -- the expansion against JAX ---------------------------------------------

@pytest.fixture(scope="module")
def trie():
    tg = make_trie_graph(np.random.RandomState(1), num_words=120,
                         num_phones=25, bigram_states=30, variants=2)
    g2, olab2, mode = prepare_decode_graph(tg.fst)
    assert mode == "eps_free"
    delta = make_big_lm(np.random.RandomState(9),
                        num_words=tg.num_words).delta_lm()
    return tg, g2, olab2, JaxDeviceLm.build(delta)


# (group, csr_group, compact, hot rows as a share of the states)
LAYOUTS = {"compact": (2, 16, None, 0), "classic-g4": (4, 4, None, 0),
           "classic-g2": (2, 16, False, 0), "classic-hot": (2, 16, None, 3)}


def _tables(trie, layout):
    tg, g2, olab2, _ = trie
    g, gc, compact, hot = LAYOUTS[layout]
    jd = JaxDeviceFst.build(g2, tg.tid2pdf, group=g, eps_depth_cap=1,
                            csr_group=gc, olabel2=olab2, compact=compact,
                            hot_rows=g2.num_states // hot if hot else 0)
    td = dfst_from_jax(jd)
    assert td.emit_compact == (layout == "compact")
    assert bool(td.hot_rows) == bool(hot)
    assert td.max_emit_fanout > g  # the CSR pass runs
    return jd, td


def jax_expand(jcfg, jd, states, costs, lms, logp, need_lm):
    """JAX's `_expand` (emitting) + `_acoustic_lookup` + :717 under
    jax.jit, vmapped over rows: (valid, next, cost, tok, olabel, olab2,
    lm, overflow, needed, cold_over, cold_needed)."""
    def one(s, c, l, lp):
        k = s.shape[0]
        beam = jbeam.BeamState(s, l, c, jnp.arange(k, dtype=jnp.int32),
                               jnp.bool_(False), jnp.zeros(5, jnp.int32))
        x = jbeam._expand(jcfg, jd, beam, jcfg.expand_size, True,
                          need_lm=need_lm, need_bp=False, need_eps=True)
        cost = x.cost - jcfg.am_scale * jbeam._acoustic_lookup(lp, x.pdf)
        return (x.valid, x.next_state, cost, x.tok, x.olabel, x.eps,
                x.lm if need_lm else x.tok, x.overflow, x.needed,
                jnp.asarray(x.cold_over), jnp.asarray(x.cold_needed))

    return [np.asarray(v) for v in jax.jit(jax.vmap(one))(
        jnp.asarray(states), jnp.asarray(costs), jnp.asarray(lms),
        jnp.asarray(logp))]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("expand_size,need_lm", [(512, True), (48, False)])
def test_expand_model_matches_jax(trie, layout, expand_size, need_lm):
    """Both row layouts, the hot/cold split (at 48 slots with 5 cold
    lanes, which overflow), a CSR tail (and at 48 slots an overflowing
    one), pdfs past logp's width: the model equals JAX on the valid lanes
    (and in overflow, needed and the cold counts), and the port's plain
    version in full."""
    jd, td = _tables(trie, layout)
    b, k = 3, 32
    states, costs, lms = random_beam(td, 5, b, k)
    rng = np.random.RandomState(6)
    p = int(to_np(trie[0].tid2pdf).max()) + 1 - 4  # the top pdfs are out
    logp = np.log(rng.dirichlet(np.ones(p), b)).astype(np.float32)
    cold = (5 if expand_size == 48 else 100) if td.hot_rows else 0
    kw = dict(beam_size=k, expand_size=expand_size, am_scale=0.1,
              cold_expand_size=cold)
    jcfg, tcfg = jbeam.BeamConfig(**kw), tbeam.BeamConfig(**kw)
    g, gc = td.group, td.csr_group
    n_slots = -(-expand_size // gc)
    got = expand_model(states, costs, lms if need_lm else None,
                       to_np(td.emit_block), to_np(td.over_packed), logp, k,
                       g, gc, td.emit_compact, n_slots, True, 0.1,
                       to_np(td.emit_hot) if cold else None, min(cold, k))
    ref = jax_expand(jcfg, jd, states, costs, lms, logp, need_lm)
    valid = ref[0]
    assert_same(valid, got[0] != SENTINEL, "valid lanes")
    for name, x, y in zip(("next", "cost", "tok", "olabel", "olab2", "lm"),
                          ref[1:7], got[:6]):
        if y is not None:
            assert_same(np.where(valid, x, 0), np.where(valid, y, 0), name)
    assert_same(ref[7], got[6], "overflow")
    assert_same(ref[8], got[7], "needed")
    assert got[6].any() == (expand_size == 48)
    if cold:
        assert_same(ref[9], got[8], "cold_over")
        assert_same(ref[10], got[9], "cold_needed")
        assert got[8].any() == (cold == 5)
        assert (got[9] > 0).all()
    assert valid[:, k + k * g:].any()  # live CSR lanes
    beam = tbeam.BeamState(torch.from_numpy(states), torch.from_numpy(lms),
                           torch.from_numpy(costs),
                           torch.arange(k, dtype=torch.int32).expand(b, k),
                           torch.zeros(b, dtype=torch.bool),
                           torch.zeros((b, 5), dtype=torch.int32))
    plain = tbeam.expand_emitting_ref(tcfg, td, beam, torch.from_numpy(logp),
                                      need_lm)
    for name, x, y in zip(tbeam.EmitCands._fields, got, plain):
        if x is not None or y is not None:
            assert_same(x, y, f"expand_emitting_ref {name}")


def test_expand_model_reads_zero_past_logp(trie):
    """A live lane whose pdf is outside [0, P) adds no acoustic term, as
    the one-hot lookup gives: cost = token cost + arc weight exactly."""
    jd, td = _tables(trie, "compact")
    states, costs, lms = random_beam(td, 8, 2, 32)
    logp = np.full((2, 3), -7.0, np.float32)  # P = 3: most pdfs are out
    got = expand_model(states, costs, None, to_np(td.emit_block),
                       to_np(td.over_packed), logp, 32, 2, 16, True, 32,
                       True, 0.1)
    jcfg = jbeam.BeamConfig(beam_size=32, expand_size=512, am_scale=0.1)
    ref = jax_expand(jcfg, jd, states, costs, lms, logp, False)
    valid = ref[0]
    assert_same(np.where(valid, ref[2], 0), np.where(valid, got[1], 0),
                "cost")
    assert valid.sum() > 50


EXPAND_MASKS = {"mixed": [True, False, True], "all": [False] * 3,
                "one": [False, True, False]}


@pytest.mark.parametrize("mask", list(EXPAND_MASKS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("expand_size,need_lm", [(512, True), (48, False)])
def test_expand_emitting_ref_row_valid(trie, layout, expand_size, need_lm,
                                       mask):
    """expand_emitting_ref with row_valid: each masked row is dead in
    every lane (state SENTINEL_STATE, cost +inf, tok, olabel, olab2 and lm
    0) and reads 0 in overflow, needed, cold_over and cold_needed; each
    unmasked row is byte-equal to the call without a mask; the kernel's
    numpy model under the same mask and the public name on the CPU agree
    in full.  Both row layouts, the hot/cold split and a CSR tail (at 48
    slots an overflowing one)."""
    _, td = _tables(trie, layout)
    b, k = 3, 32
    states, costs, lms = random_beam(td, 5, b, k)
    rng = np.random.RandomState(6)
    p = int(to_np(trie[0].tid2pdf).max()) + 1 - 4
    logp = torch.from_numpy(np.log(rng.dirichlet(np.ones(p), b))
                            .astype(np.float32))
    cold = (5 if expand_size == 48 else 100) if td.hot_rows else 0
    cfg = tbeam.BeamConfig(beam_size=k, expand_size=expand_size,
                           am_scale=0.1, cold_expand_size=cold)
    beam = tbeam.BeamState(torch.from_numpy(states), torch.from_numpy(lms),
                           torch.from_numpy(costs),
                           torch.arange(k, dtype=torch.int32).expand(b, k),
                           torch.zeros(b, dtype=torch.bool),
                           torch.zeros((b, 5), dtype=torch.int32))
    valid = np.array(EXPAND_MASKS[mask])
    rv = torch.from_numpy(valid)
    full = tbeam.expand_emitting_ref(cfg, td, beam, logp, need_lm)
    got = tbeam.expand_emitting_ref(cfg, td, beam, logp, need_lm, rv)
    assert (to_np(full.needed) > 0).all()  # the mask has work to undo
    assert to_np(full.overflow).any() == (expand_size == 48)
    dead = {"state": SENTINEL, "cost": np.inf}
    for name, x, y in zip(tbeam.EmitCands._fields, full, got):
        if x is None:
            assert y is None, name
            continue
        x, y = to_np(x), to_np(y)
        assert_same(x[valid], y[valid], f"unmasked {name}")
        assert x.dtype == y.dtype, name
        assert (y[~valid] == dead.get(name, 0)).all(), f"masked {name}"
    assert (got.cold_over is None) == (not cold)
    model = expand_model(states, costs, lms if need_lm else None,
                         to_np(td.emit_block), to_np(td.over_packed),
                         to_np(logp), k, td.group, td.csr_group,
                         td.emit_compact, -(-expand_size // td.csr_group),
                         True, 0.1, to_np(td.emit_hot) if cold else None,
                         min(cold, k), row_valid=valid)
    pub = tbeam.expand_emitting(cfg, td, beam, logp, need_lm, row_valid=rv)
    for name, x, y, z in zip(tbeam.EmitCands._fields, got, model, pub):
        if x is not None or y is not None:
            assert_same(x, y, f"model {name}")
        assert_same(x, z, f"expand_emitting {name}")


def _ragged_chunk(trie, lengths, frames):
    """Planted log-probs [T, B, P] of len(lengths) utterances and the
    [T, B] mask of their valid frames."""
    logp, _ = plant_logp(np.random.RandomState(3), trie[0], len(lengths),
                         frames)
    lp = torch.from_numpy(np.ascontiguousarray(np.transpose(logp, (1, 0, 2))))
    valid = np.arange(frames)[:, None] < np.array(lengths)[None]
    return lp, torch.from_numpy(valid)


@pytest.mark.parametrize("layout,knobs", [
    ("compact", {}), ("classic-g4", {}), ("classic-g2", {"beam": 1e9}),
    ("classic-hot", {"cold_expand_size": 10, "select_compact": 300})])
def test_decode_chunk_same_with_and_without_the_expansion_mask(
        trie, monkeypatch, layout, knobs):
    """LM off, decode_chunk on the CPU (each _frame_step handing its
    frame's valid flags to expand_emitting as row_valid) gives the beam
    and trace, bit for bit, of the same chunk whose expansion is given no
    mask, on a ragged batch (rows that end early, one of a single frame);
    so does one more _frame_step from the chunk's beam with rows masked.
    The expansion's overflow and needed of a masked row are thrown away
    with its beam, so the decode is the unmasked one's."""
    _, td = _tables(trie, layout)
    cfg = tbeam.BeamConfig(**dict(dict(
        beam_size=64, expand_size=256, eps_expand_size=64, max_eps_iters=4,
        beam=12.0), **knobs))
    lengths = [12, 7, 1, 9]
    lp, valid = _ragged_chunk(trie, lengths, 12)
    real = tbeam.expand_emitting
    masks = []

    def spy(*args, **kw):
        masks.append(kw.get("row_valid"))
        return real(*args, **kw)

    def unmasked(*args, row_valid=None):
        return real(*args)

    runs = []
    for wrapper in (spy, unmasked):
        monkeypatch.setattr(tbeam, "expand_emitting", wrapper)
        beam, _ = tbeam.init_beam_batch(cfg, 4, td)
        beam, trace = tbeam.decode_chunk(cfg, td, beam, lp, valid)
        step_valid = torch.tensor([True, False, True, False])
        runs.append((beam, trace) + tbeam._frame_step(
            cfg, td, None, beam, lp[3], step_valid))
    monkeypatch.undo()
    assert len(masks) == 13
    assert all(m is not None for m in masks)
    assert [int(m.sum()) for m in masks[:12]] == valid.sum(1).tolist()
    assert (to_np(runs[0][0].costs[:, 0]) < np.inf).all()
    for (what, x), y in zip((("chunk beam", runs[0][0]),
                             ("chunk trace", runs[0][1]),
                             ("step beam", runs[0][2]),
                             ("step trace", runs[0][3])), runs[1][:4]):
        for name, u, v in zip(x._fields, x, y):
            assert_same(u, v, f"{what} {name}")


@pytest.mark.parametrize("lm_on", [False, True])
def test_eps_free_step_masks_the_expansion_only_without_an_lm(
        trie, monkeypatch, lm_on):
    """_frame_step hands its frame's valid flags to expand_emitting as
    row_valid with no LM, and no mask with a delta-LM (whose walks read
    every lane); the selection takes the mask either way."""
    _, td = _tables(trie, "compact")
    dlm = dlm_from_jax(trie[3]) if lm_on else None
    cfg = tbeam.BeamConfig(beam_size=64, expand_size=256,
                           eps_expand_size=64, max_eps_iters=4, beam=12.0,
                           lm_expand_size=64 if lm_on else 0)
    lp, valid = _ragged_chunk(trie, [3, 1, 2], 3)
    seen = {"expand_emitting": [], "select_beam": []}

    def spy(name):
        real = getattr(tbeam, name)

        def call(*args, **kw):
            seen[name].append(kw.get("row_valid"))
            return real(*args, **kw)
        return call

    for name in seen:
        monkeypatch.setattr(tbeam, name, spy(name))
    beam, _ = tbeam.init_beam_batch(cfg, 3, td, dlm)
    tbeam.decode_chunk(cfg, td, beam, lp, valid, dlm)
    assert len(seen["expand_emitting"]) == len(seen["select_beam"]) == 3
    for f, (ex, sel) in enumerate(zip(*seen.values())):
        assert to_np(sel).tolist() == to_np(valid[f]).tolist()
        if lm_on:
            assert ex is None
        else:
            assert ex is sel


# -- the step and the public names ----------------------------------------

def _mid_beam(trie, jd, jl, k, frames=6):
    """A JAX beam after `frames` planted frames of two utterances, plus an
    empty third row (every candidate of the next frame dead)."""
    tg = trie[0]
    logp, _ = plant_logp(np.random.RandomState(2), tg, 3, frames + 1)
    kw = dict(beam_size=k, expand_size=256, eps_expand_size=64,
              max_eps_iters=4, beam=12.0)
    jcfg = jbeam.BeamConfig(**kw)
    jb, _ = jbeam.init_beam_batch(jcfg, jl is not None, 3, jd, jl)
    lp = np.ascontiguousarray(np.transpose(logp[:, :frames], (1, 0, 2)))
    jb, _ = jbeam.decode_chunk(jcfg, jl is not None, jd, jl, jb,
                               jnp.asarray(lp), jnp.ones((frames, 3), bool))
    jb = jb._replace(states=jb.states.at[2].set(-1),
                     costs=jb.costs.at[2].set(jnp.inf))
    return kw, jb, logp[:, frames]


@pytest.mark.parametrize("lm_on,layout,knobs", [
    (False, "compact", {}), (True, "compact", {}),
    (False, "compact", {"select_compact": 64}),
    (True, "classic-hot", {"cold_expand_size": 10, "select_compact": 300})])
def test_eps_free_step_matches_jax(trie, lm_on, layout, knobs):
    """The port's _eps_free_step on the CPU (through expand_emitting and
    select_beam) against JAX's _eps_free_step, one frame from a mid-decode
    beam, also with select_compact and the hot/cold split: the new beam
    bit for bit; prev_slot and words too, where JAX's are not the
    payloads of a dead row."""
    jd, td = _tables(trie, layout)
    jl = trie[3] if lm_on else None
    tl = dlm_from_jax(jl) if lm_on else None
    kw, jb, logp = _mid_beam(trie, jd, jl, 64)
    kw.update(knobs)
    jcfg, tcfg = jbeam.BeamConfig(**kw), tbeam.BeamConfig(**kw)
    step = jax.jit(jax.vmap(lambda b_, lp: jbeam._eps_free_step(
        jcfg, jd, jl, b_, lp)))
    (nb, prev, words) = step(jb, jnp.asarray(logp))
    tb = tbeam.BeamState(*(torch.from_numpy(np.array(x)) for x in jb))
    before = (tbeam.expand_emitting.launches, tbeam.select_beam.launches)
    got_b, got_prev, got_words = tbeam._eps_free_step(
        tcfg, td, tl, tb, torch.from_numpy(logp))
    assert (tbeam.expand_emitting.launches,
            tbeam.select_beam.launches) == before
    for name, x, y in zip(nb._fields, nb, got_b):
        assert_same(x, y, f"beam {name}")
    alive = np.isfinite(np.asarray(nb.costs)).any(1)
    assert alive.tolist() == [True, True, False]
    assert_same(np.asarray(prev)[alive], to_np(got_prev)[alive], "prev")
    assert_same(np.asarray(words)[alive], to_np(got_words)[alive], "words")
    assert not to_np(got_prev)[~alive].any()
    assert not to_np(got_words)[~alive].any()
    if lm_on:
        assert (to_np(got_b.lm) > 0).any()


@pytest.mark.parametrize("lm_on", [False, True])
def test_batch_decoder_ragged_batch_matches_jax(lm_on):
    """BatchDecoder on the CPU (its selection's rows masked by each
    frame's valid flag) against JAX's decode_batch on a ragged batch:
    rows that end inside a chunk, on a chunk's edge and at the last frame,
    one row of a single frame, and a last chunk padded with invalid
    frames: the same words and bit-equal costs, LM off and on.  The
    decoder counts the selection's rows it stepped (5 rows x 13 chunks of
    8, the padding included) and those whose frame was valid."""
    from catears_tpu.decode import decoder as jdecoder
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.tools import biggraph as tbiggraph
    from catears_tpu_torch.utils import log

    kw = dict(num_words=120, num_phones=25, bigram_states=30, variants=2)
    tg = make_trie_graph(np.random.RandomState(1), **kw)
    port_tg = tbiggraph.make_trie_graph(np.random.RandomState(1), **kw)
    delta = port_delta = None
    if lm_on:
        delta = make_big_lm(np.random.RandomState(9),
                            num_words=tg.num_words).delta_lm()
        port_delta = tbiggraph.make_big_lm(
            np.random.RandomState(9), num_words=tg.num_words).delta_lm()
    logp, _ = plant_logp(np.random.RandomState(2), tg, 5, 100)
    lengths = [100, 61, 1, 96, 83]
    cfg = dict(beam_size=128, expand_size=2048, eps_expand_size=1024,
               max_eps_iters=4, beam=12.0, lm_expand_size=64)
    ref = jdecoder.decode_batch(tg.fst, tg.tid2pdf, logp, lengths,
                                delta_lm=delta, config=jbeam.BeamConfig(**cfg),
                                arc_group=2, csr_group=16, chunk_frames=8,
                                retry_on_overflow=False)
    dec = BatchDecoder(port_tg.fst, port_tg.tid2pdf,
                       config=tbeam.BeamConfig(**cfg), arc_group=2,
                       csr_group=16, delta_lm=port_delta, chunk_frames=8,
                       device=CPU)
    log.reset_metrics()
    got = dec.decode(logp, lengths, retry_on_overflow=False)
    m = log.metrics()
    log.reset_metrics()
    assert [h.words for h in got] == [h.words for h in ref]
    assert [h.weight for h in got] == [h.weight for h in ref]
    assert sum(bool(h.words) for h in got) >= 3
    assert m["frame_rows_stepped"] == 5 * 104
    assert m["frame_rows_valid"] == sum(lengths) == m["frames_decoded"]


def test_public_names_take_the_plain_version_on_cpu(trie, monkeypatch):
    """CPU tensors: expand_emitting and select_beam give their plain
    versions' outputs exactly; no kernel is built or counted."""
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(tbeam, "kernel_library", no_kernel)
    _, td = _tables(trie, "classic-g4")
    states, costs, lms = random_beam(td, 3, 2, 16)
    beam = tbeam.BeamState(torch.from_numpy(states), torch.from_numpy(lms),
                           torch.from_numpy(costs),
                           torch.arange(16, dtype=torch.int32).expand(2, 16),
                           torch.zeros(2, dtype=torch.bool),
                           torch.zeros((2, 5), dtype=torch.int32))
    logp = torch.from_numpy(np.log(np.random.RandomState(0).dirichlet(
        np.ones(200), 2)).astype(np.float32))
    cfg = tbeam.BeamConfig(beam_size=16, expand_size=128)
    before = (tbeam.expand_emitting.launches, tbeam.select_beam.launches)
    got = tbeam.expand_emitting(cfg, td, beam, logp, True)
    ref = tbeam.expand_emitting_ref(cfg, td, beam, logp, True)
    for name, x, y in zip(tbeam.EmitCands._fields, ref, got):
        assert_same(x, y, name)
    cols = (got.state, got.lm, got.cost, None, None, got.tok, got.olab2,
            got.olabel)
    sel = tbeam.select_beam(cfg, *cols)
    ref = tbeam.select_beam_ref(cfg, *cols)
    for name, x, y in zip(tbeam.Selected._fields, ref, sel):
        assert_same(x, y, name)
    assert (tbeam.expand_emitting.launches,
            tbeam.select_beam.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take(trie):
    """Other devices, dtypes, shapes and layouts raise on every device: no
    path falls back to a plain version."""
    _, td = _tables(trie, "compact")
    _, td4 = _tables(trie, "classic-g4")
    cfg = tbeam.BeamConfig(beam_size=4, expand_size=64)
    z = torch.zeros((2, 4), dtype=torch.int32)
    f = torch.zeros((2, 4))
    beam = tbeam.BeamState(z, z, f, z, torch.zeros(2, dtype=torch.bool),
                           torch.zeros((2, 5), dtype=torch.int32))
    logp = torch.zeros((2, 10))
    meta = tbeam.BeamState(*(x.to("meta") for x in beam))
    with pytest.raises(ValueError, match="unsupported device"):
        tbeam.expand_emitting(cfg, td, meta, logp.to("meta"), False)
    with pytest.raises(ValueError, match="float32"):
        tbeam.expand_emitting(cfg, td, beam._replace(costs=f.double()),
                              logp, False)
    with pytest.raises(ValueError, match=r"needs beam \[B, 8\]"):
        tbeam.expand_emitting(tbeam.BeamConfig(beam_size=8), td, beam, logp,
                              False)
    with pytest.raises(ValueError, match="emit_hot must be"):
        tbeam.expand_emitting(
            tbeam.BeamConfig(beam_size=4, cold_expand_size=8),
            dataclasses.replace(td4, hot_rows=5, emit_hot=None), beam, logp,
            False)
    with pytest.raises(ValueError, match="emit_hot must hold rows"):
        tbeam.expand_emitting(
            tbeam.BeamConfig(beam_size=4, cold_expand_size=8),
            dataclasses.replace(td4, hot_rows=5,
                                emit_hot=td4.emit_block[:5, :-1]),
            beam, logp, False)
    with pytest.raises(ValueError, match="neither the compact"):
        tbeam.expand_emitting(cfg, dataclasses.replace(
            td4, emit_block=td4.emit_block[:, :-1]), beam, logp, False)
    for bad in (torch.ones(2, dtype=torch.int32),
                torch.ones(3, dtype=torch.bool),
                torch.ones(4, dtype=torch.bool)[::2]):
        with pytest.raises(ValueError, match="row_valid must be"):
            tbeam.expand_emitting(cfg, td, beam, logp, False, row_valid=bad)
    e = torch.zeros((2, 12), dtype=torch.int32)
    c = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="unsupported device"):
        tbeam.select_beam(cfg, e.to("meta"), None, c.to("meta"), None, None,
                          e.to("meta"), e.to("meta"), e.to("meta"))
    with pytest.raises(ValueError, match="cost must be"):
        tbeam.select_beam(cfg, e, None, c.double(), None, None, e, e, e)
    with pytest.raises(ValueError, match="tok must be"):
        tbeam.select_beam(cfg, e, None, c, None, None, e[:, :5], e, e)
    with pytest.raises(ValueError, match="lm must be"):
        tbeam.select_beam(tbeam.BeamConfig(beam_size=4, select_compact=8),
                          e, e.to(torch.int64), c, None, None, e, e, e)
    with pytest.raises(ValueError, match="stamps must be"):  # a card's only
        tbeam.select_beam(cfg, e, None, c, None, None, e, e, e,
                          stamps=torch.zeros((2, tbeam.SELECT_STAMPS),
                                             dtype=torch.int64))

