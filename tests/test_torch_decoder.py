"""PyTorch port of the batched beam search vs the JAX decoder, exactly.

`init_beam_batch` then `decode_chunk` per chunk, on the same device tables
(the JAX build's, loaded with DeviceFst.from_numpy / DeviceLm.from_numpy)
and the same numpy log-probs, LM off and with delta-LM rescoring: every
chunk's beam (states, lm, costs bit for bit, bp, overflow, hiwater) and
trace (prev_slot, words) must be identical, and so must the BatchDecoder
transcripts and costs (LM final weights included), overflow retry
included.  No tolerance: the decode is integer bookkeeping plus float32
sums done in the same order.  The graphs here are eps-free (the random
ones drawn by eps_free_random_fst); the closed and raw modes are held to
JAX in tests/test_torch_eps_modes.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_same, dfst_from_jax, dirichlet,
                           dlm_from_jax, eps_free_random_fst, run_chunks,
                           with_lm_words)
from catears_tpu.decode import beam as jbeam
from catears_tpu.decode import decoder as jdecoder
from catears_tpu.graph.device import DeviceFst as JaxDeviceFst
from catears_tpu.graph.device import DeviceLm as JaxDeviceLm
from catears_tpu.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu.io.binfmt import read_vec0_file
from catears_tpu.io.symbols import SymbolTable
from catears_tpu.graph.transform import prepare_decode_graph
from catears_tpu.tools.biggraph import make_big_lm, make_trie_graph, plant_logp
from catears_tpu.tools.toy import make_phone_loop_graph
from catears_tpu.utils.errors import BeamCapacityError
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.decode import decoder as tdecoder
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.graph import transform as ttransform
from catears_tpu_torch.io import binfmt as tbinfmt
from catears_tpu_torch.io import symbols as tsymbols
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.tools import toy as ttoy
from catears_tpu_torch.utils import errors as terrors


def _configs(**kw):
    base = dict(beam_size=32, expand_size=64, eps_expand_size=16,
                max_eps_iters=6, beam=10.0, am_scale=0.1)
    base.update(kw)
    return jbeam.BeamConfig(**base), tbeam.BeamConfig(**base)


def _build(fst, tid2pdf, group, csr_group=None):
    g2, olab2, mode = prepare_decode_graph(fst)
    assert mode == "eps_free"
    jd = JaxDeviceFst.build(g2, tid2pdf, group=group, eps_depth_cap=1,
                            csr_group=csr_group, olabel2=olab2)
    return jd, dfst_from_jax(jd)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_eps_free_graphs(seed):
    fst, used = eps_free_random_fst(seed, flat=FlatFst)
    rng = np.random.RandomState(used + 1)
    jd, td = _build(fst, np.arange(11, dtype=np.int32), group=2)
    jcfg, tcfg = _configs()
    run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (3, 20)), [20, 13, 7])


@pytest.mark.parametrize("group", [1, 4])
def test_phone_loop_ragged(group):
    rng = np.random.RandomState(100 + group)
    g = make_phone_loop_graph(rng, num_words=5, num_pdfs=24)
    jd, td = _build(FlatFst.from_raw(g.fst), g.tid2pdf, group)
    jcfg, tcfg = _configs()
    final = run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 24, (4, 21)),
                       [21, 16, 9, 2])
    assert np.isfinite(np.asarray(final.costs)).any()


def test_high_fanout_csr_overflow():
    """A 30-word loop state: the CSR overflow pass runs, and an undersized
    expand_size truncates, sets the sticky flag and records hiwater."""
    rng = np.random.RandomState(42)
    g = make_phone_loop_graph(rng, num_words=30, num_pdfs=32)
    jd, td = _build(FlatFst.from_raw(g.fst), g.tid2pdf, group=1)
    assert td.max_emit_fanout > 1
    jcfg, tcfg = _configs(beam_size=64, expand_size=8, beam=1e9)
    final = run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 32, (2, 17)),
                       [17, 11])
    assert np.asarray(final.overflow).all()
    assert (np.asarray(final.hiwater)[:, 0] > 8).all()


def test_dead_end_freezes_beam():
    arcs = np.array([(0, 1, 1, 1, 0.5), (1, 2, 2, 2, 0.5)])
    final = np.full(3, np.inf, np.float32)
    final[2] = 0.0
    fst, port_fst = (flat.from_arrays(
        start=0, final=final, state_of_arc=arcs[:, 0].astype(np.int64),
        arc_next=arcs[:, 1].astype(np.int32),
        arc_ilabel=arcs[:, 2].astype(np.int32),
        arc_olabel=arcs[:, 3].astype(np.int32),
        arc_weight=arcs[:, 4].astype(np.float32))
        for flat in (FlatFst, tfst.FlatFst))
    tid2pdf = np.arange(3, dtype=np.int32)
    jd, td = _build(fst, tid2pdf, group=2)
    jcfg, tcfg = _configs(beam_size=16)
    logp = np.log(np.full((2, 6, 3), 1 / 3, np.float32))
    run_chunks(jd, td, jcfg, tcfg, logp, [6, 4])
    dec = tdecoder.BatchDecoder(port_fst, tid2pdf, config=tcfg, arc_group=2,
                                device=CPU)
    assert [h.words for h in dec.decode(logp, [6, 4])] == [[1, 2], [1, 2]]


def test_compact_trie_planted():
    rng = np.random.RandomState(1)
    tg = make_trie_graph(rng, num_words=120, num_phones=25,
                         bigram_states=30, variants=2)
    jd, td = _build(tg.fst, tg.tid2pdf, group=2, csr_group=16)
    assert td.emit_compact
    logp, _ = plant_logp(rng, tg, 2, 30)
    jcfg, tcfg = _configs(beam_size=64, expand_size=256, eps_expand_size=64)
    run_chunks(jd, td, jcfg, tcfg, logp, [30, 23])


def test_batch_decoder_retry_matches_jax():
    """Undersized capacities: both regrow from hiwater and retry once, with
    identical transcripts and costs; without retry both raise with the
    same hiwater."""
    rng = np.random.RandomState(5)
    g = make_phone_loop_graph(rng, num_words=40, num_pdfs=32)
    fst = FlatFst.from_raw(g.fst)
    port_fst = tfst.FlatFst.from_raw(ttoy.make_phone_loop_graph(
        np.random.RandomState(5), num_words=40, num_pdfs=32).fst)
    logp = dirichlet(rng, 32, (2, 30))
    lengths = [30, 19]
    jcfg, tcfg = _configs(beam_size=64, expand_size=8, eps_expand_size=512,
                          beam=1e9)
    ref = jdecoder.decode_batch(fst, g.tid2pdf, logp, lengths, config=jcfg,
                                arc_group=1, chunk_frames=10)
    dec = tdecoder.BatchDecoder(port_fst, g.tid2pdf, config=tcfg,
                                arc_group=1, device=CPU)
    got = dec.decode(logp, lengths)
    assert [h.words for h in got] == [h.words for h in ref]
    assert [h.weight for h in got] == [h.weight for h in ref]
    with pytest.raises(BeamCapacityError) as jerr:
        jdecoder.decode_batch(fst, g.tid2pdf, logp, lengths, config=jcfg,
                              arc_group=1, chunk_frames=10,
                              retry_on_overflow=False)
    with pytest.raises(terrors.BeamCapacityError) as terr:
        dec.decode(logp, lengths, retry_on_overflow=False)
    assert terr.value.hiwater == jerr.value.hiwater


def test_backtrace_device_matches_jax():
    rng = np.random.RandomState(3)
    t, b, k, w = 9, 3, 5, 2
    prev = rng.randint(-1, k, (t, b, k)).astype(np.int32)
    words = rng.randint(0, 4, (t, b, k, w)).astype(np.int32)
    slots = np.array([0, 4, -1], np.int32)
    ref = jbeam.backtrace_device(
        jbeam.FrameTrace(jnp.asarray(prev), jnp.asarray(words)),
        jnp.asarray(slots))
    got = tbeam.backtrace_device(
        tbeam.FrameTrace(torch.from_numpy(prev), torch.from_numpy(words)),
        torch.from_numpy(slots))
    assert_same(ref, got, "words")


def test_init_closure_without_packed_eps_metadata():
    """A root with 520 epsilon arcs (>= 512) does not fit the packed eps
    metadata lane, so the init closure takes the state_packed path."""
    rng = np.random.RandomState(8)
    n = 520
    arcs = [(0, i, 0, i % 7, rng.rand() * 3) for i in range(1, n + 1)]
    arcs += [(i, i, 1 + rng.randint(10), 0, rng.rand()) for i in
             range(1, n + 1)]
    arr = np.array(arcs)
    final = np.where(rng.rand(n + 1) < 0.5, 0.0, np.inf).astype(np.float32)
    fst = FlatFst.from_arrays(
        start=0, final=final, state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))
    jd, td = _build(fst, np.arange(11, dtype=np.int32), group=2)
    assert not td.eps_meta_ok
    jcfg, tcfg = _configs(eps_expand_size=1024)
    run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (2, 9)), [9, 5])


# -- delta-LM rescoring ------------------------------------------------------


@pytest.fixture(scope="module")
def toy_delta(data_dir):
    """The toy G' of tests/test_decoder.py's TestDeltaLm."""
    lm = LmFst.read_lm(os.path.join(data_dir, "G.pfst"))
    table = SymbolTable.read(os.path.join(data_dir, "lm.words.txt"))
    small = read_vec0_file(os.path.join(data_dir, "lm.1order.bin"))
    return DeltaLmFst(small, lm, table)


@pytest.fixture(scope="module")
def port_toy_delta(data_dir):
    """The same G', read by the port."""
    lm = tfst.LmFst.read_lm(os.path.join(data_dir, "G.pfst"))
    table = tsymbols.SymbolTable.read(os.path.join(data_dir, "lm.words.txt"))
    small = tbinfmt.read_vec0_file(os.path.join(data_dir, "lm.1order.bin"))
    return tfst.DeltaLmFst(small, lm, table)


def _lm_pair(delta):
    jl = JaxDeviceLm.build(delta)
    return jl, dlm_from_jax(jl)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_graphs_with_delta_lm(toy_delta, seed):
    fst, used = eps_free_random_fst(seed, flat=FlatFst)
    rng = np.random.RandomState(used + 7)
    fst = with_lm_words(fst, toy_delta, rng)
    jd, td = _build(fst, np.arange(11, dtype=np.int32), group=2)
    assert td.has_emit_olabel  # both LM walks run
    jl, tl = _lm_pair(toy_delta)
    jcfg, tcfg = _configs()
    final = run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (3, 20)),
                       [20, 13, 7], jl, tl)
    assert (np.asarray(final.lm) > 0).any()
    assert (np.asarray(final.hiwater)[:, 2] > 0).all()


@pytest.fixture(scope="module")
def planted_lm():
    rng = np.random.RandomState(1)
    g = make_trie_graph(rng, num_words=120, num_phones=25, bigram_states=30,
                        variants=2)
    delta = make_big_lm(np.random.RandomState(9),
                        num_words=g.num_words).delta_lm()
    logp, _ = plant_logp(rng, g, 2, 40)
    return g, delta, logp, [40, 29]


@pytest.fixture(scope="module")
def port_planted_lm():
    """The port's own trie graph and G' from the same seeds."""
    g = tbiggraph.make_trie_graph(np.random.RandomState(1), num_words=120,
                                  num_phones=25, bigram_states=30, variants=2)
    return g, tbiggraph.make_big_lm(np.random.RandomState(9),
                                    num_words=g.num_words).delta_lm()


def _planted_configs(**kw):
    return _configs(beam_size=128, expand_size=2048, eps_expand_size=1024,
                    max_eps_iters=4, beam=12.0, **kw)


@pytest.mark.parametrize("cap", ["uncapped", "hiwater", "one"])
def test_planted_trie_with_big_delta_lm(planted_lm, cap):
    """The trie + ARPA-shaped G' (test_planted_decode_with_big_delta_lm's
    setup) at lm_expand_size 0, at its high-water mark and at 1, where the
    capped walk truncates: overflow and the wrong-but-flagged beams match
    too."""
    g, delta, logp, lengths = planted_lm
    jd, td = _build(g.fst, g.tid2pdf, group=2, csr_group=16)
    jl, tl = _lm_pair(delta)
    jcfg, tcfg = _planted_configs()
    final = run_chunks(jd, td, jcfg, tcfg, logp, lengths, jl, tl)
    hw = int(np.asarray(final.hiwater)[:, 2].max())
    assert hw > 1 and not np.asarray(final.overflow).any()
    if cap == "uncapped":
        return
    lm_cap = hw if cap == "hiwater" else 1
    jcfg, tcfg = _planted_configs(lm_expand_size=lm_cap)
    capped = run_chunks(jd, td, jcfg, tcfg, logp, lengths, jl, tl)
    assert np.asarray(capped.overflow).all() == (cap == "one")
    if cap == "hiwater":
        for name in ("states", "lm", "costs"):
            assert_same(getattr(final, name), getattr(capped, name), name)


def test_batch_decoder_with_delta_lm_matches_jax(planted_lm, port_planted_lm,
                                                 toy_delta, port_toy_delta):
    """Words and bit-equal totals (LM final weights included), on the
    planted trie with its big G' and on a random graph with the toy G'."""
    g, delta, logp, lengths = planted_lm
    tg, tdelta = port_planted_lm
    jcfg, tcfg = _planted_configs()
    ref = jdecoder.decode_batch(g.fst, g.tid2pdf, logp, lengths,
                                delta_lm=delta, config=jcfg, arc_group=2,
                                csr_group=16, chunk_frames=16,
                                retry_on_overflow=False)
    got = tdecoder.BatchDecoder(tg.fst, tg.tid2pdf, config=tcfg, arc_group=2,
                                csr_group=16, delta_lm=tdelta,
                                device=CPU).decode(
        logp, lengths, retry_on_overflow=False)
    assert [h.words for h in got] == [h.words for h in ref]
    assert [h.weight for h in got] == [h.weight for h in ref]
    assert any(h.words for h in got)

    fst, used = eps_free_random_fst(4, flat=FlatFst)
    rng = np.random.RandomState(used + 7)
    fst = with_lm_words(fst, toy_delta, rng)
    port_fst = with_lm_words(eps_free_random_fst(4)[0], port_toy_delta,
                              np.random.RandomState(used + 7))
    tid2pdf = np.arange(11, dtype=np.int32)
    lp = dirichlet(rng, 11, (3, 15))
    jcfg, tcfg = _configs()
    ref = jdecoder.decode_batch(fst, tid2pdf, lp, [15, 11, 6],
                                delta_lm=toy_delta, config=jcfg, arc_group=2,
                                chunk_frames=8)
    got = tdecoder.BatchDecoder(port_fst, tid2pdf, config=tcfg, arc_group=2,
                                delta_lm=port_toy_delta,
                                device=CPU).decode(lp, [15, 11, 6])
    assert [h.words for h in got] == [h.words for h in ref]
    assert [h.weight for h in got] == [h.weight for h in ref]
    assert np.isfinite([h.weight for h in got]).any()


def test_batch_decoder_lm_regrow_matches_jax(planted_lm, port_planted_lm):
    """lm_expand_size = 1 overflows: both regrow lm_expand_size from the
    high-water mark and retry once, with identical words and totals;
    without retry both raise with the same hiwater."""
    g, delta, logp, lengths = planted_lm
    tg, tdelta = port_planted_lm
    jcfg, tcfg = _planted_configs(lm_expand_size=1)
    ref = jdecoder.decode_batch(g.fst, g.tid2pdf, logp, lengths,
                                delta_lm=delta, config=jcfg, arc_group=2,
                                csr_group=16, chunk_frames=16)
    dec = tdecoder.BatchDecoder(tg.fst, tg.tid2pdf, config=tcfg, arc_group=2,
                                csr_group=16, delta_lm=tdelta, device=CPU)
    got = dec.decode(logp, lengths)
    assert [h.words for h in got] == [h.words for h in ref]
    assert [h.weight for h in got] == [h.weight for h in ref]
    with pytest.raises(BeamCapacityError) as jerr:
        jdecoder.decode_batch(g.fst, g.tid2pdf, logp, lengths,
                              delta_lm=delta, config=jcfg, arc_group=2,
                              csr_group=16, chunk_frames=16,
                              retry_on_overflow=False)
    with pytest.raises(terrors.BeamCapacityError) as terr:
        dec.decode(logp, lengths, retry_on_overflow=False)
    assert terr.value.hiwater == jerr.value.hiwater
    regrown = tdecoder._regrow_config(tcfg, terr.value.hiwater)
    assert regrown.lm_expand_size == jdecoder._regrow_config(
        jcfg, jerr.value.hiwater, 1.5).lm_expand_size > 1


def test_safe_config_with_lm_matches_jax(planted_lm, port_planted_lm):
    g, _, _, _ = planted_lm
    g2, _, _ = prepare_decode_graph(g.fst)
    tg2, _, _ = ttransform.prepare_decode_graph(port_planted_lm[0].fst)
    jcfg, tcfg = _planted_configs()
    for has_lm in (False, True):
        ref = jdecoder.safe_config(g2, 2, jcfg, has_lm, csr_group=16)
        got = tdecoder.safe_config(tg2, 2, tcfg, has_lm, csr_group=16)
        assert (got.expand_size, got.eps_expand_size) == (
            ref.expand_size, ref.eps_expand_size)


# -- the final-token pick ------------------------------------------------------


def _jax_batch_pick(states, lms, costs, final, delta_lm, final_fallback):
    """The final-weight pick inline in the JAX batch decoder
    (catears_tpu/decode/decoder.py::_decode_batch_once), copied here as
    the reference: (best_slots, totals, empty)."""
    b = states.shape[0]
    best_slots = np.zeros(b, np.int32)
    totals = np.zeros(b, np.float64)
    empty = np.zeros(b, bool)
    for u in range(b):
        total = costs[u].astype(np.float64).copy()
        valid = states[u] >= 0
        idx = np.where(valid, states[u], 0)
        total += np.where(valid, np.asarray(final)[idx], np.inf)
        if delta_lm is not None:
            for i in np.nonzero(valid & np.isfinite(total))[0]:
                total[i] += delta_lm.final(int(lms[u, i]))
        total[~valid] = np.inf
        if not np.isfinite(total).any():
            if not final_fallback:
                empty[u] = True
                continue
            total = np.where(valid, costs[u], np.inf)
        best_slots[u] = int(np.argmin(total))
        totals[u] = total[best_slots[u]]
    return best_slots, totals, empty


def _pick_rows(case):
    """[B, K] beam rows (states, lms, costs) and the graph's final weights
    for one case of the pick; every case has a dead slot in each row."""
    rng = np.random.RandomState(sum(map(ord, case)))
    b, k, s = 5, 12, 30
    final = rng.uniform(0, 3, s).astype(np.float32)
    final[rng.rand(s) < 0.3] = np.inf
    states = rng.randint(0, s, (b, k)).astype(np.int32)
    states[:, 3] = -1
    states[rng.rand(b, k) < 0.2] = -1
    costs = rng.uniform(0, 10, (b, k)).astype(np.float32)
    lms = rng.randint(0, 40, (b, k)).astype(np.int32)
    if case == "ties":  # equal totals on several slots: the first wins
        final[np.isfinite(final)] = 0.5
        costs = rng.choice(np.float32([1.0, 2.0]), (b, k))
        costs[:, 3] = 0.0  # the dead slot would win
    elif case == "all_dead":
        states[1] = -1
    elif case == "no_final":  # live slots, none in a final state
        states[2] = np.flatnonzero(~np.isfinite(final))[0]
        states[2, 5] = -1
    elif case == "lm_shared":  # a few LM states shared across the batch
        lms = rng.choice(np.int32([1, 7, 40]), (b, k))
    elif case == "lm_distinct":
        # every one of the 83 states of the 40-word G' below
        lms = rng.permutation(b * k).reshape(b, k).astype(np.int32) % 83
        lms[0, :] = 42  # the G' final state: no </s>, an infinite final
    return states, lms, costs, final


PICK_CASES = [(case, fb) for case in ("ties", "all_dead", "no_final",
                                      "lm_shared", "lm_distinct")
              for fb in (False, True)] + [("not_eos", False)]


@pytest.mark.parametrize("case,fallback", PICK_CASES)
def test_pick_final_matches_jax(case, fallback):
    """hyp.pick_final over a [B, K] batch against JAX's best_path row by
    row (without the fallback) and against the JAX batch decoder's inline
    pick (at end of stream): slots, totals and empties equal to the bit."""
    from types import SimpleNamespace

    from catears_tpu.decode import hyp as jhyp
    from catears_tpu_torch.decode import hyp as thyp

    states, lms, costs, final = _pick_rows(case)
    eos = case != "not_eos"
    jdelta = tdelta = None
    if case.startswith("lm_"):
        jdelta = make_big_lm(np.random.RandomState(9),
                             num_words=40).delta_lm()
        tdelta = tbiggraph.make_big_lm(np.random.RandomState(9),
                                       num_words=40).delta_lm()
        assert not np.isfinite(jdelta.final(42))
    slot, total, empty = thyp.pick_final(states, lms, costs, final, tdelta,
                                         end_of_stream=eos,
                                         fallback=fallback)
    assert slot.dtype == np.int64 and total.dtype == np.float64
    if eos:
        want = _jax_batch_pick(states, lms, costs, final, jdelta, fallback)
        assert np.array_equal(slot, want[0])
        assert total.tobytes() == want[1].tobytes()
        assert np.array_equal(empty, want[2])
    if fallback:
        assert not empty.any()
        return
    # A one-frame trace whose slot k emits word k + 1 names the slot the
    # reference's backtrace starts from.
    k = states.shape[1]
    trace = [jhyp.HostTrace(np.full(k, -1, np.int32),
                            np.arange(1, k + 1, dtype=np.int32)[:, None])]
    port_trace = [thyp.HostTrace(t.prev_slot, t.words) for t in trace]
    graph = SimpleNamespace(final=final)
    for u in range(states.shape[0]):
        ref = jhyp.best_path(trace, states[u], lms[u], costs[u], graph,
                             jdelta, end_of_stream=eos)
        got = thyp.best_path(port_trace, states[u], lms[u], costs[u],
                             graph, tdelta, end_of_stream=eos)
        assert (got.words, got.weight) == (ref.words, ref.weight)
        assert bool(empty[u]) == (ref.words == [])
        assert ref.words == ([] if empty[u] else [int(slot[u]) + 1])
        assert (np.float64(ref.weight).tobytes()
                == np.float64(total[u]).tobytes())
    assert case not in ("all_dead", "no_final") or empty.any()
