"""The port's closed and raw epsilon modes vs the JAX decoder, exactly.

Graphs that keep their epsilon arcs decode as `_emitting_step` + a closure:
`_eps_closure_fused` when the epsilon depth is static (closed graphs at
depth 1, raw ones of depth <= max_eps_iters), the arena `_eps_closure` +
`_resolve_chains` otherwise.  On the same device tables (the JAX build's)
and the same numpy log-probs, LM off and with a delta-LM, every chunk's
beam (states, lm, costs bit for bit, bp, overflow, all five hiwater slots)
and trace (prev_slot, words) must be identical; so must the Decoder's and
BatchDecoder's words, costs and high-water marks.  The port runs every one
of max_eps_iters rounds of the dynamic closure where the JAX while_loop
stops at the first round that accepts nothing:
`test_static_rounds_equal_while_loop` shows that the loop does stop early
on its graphs and that the results agree all the same.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, STREAM_BEAM, assert_same, dfst_from_jax,
                           dirichlet, dlm_from_jax, random_fst, run_chunks,
                           wav_payload, with_lm_words, write_raw_conf,
                           write_stream_toy)
from catears_tpu.decode import beam as jbeam
from catears_tpu.decode import decoder as jdecoder
from catears_tpu.graph.device import DeviceFst as JaxDeviceFst
from catears_tpu.graph.device import DeviceLm as JaxDeviceLm
from catears_tpu.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu.graph.transform import close_epsilons, prepare_decode_graph
from catears_tpu.io.binfmt import read_vec0_file
from catears_tpu.io.symbols import SymbolTable
from catears_tpu.runtime import recognizer as jrec
from catears_tpu.tools.biggraph import make_trie_graph, plant_logp
from catears_tpu.tools.toy import make_phone_loop_graph
from catears_tpu.utils.errors import BeamCapacityError
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.decode import decoder as tdecoder
from catears_tpu_torch.graph import device as tdevice
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.graph import transform as ttransform
from catears_tpu_torch.io import binfmt as tbinfmt
from catears_tpu_torch.io import symbols as tsymbols
from catears_tpu_torch.runtime import recognizer as trec
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.tools import toy as ttoy
from catears_tpu_torch.utils import errors as terrors

TID2PDF = np.arange(11, dtype=np.int32)  # random_fst's 10 transition ids
# The frame path of each random_fst seed at max_eps_iters 6 (seed 0 reaches
# the eps-free mode; seeds 2 and 4 have no static epsilon depth).
RANDOM_PATHS = {0: "eps_free", 2: "dynamic", 4: "dynamic"}


def _configs(**kw):
    base = dict(beam_size=128, expand_size=1024, eps_expand_size=512,
                max_eps_iters=6, beam=8.0, am_scale=0.1)
    base.update(kw)
    return jbeam.BeamConfig(**base), tbeam.BeamConfig(**base)


def _build(fst, tid2pdf, group=2, close_eps=True, csr_group=None):
    """The JAX decoders' device graph (built by JAX) and the port's copy of
    its tables, with prepare_decode_graph's mode ('raw' without
    close_eps)."""
    g2, cap, olab2, mode = fst, None, None, "raw"
    if close_eps:
        h, o, mode = prepare_decode_graph(fst)
        if mode != "raw":
            g2, cap, olab2 = h, 1, o
    jd = JaxDeviceFst.build(g2, tid2pdf, group=group, eps_depth_cap=cap,
                            csr_group=csr_group, olabel2=olab2)
    return jd, dfst_from_jax(jd), mode


def _path(cfg, dfst):
    if dfst.eps_removed:
        return "eps_free"
    return "static" if tbeam._static_depth(cfg, dfst) else "dynamic"


def _fsts(seed):
    """random_fst(seed) as the JAX package's and as the port's FlatFst."""
    return (random_fst(np.random.RandomState(seed), flat=FlatFst),
            random_fst(np.random.RandomState(seed), flat=tfst.FlatFst))


def test_emitting_acoustic_term_is_one_fma():
    """The JAX _emitting_step writes its acoustic term `cost + (-am_scale
    * logp)`; XLA:CPU contracts that into one fused multiply-add, as it
    does the eps-free form, so the port's _emitting_step takes beam._fms
    (two roundings differ on some lanes)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    cost = (rng.randn(200_000) * 50).astype(np.float32)
    logp = np.log(rng.rand(200_000)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c, l: c + (-0.1 * l))(
        jnp.asarray(cost), jnp.asarray(logp)))
    got = tbeam._fms(torch.from_numpy(cost), 0.1,
                     torch.from_numpy(logp)).numpy()
    assert_same(ref, got, "acoustic term")
    assert (ref != cost + np.float32(-0.1) * logp).any()


@pytest.mark.parametrize("seed", range(12))
def test_random_graph_modes(seed):
    """tests/test_decoder.py's random graphs: all three frame paths."""
    fst, _ = _fsts(seed)
    jd, td, mode = _build(fst, TID2PDF)
    jcfg, tcfg = _configs()
    assert mode == ("eps_free" if seed == 0 else "raw")
    assert _path(tcfg, td) == RANDOM_PATHS.get(seed, "static")
    rng = np.random.RandomState(seed + 1)
    run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (3, 20)), [20, 13, 7])


@pytest.mark.parametrize("seed,iters", [(5, 3), (9, 3), (2, 6), (4, 6)])
def test_static_rounds_equal_while_loop(monkeypatch, seed, iters):
    """The dynamic closure: seeds 5 and 9 (epsilon depth 4) at
    max_eps_iters 3, seeds 2 and 4 (no static depth) at 6.  For every
    closure of the decode, the round after which the JAX while_loop stops
    is found by running the port's closure with 1, 2, ... rounds: the
    first r >= 2 whose beam equals that of r - 1 accepted nothing.  The
    loop must stop early somewhere, and the port's all-rounds closure must
    still equal JAX's, chunk by chunk."""
    fst, _ = _fsts(seed)
    jd, td, _ = _build(fst, TID2PDF)
    jcfg, tcfg = _configs(max_eps_iters=iters)
    assert _path(tcfg, td) == "dynamic"
    closure = tbeam._eps_closure
    stops = []

    def observed(cfg, dfst, dlm, beam, arena, cutoff):
        rounds = [beam]
        for r in range(1, cfg.max_eps_iters + 1):
            rounds.append(closure(dataclasses.replace(cfg, max_eps_iters=r),
                                  dfst, dlm, beam, arena.clone(), cutoff)[0])
        for u in range(beam.states.shape[0]):
            same = [all(torch.equal(a[u], b[u]) for a, b in
                        zip(rounds[r - 1][:4], rounds[r][:4]))
                    for r in range(2, cfg.max_eps_iters + 1)]
            stops.append(2 + same.index(True) if True in same
                         else cfg.max_eps_iters)
        return closure(cfg, dfst, dlm, beam, arena, cutoff)

    monkeypatch.setattr(tbeam, "_eps_closure", observed)
    rng = np.random.RandomState(seed + 1)
    run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (3, 20)), [20, 13, 7])
    assert min(stops) < iters, stops


@pytest.mark.parametrize("group", [1, 4])
def test_phone_loop_raw(group):
    """The phone loop with close_eps=False: word-end epsilon arcs closed
    by the static rounds, ragged lengths."""
    rng = np.random.RandomState(100 + group)
    g = make_phone_loop_graph(rng, num_words=5, num_pdfs=24)
    jd, td, _ = _build(FlatFst.from_raw(g.fst), g.tid2pdf, group,
                       close_eps=False)
    jcfg, tcfg = _configs()
    assert _path(tcfg, td) == "static"
    final = run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 24, (4, 21)),
                       [21, 16, 9, 2])
    assert np.isfinite(np.asarray(final.costs)).any()


@pytest.fixture(scope="module")
def trie():
    rng = np.random.RandomState(1)
    tg = make_trie_graph(rng, num_words=120, num_phones=25,
                         bigram_states=30, variants=2)
    logp, _ = plant_logp(rng, tg, 2, 30)
    return tg, logp


@pytest.mark.parametrize("mode,iters", [("closed", 4), ("raw", 4),
                                        ("raw", 1)])
def test_trie_closed_and_raw(trie, mode, iters):
    """The small trie through close_epsilons (depth capped at 1), and raw
    (depth 2: static at max_eps_iters 4, the arena path at 1), on planted
    log-probs."""
    tg, logp = trie
    if mode == "closed":
        fst, ok = close_epsilons(tg.fst)
        assert ok
        jd = JaxDeviceFst.build(fst, tg.tid2pdf, group=2, eps_depth_cap=1,
                                csr_group=16)
        td = dfst_from_jax(jd)
    else:
        jd, td, _ = _build(tg.fst, tg.tid2pdf, csr_group=16, close_eps=False)
    jcfg, tcfg = _configs(expand_size=2048, eps_expand_size=1024,
                          max_eps_iters=iters, beam=12.0)
    assert td.eps_depth == (1 if mode == "closed" else 2)
    assert _path(tcfg, td) == ("static" if iters >= td.eps_depth
                               else "dynamic")
    run_chunks(jd, td, jcfg, tcfg, logp, [30, 23])


def test_device_fst_build_modes(trie):
    """DeviceFst.build of the port gives JAX's tables and eps_depth for a
    closed graph (cap 1) and raw ones (cap None), also where the depth is
    unbounded."""
    tg, _ = trie
    port_tg = tbiggraph.make_trie_graph(np.random.RandomState(1),
                                        num_words=120, num_phones=25,
                                        bigram_states=30, variants=2)
    closed = close_epsilons(tg.fst)[0]
    port_closed = ttransform.close_epsilons(port_tg.fst)[0]
    cases = [(closed, port_closed, tg.tid2pdf, 1, 16),
             (tg.fst, port_tg.fst, tg.tid2pdf, None, 16)]
    for seed in (1, 2):
        cases.append(_fsts(seed) + (TID2PDF, None, None))
    for fst, port_fst, tid2pdf, cap, csr in cases:
        jd = JaxDeviceFst.build(fst, tid2pdf, group=2, eps_depth_cap=cap,
                                csr_group=csr)
        arrays, meta = tdevice.build_arrays(port_fst, tid2pdf, group=2,
                                            eps_depth_cap=cap, csr_group=csr)
        assert meta["eps_depth"] == jd.eps_depth
        for name in tdevice.TABLES:
            assert_same(getattr(jd, name), arrays[name], name)
    assert [c for c in (JaxDeviceFst.build(f, t, group=2, eps_depth_cap=c_)
                        .eps_depth for f, _, t, c_, _ in cases[2:])] == [
        2, None]


# -- delta-LM rescoring ------------------------------------------------------


@pytest.fixture(scope="module")
def toy_delta(data_dir):
    """The toy G' of tests/test_decoder.py's TestDeltaLm, read by each
    package."""
    paths = [os.path.join(data_dir, name) for name in
             ("G.pfst", "lm.words.txt", "lm.1order.bin")]
    jax_lm = DeltaLmFst(read_vec0_file(paths[2]), LmFst.read_lm(paths[0]),
                        SymbolTable.read(paths[1]))
    port_lm = tfst.DeltaLmFst(tbinfmt.read_vec0_file(paths[2]),
                              tfst.LmFst.read_lm(paths[0]),
                              tsymbols.SymbolTable.read(paths[1]))
    return jax_lm, port_lm


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_random_graphs_with_delta_lm(toy_delta, seed):
    """Static (seed 1) and dynamic (2; 5 at max_eps_iters 3) closures with
    the toy G': an LM walk on the emitting arcs and one per closure
    round."""
    fst, _ = _fsts(seed)
    rng = np.random.RandomState(seed + 7)
    fst = with_lm_words(fst, toy_delta[0], rng)
    jd, td, _ = _build(fst, TID2PDF)
    jl = JaxDeviceLm.build(toy_delta[0])
    jcfg, tcfg = _configs(max_eps_iters=3 if seed == 5 else 6)
    final = run_chunks(jd, td, jcfg, tcfg, dirichlet(rng, 11, (3, 20)),
                       [20, 13, 7], jl, dlm_from_jax(jl))
    assert (np.asarray(final.lm) > 0).any()
    assert (np.asarray(final.hiwater)[:, 2] > 0).all()


# -- the entry points --------------------------------------------------------


@pytest.mark.parametrize("seed,lm", [(1, False), (2, False), (5, False),
                                     (2, True)])
def test_decoder_close_eps_false(toy_delta, seed, lm):
    """The single-utterance Decoder with close_eps=False and chunk_frames=7
    against the JAX Decoder: best path words and cost, high-water marks."""
    fst, port_fst = _fsts(seed)
    rng = np.random.RandomState(seed + 11)
    jlm = tlm = None
    if lm:
        jlm, tlm = toy_delta
        fst = with_lm_words(fst, jlm, np.random.RandomState(seed))
        port_fst = with_lm_words(port_fst, tlm, np.random.RandomState(seed))
    logp = dirichlet(rng, 11, 17)
    jcfg, tcfg = _configs(beam=1e9)
    decs = [jdecoder.Decoder(fst, TID2PDF, delta_lm=jlm, config=jcfg,
                             chunk_frames=7, close_eps=False),
            tdecoder.Decoder(port_fst, TID2PDF, delta_lm=tlm, config=tcfg,
                             chunk_frames=7, close_eps=False, device=CPU)]
    for dec in decs:
        dec.process(logp[:10])
        dec.process(logp[10:])
        dec.end_of_stream()
    ref, got = (d.best_path() for d in decs)
    assert (got.words, got.weight) == (ref.words, ref.weight)
    assert decs[1].capacity_high_water == decs[0].capacity_high_water


@pytest.mark.parametrize("close_eps", [True, False])
@pytest.mark.parametrize("device_backtrace", [True, False])
@pytest.mark.parametrize("seed", [0, 2])
def test_decode_batch_matches_jax(seed, close_eps, device_backtrace):
    """decode_batch over every path (seed 0 eps-free or raw; seed 2 the
    dynamic closure), both backtraces; BatchDecoder with an am_scale that
    replaces the config's."""
    fst, port_fst = _fsts(seed)
    rng = np.random.RandomState(seed + 3)
    logp = dirichlet(rng, 11, (3, 19))
    lengths = [19, 12, 5]
    jcfg, tcfg = _configs()
    kw = dict(arc_group=2, close_eps=close_eps, chunk_frames=7,
              device_backtrace=device_backtrace)
    ref = jdecoder.decode_batch(fst, TID2PDF, logp, lengths, config=jcfg,
                                **kw)
    got = tdecoder.decode_batch(port_fst, TID2PDF, logp, lengths,
                                config=tcfg, device=CPU, **kw)
    assert [(h.words, h.weight) for h in got] == [
        (h.words, h.weight) for h in ref]
    assert np.isfinite([h.weight for h in got]).any()
    ref = jdecoder.BatchDecoder(fst, TID2PDF, am_scale=0.25, config=jcfg,
                                arc_group=2, close_eps=close_eps).decode(
        logp, lengths, device_backtrace=device_backtrace)
    dec = tdecoder.BatchDecoder(port_fst, TID2PDF, am_scale=0.25,
                                config=tcfg, arc_group=2, close_eps=close_eps,
                                device=CPU)
    assert dec.cfg.am_scale == 0.25
    got = dec.decode(logp, lengths, device_backtrace=device_backtrace)
    assert [(h.words, h.weight) for h in got] == [
        (h.words, h.weight) for h in ref]


def test_batch_decoder_adopts_dfst(trie):
    """BatchDecoder(dfst=...) on the closed trie: the prebuilt tables are
    used as they are (no transform), as in JAX."""
    tg, logp = trie
    port_tg = tbiggraph.make_trie_graph(np.random.RandomState(1),
                                        num_words=120, num_phones=25,
                                        bigram_states=30, variants=2)
    closed = close_epsilons(tg.fst)[0]
    port_closed = ttransform.close_epsilons(port_tg.fst)[0]
    jd = JaxDeviceFst.build(closed, tg.tid2pdf, group=2, eps_depth_cap=1,
                            csr_group=16)
    td = tdevice.DeviceFst.build(port_closed, tg.tid2pdf, group=2,
                                 eps_depth_cap=1, csr_group=16, device=CPU)
    jcfg, tcfg = _configs(expand_size=2048, eps_expand_size=1024,
                          max_eps_iters=3, beam=12.0)
    ref = jdecoder.BatchDecoder(closed, tg.tid2pdf, config=jcfg,
                                chunk_frames=9, dfst=jd).decode(
        logp, [30, 23])
    dec = tdecoder.BatchDecoder(port_closed, tg.tid2pdf, config=tcfg,
                                chunk_frames=9, dfst=td)
    assert dec.dfst is td
    got = dec.decode(logp, [30, 23])
    assert [(h.words, h.weight) for h in got] == [
        (h.words, h.weight) for h in ref]
    assert any(h.words for h in got)


def _overflow_graph(seed=5, num_words=40):
    """TestOverflowSafety's phone loop (40 words) and 30 frames, for each
    package."""
    rng = np.random.RandomState(seed)
    g = make_phone_loop_graph(rng, num_words=num_words, num_pdfs=32)
    logp = np.log(rng.dirichlet(np.ones(32), size=30)).astype(np.float32)
    port_g = ttoy.make_phone_loop_graph(np.random.RandomState(seed),
                                        num_words=num_words, num_pdfs=32)
    return (FlatFst.from_raw(g.fst), tfst.FlatFst.from_raw(port_g.fst),
            g.tid2pdf, logp)


def _both_decoders(fst, port_fst, tid2pdf, logp, **kw):
    """A JAX and a port Decoder (close_eps=False) over logp, finished."""
    jcfg, tcfg = _configs(**kw)
    decs = [jdecoder.Decoder(fst, tid2pdf, config=jcfg, arc_group=1,
                             close_eps=False),
            tdecoder.Decoder(port_fst, tid2pdf, config=tcfg, arc_group=1,
                             close_eps=False, device=CPU)]
    for dec in decs:
        dec.process(logp)
        dec.end_of_stream()
    return decs


def test_too_small_eps_expand_reports():
    """An undersized epsilon capacity is flagged by the closure pass and
    raised from best_path, with JAX's high-water marks."""
    fst, port_fst, tid2pdf, logp = _overflow_graph()
    jdec, tdec = _both_decoders(fst, port_fst, tid2pdf, logp,
                                beam_size=256, expand_size=4096,
                                eps_expand_size=2, beam=1e9)
    assert jdec.overflowed and tdec.overflowed
    assert tdec.capacity_high_water == jdec.capacity_high_water
    with pytest.raises(BeamCapacityError):
        jdec.best_path()
    with pytest.raises(terrors.BeamCapacityError):
        tdec.best_path()


def test_capacity_high_water():
    """The high-water marks of a generous decode size a tight one (no
    overflow, same words); an eps capacity below the mark overflows."""
    fst, port_fst, tid2pdf, logp = _overflow_graph()
    geometry = dict(beam_size=64, beam=1e9)
    jdec, tdec = _both_decoders(fst, port_fst, tid2pdf, logp,
                                expand_size=4096, eps_expand_size=4096,
                                **geometry)
    assert not tdec.overflowed
    hw = tdec.capacity_high_water
    assert hw == jdec.capacity_high_water
    assert 0 < hw[0] <= 4096 and 0 < hw[1] <= 4096
    words = tdec.best_path().words
    assert words == jdec.best_path().words
    tight = _both_decoders(fst, port_fst, tid2pdf, logp, expand_size=hw[0],
                           eps_expand_size=hw[1], **geometry)
    assert not any(d.overflowed for d in tight)
    assert tight[1].best_path().words == words
    small = _both_decoders(fst, port_fst, tid2pdf, logp, expand_size=hw[0],
                           eps_expand_size=max(hw[1] // 2, 1), **geometry)
    assert all(d.overflowed for d in small)
    assert small[1].capacity_high_water == small[0].capacity_high_water


def test_eps_overflow_regrows_and_retries():
    """BatchDecoder with close_eps=False and a 2-slot epsilon capacity:
    both packages regrow eps_expand_size from the high-water mark (x
    retry_margin) and give the same words and costs; without the retry
    both raise with the same marks."""
    fst, port_fst, tid2pdf, logp = _overflow_graph()
    lp = np.stack([logp, logp[::-1]])
    jcfg, tcfg = _configs(beam_size=256, expand_size=4096,
                          eps_expand_size=2, beam=1e9)
    kw = dict(arc_group=1, close_eps=False)
    jdec = jdecoder.BatchDecoder(fst, tid2pdf, config=jcfg, **kw)
    tdec = tdecoder.BatchDecoder(port_fst, tid2pdf, config=tcfg, device=CPU,
                                 **kw)
    ref = jdec.decode(lp, [30, 21], retry_margin=2.0)
    got = tdec.decode(lp, [30, 21], retry_margin=2.0)
    assert [(h.words, h.weight) for h in got] == [
        (h.words, h.weight) for h in ref]
    with pytest.raises(BeamCapacityError) as jerr:
        jdec.decode(lp, [30, 21], retry_on_overflow=False)
    with pytest.raises(terrors.BeamCapacityError) as terr:
        tdec.decode(lp, [30, 21], retry_on_overflow=False)
    assert terr.value.hiwater == jerr.value.hiwater
    assert terr.value.hiwater[1] > 2
    regrown = tdecoder._regrow_config(tcfg, terr.value.hiwater, 2.0)
    assert regrown.eps_expand_size == jdecoder._regrow_config(
        jcfg, jerr.value.hiwater, 2.0).eps_expand_size


@pytest.mark.parametrize("iters", [6, 1])
def test_streaming_on_a_raw_graph(tmp_path, data_dir, iters):
    """The streaming toy model on a raw graph (a static closure at
    max_eps_iters 6, the arena at 1): the fused and the componentized
    Utterance and both streams of a BatchStreamingSession fed in 20-frame
    ticks give the JAX Utterance's transcript."""
    conf = write_raw_conf(write_stream_toy(str(tmp_path), data_dir), "raw")
    geometry = dict(STREAM_BEAM, max_eps_iters=iters)
    jr = jrec.Recognizer(conf, beam_config=jbeam.BeamConfig(**geometry))
    tr = trec.Recognizer(conf, beam_config=tbeam.BeamConfig(**geometry),
                         device=CPU)
    cfg, dfst, _ = tr._decode_graph()
    assert _path(cfg, dfst) == ("static" if iters == 6 else "dynamic")
    fmt, payload = wav_payload(os.path.join(data_dir, "en-us-hello.wav"))
    hyps = []
    for mod, rec, fused in ((jrec, jr, True), (trec, tr, True),
                            (trec, tr, False)):
        utt = mod.Utterance(rec, fmt, fused=fused)
        utt.process(payload)
        utt.end_of_stream()
        hyps.append(utt.hyp)
    assert hyps[0] and hyps[1:] == hyps[:1] * 2
    samples = np.frombuffer(payload, dtype="<i2").astype(np.float32)
    batch = tr.create_stream_batch(2)
    for off in range(0, samples.size, 3200):
        batch.process_batch([samples[off:off + 3200], samples[off // 2:
                                                              off // 2
                                                              + 1600]])
    batch.process(1, samples[samples.size // 2:])
    for u in range(2):
        batch.end_of_stream(u)
    assert [" ".join(tr.symbol_table.get(w) for w in
                     batch.best_path(u, end_of_stream=True).words)
            for u in range(2)] == hyps[:1] * 2
