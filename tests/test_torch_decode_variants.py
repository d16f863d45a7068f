"""The exact decode variants of the port vs the JAX package, on the CPU.

- the state renumberings (`bfs_order`, `frequency_order`, `hot_order`,
  `renumber_states`): the same permutations and graph arrays;
- `DeviceFst.build` with `hot_rows`, `compact` and `eps_group`: the same
  tables (`emit_hot` included) and static fields;
- `BeamConfig.select_compact` and the hot/cold emit split
  (`cold_expand_size` on a `hot_rows` graph): every chunk's beam (states,
  LM states, costs bit for bit, backpointers, overflow, all five hiwater
  slots) and trace equal JAX's, on tables each package built itself, and
  so do the `Decoder` and `BatchDecoder` results, overflow and the
  regrow-and-retry included;
- a `Recognizer` whose config sets `select_compact`.
The setups are the JAX tests' own (tests/test_decoder.py TestSelectCompact
and TestHotColdSplit, tests/test_graph.py TestRenumber).  No tolerance: the
integers are equal and the costs are equal as float32 bits.
"""

import dataclasses
import os

import numpy as np
import pytest

from _torch_parity import (CPU, DFST_META, assert_same, dlm_from_jax,
                           random_fst, run_chunks, wav_payload)
from catears_tpu.decode import beam as jbeam
from catears_tpu.decode import decoder as jdecoder
from catears_tpu.graph import device as jdevice
from catears_tpu.graph import transform as jtransform
from catears_tpu.graph.device import DeviceLm as JaxDeviceLm
from catears_tpu.graph.fst import FlatFst
from catears_tpu.tools.biggraph import make_big_lm, make_trie_graph, plant_logp
from catears_tpu.tools.toy import make_phone_loop_graph
from catears_tpu.utils.errors import BeamCapacityError
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.decode import decoder as tdecoder
from catears_tpu_torch.graph import device as tdevice
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.graph import transform as ttransform
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.utils import errors as terrors

FST_FIELDS = ("start", "final", "offsets", "arc_next", "arc_ilabel",
              "arc_olabel", "arc_weight")


def _assert_fst_equal(jf, tf):
    for name in FST_FIELDS:
        assert_same(np.asarray(getattr(jf, name)),
                    np.asarray(getattr(tf, name)), name)


def _trie(seed, **kw):
    """(JAX TrieGraph, the port's, the JAX one's RandomState after the
    build) from one seed: equal graphs."""
    rng = np.random.RandomState(seed)
    jg = make_trie_graph(rng, **kw)
    tg = tbiggraph.make_trie_graph(np.random.RandomState(seed), **kw)
    _assert_fst_equal(jg.fst, tg.fst)
    return jg, tg, rng


def _port_fst(fst):
    return tfst.FlatFst.from_arrays(
        fst.start, fst.final, np.repeat(np.arange(fst.num_states),
                                        np.diff(fst.offsets)),
        fst.arc_next, fst.arc_ilabel, fst.arc_olabel, fst.arc_weight)


def _configs(**kw):
    return jbeam.BeamConfig(**kw), tbeam.BeamConfig(**kw)


# -- graph/transform.py: the renumberings ----------------------------------

def _order_graph(kind):
    """(JAX FlatFst, the port's) of a kind of graph."""
    if kind == "trie":
        jg, tg, _ = _trie(3, num_words=120, num_phones=20,
                          bigram_states=25, variants=2)
        return jg.fst, tg.fst
    if kind == "loop":
        g = make_phone_loop_graph(np.random.RandomState(0), num_words=5,
                                  num_pdfs=24)
        fst = FlatFst.from_raw(g.fst)
    else:  # random arcs: some states unreachable from the start
        fst = random_fst(np.random.RandomState(7), num_states=40,
                         flat=FlatFst)
    return fst, _port_fst(fst)


ORDERS = {
    "bfs": lambda m, f, c: m.bfs_order(f),
    "freq": lambda m, f, c: m.frequency_order(c),
    "freq-bfs-ties": lambda m, f, c: m.frequency_order(
        c // 20, tie_break=m.bfs_order(f)),
    "hot-half": lambda m, f, c: m.hot_order(c, f.num_states // 2),
    "hot-50-seed3": lambda m, f, c: m.hot_order(c, 50, seed=3),
    "hot-all": lambda m, f, c: m.hot_order(c, f.num_states + 10),
    "hot-none": lambda m, f, c: m.hot_order(c, 0),
}


@pytest.mark.parametrize("kind", ["trie", "loop", "random"])
@pytest.mark.parametrize("order", list(ORDERS))
def test_renumbering_equals_jax(kind, order):
    """The permutation element for element, and renumber_states' graph."""
    jf, tf = _order_graph(kind)
    counts = np.random.RandomState(5).randint(0, 100, size=jf.num_states)
    want = ORDERS[order](jtransform, jf, counts)
    got = ORDERS[order](ttransform, tf, counts)
    assert_same(want, got, "perm")
    assert np.array_equal(np.sort(got), np.arange(tf.num_states))
    _assert_fst_equal(jtransform.renumber_states(jf, want),
                      ttransform.renumber_states(tf, got))


def test_bfs_order_starts_at_start():
    _, tf = _order_graph("loop")
    assert ttransform.bfs_order(tf)[tf.start] == 0


# -- graph/device.py: DeviceFst.build(eps_group, hot_rows, compact) --------

BUILDS = {
    "default": {},
    "compact-off": {"compact": False},
    "compact-on": {"compact": True},
    "hot-300": {"hot_rows": 300},
    "hot-all": {"hot_rows": 10 ** 9},
    "hot-compact-on": {"hot_rows": 300, "compact": True},
    "eps-group-8": {"eps_group": 8, "csr_group": 16},
    "raw-hot-eps-group": {"eps_group": 4, "hot_rows": 100, "raw": True},
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_device_build_equals_jax(case):
    """Tables (emit_hot included) and static fields equal JAX's; the compact
    row only where JAX's guard allows it; from_numpy of the tables without
    emit_hot (a JAX build's fields) gives the same graph."""
    jg, tg, _ = _trie(5, num_words=150, num_phones=25, bigram_states=30,
                      variants=2)
    kw = dict(BUILDS[case])
    if kw.pop("raw", False):
        jf, tf, cap, jo, to = jg.fst, tg.fst, None, None, None
    else:
        jf, jo, mode = jtransform.prepare_decode_graph(jg.fst)
        tf, to, _ = ttransform.prepare_decode_graph(tg.fst)
        assert mode == "eps_free"
        cap = 1
    jd = jdevice.DeviceFst.build(jf, jg.tid2pdf, group=2, eps_depth_cap=cap,
                                 olabel2=jo, **kw)
    td = tdevice.DeviceFst.build(tf, tg.tid2pdf, group=2, eps_depth_cap=cap,
                                 olabel2=to, device=CPU, **kw)
    for name in tdevice.TABLES:
        assert_same(getattr(jd, name), getattr(td, name), name)
    assert int(jd.start) == td.start
    for name in DFST_META:
        assert getattr(jd, name) == getattr(td, name), name
    arrays = {name: getattr(td, name).numpy() for name in tdevice.TABLES
              if getattr(td, name) is not None}
    loaded = tdevice.DeviceFst.from_numpy(
        dict(arrays, start=td.start),
        {name: getattr(td, name) for name in DFST_META}, device=CPU)
    for name in tdevice.TABLES:
        assert_same(getattr(td, name), getattr(loaded, name), name)
    hot = min(kw.get("hot_rows", 0), tf.num_states)
    assert td.hot_rows == hot and (td.emit_hot is None) == (hot == 0)
    assert td.emit_compact == (to is not None and not hot
                               and kw.get("compact") is not False)
    if hot:
        assert_same(td.emit_block[:hot], td.emit_hot, "emit_hot copy")


@pytest.mark.parametrize("distinct", [True, False])
def test_expansion_bounds_eps_group_equals_jax(distinct):
    jg, tg, _ = _trie(5, num_words=150, num_phones=25, bigram_states=30,
                      variants=2)
    for group, csr, eps in ((2, None, 8), (2, 16, 4), (4, 8, None)):
        want = jdevice.expansion_bounds(jg.fst, group, 64, distinct, csr,
                                        eps)
        got = tdevice.expansion_bounds(tg.fst, group, 64, distinct, csr,
                                       eps)
        assert got == want


# -- decode/beam.py: select_compact -----------------------------------------

# Planted frames that end in a final state (the words [2, 1, 1] and
# [7, 120]); at 120 frames the first utterance ends mid-word.
COMPACT_LENGTHS = [100, 120]


def _compact_setup():
    """TestSelectCompact's trie, and two planted utterances of 120 frames
    (its test plants one)."""
    jg, tg, rng = _trie(3, num_words=120, num_phones=25, bigram_states=30,
                        variants=2)
    logp, _ = plant_logp(rng, jg, 2, 120)
    return jg, tg, logp


def _compact_cfg(beam=12.0, **kw):
    return dict(beam_size=256, expand_size=2048, eps_expand_size=1024,
                max_eps_iters=4, beam=beam, am_scale=0.1, **kw)


def _decode_graph(g, mode, port=True, group=2, hot_rows=0):
    """(decode graph, DeviceFst) of the TrieGraph g in `mode` (eps_free;
    closed: close_epsilons at depth 1; raw), built by the port or, with
    port=False, by the JAX package."""
    transform, device = ((ttransform, tdevice) if port
                         else (jtransform, jdevice))
    if mode == "eps_free":
        g2, olab2, m = transform.prepare_decode_graph(g.fst)
        assert m == "eps_free"
        cap = 1
    elif mode == "closed":
        (g2, ok), olab2, cap = transform.close_epsilons(g.fst), None, 1
        assert ok
    else:
        g2, olab2, cap = g.fst, None, None
    return g2, device.DeviceFst.build(
        g2, g.tid2pdf, group=group, eps_depth_cap=cap, olabel2=olab2,
        hot_rows=hot_rows, **({"device": CPU} if port else {}))


def _tables(jg, tg, mode, group, hot_rows=0):
    """(JAX DeviceFst, the port's), each built by its own package."""
    return (_decode_graph(jg, mode, False, group, hot_rows)[1],
            _decode_graph(tg, mode, True, group, hot_rows)[1])


def _demand(jg, logp):
    """hiwater[3] of a JAX decode at select_compact 1024."""
    dec = jdecoder.Decoder(jg.fst, jg.tid2pdf,
                           config=jbeam.BeamConfig(
                               **_compact_cfg(select_compact=1024)),
                           chunk_frames=7)
    dec.process(logp)
    dec.end_of_stream()
    need = dec.capacity_high_water[3]
    assert 0 < need <= 1024 and not dec.overflowed
    return need


@pytest.mark.parametrize("mode,group,sc", [
    ("eps_free", 4, "K"), ("eps_free", 4, 1024), ("eps_free", 4, "hiwater"),
    ("eps_free", 2, 512), ("closed", 2, "K"), ("raw", 2, 1024)],
    ids=["eps-free-K", "eps-free-1024", "eps-free-hiwater",
         "compact-row-512", "closed-K", "raw-1024"])
def test_select_compact_chunks_equal_jax(mode, group, sc):
    """Every chunk's beam and trace, with the compacted selection in the
    eps-free step or in the emitting step before the closure rounds."""
    jg, tg, logp = _compact_setup()
    sc = {"K": 256, "hiwater": _demand(jg, logp[0])}.get(sc, sc)
    jd, td = _tables(jg, tg, mode, group)
    jcfg, tcfg = _configs(**_compact_cfg(select_compact=sc))
    final = run_chunks(jd, td, jcfg, tcfg, logp, [120, 97], chunk=7)
    assert np.asarray(final.hiwater)[:, 3].max() > 0


@pytest.mark.parametrize("sc", [256, 2048])
def test_select_compact_with_lm_equals_jax(sc):
    """The 3-key dedup sort of the compacted selection (LM on)."""
    jg, tg, logp = _compact_setup()
    big = make_big_lm(np.random.RandomState(3), num_words=120)
    delta = big.delta_lm()
    jl = JaxDeviceLm.build(delta)
    jd, td = _tables(jg, tg, "eps_free", 2)
    jcfg, tcfg = _configs(**_compact_cfg(select_compact=sc,
                                         lm_expand_size=64))
    run_chunks(jd, td, jcfg, tcfg, logp[:, :60], [60, 41], jl=jl,
               tl=dlm_from_jax(jl), chunk=7)


def _decoder(g, logp, port=True, **kw):
    """A single-utterance Decoder of the port (or JAX's) over one row."""
    if port:
        dec = tdecoder.Decoder(g.fst, g.tid2pdf, chunk_frames=7, device=CPU,
                               config=tbeam.BeamConfig(**_compact_cfg(**kw)))
    else:
        dec = jdecoder.Decoder(g.fst, g.tid2pdf, chunk_frames=7,
                               config=jbeam.BeamConfig(**_compact_cfg(**kw)))
    dec.process(logp)
    dec.end_of_stream()
    return dec


@pytest.mark.parametrize("sc", ["K", 1024, "hiwater"])
def test_select_compact_decoder_equals_jax(sc):
    """Decoder (the single-utterance API): final beam, every frame trace,
    hiwater, overflow and best path (the words also the classic decode's;
    at K lanes the survivors overflow, loudly, in both)."""
    jg, tg, logp = _compact_setup()
    sc = {"K": 256, "hiwater": _demand(jg, logp[0])}.get(sc, sc)
    row = logp[0, :COMPACT_LENGTHS[0]]
    jdec = _decoder(jg, row, port=False, select_compact=sc)
    tdec = _decoder(tg, row, select_compact=sc)
    for name, x, y in zip(jdec.beam._fields, jdec.beam, tdec.beam):
        assert_same(x, y, f"beam {name}")
    assert len(jdec.traces) == len(tdec.traces)
    for f, (a, b) in enumerate(zip(jdec.traces, tdec.traces)):
        assert_same(a.prev_slot, b.prev_slot, f"frame {f} prev_slot")
        assert_same(a.words, b.words, f"frame {f} words")
    assert tdec.capacity_high_water == jdec.capacity_high_water
    assert tdec.overflowed == jdec.overflowed
    if tdec.overflowed:  # K lanes hold fewer than the survivors
        assert tdec.capacity_high_water[3] > 256
        with pytest.raises(terrors.BeamCapacityError):
            tdec.best_path()
        return
    want, got = jdec.best_path(), tdec.best_path()
    assert got.words == want.words
    assert np.float32(got.weight).tobytes() == np.float32(
        want.weight).tobytes()
    assert _decoder(tg, row).best_path().words == got.words
    assert got.words


@pytest.mark.parametrize("sc", ["K", 1024])
def test_select_compact_batch_decoder_equals_jax(sc):
    """BatchDecoder: hypotheses equal JAX's, with and without the retry;
    without it both raise with the same hiwater or both decode."""
    jg, tg, logp = _compact_setup()
    sc = {"K": 256}.get(sc, sc)
    jcfg, tcfg = _configs(**_compact_cfg(select_compact=sc))
    jdec = jdecoder.BatchDecoder(jg.fst, jg.tid2pdf, config=jcfg)
    tdec = tdecoder.BatchDecoder(tg.fst, tg.tid2pdf, config=tcfg,
                                 device=CPU)
    for retry in (False, True):
        try:
            want = jdec.decode(logp, COMPACT_LENGTHS,
                               retry_on_overflow=retry)
        except BeamCapacityError as err:
            with pytest.raises(terrors.BeamCapacityError) as got:
                tdec.decode(logp, COMPACT_LENGTHS, retry_on_overflow=retry)
            assert got.value.hiwater == err.hiwater
            continue
        got = tdec.decode(logp, COMPACT_LENGTHS, retry_on_overflow=retry)
        assert [h.words for h in got] == [h.words for h in want]
        assert [np.float64(h.weight) for h in got] == [
            np.float64(h.weight) for h in want]
        assert all(h.words for h in got)


def test_select_compact_overflow_is_loud():
    """select_compact=1 at beam 1e9: the K-wide compaction truncates in both
    packages, with the same hiwater; best_path raises."""
    jg, tg, logp = _compact_setup()
    jdec = _decoder(jg, logp[0], port=False, beam=1e9, select_compact=1)
    tdec = _decoder(tg, logp[0], beam=1e9, select_compact=1)
    assert jdec.overflowed and tdec.overflowed
    assert tdec.capacity_high_water == jdec.capacity_high_water
    assert tdec.capacity_high_water[3] > 256
    with pytest.raises(terrors.BeamCapacityError) as err:
        tdec.best_path()
    assert err.value.hiwater == jdec.capacity_high_water


# -- decode/beam.py: the hot/cold emit split --------------------------------

def _hot_setup(hot):
    """TestHotColdSplit's trie and planted batch, renumbered by hot_order of
    seeded random counts with `hot` hot states (-1: half the states)."""
    jg, tg, rng = _trie(21, num_words=200, num_phones=25, bigram_states=40,
                        variants=2)
    logp, _ = plant_logp(rng, jg, 2, 100)
    counts = rng.randint(0, 100, size=jg.fst.num_states)
    h = jg.fst.num_states // 2 if hot < 0 else hot
    jg2 = dataclasses.replace(jg, fst=jtransform.renumber_states(
        jg.fst, jtransform.hot_order(counts, h)))
    tg2 = dataclasses.replace(tg, fst=ttransform.renumber_states(
        tg.fst, ttransform.hot_order(counts, h)))
    return (jg, tg), (jg2, tg2), h, logp


def _hot_cfg(cold, beam=256):
    return dict(beam_size=beam, expand_size=4096, eps_expand_size=2048,
                max_eps_iters=3, cold_expand_size=cold)


def _batch_decoder(g, cold, port=True, hot_rows=0):
    """A BatchDecoder of the port (or JAX's) on g's eps-free tables with
    `hot_rows` hot states and `cold` cold lanes."""
    g2, dfst = _decode_graph(g, "eps_free", port, hot_rows=hot_rows)
    if port:
        return tdecoder.BatchDecoder(g2, g.tid2pdf, dfst=dfst,
                                     config=tbeam.BeamConfig(**_hot_cfg(cold)))
    return jdecoder.BatchDecoder(g2, g.tid2pdf, dfst=dfst,
                                 config=jbeam.BeamConfig(**_hot_cfg(cold)))


@pytest.mark.parametrize("mode,hot,cold", [
    ("eps_free", -1, 256), ("eps_free", -1, 64), ("eps_free", 50, 1024),
    ("closed", -1, 128)],
    ids=["half-cold-256", "half-cold-64", "hot-50-cold-1024",
         "closed-cold-128"])
def test_hot_cold_chunks_equal_jax(mode, hot, cold):
    """Every chunk's beam (hiwater slot 4 included) and trace."""
    _, (jg2, tg2), h, logp = _hot_setup(hot)
    jd, td = _tables(jg2, tg2, mode, 2, hot_rows=h)
    assert td.hot_rows == h and not td.emit_compact
    jcfg, tcfg = _configs(**_hot_cfg(cold))
    final = run_chunks(jd, td, jcfg, tcfg, logp, [100, 83], chunk=10)
    assert np.asarray(final.hiwater)[:, 4].max() > 0


def test_hot_cold_decode_equals_plain_and_jax():
    """The split decodes the plain graph's words (JAX's test) and the port
    equals JAX's hypotheses bit for bit."""
    (_, tg), (jg2, tg2), h, logp = _hot_setup(-1)
    plain = _batch_decoder(tg, 0).decode(logp)
    want = _batch_decoder(jg2, 256, False, h).decode(
        logp, retry_on_overflow=False)
    got = _batch_decoder(tg2, 256, True, h).decode(
        logp, retry_on_overflow=False)
    assert [x.words for x in got] == [x.words for x in want]
    assert [np.float64(x.weight) for x in got] == [
        np.float64(x.weight) for x in want]
    assert [x.words for x in got] == [x.words for x in plain]
    assert all(abs(a.weight - b.weight) < 1e-3 for a, b in zip(got, plain))
    assert any(x.words for x in got)


def test_cold_overflow_is_loud_and_retries():
    """A cold cap of 8 on a 50-state hot set: both raise with the same
    hiwater (slot 4 > 8); the regrow-and-retry returns JAX's words, the
    plain graph's."""
    (_, tg), (jg2, tg2), h, logp = _hot_setup(50)
    jdec = _batch_decoder(jg2, 8, False, h)
    tdec = _batch_decoder(tg2, 8, True, h)
    with pytest.raises(BeamCapacityError) as want:
        jdec.decode(logp, retry_on_overflow=False)
    with pytest.raises(terrors.BeamCapacityError) as got:
        tdec.decode(logp, retry_on_overflow=False)
    assert got.value.hiwater == want.value.hiwater
    assert got.value.hiwater[4] > 8
    retried = [x.words for x in tdec.decode(logp)]
    assert retried == [x.words for x in jdec.decode(logp)]
    assert retried == [x.words for x in _batch_decoder(tg, 0).decode(logp)]


@pytest.mark.parametrize("base,hiwater", [
    ({"cold_expand_size": 8, "select_compact": 256},
     (100, 0, 0, 300, 900)),
    ({"cold_expand_size": 0, "select_compact": 1, "lm_expand_size": 64},
     (5000, 70, 200, 2, 0)),
    ({"cold_expand_size": 1024, "expand_size": 1 << 16},
     (10, 3000, 0, 40, 10)),
])
def test_regrow_config_equals_jax(base, hiwater):
    jcfg, tcfg = _configs(**base)
    want = jdecoder._regrow_config(jcfg, hiwater, 1.5)
    got = tdecoder._regrow_config(tcfg, hiwater, 1.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.select_compact == 0


# -- runtime/recognizer.py: the config key ----------------------------------

def test_recognizer_reads_select_compact(tmp_path, data_dir):
    """A config with select_compact: the port's Recognizer reads it as JAX's
    does and decodes tests/data's wavs to JAX's transcripts, through an
    Utterance and through create_stream_batch (whose partials equal its
    best paths)."""
    from catears_tpu.runtime.recognizer import Recognizer as JaxRecognizer
    from catears_tpu.runtime.recognizer import \
        decode_wav_file as jax_decode_wav
    from catears_tpu.tools.toy import write_toy_model
    from catears_tpu_torch.runtime.recognizer import (Recognizer,
                                                      decode_wav_file)

    conf = write_toy_model(str(tmp_path), rng=np.random.RandomState(5),
                           num_words=20, hidden=64, num_pdfs=96)
    with open(conf, "a") as fd:
        fd.write("beam_size = 256\nexpand_size = 2048\n"
                 "eps_expand_size = 1024\nselect_compact = 256\n")
    jrec = JaxRecognizer(conf)
    trec = Recognizer(conf, device=CPU)
    assert dataclasses.asdict(trec.beam_config) == dataclasses.asdict(
        jrec.beam_config)
    assert trec.beam_config.select_compact == 256
    want = []
    for word in ("hello", "cat"):
        wav = os.path.join(data_dir, f"en-us-{word}.wav")
        want.append(jax_decode_wav(jrec, wav))
        assert decode_wav_file(trec, wav) == want[-1]
    pcm = [np.frombuffer(wav_payload(os.path.join(
        data_dir, f"en-us-{word}.wav"))[1], "<i2").astype(np.float32)
        for word in ("hello", "cat")]
    batch = trec.create_stream_batch(2)
    for off in range(0, max(map(len, pcm)), 3200):
        batch.process_batch([x[off:off + 3200] for x in pcm])
        assert [h.words for h in batch.partials()] == [
            batch.best_path(u, end_of_stream=False).words for u in range(2)]
    for u in range(2):
        batch.end_of_stream(u)
    assert [" ".join(trec.symbol_table.get(w) for w in
                     batch.best_path(u, end_of_stream=True).words)
            for u in range(2)] == want and all(want)
