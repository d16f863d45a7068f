"""The PyTorch port's streaming building blocks vs the JAX package, on the CPU.

Front end and AM: FbankStream over odd chunkings, OnlineCMVN / CMVNStream,
the device CMVN ring, the bucketed whole-utterance AM and AMStream (float
and int8, with a tail whose bucket pad is non-trivial).  Decoder: the
single-utterance Decoder fed the same log-probs in ragged process() calls,
LM off and with a delta-LM; its overflow, autosize and the incremental
backtracker.  Sessions: BatchStreamingSession under ragged pacing and group
ticks, StreamingSession as its one-stream view (and its state round
trip), and a trie model streamed with a delta-LM.

Tolerances: decoder state from identical log-probs bit-equal; features 1e-4
(against JAX and the Kaldi goldens); float log-probs 1e-4
(tests/test_torch_am.py); int8 log-probs below 1% of the output range;
transcripts equal strings.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, STREAM_BEAM, assert_same, range_error,
                           wav_payload, write_stream_toy)
from catears_tpu.am import model as jmodel
from catears_tpu.decode import beam as jbeam
from catears_tpu.decode import decoder as jdecoder
from catears_tpu.decode import hyp as jhyp
from catears_tpu.frontend import cmvn as jcmvn
from catears_tpu.frontend import fbank as jfbank
from catears_tpu.graph.fst import FlatFst
from catears_tpu.io.config import Configuration
from catears_tpu.runtime import recognizer as jrec
from catears_tpu.runtime import streaming as jstreaming
from catears_tpu.tools.biggraph import make_big_lm, make_trie_graph, plant_logp
from catears_tpu.tools.toy import make_phone_loop_graph
from catears_tpu.utils.errors import BeamCapacityError
from catears_tpu_torch.am import model as tmodel
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.decode import decoder as tdecoder
from catears_tpu_torch.decode import hyp as thyp
from catears_tpu_torch.frontend import cmvn as tcmvn
from catears_tpu_torch.frontend import fbank as tfbank
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.io.config import Configuration as TConfiguration
from catears_tpu_torch.io.wav import read_16k_pcm
from catears_tpu_torch.runtime import recognizer as trec
from catears_tpu_torch.runtime import streaming as tstreaming
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.tools import toy as ttoy
from catears_tpu_torch.utils import errors as terrors

ATOL = 1e-4


def _golden(data_dir, name):
    return np.loadtxt(os.path.join(data_dir, name)).reshape(-1, 40)


@pytest.fixture(scope="module")
def hello(data_dir):
    return read_16k_pcm(os.path.join(data_dir, "en-us-hello.wav"))


# -- front end -----------------------------------------------------------------


@pytest.mark.parametrize("step", [517, 160, 4000, 399])
def test_fbank_stream_matches_jax(hello, data_dir, step):
    """Odd chunkings: every call's features equal JAX's to 1e-4, and the
    whole stream the Kaldi golden."""
    js, ts = jfbank.FbankStream(), tfbank.FbankStream(tfbank.Fbank(CPU))
    parts = []
    for off in range(0, hello.size, step):
        ref = js.process(hello[off:off + step])
        got = ts.process(hello[off:off + step])
        assert got.dtype == np.float32 and got.shape == ref.shape
        if got.size:
            assert np.abs(got - ref).max() < ATOL
        parts.append(got)
    golden = _golden(data_dir, "fbankmat_en-us-hello.wav.txt")
    assert np.abs(np.concatenate(parts) - golden).max() < ATOL
    assert ts.process(np.zeros(0, np.float32)).shape == (0, 40)


def test_cmvn_matches_jax_and_the_kaldi_golden(hello, data_dir):
    """OnlineCMVN and CMVNStream equal JAX's bit for bit (the same float64
    numpy code); fbank + CMVN matches Kaldi's apply-cmvn-online dump."""
    from catears_tpu_torch.io.binfmt import read_vec0_file

    stats = read_vec0_file(os.path.join(data_dir, "cmvn_stats.bin"))
    feats = tfbank.Fbank(CPU).compute(hello)
    got = tcmvn.OnlineCMVN(stats).apply(feats)
    assert_same(jcmvn.OnlineCMVN(stats).apply(feats), got, "OnlineCMVN")
    golden = _golden(data_dir, "fbankcmvnmat_en-us-hello.wav.txt")
    assert got.shape == golden.shape and np.abs(got - golden).max() < ATOL
    rng = np.random.RandomState(0)
    x = rng.randn(700, 40).astype(np.float32) * 3 + 10
    st = np.concatenate([rng.rand(40) * 1e6, [1e5]]).astype(np.float32)
    js, ts = jcmvn.CMVNStream(st), tcmvn.CMVNStream(st)
    for i in range(0, 700, 17):
        assert_same(js.process(x[i:i + 17]), ts.process(x[i:i + 17]),
                    f"CMVNStream at {i}")
    assert ts.process(x[:0]).shape == (0, 40)


def test_device_cmvn_ring_matches_jax(hello, data_dir):
    """The float32 ring over 20-frame chunks of 2 streams (one idle for the
    first chunks) equals JAX's ring chunk by chunk to 1e-4, and the host
    float64 OnlineCMVN to 1e-3 (the JAX test's bar for its ring)."""
    from catears_tpu_torch.io.binfmt import read_vec0_file

    stats = read_vec0_file(os.path.join(data_dir, "cmvn_stats.bin"))
    feats = tfbank.Fbank(CPU).compute(hello)
    gsum, gcount, rings, counts = tstreaming._cmvn_state(stats, 2, CPU)
    jg = jnp.asarray(np.asarray(stats[:40], np.float64), jnp.float32)
    jc = jnp.float32(np.float64(stats[40]))
    jring, jcount = jnp.zeros((600, 40), jnp.float32), jnp.int32(0)
    outs = []
    for off in range(0, feats.shape[0], 20):
        chunk = feats[off:off + 20]
        ref, jring, jcount = jstreaming._device_cmvn_chunk(
            jg, jc, jring, jcount, jnp.asarray(chunk))
        both = torch.from_numpy(np.stack([chunk, chunk[::-1].copy()]))
        out, rings, counts = tstreaming._device_cmvn_chunk(
            gsum, gcount, rings, counts, both)
        assert np.abs(out[0].numpy() - np.asarray(ref)).max() < ATOL
        outs.append(out[0].numpy())
    assert counts.tolist() == [feats.shape[0]] * 2
    host = tcmvn.OnlineCMVN(stats).apply(feats)
    assert np.abs(np.concatenate(outs) - host).max() < 1e-3


# -- acoustic model ------------------------------------------------------------


@pytest.fixture(scope="module")
def toy_ams(tmp_path_factory, data_dir):
    """{quantized: (JAX AM, port AM)} of the streaming toy model."""
    out = {}
    for quantized in (False, True):
        d = str(tmp_path_factory.mktemp(f"am_stream_{int(quantized)}"))
        conf = write_stream_toy(d, data_dir, quantized=quantized)
        out[quantized] = (
            jmodel.AcousticModel.read(Configuration.read(conf)),
            tmodel.AcousticModel.read(TConfiguration.read(conf), device=CPU))
    return out


def _close(ref, got, quantized):
    assert got.dtype == np.float32 and got.shape == ref.shape
    if not got.size:
        return
    if quantized:
        assert range_error(ref, got) < 0.01
    else:
        assert np.abs(ref - got).max() < ATOL


@pytest.mark.parametrize("quantized", [False, True])
def test_am_forward_bucketed_matches_jax(toy_ams, hello, quantized):
    """The whole-utterance host path pads to JAX's bucketed row counts: 37
    and 153 frames (pads of 27 and 103 replicated rows), and 16 (none)."""
    jam, tam = toy_ams[quantized]
    feats = tfbank.Fbank(CPU).compute(hello)
    for t in (37, 153, 16):
        _close(jam.forward(feats[:t]), tam.forward(feats[:t]), quantized)
    assert tam.forward(feats[:0]).shape == (0, tam.num_pdfs)
    assert np.array_equal(tam.pad_context(feats[:5]),
                          jam.pad_context(feats[:5]))


@pytest.mark.parametrize("quantized", [False, True])
def test_am_stream_matches_jax_per_chunk(toy_ams, hello, quantized):
    jam, tam = toy_ams[quantized]
    feats = tfbank.Fbank(CPU).compute(hello)[:90]
    js, ts = jmodel.AMStream(jam), tmodel.AMStream(tam)
    assert ts.process(feats[:0]).shape == (0, tam.num_pdfs)
    off = 0
    for n in (3, 11, 20, 1, 27):
        _close(js.process(feats[off:off + n]), ts.process(feats[off:off + n]),
               quantized)
        off += n
    tail = ts._buffer.shape[0] - tam.left_context
    assert tfbank.bucket(tail) > tail  # the pad takes part in the scales
    ref, got = js.end_of_stream(), ts.end_of_stream()
    assert got.shape[0] == tail
    _close(ref, got, quantized)
    assert ts.end_of_stream().shape == (0, tam.num_pdfs)


# -- decoder -------------------------------------------------------------------


def _graphs(lm):
    """(JAX graph, port graph, tid2pdf, JAX G', port G', csr_group, log-probs
    [T, P]): the small trie with log-probs planted along word paths, and
    with lm its big G' (None without), each package building its own from
    the same seeds."""
    kw = dict(num_words=120, num_phones=25, bigram_states=30, variants=2)
    g = make_trie_graph(np.random.RandomState(1), **kw)
    tg = tbiggraph.make_trie_graph(np.random.RandomState(1), **kw)
    jd = td = None
    if lm:
        jd = make_big_lm(np.random.RandomState(9),
                         num_words=g.num_words).delta_lm()
        td = tbiggraph.make_big_lm(np.random.RandomState(9),
                                   num_words=g.num_words).delta_lm()
    logp, _ = plant_logp(np.random.RandomState(2), g, 1, 57)
    return g.fst, tg.fst, g.tid2pdf, jd, td, 16, logp[0]


def _decoders(lm):
    """(JAX Decoder, port Decoder, log-probs [T, P]) on _graphs(lm)."""
    jfst, tfst_, tid2pdf, jd, td, csr, logp = _graphs(lm)
    base = dict(beam_size=64, expand_size=2048, eps_expand_size=1024,
                max_eps_iters=4, beam=12.0, am_scale=0.1)
    common = dict(am_scale=0.1, chunk_frames=8, arc_group=2, csr_group=csr)
    jdec = jdecoder.Decoder(jfst, tid2pdf, delta_lm=jd,
                            config=jbeam.BeamConfig(**base), **common)
    tdec = tdecoder.Decoder(tfst_, tid2pdf, delta_lm=td,
                            config=tbeam.BeamConfig(**base), device=CPU,
                            **common)
    return jdec, tdec, logp


def _same_decoder_state(jdec, tdec, what):
    for name, x, y in zip(jdec.beam._fields, jdec.beam, tdec.beam):
        assert_same(x, y, f"{what}: beam {name}")
    assert len(jdec.traces) == len(tdec.traces), what
    for f, (a, b) in enumerate(zip(jdec.traces, tdec.traces)):
        assert_same(a.prev_slot, b.prev_slot, f"{what}: trace {f} prev")
        assert_same(a.words, b.words, f"{what}: trace {f} words")
    assert jdec.num_frames_decoded == tdec.num_frames_decoded
    assert jdec.capacity_high_water == tdec.capacity_high_water


@pytest.mark.parametrize("lm", [False, True])
def test_decoder_matches_jax_on_ragged_process_calls(lm):
    jdec, tdec, logp = _decoders(lm)
    off, partial_words = 0, 0
    for n in (5, 11, 3, 17, 1, 9):
        jdec.process(logp[off:off + n])
        tdec.process(logp[off:off + n])
        off += n
        _same_decoder_state(jdec, tdec, f"after {off} frames")
        ref, got = jdec.best_path(), tdec.best_path()  # partial
        assert (got.words, got.weight) == (ref.words, ref.weight)
        partial_words += len(got.words)
    jdec.process(logp[off:])
    tdec.process(logp[off:])
    jdec.end_of_stream()
    tdec.end_of_stream()
    _same_decoder_state(jdec, tdec, "end of stream")
    ref, got = jdec.best_path(), tdec.best_path()
    assert (got.words, got.weight) == (ref.words, ref.weight)
    assert partial_words  # the paths compared carry words
    if lm:
        assert (np.asarray(tdec.beam.lm) > 0).any()
    state = tdec.get_state()
    jstate = jdec.get_state()
    assert sorted(state) == sorted(jstate)
    for x, y in zip(jstate["beam"], state["beam"]):
        assert_same(x, y, "get_state beam")
    tdec.initialize()
    assert tdec.num_frames_decoded == 0 and len(tdec.traces) == 1
    tdec.set_state(state)
    _same_decoder_state(jdec, tdec, "set_state")


def test_decoder_overflow_raises_as_jax():
    """An undersized CSR capacity on the 30-word loop: both raise
    BeamCapacityError with the same high-water marks and message."""
    common = dict(beam_size=64, expand_size=8, eps_expand_size=16, beam=1e9,
                  am_scale=0.1)
    g = make_phone_loop_graph(np.random.RandomState(42), num_words=30,
                              num_pdfs=32)
    tg = ttoy.make_phone_loop_graph(np.random.RandomState(42), num_words=30,
                                    num_pdfs=32)
    logp = np.log(np.random.RandomState(4).dirichlet(
        np.ones(32), size=25)).astype(np.float32)
    jdec = jdecoder.Decoder(FlatFst.from_raw(g.fst), g.tid2pdf,
                            config=jbeam.BeamConfig(**common), arc_group=1)
    tdec = tdecoder.Decoder(tfst.FlatFst.from_raw(tg.fst), tg.tid2pdf,
                            config=tbeam.BeamConfig(**common), arc_group=1,
                            device=CPU)
    errs = []
    for dec, exc in ((jdec, BeamCapacityError),
                     (tdec, terrors.BeamCapacityError)):
        dec.process(logp)
        dec.end_of_stream()
        assert dec.overflowed
        with pytest.raises(exc) as err:
            dec.best_path()
        errs.append(err.value)
    assert errs[0].hiwater == errs[1].hiwater and errs[1].hiwater[0] > 8
    assert str(errs[0]) == str(errs[1])


@pytest.mark.parametrize("lm", [False, True])
def test_autosize_matches_jax(lm):
    jfst, tfst_, tid2pdf, jd, td, csr, logp = _graphs(lm)
    kw = dict(am_scale=0.1, margin=1.25, arc_group=2, csr_group=csr)
    ref = jdecoder.autosize(jfst, tid2pdf, logp, delta_lm=jd,
                            base=jbeam.BeamConfig(beam_size=64), **kw)
    got = tdecoder.autosize(tfst_, tid2pdf, logp, delta_lm=td,
                            base=tbeam.BeamConfig(beam_size=64), device=CPU,
                            **kw)
    for name in ("beam_size", "expand_size", "eps_expand_size",
                 "lm_expand_size", "max_eps_iters", "beam", "am_scale"):
        assert getattr(ref, name) == getattr(got, name), name
    assert (got.lm_expand_size > 0) == lm


def test_incremental_backtracker_matches_backtrace():
    """At every refresh over random growing traces (path switches, rooted
    rows): the port's tracker == its backtrace == the JAX backtrace."""
    rng = np.random.RandomState(0)
    k, w = 16, 3
    for trial in range(5):
        tracker = thyp.IncrementalBacktracker()
        traces, jtraces = [], []
        for step in range(80):
            if step == 0:  # the init pseudo-frame: every chain roots here
                prev = np.full(k, -1, np.int32)
                words = np.zeros((k, w), np.int32)
            else:
                prev = rng.randint(0, k, size=k).astype(np.int32)
                if rng.rand() < 0.1:
                    prev[rng.randint(0, k)] = -1
                words = np.where(rng.rand(k, w) < 0.3,
                                 rng.randint(1, 50, size=(k, w)),
                                 0).astype(np.int32)
            traces.append(thyp.HostTrace(prev, words))
            jtraces.append(jhyp.HostTrace(prev, words))
            if step % 3 == 0:
                slot = int(rng.randint(0, k))
                want = jhyp.backtrace(jtraces, slot)
                assert thyp.backtrace(traces, slot) == want
                assert tracker.best_words(traces, slot) == want, (trial, step)


# -- streaming sessions --------------------------------------------------------


@pytest.fixture(scope="module")
def recognizers(tmp_path_factory, data_dir):
    """(JAX Recognizer, port Recognizer) of the streaming toy model."""
    d = str(tmp_path_factory.mktemp("batch_stream"))
    conf = write_stream_toy(d, data_dir)
    return (jrec.Recognizer(conf, beam_config=jbeam.BeamConfig(**STREAM_BEAM)),
            trec.Recognizer(conf, beam_config=tbeam.BeamConfig(**STREAM_BEAM),
                            device=CPU))


def _solo(mod, rec, payload, fmt):
    utt = mod.Utterance(rec, fmt, fused=True)
    utt.process(payload)
    utt.end_of_stream()
    return utt.hyp


def _pcm(payload):
    return np.frombuffer(payload, dtype="<i2").astype(np.float32)


def _words(rec, hyp):
    return " ".join(rec.symbol_table.get(w) for w in hyp.words)


def test_batch_streaming_ragged_pacing(recognizers, data_dir):
    """Three streams at different rates, one starting late: each equals an
    independent port session and the JAX package's transcript; a stream's
    end of stream leaves the other streams' host traces as they were."""
    jr, tr = recognizers
    names = [("hello", 0), ("cat", 0), ("hello", 9000)]
    pays = [wav_payload(os.path.join(data_dir, f"en-us-{w}.wav"), cut)
            for w, cut in names]
    want = [_solo(jrec, jr, p, fmt) for fmt, p in pays]
    assert [_solo(trec, tr, p, fmt) for fmt, p in pays] == want
    batch = tr.create_stream_batch(3)
    samples = [_pcm(p) for _, p in pays]
    steps, offs = [3000, 4700, 2400], [0, 0, -20000]
    done = [False] * 3
    while not all(done):
        for u in range(3):
            lo = offs[u]
            offs[u] = lo + steps[u]
            if lo < 0:
                continue
            if lo >= samples[u].size:
                if not done[u]:
                    batch._materialize()
                    before = [len(t) for t in batch._host_traces]
                    batch.end_of_stream(u)
                    batch._materialize()
                    after = [len(t) for t in batch._host_traces]
                    assert [a - b for a, b in zip(after, before)] == [
                        0 if v != u else after[u] - before[u]
                        for v in range(3)]
                    done[u] = True
                continue
            batch.process(u, samples[u][lo:offs[u]])
    got = [_words(tr, batch.best_path(u, end_of_stream=True))
           for u in range(3)]
    assert got == want and all(got)


def test_process_batch_one_group_step_per_tick(recognizers, data_dir):
    jr, tr = recognizers
    fmt, payload = wav_payload(os.path.join(data_dir, "en-us-hello.wav"))
    want = _solo(jrec, jr, payload, fmt)
    samples = _pcm(payload)
    batch = tr.create_stream_batch(2)
    with pytest.raises(ValueError, match="one chunk per stream"):
        batch.process_batch([samples[:3200]])
    for off in range(0, samples.size, 3200):
        batch.process_batch([samples[off:off + 3200]] * 2)
    assert batch.num_frames_decoded[0] == batch.num_frames_decoded[1]
    # One group step per 20 decoded frames: both streams rode every step.
    assert len(batch._dev_traces) == batch.num_frames_decoded[0] // 20
    got = []
    for u in range(2):
        batch.end_of_stream(u)
        got.append(_words(tr, batch.best_path(u, end_of_stream=True)))
    assert got == [want, want]


def test_partials_equal_best_path(recognizers, data_dir):
    """partials() (one pull for all streams) equals the per-stream
    best_path calls it replaces, and a solo session's partial at the same
    decoded-frame count."""
    _, tr = recognizers
    fmt, payload = wav_payload(os.path.join(data_dir, "en-us-cat.wav"))
    samples = _pcm(payload)
    batch = tr.create_stream_batch(2)
    batch.process(0, samples[:24000])
    batch.process(1, samples[:8000])
    hyps = batch.partials()
    assert [h.words for h in hyps] == [
        batch.best_path(u, end_of_stream=False).words for u in range(2)]
    solo = trec.Utterance(tr, fmt, fused=True)
    solo.process(payload[:2 * 24000])
    assert batch.num_frames_decoded[0] == solo.session.num_frames_decoded
    assert (batch.best_path(0, end_of_stream=False).words
            == solo.session.best_path(end_of_stream=False).words)


@pytest.mark.parametrize("cmvn", [False, True])
def test_streaming_session_is_a_one_stream_batch(tmp_path, data_dir, cmvn):
    """A StreamingSession and a one-stream BatchStreamingSession fed the
    same ragged chunks give equal partial and final hypotheses; get_state
    taken before the first chunk step and mid-stream round-trips through
    pickle and set_state into fresh sessions that decode on identically."""
    conf = write_stream_toy(str(tmp_path), data_dir, cmvn=cmvn)
    tr = trec.Recognizer(conf, beam_config=tbeam.BeamConfig(**STREAM_BEAM),
                         device=CPU)
    args = (tr.am, tr.fst, tr.delta_lm) + tuple(tr._decode_graph())
    kw = dict(chunk_frames=20, cmvn_stats=tr.cmvn_stats)
    _, payload = wav_payload(os.path.join(data_dir, "en-us-cat.wav"))
    samples = _pcm(payload)
    solo = tstreaming.StreamingSession(*args, **kw)
    batch = tstreaming.BatchStreamingSession(*args, 1, **kw)
    cuts = [0, 1700, 4100, 4133, 9000, 15555, 16000, 23001, samples.size]
    resumed = []
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        for sess in [solo] + resumed:
            sess.process(samples[lo:hi])
        batch.process(0, samples[lo:hi])
        want = batch.best_path(0, end_of_stream=False)
        for sess in [solo] + resumed:
            assert sess.num_frames_decoded == batch.num_frames_decoded[0]
            got = sess.best_path(end_of_stream=False)
            assert (got.words, got.weight) == (want.words, want.weight), i
        if i in (0, 4):
            state = pickle.loads(pickle.dumps(solo.get_state()))
            assert (state["ctx"] is None) == (i == 0)
            assert state["beam"][0].shape[0] == 1
            assert [np.shape(x) for x in state["cm"]] == [
                (40,), (), (600 if cmvn else 1, 40), ()]
            fresh = tstreaming.StreamingSession(*args, **kw)
            fresh.set_state(state)
            resumed.append(fresh)
    batch.end_of_stream(0)
    want = batch.best_path(0, end_of_stream=True)
    assert want.words
    for sess in [solo] + resumed:
        sess.end_of_stream()
        assert not sess.overflowed
        got = sess.best_path(end_of_stream=True)
        assert (got.words, got.weight) == (want.words, want.weight)


def _decode_pcm(mod, rec, pcm, fused=True):
    from catears_tpu_torch.io.wav import WaveFormat

    utt = mod.Utterance(rec, WaveFormat(1, 16000, 16), fused=fused)
    for off in range(0, len(pcm), 1024):
        utt.process(pcm[off:off + 1024])
    utt.end_of_stream()
    return utt.hyp


def test_streaming_trie_with_delta_lm_matches_jax(tmp_path):
    """write_trie_model(with_lm=True) (tests/test_streaming.py's small
    trie, at a narrow geometry) streamed with the G' rescoring the fused
    steps, fused and componentized: JAX's transcript on 1 s of noise."""
    rng = np.random.RandomState(4)
    conf = tbiggraph.write_trie_model(str(tmp_path), rng, num_words=80,
                                      hidden=32, num_phones=25,
                                      bigram_states=20, variants=2,
                                      with_lm=True)
    with open(conf, "a") as fd:
        fd.write("beam_size = 256\nexpand_size = 1024\n"
                 "eps_expand_size = 256\nlm_expand_size = 64\n")
    jr, tr = jrec.Recognizer(conf), trec.Recognizer(conf, device=CPU)
    assert tr.delta_lm is not None
    noise = (rng.randn(16000) * 1000).astype("<i2").tobytes()
    want = _decode_pcm(jrec, jr, noise)
    assert _decode_pcm(trec, tr, noise) == want
    assert _decode_pcm(trec, tr, noise, fused=False) == want


def test_streaming_toy_with_delta_lm_matches_jax(tmp_path, data_dir):
    """The toy model with a G' over its words (its decodes end in final
    states): the same non-empty transcript of hello.wav as JAX's."""
    from catears_tpu_torch.io import binfmt

    conf = write_stream_toy(str(tmp_path), data_dir)
    big = tbiggraph.make_big_lm(np.random.RandomState(3), num_words=5)
    with open(os.path.join(str(tmp_path), "g.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, big.lm.to_raw())
    with open(os.path.join(str(tmp_path), "g.unigram"), "wb") as fd:
        binfmt.write_vec0(fd, big.small_lm)
    with open(conf, "a") as fd:
        fd.write("large_lm = g.fst\noriginal_lm = g.unigram\n")
    jr = jrec.Recognizer(conf, beam_config=jbeam.BeamConfig(**STREAM_BEAM))
    tr = trec.Recognizer(conf, beam_config=tbeam.BeamConfig(**STREAM_BEAM),
                         device=CPU)
    _, pcm = wav_payload(os.path.join(data_dir, "en-us-hello.wav"))
    want = _decode_pcm(jrec, jr, pcm)
    assert want and _decode_pcm(trec, tr, pcm) == want
