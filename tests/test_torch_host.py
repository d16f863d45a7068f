"""The port's copies of the JAX package's host modules vs their originals.

`catears_tpu_torch` keeps its own copies of the host code it needs (io,
graph.fst, graph.transform, tools, utils) at the JAX package's module
paths.  From the same seeds and files: the generators write byte-identical
model files, the graph code gives equal arrays, the readers and online CMVN
equal results, the error paths the same exception names and messages (and
the same last-error record), and the metrics registry the same counters.  Exact
throughout: the copies are the same numpy code.
"""

import filecmp
import os
import struct

import numpy as np
import pytest

from _torch_parity import random_fst
from catears_tpu.frontend import cmvn as jcmvn
from catears_tpu.graph import fst as jfst
from catears_tpu.graph import transform as jtransform
from catears_tpu.io import binfmt as jbinfmt
from catears_tpu.io import config as jconfig
from catears_tpu.io import openfst as jopenfst
from catears_tpu.io import symbols as jsymbols
from catears_tpu.io import wav as jwav
from catears_tpu.tools import biggraph as jbiggraph
from catears_tpu.tools import score as jscore
from catears_tpu.tools import toy as jtoy
from catears_tpu.utils import errors as jerrors
from catears_tpu.utils import log as jlog
from catears_tpu_torch.frontend import cmvn as tcmvn
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.graph import transform as ttransform
from catears_tpu_torch.io import binfmt as tbinfmt
from catears_tpu_torch.io import config as tconfig
from catears_tpu_torch.io import openfst as topenfst
from catears_tpu_torch.io import symbols as tsymbols
from catears_tpu_torch.io import wav as twav
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.tools import score as tscore
from catears_tpu_torch.tools import toy as ttoy
from catears_tpu_torch.utils import errors as terrors
from catears_tpu_torch.utils import log as tlog

FST_FIELDS = ("final", "offsets", "arc_next", "arc_ilabel", "arc_olabel",
              "arc_weight")


def assert_fst_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a.start == b.start
    for name in FST_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def assert_same_dir(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    match, mismatch, errors = filecmp.cmpfiles(d1, d2, names, shallow=False)
    assert not mismatch and not errors and match == names


# -- generators: byte-identical files from the same seed ----------------------


@pytest.mark.parametrize("with_lm", [False, True])
def test_write_trie_model_byte_identical(tmp_path, with_lm):
    kw = dict(num_words=80, hidden=32, num_phones=25, bigram_states=20,
              variants=2, with_lm=with_lm)
    jbiggraph.write_trie_model(str(tmp_path / "j"), np.random.RandomState(4),
                               **kw)
    tbiggraph.write_trie_model(str(tmp_path / "t"), np.random.RandomState(4),
                               **kw)
    assert_same_dir(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("num_words,hidden,num_pdfs", [(6, 64, 48),
                                                       (20, 32, 96)])
def test_write_toy_model_byte_identical(tmp_path, num_words, hidden,
                                        num_pdfs):
    for pkg, d in ((jtoy, "j"), (ttoy, "t")):
        pkg.write_toy_model(str(tmp_path / d), np.random.RandomState(5),
                            num_words=num_words, hidden=hidden,
                            num_pdfs=num_pdfs)
    assert_same_dir(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("num_words,num_trigrams", [(20, 0), (500, 120)])
def test_make_big_lm_byte_identical(tmp_path, num_words, num_trigrams):
    written = []
    for pkg, binfmt in ((jbiggraph, jbinfmt), (tbiggraph, tbinfmt)):
        big = pkg.make_big_lm(np.random.RandomState(3), num_words=num_words,
                              num_trigrams=num_trigrams)
        path = tmp_path / f"{pkg.__name__}.bin"
        with open(path, "wb") as fd:
            binfmt.write_pkfst(fd, big.lm.to_raw())
            binfmt.write_vec0(fd, big.small_lm)
        written.append((big, path.read_bytes()))
    (jb, jbytes), (tb, tbytes) = written
    assert jbytes == tbytes
    assert_fst_equal(jb.lm, tb.lm)
    assert (jb.bos_id, jb.eos_id, jb.num_states, jb.num_arcs) == (
        tb.bos_id, tb.eos_id, tb.num_states, tb.num_arcs)


@pytest.mark.parametrize("num_words", [6, 40])
def test_make_toy_lm_byte_identical(tmp_path, num_words):
    """tools.toy.make_toy_lm (the toy backoff bigram G' and its unigram
    vector): the same FST and costs from the same seed, written byte for
    byte alike."""
    written = []
    for pkg, binfmt in ((jtoy, jbinfmt), (ttoy, tbinfmt)):
        raw, small = pkg.make_toy_lm(np.random.RandomState(4), num_words,
                                     num_words + 1, num_words + 2)
        path = tmp_path / f"{pkg.__name__}.bin"
        with open(path, "wb") as fd:
            binfmt.write_pkfst(fd, raw)
            binfmt.write_vec0(fd, small)
        written.append(path.read_bytes())
    assert written[0] == written[1]


def test_trie_graph_and_planted_frames_equal():
    kw = dict(num_words=150, num_phones=25, bigram_states=30, variants=2)
    jrng, trng = np.random.RandomState(1), np.random.RandomState(1)
    jg = jbiggraph.make_trie_graph(jrng, **kw)
    tg = tbiggraph.make_trie_graph(trng, **kw)
    assert_fst_equal(jg.fst, tg.fst)
    for name in ("tid2pdf", "word_pdf_off", "word_pdf_flat", "unigram_cost"):
        assert np.array_equal(getattr(jg, name), getattr(tg, name)), name
    jl, jw = jbiggraph.plant_logp(jrng, jg, 2, 50)
    tl, tw = tbiggraph.plant_logp(trng, tg, 2, 50)
    assert jl.tobytes() == tl.tobytes() and jw == tw


# -- graph code: equal arrays -------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_prepare_decode_graph_equal_on_random_graphs(seed):
    ref = jtransform.prepare_decode_graph(
        random_fst(np.random.RandomState(seed), flat=jfst.FlatFst))
    got = ttransform.prepare_decode_graph(
        random_fst(np.random.RandomState(seed)))
    assert got[2] == ref[2]
    assert_fst_equal(ref[0], got[0])
    if ref[1] is None:
        assert got[1] is None
    else:
        assert got[1].dtype == ref[1].dtype and np.array_equal(got[1], ref[1])


@pytest.mark.parametrize("graph", ["phone_loop", "trie"])
def test_prepare_decode_graph_equal_on_model_graphs(graph):
    out = []
    for toy, bg, fst, tr in ((jtoy, jbiggraph, jfst, jtransform),
                             (ttoy, tbiggraph, tfst, ttransform)):
        if graph == "trie":
            g = bg.make_trie_graph(np.random.RandomState(2), num_words=120,
                                   num_phones=25, bigram_states=30,
                                   variants=2).fst
        else:
            g = fst.FlatFst.from_raw(toy.make_phone_loop_graph(
                np.random.RandomState(42), num_words=30, num_pdfs=32).fst)
        out.append(tr.prepare_decode_graph(g))
    (jg, jo, jm), (tg, to, tm) = out
    assert jm == tm == "eps_free"
    assert_fst_equal(jg, tg)
    assert np.array_equal(jo, to)


def test_flat_fst_round_trips_and_queries_equal():
    jf = random_fst(np.random.RandomState(9), flat=jfst.FlatFst)
    tf = random_fst(np.random.RandomState(9))
    assert_fst_equal(jf, tf)
    jraw, traw = jf.to_raw(), tf.to_raw()
    assert np.array_equal(jraw.first_arc, traw.first_arc)
    assert_fst_equal(jfst.FlatFst.from_raw(jraw), tfst.FlatFst.from_raw(traw))
    for s in range(jf.num_states):
        assert jf.arc_range(s) == tf.arc_range(s)
        assert jf.num_eps(s) == tf.num_eps(s)
        for ilabel in range(12):
            assert jf.get_arc(s, ilabel) == tf.get_arc(s, ilabel)


def test_delta_lm_walk_equal():
    jb = jbiggraph.make_big_lm(np.random.RandomState(6), num_words=300)
    tb = tbiggraph.make_big_lm(np.random.RandomState(6), num_words=300)
    jd, td = jb.delta_lm(), tb.delta_lm()
    assert jd.start_state() == td.start_state()
    rng = np.random.RandomState(0)
    for s in rng.randint(0, jb.num_states, 200):
        assert jd.final(int(s)) == td.final(int(s))
        for label in rng.randint(1, 303, 5):
            assert (jd.get_arc(int(s), int(label))
                    == td.get_arc(int(s), int(label)))


# -- readers: equal results, the same errors ----------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_model")
    conf = jtoy.write_toy_model(str(d), np.random.RandomState(7),
                                num_words=12, hidden=32, num_pdfs=40)
    return str(d), conf


def test_config_and_symbol_table_equal(model_dir):
    d, conf = model_dir
    with open(conf, "a") as fd:
        fd.write("# comment\nBeam = 12.5\nquantized = true\n")
    jc, tc = jconfig.Configuration.read(conf), tconfig.Configuration.read(conf)
    for key in ("fst", "nnet", "symbol_table", "tid2pdf"):
        assert jc.get_path(key) == tc.get_path(key)
        assert jc.get_string(key) == tc.get_string(key)
    for key in ("left_context", "right_context", "num_pdfs"):
        assert jc.get_int(key) == tc.get_int(key)
    assert jc.get_float("beam") == tc.get_float("beam") == 12.5
    assert jc.has("quantized") and tc.has("quantized") and not tc.has("x")
    assert tc.get_int("x", 3) == 3 and tc.filename == jc.filename
    js = jsymbols.SymbolTable.read(jc.get_path("symbol_table"))
    ts = tsymbols.SymbolTable.read(tc.get_path("symbol_table"))
    assert len(js) == len(ts) and (js.bos_id, js.eos_id) == (ts.bos_id,
                                                             ts.eos_id)
    assert [js.get(i) for i in range(len(js))] == [ts.get(i)
                                                   for i in range(len(ts))]
    assert ts.get_id("word3") == js.get_id("word3") and ts.get_id("?") == -1


def test_binary_readers_equal(model_dir):
    d, conf = model_dir
    c = tconfig.Configuration.read(conf)
    for key, dtype in (("prior", np.float32), ("tid2pdf", np.int32)):
        a = jbinfmt.read_vec0_file(c.get_path(key), dtype)
        b = tbinfmt.read_vec0_file(c.get_path(key), dtype)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jn = jbinfmt.read_nnet_file(c.get_path("nnet"))
    tn = tbinfmt.read_nnet_file(c.get_path("nnet"))
    assert (jn.left_context, jn.right_context) == (tn.left_context,
                                                   tn.right_context)
    assert len(jn.layers) == len(tn.layers)
    for x, y in zip(jn.layers, tn.layers):
        assert (x.kind, x.indices, x.narrow_left, x.narrow_right) == (
            y.kind, y.indices, y.narrow_left, y.narrow_right)
        for name in ("weight", "bias", "scale", "offset"):
            a, b = getattr(x, name), getattr(y, name)
            assert (a is None and b is None) or np.array_equal(a, b), name
    assert_fst_equal(jfst.FlatFst.read(c.get_path("fst")),
                     tfst.FlatFst.read(c.get_path("fst")))


def test_const_fst_reader_equal(tmp_path):
    """An OpenFST ConstFst (written by the JAX package's writer): the
    port's Python parser gives the JAX package's arrays."""
    f = random_fst(np.random.RandomState(11), flat=jfst.FlatFst)
    cf = jopenfst.ConstFst(
        start=f.start, final=f.final, arc_pos=f.offsets[:-1],
        arc_count=np.diff(f.offsets).astype(np.int32),
        arc_ilabel=f.arc_ilabel, arc_olabel=f.arc_olabel,
        arc_weight=f.arc_weight, arc_next=f.arc_next)
    path = str(tmp_path / "g.fst")
    with open(path, "wb") as fd:
        jopenfst.write_const_fst(fd, cf)
    ref, got = (jopenfst.read_const_fst_file(path),
                topenfst.read_const_fst_file(path))
    for name in ("final", "arc_pos", "arc_count", "arc_ilabel", "arc_olabel",
                 "arc_weight", "arc_next"):
        assert np.array_equal(getattr(ref, name), getattr(got, name)), name
    assert_fst_equal(jfst.FlatFst.from_const_fst(ref),
                     tfst.FlatFst.read(path))
    with open(path, "r+b") as fd:
        fd.write(struct.pack("<i", 12345))
    for reader, errs in ((jopenfst, jerrors), (topenfst, terrors)):
        with pytest.raises(errs.CorruptionError, match="bad FST magic"):
            reader.read_const_fst_file(path)


def test_wav_and_scp_readers_equal(data_dir, tmp_path):
    wavs = [os.path.join(data_dir, f"en-us-{w}.wav") for w in ("hello", "cat")]
    for w in wavs:
        ref, got = jwav.read_16k_pcm(w), twav.read_16k_pcm(w)
        assert ref.dtype == got.dtype and np.array_equal(ref, got)
    scp = tmp_path / "list.scp"
    scp.write_text("a " + wavs[0] + "\n\nb " + wavs[1] + "\n")
    assert jwav.read_scp(str(scp)) == twav.read_scp(str(scp))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(open(wavs[0], "rb").read()[:30])
    msgs = []
    for reader, errs in ((jwav, jerrors), (twav, terrors)):
        with pytest.raises(errs.CorruptionError) as err:
            reader.read_16k_pcm(str(bad))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("text,key", [("x = 1\nbad line\n", "x"),
                                      ("x = \n", "x"), ("x = 1\n", "y")])
def test_config_errors_equal(tmp_path, text, key):
    path = tmp_path / "c.conf"
    path.write_text(text)
    msgs = []
    for mod, errs in ((jconfig, jerrors), (tconfig, terrors)):
        with pytest.raises(errs.CorruptionError) as err:
            mod.Configuration.read(str(path)).get_string(key)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- scoring ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_token_errors_equal(seed):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(6)]
    for _ in range(20):
        ref = list(rng.choice(vocab, rng.randint(0, 12)))
        hyp = list(rng.choice(vocab, rng.randint(0, 12)))
        assert tscore.token_errors(ref, hyp) == jscore.token_errors(ref, hyp)
        assert tscore.edit_distance(ref, hyp) == jscore.edit_distance(ref,
                                                                      hyp)


# -- online CMVN, the last-error record, the metrics registry ------------------


@pytest.mark.parametrize("t,step", [(0, 5), (1, 1), (650, 37), (1300, 600)])
def test_online_cmvn_equal(t, step):
    rng = np.random.RandomState(t)
    feats = (rng.randn(t, 40) * 4 + 9).astype(np.float32)
    stats = np.concatenate([rng.rand(40) * 1e5, [3e4]])
    ref = jcmvn.OnlineCMVN(stats).apply(feats)
    got = tcmvn.OnlineCMVN(stats).apply(feats)
    assert ref.dtype == got.dtype and np.array_equal(ref, got)
    js, ts = jcmvn.CMVNStream(stats), tcmvn.CMVNStream(stats)
    for i in range(0, t, step):
        a, b = js.process(feats[i:i + step]), ts.process(feats[i:i + step])
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(js._history, ts._history)
    assert (tcmvn.CMVN_WINDOW, tcmvn.CMVN_GLOBAL_FRAMES, tcmvn.FEAT_DIM) == (
        jcmvn.CMVN_WINDOW, jcmvn.CMVN_GLOBAL_FRAMES, jcmvn.FEAT_DIM)
    for mod in (jcmvn, tcmvn):
        with pytest.raises(AssertionError):
            mod.OnlineCMVN(stats[:40])


def test_last_error_record_equal():
    """Raising any error records `<code>: <message>`; record_error
    overwrites it; BeamCapacityError carries its high-water marks."""
    seen = []
    for errs in (jerrors, terrors):
        for cls in (errs.IOError_, errs.CorruptionError, errs.RuntimeError_,
                    errs.NotImplementedError_, errs.CatEarsError):
            with pytest.raises(cls):
                raise cls("went wrong")
            seen.append(errs.last_error())
        cls()
        seen.append(errs.last_error())
        err = errs.BeamCapacityError("over", hiwater=(1, 2, 3, 4, 5))
        seen.append((errs.last_error(), err.hiwater, err.code))
        errs.record_error("by hand")
        seen.append(errs.last_error())
    half = len(seen) // 2
    assert seen[:half] == seen[half:]
    assert seen[1] == "Corruption: went wrong"


def test_metrics_registry_equal():
    """count / timed / reset_metrics keep the same keys and counts."""
    out = []
    for mod in (jlog, tlog):
        mod.reset_metrics()
        mod.count("frames_decoded", 20)
        mod.count("frames_decoded")
        with mod.timed("decode"):
            pass
        with pytest.raises(ZeroDivisionError):
            with mod.timed("am"):
                1 / 0
        m = mod.metrics()
        assert m["decode_seconds"] >= 0 and m["am_seconds"] >= 0
        out.append((sorted(m), m["frames_decoded"]))
        mod.info("x %d", 1)
        mod.warn("x")
        mod.debug("x")
        mod.reset_metrics()
        assert mod.metrics() == {}
    assert out[0] == out[1] == (["am_seconds", "decode_seconds",
                                 "frames_decoded"], 21.0)
