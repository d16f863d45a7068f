"""The port's spans (`catears_tpu_torch.utils.log`) on the CPU: nothing is
recorded while tracing is off and the counters read as before; nesting,
parents, attributes and sequence numbers; the spans a BatchDecoder decode,
its overflow retry, `batched_logp`, the live session's tick and the
decoder's set-up record; and the clock, shared with `torch.profiler`'s
events."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import CPU, dirichlet, write_stream_toy
from catears_tpu_torch.decode.beam import BeamConfig, emit_lanes
from catears_tpu_torch.decode.decoder import BatchDecoder, Decoder
from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.runtime.batch import batched_logp
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.tools.biggraph import make_trie_graph, plant_logp
from catears_tpu_torch.tools.toy import make_phone_loop_graph
from catears_tpu_torch.utils import log


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty afterwards."""
    log.start_tracing()
    yield
    log.stop_tracing()
    log.start_tracing()
    log.stop_tracing()


def tree(spans):
    """{id: span} and {parent id: [child names in start order]}."""
    by_id = {s.id: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s.name)
    return by_id, kids


def test_tracing_off_records_nothing():
    log.start_tracing()
    log.stop_tracing()
    log.reset_metrics()
    a = log.span("x", batch=3)
    assert a is log.span("y", device=True)  # the one shared no-op
    with a as s:
        s.set(frames=2)
        log.annotate("x", more=1)
        with log.timed("am"):
            log.count("frames_decoded", 5)
    assert log.spans() == [] and not log.tracing()
    m = log.metrics()
    assert sorted(m) == ["am_seconds", "frames_decoded"]
    assert m["frames_decoded"] == 5.0 and m["am_seconds"] >= 0
    log.reset_metrics()


def test_nesting_parents_attributes_and_sequence(traced):
    for k in range(3):
        with log.span("logp", batch=k) as top:
            with log.span("logp.host"):
                with log.span("inner"):
                    log.annotate("logp", frames=10 * k)
            top.set(audio_s=1.5)
        with log.span("decode"):
            with log.span("decode.frames", frames=5):
                pass
    spans = log.spans()
    assert [s.name for s in spans[:5]] == [
        "logp", "logp.host", "inner", "decode", "decode.frames"]
    by_id, kids = tree(spans)
    tops = [s for s in spans if s.parent is None]
    assert [(s.name, s.seq) for s in tops] == [
        ("logp", 0), ("decode", 0), ("logp", 1), ("decode", 1),
        ("logp", 2), ("decode", 2)]
    assert all(s.seq is None for s in spans if s.parent is not None)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.attrs for s in tops if s.name == "logp"] == [
        {"batch": k, "frames": 10 * k, "audio_s": 1.5} for k in range(3)]
    assert kids[tops[0].id] == ["logp.host"]
    host = [s for s in spans if s.name == "logp.host"][0]
    assert kids[host.id] == ["inner"]
    assert len({s.id for s in spans}) == len(spans)
    log.start_tracing()  # a fresh list, sequence numbers from 0 again
    with log.span("logp"):
        pass
    assert [(s.name, s.seq) for s in log.spans()] == [("logp", 0)]


def test_timed_keeps_its_counter_and_records_a_span(traced):
    log.reset_metrics()
    with log.timed("frontend"):
        with log.span("inside"):
            pass
    with pytest.raises(ZeroDivisionError):
        with log.timed("am"):
            1 / 0
    names = [(s.name, s.parent is None) for s in log.spans()]
    assert names == [("frontend", True), ("inside", False), ("am", True)]
    assert all(s.end_ns is not None for s in log.spans())
    assert sorted(log.metrics()) == ["am_seconds", "frontend_seconds"]
    log.reset_metrics()


def _trie_decoder(config=None, chunk_frames=10):
    g = make_trie_graph(np.random.RandomState(1), num_words=120,
                        num_phones=25, bigram_states=30, variants=2)
    lp, _ = plant_logp(np.random.RandomState(2), g, 2, 35)
    dec = BatchDecoder(g.fst, g.tid2pdf, config=config,
                       chunk_frames=chunk_frames, arc_group=2, device=CPU)
    return dec, lp


def test_batch_decode_spans(traced):
    """decode > decode.init, one decode.frames per chunk (their frames sum
    to T), decode.read, decode.backtrace, decode.hyps; the decode span
    carries batch, frames, steps, hiwater and the lane capacity."""
    dec, lp = _trie_decoder()
    log.start_tracing()
    lengths = [lp.shape[1], lp.shape[1] - 9]
    hyps = dec.decode(lp, lengths)
    assert len(hyps) == 2
    spans = log.spans()
    by_id, kids = tree(spans)
    (top,) = [s for s in spans if s.parent is None]
    t = lp.shape[1]
    chunks = -(-t // 10)
    assert top.name == "decode" and top.seq == 0
    assert kids[top.id] == (["decode.init"] + ["decode.frames"] * chunks
                            + ["decode.read", "decode.backtrace",
                               "decode.hyps"])
    frames = [s.attrs["frames"] for s in spans if s.name == "decode.frames"]
    assert sum(frames) == t and frames[0] == 10
    a = top.attrs
    assert (a["batch"], a["frames"], a["steps"]) == (2, sum(lengths), t)
    assert len(a["hiwater"]) == 5 and a["hiwater"][0] > 0
    assert a["lanes"] == emit_lanes(dec.cfg, dec.dfst)
    assert a["hiwater"][0] <= a["lanes"]
    ordered = [by_id[i] for i in sorted(by_id)]
    for x, y in zip(ordered[1:], ordered[2:]):  # siblings do not overlap
        assert x.end_ns <= y.start_ns


def test_batch_decode_retry_spans(traced):
    """An explicit too-small BeamConfig: the overflow retry is a
    decode.retry span under decode holding the second decode's phases,
    overflow_retries counts it once, and the hiwater is recorded."""
    rng = np.random.RandomState(5)
    g = make_phone_loop_graph(rng, num_words=40, num_pdfs=32)
    fst = FlatFst.from_raw(g.fst)
    logp = dirichlet(rng, 32, (2, 30))
    cfg = BeamConfig(beam_size=64, expand_size=8, eps_expand_size=512,
                     beam=1e9)
    dec = BatchDecoder(fst, g.tid2pdf, config=cfg, arc_group=1,
                       chunk_frames=10, device=CPU)
    log.reset_metrics()
    log.start_tracing()
    dec.decode(logp, [30, 19])
    assert log.metrics()["overflow_retries"] == 1
    spans = log.spans()
    by_id, kids = tree(spans)
    (top,) = [s for s in spans if s.parent is None]
    assert kids[top.id] == (["decode.init"] + ["decode.frames"] * 3
                            + ["decode.read", "decode.retry"])
    (retry,) = [s for s in spans if s.name == "decode.retry"]
    assert kids[retry.id] == (["decode.init"] + ["decode.frames"] * 3
                              + ["decode.read", "decode.backtrace",
                                 "decode.hyps"])
    first = retry.attrs["hiwater"]
    assert len(first) == 5 and first[0] > cfg.expand_size
    assert len(top.attrs["hiwater"]) == 5
    assert top.attrs["hiwater"][0] >= first[0]
    log.reset_metrics()


def test_decoder_setup_spans(traced):
    log.start_tracing()
    _trie_decoder()
    names = [s.name for s in log.spans() if s.parent is None]
    assert names == ["setup.decode_graph", "setup.device_fst"]


def test_streaming_decoder_setup_spans_with_a_delta_lm(traced, data_dir):
    """The single-utterance Decoder (the Recognizer's graph build) records
    the same set-up spans, with the G' tables as setup.device_lm."""
    import os

    from catears_tpu_torch.graph.fst import DeltaLmFst, LmFst
    from catears_tpu_torch.io.binfmt import read_vec0_file
    from catears_tpu_torch.io.symbols import SymbolTable

    delta = DeltaLmFst(
        read_vec0_file(os.path.join(data_dir, "lm.1order.bin")),
        LmFst.read_lm(os.path.join(data_dir, "G.pfst")),
        SymbolTable.read(os.path.join(data_dir, "lm.words.txt")))
    g = make_phone_loop_graph(np.random.RandomState(3), num_words=20,
                              num_pdfs=16)
    log.start_tracing()
    Decoder(FlatFst.from_raw(g.fst), g.tid2pdf, delta_lm=delta,
            arc_group=1, device=CPU)
    names = [s.name for s in log.spans() if s.parent is None]
    assert names == ["setup.decode_graph", "setup.device_fst",
                     "setup.device_lm"]


def test_batched_logp_spans(traced, tmp_path, data_dir):
    conf = write_stream_toy(str(tmp_path), data_dir)
    rec = Recognizer(conf, device=CPU)
    rng = np.random.RandomState(0)
    waves = [rng.randn(n).astype(np.float32) * 0.1 for n in (8000, 12345)]
    log.start_tracing()
    logp, lengths = batched_logp(rec.am, waves)
    spans = log.spans()
    by_id, kids = tree(spans)
    (top,) = [s for s in spans if s.parent is None]
    assert top.name == "logp" and kids[top.id] == ["logp.host", "logp.am"]
    assert top.attrs == {"batch": 2, "frames": sum(lengths),
                         "audio_s": (8000 + 12345) / 16000.0}
    assert top.device_s is None  # a CPU decode records no CUDA events
    assert logp.shape[:2] == (2, max(lengths))


def test_stream_batch_tick_spans(traced, tmp_path, data_dir):
    conf = write_stream_toy(str(tmp_path), data_dir)
    with open(conf, "a") as fd:
        fd.write("beam_size = 64\nexpand_size = 1024\n"
                 "eps_expand_size = 512\n")
    rec = Recognizer(conf, device=CPU)
    sess = rec.create_stream_batch(2)
    rng = np.random.RandomState(0)
    log.start_tracing()
    sess.process_batch([rng.randn(8000).astype(np.float32) * 0.1, None])
    sess.partials()
    spans = log.spans()
    by_id, kids = tree(spans)
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in tops] == ["tick.step", "tick.partials"]
    step, part = tops
    assert kids[step.id] == ["tick.features", "tick.decode"] * (
        len(kids[step.id]) // 2) and kids[step.id]
    assert all(s.attrs["frames"] == 20 for s in spans
               if s.name == "tick.decode")
    assert kids[part.id] == ["partials.copy", "partials.copy"]


def test_spans_share_the_profilers_clock(traced):
    """An op run inside a span has its kineto event inside the span's
    interval (torch.profiler, CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with log.span("mm"):
                torch.mm(x, x)
    windows = [(s.start_ns, s.end_ns) for s in log.spans()]
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::mm")
    assert len(events) == 3 == len(windows)
    for (a, b), (s, e) in zip(events, windows):
        assert s <= a <= b <= e, (s, a, b, e)


def test_spans_ignore_other_threads_nesting(traced):
    """Each thread nests its own spans: a span opened on a worker thread
    while the main thread has one open is top-level."""
    import threading

    def work():
        with log.span("worker"):
            pass

    with log.span("main"):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    by_name = {s.name: s for s in log.spans()}
    assert by_name["worker"].parent is None and by_name["worker"].seq == 0
    assert by_name["main"].end_ns >= by_name["worker"].end_ns
