"""`asrbench/spans.py`: idle time split by the program's spans on
synthetic timelines (gaps split at span edges, `harness` outside every
span, the innermost span of nested ones), the gap labels, the causality
count, the numbers from records, and a whole traced run of a tiny
checkout with the program's tracing on."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import REPO

from asrbench import spans as sp

MS = 1_000_000  # ns


def span(sid, name, a, b, parent=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "seq": None,
            "start_ns": a * MS, "end_ns": b * MS, "attrs": attrs,
            "device_s": attrs.pop("device_s", None)}


def op(name, a, b):
    """A device operation from a to b ms, as trace.device_ops gives it."""
    return (name, a * 1e3, b * 1e3, not name.startswith("Memcpy"))


def test_idle_is_split_at_span_edges_and_harness_outside():
    # card busy 0-10 and 40-50 ms; the host in `logp.host` 5-20, in
    # `decode` 20-48 and `decode.frames` 25-45 inside it, in no span after
    spans = [span(1, "logp.host", 5, 20), span(2, "decode", 20, 48),
             span(3, "decode.frames", 25, 45, parent=2)]
    ops = [op("k1", 0, 10), op("Memcpy HtoD (Pageable -> Device)", 40, 50)]
    got = sp.attribute(ops, spans, 0, 60 * MS)
    idle = got["idle_by_span"]
    # 10-20 logp.host, 20-25 decode, 25-40 decode.frames, 50-60 harness
    assert idle == pytest.approx({"logp.host": 0.010, "decode": 0.005,
                                  "decode.frames": 0.015, "harness": 0.010})
    assert sum(idle.values()) == pytest.approx(0.040)
    assert got["idle_gaps"] == [
        ["before Memcpy HtoD in decode.frames", pytest.approx(0.030)]]


def test_innermost_of_nested_spans():
    spans = [span(1, "decode", 0, 100), span(2, "decode.read", 10, 20, 1),
             span(3, "decode.hyps", 30, 90, 1), span(4, "deep", 40, 50, 3)]
    pieces = sp.innermost(spans, -10 * MS, 110 * MS)
    assert [(a / MS, b / MS, n) for a, b, n in pieces] == [
        (-10, 0, "harness"), (0, 10, "decode"), (10, 20, "decode.read"),
        (20, 30, "decode"), (30, 40, "decode.hyps"), (40, 50, "deep"),
        (50, 90, "decode.hyps"), (90, 100, "decode"), (100, 110, "harness")]


def test_gap_labels_take_the_span_holding_most_of_the_gap():
    spans = [span(1, "decode.hyps", 0, 12), span(2, "logp.host", 14, 30)]
    ops = [op("k1", 0, 2), op("k2", 30, 31), op("k3", 31.5, 40)]
    got = sp.attribute(ops, spans, 0, 40 * MS)
    assert got["idle_gaps"][0] == ["before k2 in logp.host",
                                   pytest.approx(0.028)]
    assert got["idle_gaps"][1][0] == "before k3 in harness"
    assert got["idle_by_span"]["decode.hyps"] == pytest.approx(0.010)


def test_causality_counts_copies_before_their_batch():
    spans = [span(1, "logp", 10, 20), span(2, "decode", 20, 50),
             span(3, "logp", 60, 70), span(4, "decode", 70, 90)]
    fine = [op("Memcpy HtoD (Pageable -> Device)", 12, 13),
            op("Memcpy HtoD (Pageable -> Device)", 61, 62)]
    assert sp.causality(fine, spans, 0, 100 * MS) == 0
    # the second batch's copy shown 5 ms before its span began: a clock
    # off by more than the host's time between the two spans
    early = [fine[0], op("Memcpy HtoD (Pageable -> Device)", 55, 56)]
    assert sp.causality(early, spans, 0, 100 * MS) == 1


def test_numbers_from_records():
    spans = [
        span(1, "setup.decode_graph", 0, 500),
        span(2, "setup.device_fst", 500, 1500),
        span(3, "logp", 2000, 2100, device_s=0.05, audio_s=10.0),
        span(4, "logp.host", 2000, 2010, parent=3),
        span(5, "decode", 2100, 3000, hiwater=[3000, 0, 0, 10, 0],
             lanes=38912),
        span(6, "decode.frames", 2100, 2200, parent=5, frames=50),
        span(7, "decode.frames", 2200, 2250, parent=5, frames=25),
        span(8, "logp", 3000, 3100, device_s=0.15, audio_s=20.0),
        span(9, "decode", 3100, 4000, hiwater=[9000, 0, 0, 10, 0],
             lanes=38912),
        span(10, "decode.retry", 3500, 4000, parent=9),
        span(11, "logp", 4500, 4600, device_s=1.0, audio_s=1.0),
    ]
    rec = {"spans": spans, "window_ns": [1900 * MS, 4100 * MS],
           "idle_by_span": {"decode.frames": 0.11, "logp.host": 0.022}}
    assert sp.frame_loop_host_ms(rec) == pytest.approx(150 / 75)
    assert sp.idle_in_frame_loop(rec) == pytest.approx(5.0)
    assert sp.idle_in_logp_host(rec) == pytest.approx(1.0)
    assert sp.am_span_ms_per_audio_s(rec) == pytest.approx(200 / 30)
    assert sp.lane_fill(rec) == pytest.approx(100 * 6000 / 38912)
    assert sp.decode_retries(rec) == pytest.approx(50.0)
    assert sp.setup_program_s(rec) == pytest.approx(1.5)
    assert sp.idle_in_frame_loop({**rec, "idle_by_span": {}}) is None
    assert sp.tick_decode_ms(rec) is None
    ticks = [span(20, "tick.step", 2000, 2030),
             span(21, "tick.decode", 2005, 2025, parent=20),
             span(22, "tick.step", 2100, 2140),
             span(23, "tick.decode", 2105, 2135, parent=22),
             span(24, "tick.partials", 2140, 2150),
             span(25, "partials.copy", 2140, 2148, parent=24)]
    live = {"spans": ticks, "window_ns": rec["window_ns"]}
    assert sp.tick_decode_ms(live) == pytest.approx(25.0)
    assert sp.tick_partials_ms(live) == pytest.approx(5.0)
    assert sp.frame_loop_host_ms(live) is None
    none = {"spans": [], "window_ns": [0, 1]}
    assert all(fn(none) is None for fn, _ in sp.NUMBERS.values())


def test_a_traced_run_with_the_programs_spans(tiny_root):
    """The cell's traced run with the program's tracing on: its own last
    line first, then the spans' line; on the CPU (no device trace) the
    numbers that need the card's timeline are left out."""
    out = subprocess.run(
        [sys.executable, "-m", "asrbench.spans", "--workload", "bulk-lmoff",
         "--seed", "2147483903", "--seconds", "0.5", "--root", tiny_root,
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    run_line, line = [json.loads(x) for x in
                      out.stdout.strip().splitlines()[-2:]]
    assert run_line["correct"] is True and "frame_ms.bulk" in run_line[
        "metrics"]
    got = line["metrics"]
    assert set(got) == {n for n in sp.NUMBERS if n.endswith(".bulk")} - {
        "idle_in_frame_loop.bulk", "idle_in_logp_host.bulk",
        "am_span_ms_per_audio_s.bulk"}
    assert got["decode_retries.bulk"]["value"] == 0.0
    assert 0 < got["lane_fill.bulk"]["value"] <= 100
    assert got["setup_program_s.bulk"]["value"] > 0
    # within the host time of the whole decode, as the harness times it
    assert 0 < got["frame_loop_host_ms.bulk"]["value"] <= \
        run_line["metrics"]["frame_ms.bulk"]["value"]
    assert line["spans_in_window"]["logp"] == \
        line["spans_in_window"]["decode"] > 0


def test_a_live_run_with_the_programs_spans(tiny_root):
    """The live cell (measured, not held) through the same run: the tick's
    split into decode and partials."""
    out = subprocess.run(
        [sys.executable, "-m", "asrbench.spans", "--workload",
         "live-streams", "--seed", "2147483911", "--seconds", "1",
         "--root", tiny_root, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    run_line, line = [json.loads(x) for x in
                      out.stdout.strip().splitlines()[-2:]]
    assert run_line["correct"] is True
    tick = run_line["metrics"]["tick_ms.live"]["value"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == {"tick_decode_ms.live", "tick_partials_ms.live",
                        "setup_program_s.live"}
    assert 0 < got["tick_decode_ms.live"] + got["tick_partials_ms.live"] \
        <= tick
    assert line["spans_in_window"]["tick.step"] == \
        line["spans_in_window"]["tick.partials"] > 0
