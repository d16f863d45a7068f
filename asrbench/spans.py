"""The program's own spans (`catears_tpu_torch.utils.log`) beside the
card's timeline: what the host was doing in each idle gap of a traced
window, and the per-layer numbers that only spans inside the program give.

    python3 -m asrbench.spans --workload bulk-lmoff --seed <n> --seconds <s>

runs the cell's traced run (`asrbench.run --trace 1`) with the program's
tracing switched on from before set-up to the end of the window, prints
the run's own last line, then one line of its own: the numbers below, the
idle seconds by the innermost span the host was in (`idle_by_span`;
`harness` outside every span), the ten longest idle gaps labelled `before
<device op> in <span>`, and `causality`, the batches whose first
host-to-device copy after the previous decode began before their `logp`
span: 0 where the spans and the profiler share a clock.  The harness as it
stands switches no program tracing on, so the run reaches its profiler and
its device operations through two hooks set here (`harness.profiled` and
`trace.reduce`), which change nothing of what the run measures.

The numbers (`NUMBERS`), each from spans that started inside the window
unless said otherwise, computed from `records`: `spans` (as `span_dict`
gives them), `window_ns` (the window's first and last ns on the spans'
clock) and `idle_by_span`:
- `frame_loop_host_ms.bulk`: host ms in `decode.frames` spans over the
  frames they stepped (what a CUDA graph over the frame step removes);
- `idle_in_frame_loop.bulk`, `idle_in_logp_host.bulk`: % of the window
  in which the card was idle while the host was in `decode.frames`, in
  `logp.host`;
- `am_span_ms_per_audio_s.bulk`: the `logp` spans' CUDA-event ms over
  their audio seconds;
- `lane_fill.bulk`: the mean over the decodes of the most CSR lanes one
  frame needed (hiwater slot 0) over the lanes `frame_expand` and
  `frame_select` are launched over, in %;
- `decode_retries.bulk`: % of the decodes that overflowed and ran again;
- `setup_program_s.bulk`: seconds in the top-level `setup.*` spans before
  the window;
- `tick_decode_ms.live`, `tick_partials_ms.live`: a live tick's host ms
  in `tick.decode` (the fused steps' decode), in `tick.partials`, over
  the window's ticks (`tick.step` spans); `setup_program_s.live` as the
  bulk one.
A run reports the numbers named after its traffic's kind, those it finds
spans for.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

HARNESS = "harness"


def span_dict(s) -> dict:
    """A `log.Span` as plain data."""
    return {"name": s.name, "id": s.id, "parent": s.parent, "seq": s.seq,
            "start_ns": s.start_ns, "end_ns": s.end_ns,
            "attrs": dict(s.attrs), "device_s": s.device_s}


def innermost(spans: List[dict], t0: float,
              t1: float) -> List[Tuple[float, float, str]]:
    """(start ns, end ns, name) pieces covering [t0, t1], each named by
    the innermost span the host was in (the latest started of those open),
    or `harness`."""
    events = []
    for s in spans:
        if s["end_ns"] is None:
            continue
        a, b = max(s["start_ns"], t0), min(s["end_ns"], t1)
        if a < b:
            events += [(a, 1, s["start_ns"], s["id"], s["name"]),
                       (b, 0, s["start_ns"], s["id"], s["name"])]
    events.sort()  # at one instant, ends before starts
    pieces, open_, prev = [], [], t0
    for t, starts, begun, sid, name in events:
        if t > prev:
            pieces.append((prev, t, max(open_)[2] if open_ else HARNESS))
            prev = t
        if starts:
            open_.append((begun, sid, name))
        else:
            open_.remove((begun, sid, name))
    if t1 > prev:
        pieces.append((prev, t1, HARNESS))
    return pieces


def idle_intervals(ops, t0: float, t1: float) -> List[Tuple[float, float,
                                                            str]]:
    """(start ns, end ns, the device op that ended it) of every stretch of
    [t0, t1] in which no device operation ran; `ops` as
    `trace.device_ops` gives them (us)."""
    out, covered = [], t0
    for name, start, end, _ in sorted(ops, key=lambda x: x[1]):
        a, b = start * 1e3, end * 1e3
        if a > covered:
            out.append((covered, min(a, t1), name))
        covered = max(covered, b)
        if covered >= t1:
            break
    if covered < t1:
        out.append((covered, t1, "(window end)"))
    return [x for x in out if x[1] > x[0]]


def split_idle(idle, pieces) -> List[Dict[str, float]]:
    """For each idle interval, its seconds by span name."""
    out, j = [], 0
    for a, b, _ in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        share: Dict[str, float] = {}
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                share[pieces[k][2]] = share.get(pieces[k][2], 0.0) + \
                    (hi - lo) / 1e9
            k += 1
        out.append(share)
    return out


def attribute(ops, spans: List[dict], t0: float, t1: float) -> Dict:
    """`idle_by_span` (seconds by span name) and the ten longest idle gaps
    between device operations, each `before <op> in <span>` (the span
    holding most of it)."""
    from asrbench.trace import short_name

    idle = idle_intervals(ops, t0, t1)
    shares = split_idle(idle, innermost(spans, t0, t1))
    by_span: Dict[str, float] = {}
    for share in shares:
        for name, secs in share.items():
            by_span[name] = by_span.get(name, 0.0) + secs
    gaps = sorted(((b - a) / 1e9, op, max(share, key=share.get))
                  for (a, b, op), share in zip(idle, shares)
                  if share and op != "(window end)" and a > t0)[::-1][:10]
    return {"idle_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1])),
            "idle_gaps": [[f"before {short_name(op)} in {where}", secs]
                          for secs, op, where in gaps]}


def causality(ops, spans: List[dict], t0: float, t1: float) -> int:
    """Batches whose first host-to-device copy after the previous
    top-level span (or the window's start) began before their `logp`
    span did: each batch's waves are uploaded from inside it."""
    copies = sorted(start * 1e3 for name, start, _, _ in ops
                    if "HtoD" in name)
    bad, after = 0, t0
    for s in sorted(_tops(spans, t0, t1), key=lambda s: s["start_ns"]):
        if s["name"] == "logp":
            i = bisect.bisect_left(copies, after)
            if i < len(copies) and copies[i] < s["start_ns"]:
                bad += 1
        after = s["end_ns"] if s["end_ns"] is not None else after
    return bad


def _tops(spans: List[dict], t0: float, t1: float) -> List[dict]:
    """The top-level spans that started inside [t0, t1]."""
    return [s for s in spans if s["parent"] is None
            and t0 <= s["start_ns"] <= t1]


def _in_window(rec: dict, name: str) -> List[dict]:
    t0, t1 = rec["window_ns"]
    return [s for s in rec["spans"]
            if s["name"] == name and t0 <= s["start_ns"] <= t1]


def frame_loop_host_ms(rec: dict) -> Optional[float]:
    spans = _in_window(rec, "decode.frames")
    frames = sum(s["attrs"]["frames"] for s in spans)
    if not frames:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / frames


def _idle_share(rec: dict, name: str) -> Optional[float]:
    if not rec.get("idle_by_span"):
        return None
    t0, t1 = rec["window_ns"]
    return 100.0 * rec["idle_by_span"].get(name, 0.0) * 1e9 / (t1 - t0)


def idle_in_frame_loop(rec: dict) -> Optional[float]:
    return _idle_share(rec, "decode.frames")


def idle_in_logp_host(rec: dict) -> Optional[float]:
    return _idle_share(rec, "logp.host")


def am_span_ms_per_audio_s(rec: dict) -> Optional[float]:
    spans = [s for s in _in_window(rec, "logp") if s["device_s"] is not None]
    audio = sum(s["attrs"]["audio_s"] for s in spans)
    if not audio:
        return None
    return 1e3 * sum(s["device_s"] for s in spans) / audio


def lane_fill(rec: dict) -> Optional[float]:
    fills = [s["attrs"]["hiwater"][0] / s["attrs"]["lanes"]
             for s in _in_window(rec, "decode")
             if s["attrs"].get("lanes") and "hiwater" in s["attrs"]]
    if not fills:
        return None
    return 100.0 * sum(fills) / len(fills)


def decode_retries(rec: dict) -> Optional[float]:
    decodes = _in_window(rec, "decode")
    if not decodes:
        return None
    retried = {s["parent"] for s in _in_window(rec, "decode.retry")}
    return 100.0 * sum(s["id"] in retried for s in decodes) / len(decodes)


def setup_program_s(rec: dict) -> Optional[float]:
    t0 = rec["window_ns"][0]
    spans = [s for s in rec["spans"] if s["parent"] is None
             and s["name"].startswith("setup.") and s["start_ns"] < t0]
    if not spans:
        return None
    return sum(min(s["end_ns"], t0) - s["start_ns"] for s in spans) / 1e9


def _per_tick_ms(rec: dict, name: str) -> Optional[float]:
    ticks = len(_in_window(rec, "tick.step"))
    if not ticks:
        return None
    return sum(s["end_ns"] - s["start_ns"]
               for s in _in_window(rec, name)) / 1e6 / ticks


def tick_decode_ms(rec: dict) -> Optional[float]:
    return _per_tick_ms(rec, "tick.decode")


def tick_partials_ms(rec: dict) -> Optional[float]:
    return _per_tick_ms(rec, "tick.partials")


NUMBERS = {
    "frame_loop_host_ms.bulk": (frame_loop_host_ms, "ms"),
    "idle_in_frame_loop.bulk": (idle_in_frame_loop, "%"),
    "idle_in_logp_host.bulk": (idle_in_logp_host, "%"),
    "am_span_ms_per_audio_s.bulk": (am_span_ms_per_audio_s, "ms/audio_s"),
    "lane_fill.bulk": (lane_fill, "%"),
    "decode_retries.bulk": (decode_retries, "%"),
    "setup_program_s.bulk": (setup_program_s, "s"),
    "setup_program_s.live": (setup_program_s, "s"),
    "tick_decode_ms.live": (tick_decode_ms, "ms"),
    "tick_partials_ms.live": (tick_partials_ms, "ms"),
}


class _Hooks:
    """The traced run's profiler block and device operations, reached by
    wrapping `harness.profiled` (the window's first and last ns on the
    spans' clock, taken inside the profiler's block) and `trace.reduce`
    (the operations it reduces)."""

    def __init__(self):
        self.ops: list = []
        self.window: Optional[Tuple[int, int]] = None

    @contextlib.contextmanager
    def installed(self):
        from asrbench import harness, trace

        real_profiled, real_reduce = harness.profiled, trace.reduce

        @contextlib.contextmanager
        def profiled(ctx, out):
            with real_profiled(ctx, out):
                t0 = time.time_ns()
                yield
                self.window = (t0, time.time_ns())

        def reduce(ops):
            self.ops = list(ops)
            return real_reduce(ops)

        harness.profiled, trace.reduce = profiled, reduce
        try:
            yield self
        finally:
            harness.profiled, trace.reduce = real_profiled, real_reduce


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from asrbench import manifest, run

    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    cell = manifest.workload(manifest.load(root), args.workload)
    kind = manifest.traffic(manifest.data_dir(root), cell["traffic"])["kind"]
    rest = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", "1",
            "--device", args.device, "--root", root]
    from catears_tpu_torch.utils import log

    if not hasattr(log, "start_tracing"):
        print("asrbench.spans: this checkout's program records no spans",
              file=sys.stderr)
        return 2
    with _Hooks().installed() as hooks:
        log.start_tracing()
        try:
            rc = run.main(rest)
        finally:
            log.stop_tracing()
    if rc != 0 or hooks.window is None:
        return rc or 1
    t0, t1 = hooks.window
    spans = [span_dict(s) for s in log.spans()]
    rec = {"spans": spans, "window_ns": [t0, t1]}
    if hooks.ops:
        rec.update(attribute(hooks.ops, spans, t0, t1))
    line = {"metrics": {}}
    for name, (fn, unit) in NUMBERS.items():
        value = fn(rec) if name.endswith("." + kind) else None
        if value is not None:
            line["metrics"][name] = {"value": value, "unit": unit}
    if hooks.ops:
        line.update(idle_by_span=rec["idle_by_span"],
                    idle_gaps=rec["idle_gaps"],
                    causality=causality(hooks.ops, spans, t0, t1))
    tops: Dict[str, int] = {}
    for s in _tops(spans, t0, t1):
        tops[s["name"]] = tops.get(s["name"], 0) + 1
    line.update(window_s=(t1 - t0) / 1e9, spans_in_window=tops)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
