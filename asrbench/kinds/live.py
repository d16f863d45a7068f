"""Live traffic: open-loop live transcription from independent users.

`streams` concurrent streams of one `Recognizer.create_stream_batch`:
each pushes one chunk of 16-bit PCM noise every chunk period of wall
time, for the whole window.  Every seed offers the same streams (their
audio drawn from the traffic's `content_seed`) and the same set of
phases, evenly spaced over the period; the seed deals the phases.
The harness feeds every chunk that is due (the program's
`process_batch`), then refreshes every stream's partial hypothesis
(`partials`); a chunk's latency runs from when its audio was due to when
the partials that decoded it are on the host.  Once the window closes the
sampled streams end (`end_of_stream`, `best_path`).

Traffic parameters: streams, period_s, pcm_rms, sample_streams,
content_seed.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from asrbench import counts, gen, judge, ref, system
from asrbench.harness import (Check, Ctx, Outcome, freeze_setup, host_pace,
                              memory_peak, profiled, reset_memory,
                              seed_sample, window_notes)
from asrbench.kinds.bulk import build_model


def run(ctx: Ctx) -> Outcome:
    t = ctx.traffic
    dc = ctx.config["decoder"]
    n = t["streams"]
    period = t["period_s"]
    chunk = int(round(period * 16000))
    reset_memory(ctx)
    graph, _, layers, left, right = build_model(ctx)
    np_layers = gen.as_numpy_layers(layers)
    conf = system.write_model_dir(f"{ctx.scratch}/model", graph, np_layers,
                                  left, right, dc)
    rec, am_scale = system.recognizer(conf, ctx.device)
    chunks_max = int(ctx.seconds / period) + 2
    rng = gen.rng_for(t["content_seed"], "pcm")
    pcm = [gen.pcm_noise(rng, chunks_max * chunk, t["pcm_rms"])
           for _ in range(n)]
    phases = gen.live_phases(gen.rng_for(ctx.seed, "phase"), n, period)

    warm = rec.create_stream_batch(n)  # the first and the steady step
    for c in range(3):
        warm.process_batch([p[c * chunk:(c + 1) * chunk] for p in pcm])
        warm.partials()
    del warm
    sess = rec.create_stream_batch(n)
    ctx.sync()
    freeze_setup()
    setup_s = time.perf_counter() - ctx.t_start

    fed = np.zeros(n, np.int64)  # chunks fed per stream
    lat: List[float] = []
    lag: List[float] = []
    ticks, tick_s, stream_steps = 0, 0.0, 0
    snaps = []
    last_parts = None
    prof: dict = {}
    with window_notes(ctx), profiled(ctx, prof):
        t0 = time.perf_counter()
        due_last = np.floor((ctx.seconds - phases) / period)  # chunks due
        total = int(due_last.sum())
        while True:
            nxt = t0 + phases + (fed + 1) * period
            pending = fed < due_last
            if not pending.any():
                break
            wait = nxt[pending].min() - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            now = time.perf_counter()
            batch = [None] * n
            dues = []
            for u in np.flatnonzero(pending & (nxt <= now)):
                k = int(min(due_last[u],
                            np.floor((now - t0 - phases[u]) / period)))
                a, b = int(fed[u]), k
                batch[u] = pcm[u][a * chunk:b * chunk]
                dues += [t0 + phases[u] + (c + 1) * period
                         for c in range(a, b)]
                fed[u] = b
            before = list(sess.num_frames_decoded)
            s0 = time.perf_counter()
            if ctx.trace:
                snaps.append(sess.beam.states.clone())
            sess.process_batch(batch)
            last_parts = sess.partials()
            s1 = time.perf_counter()
            adv = np.array(sess.num_frames_decoded) - np.array(before)
            if ctx.trace:
                snaps[-1] = (snaps[-1], adv)
            ticks += 1
            tick_s += s1 - s0
            stream_steps += int((adv // 20).sum())
            lat += [s1 - d for d in dues]
            lag += [now - d for d in dues]
        window = time.perf_counter() - t0
    peak = memory_peak(ctx)
    decoded = [due_frames(int(f) * chunk, right) for f in fed]
    lat_ms = np.array(lat) * 1e3
    q = _quantiles(lat_ms)
    e2e = {"chunk_latency_p50_ms": q[0], "chunk_latency_p95_ms": q[1],
           "setup_s": setup_s}
    pct = np.percentile(lat_ms, [90, 99, 99.9]).tolist()
    ctx.note(f"# generator lag ms: p50 {float(np.percentile(lag, 50)) * 1e3!r}"
             f" p95 {float(np.percentile(lag, 95)) * 1e3!r}"
             f" max {float(max(lag)) * 1e3!r}; chunks {len(lat)} of {total}; "
             f"ticks {ticks}; window_s {window!r}; latency ms p90, p99, "
             f"p99.9 {pct!r}; chunks over 200 ms "
             f"{int((lat_ms > 200).sum())}")

    records = {}
    if ctx.trace:
        gc = counts.GraphCounts(graph, ctx.device)
        census = counts.FrameCensus(gc)
        frames = 0
        for states, adv in snaps:
            steps = adv // 20
            for k in range(1, int(steps.max(initial=0)) + 1):
                valid = torch.as_tensor(steps >= k, device=ctx.device)
                census.frame(states, states, valid, states, copies=20)
            frames += int(adv.sum())
        del snaps
        records = {
            "kind": "live", "window_s": window, "ticks": ticks,
            "tick_s": tick_s, "stream_steps": stream_steps,
            "am_flops": frames * counts.am_flops_per_frame(layers),
            "bytes": census.totals(), "trace": prof, "peaks": ctx.peaks,
        }

        ctx.note(f"# device ops by raw name: {prof.get('raw_top')!r}")
    t_ref = time.perf_counter()
    sample = seed_sample(ctx.seed, n, t["sample_streams"], "sample")
    finals = {}
    for u in sample:
        sess.end_of_stream(u)
        finals[u] = sess.best_path(u, True)
    checks = [Check("cost_gap", live_gap(
        ctx, sample, pcm, fed, chunk, decoded, last_parts, finals, layers,
        left, right, graph, am_scale), ctx.limits["cost_gap"])]
    ctx.note(f"# seconds: setup {setup_s!r} window {window!r} reference "
             f"{time.perf_counter() - t_ref!r}")
    host_pace(ctx)
    return Outcome(e2e=e2e, records=records, checks=checks,
                   attempted=total, failed=total - len(lat),
                   memory_peak=peak, busy_s=prof.get("busy_s"),
                   window_s=window,
                   breakdown=({"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
                              if prof else None))


def due_frames(samples: int, right: int, step: int = 20) -> int:
    """Frames a live stream must have decoded once `samples` are in: whole
    steps of 20, the first of which also needs the AM's right context."""
    avail = ref.num_frames(samples)
    return step * ((avail - right) // step) if avail >= step + right else 0


def _quantiles(x: np.ndarray):
    """(median, 95th percentile), Python's exclusive quantiles."""
    from statistics import quantiles

    qs = quantiles(x.tolist(), n=100)
    return float(np.median(x)), float(qs[94])


def live_gap(ctx, sample, pcm, fed, chunk, decoded, parts, finals, layers,
             left, right, graph, am_scale) -> float:
    """The widest `judge.live_gaps` over the sampled streams (their last
    partial in the window and their final hypothesis); infinite if any
    stream's last partial is still the start hypothesis though frames were
    due."""
    dc = ctx.config["decoder"]
    waves = [pcm[u][:int(fed[u]) * chunk] for u in sample]
    logps = ref.am_logp(layers, waves, left, right, graph.num_pdfs,
                        ctx.device)
    rg = ref.Graph(graph)
    frames = [decoded[u] for u in sample]
    gaps = judge.live_gaps(
        rg, [(list(parts[u].words), float(parts[u].weight)) for u in sample],
        [(list(finals[u].words), float(finals[u].weight)) for u in sample],
        logps, frames, am_scale, dc["beam_size"], dc["beam"], ctx.device)
    for u, part in enumerate(parts):
        # A stream with frames due whose partial is still the empty start
        # hypothesis was left out.
        if decoded[u] and not part.words and part.weight == 0.0:
            gaps.append(float("inf"))
    if ctx.control:
        # The reference in the program's place, a precision lower: its
        # pruned search over TF32 log-likelihoods with bfloat16 sums.
        low = ref.am_logp(layers, waves, left, right, graph.num_pdfs,
                          ctx.device, "tf32")
        rows = [x[:n] for x, n in zip(low, frames)] + low
        c, h, fc, fh = ref.beam_search(
            rg, rows, frames + [x.shape[0] for x in low], am_scale,
            dc["beam_size"], dc["beam"], ctx.device, "bfloat16")
        k = len(sample)
        # Judged as the program's answers are, its words by their hash.
        ctl = judge.live_gaps(
            rg, [(int(x), float(y)) for x, y in zip(h[:k], c[:k])],
            [(int(x), float(y)) if np.isfinite(y) else (0, 0.0)
             for x, y in zip(fh[k:], fc[k:])], logps, frames, am_scale,
            dc["beam_size"], dc["beam"], ctx.device)
        ctx.control_readings["cost_gap"] = float(max(ctl))
    return float(max(gaps))
