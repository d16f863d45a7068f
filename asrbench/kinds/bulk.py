"""Bulk traffic: closed-loop offline batch transcription, as
`catears <conf> <scp> --batch=16` runs it.

Set-up makes a pool of batches: the traffic's utterances, the same for
every seed (lengths the quantiles of a log-normal, 16 kHz noise waves,
planted pseudo-likelihood paths on the card, all from its
`content_seed`), dealt into batches in an order drawn from the run's
seed.  The timed path per batch is the
program's `batched_logp` (fbank + AM from the host waves), the planted
add (planted + mix * AM, as the earlier records ran it), and
`BatchDecoder.decode(..., final_fallback=True)` to words on the host.
The window is the fewest whole passes over the pool that last at least
`--seconds`; `bulk_xrt` is their audio over their wall time.

Traffic parameters: batch, pool_batches, length_s {mean, sigma, min,
max}, wave_rms, plant {amp, mix, dur}, sample, content_seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from asrbench import counts, gen, judge, ref, system
from asrbench.harness import (Check, Ctx, DeviceTimer, Outcome,
                              freeze_setup, host_pace, memory_peak, profiled,
                              reset_memory, seed_sample, window_notes)


@dataclass
class Batch:
    waves: List[np.ndarray]
    lengths: List[int]
    planted: torch.Tensor  # [B, T_max, P] on the card
    truth: List[List[int]]
    audio_s: float


def build_model(ctx: Ctx):
    """(graph, G' or None, TDNN layers on the device, left, right).  The
    graph and G' are the configuration's deployment, drawn from its
    `model_seed` (0: the trie of the earlier records); the TDNN's weights
    come from the run's seed."""
    c = ctx.config
    graph = gen.make_trie_graph(np.random.RandomState(c["model_seed"]),
                                **_tuples(c["graph"]))
    big = (gen.make_big_lm(gen.rng_for(c["model_seed"], "lm"), **c["lm"])
           if c.get("lm") else None)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, "weights"))
    a = c["am"]
    layers = gen.tdnn_device(g, ctx.device, a["feat_dim"], a["hidden"],
                             graph.num_pdfs, a["layers"],
                             tuple(a["context"]))
    left, right = gen.tdnn_context(layers)
    return graph, big, layers, left, right


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def make_pool(ctx: Ctx, graph) -> List[Batch]:
    """The traffic's utterances (the same for every seed: drawn from its
    `content_seed`), dealt into batches in the run's seed's order."""
    t = ctx.traffic
    ln, plant = t["length_s"], t["plant"]
    lengths = np.sort(gen.quantile_lengths(
        t["batch"] * t["pool_batches"], ln["mean"], ln["sigma"], ln["min"],
        ln["max"]))
    content = t["content_seed"]
    rng_w = gen.rng_for(content, "waves")
    rng_p = gen.rng_for(content, "plant")
    utts = []
    for i, secs in enumerate(lengths):
        wave = gen.pcm_noise(rng_w, int(round(secs * 16000)), t["wave_rms"])
        n = ref.num_frames(wave.size)
        targets, words = gen.plant_targets(rng_p, graph, n,
                                           tuple(plant["dur"]))
        g = torch.Generator(device=ctx.device)
        g.manual_seed(gen.torch_seed(content, f"noise{i}"))
        planted = gen.plant_device([targets], graph.num_pdfs, plant["amp"],
                                   g, ctx.device)[0]
        utts.append((wave, n, planted, words))
    pool = []
    for idx in gen.stratified_batches(gen.rng_for(ctx.seed, "deal"),
                                      len(utts), t["pool_batches"]):
        members = [utts[i] for i in idx]
        t_max = max(m[1] for m in members)
        planted = torch.stack([torch.nn.functional.pad(
            m[2], (0, 0, 0, t_max - m[1])) for m in members])
        pool.append(Batch([m[0] for m in members], [m[1] for m in members],
                          planted, [m[3] for m in members],
                          sum(m[0].size for m in members) / 16000.0))
    return pool


def run(ctx: Ctx) -> Outcome:
    c, t = ctx.config, ctx.traffic
    dc = c["decoder"]
    mix = t["plant"]["mix"]
    reset_memory(ctx)
    graph, big, layers, left, right = build_model(ctx)
    np_layers = gen.as_numpy_layers(layers)
    am = system.acoustic_model(np_layers, left, right, graph.num_pdfs,
                               graph.tid2pdf, ctx.device)
    dlm = system.delta_lm(big) if big is not None else None
    dec = system.batch_decoder(graph, dc, dlm, ctx.device)
    pool = make_pool(ctx, graph)

    am_host = [0.0]  # host seconds inside `batched_logp` calls

    def step(batch: Batch, am_timer=None, dec_times=None):
        h0 = time.perf_counter()
        if am_timer is not None:
            with am_timer.span():
                am_lp, lengths = system.batched_logp(am, batch.waves)
        else:
            am_lp, lengths = system.batched_logp(am, batch.waves)
        am_host[0] += time.perf_counter() - h0
        with torch.no_grad():
            logp = batch.planted + mix * am_lp
        if dec_times is not None:
            ctx.sync()
            t0 = time.perf_counter()
        hyps = dec.decode(logp, lengths, final_fallback=True)
        if dec_times is not None:
            dec_times.append(time.perf_counter() - t0)
        return am_lp, hyps

    for batch in pool:  # warm every shape of the window
        step(batch)
    ctx.sync()
    freeze_setup()
    setup_s = time.perf_counter() - ctx.t_start

    keep = seed_sample(ctx.seed, len(pool), 1, "keep")[0]
    last_hyps: List = [None] * len(pool)
    kept_am = None
    runs = [0] * len(pool)
    am_timer = DeviceTimer(ctx) if ctx.trace else None
    dec_times: List[float] = [] if ctx.trace else None
    prof: dict = {}
    audio = 0.0
    with window_notes(ctx), profiled(ctx, prof):
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        cycles, cycles_am = [], []
        while True:
            c0 = time.perf_counter()
            am_host[0] = 0.0
            for j, batch in enumerate(pool):
                am_lp, hyps = step(batch, am_timer, dec_times)
                last_hyps[j] = hyps
                runs[j] += 1
                audio += batch.audio_s
                if j == keep:
                    kept_am = am_lp
                del am_lp
            cycles.append(time.perf_counter() - c0)
            cycles_am.append(am_host[0])
            if time.perf_counter() >= deadline:
                break
        window = time.perf_counter() - t0
    peak = memory_peak(ctx)
    attempted = sum(runs[j] * len(b.waves) for j, b in enumerate(pool))
    e2e = {"bulk_xrt": audio / window, "setup_s": setup_s}

    records = {}
    t_after = time.perf_counter()
    if ctx.trace:
        frames = [max(b.lengths) for b in pool]
        valid = [sum(b.lengths) for b in pool]
        census = replay_counts(ctx, dec, pool, mix, am, graph, big)
        records = {
            "kind": "bulk", "lm": big is not None, "window_s": window,
            "audio_s": audio,
            "frames_stepped": sum(r * f for r, f in zip(runs, frames)),
            "decode_s": sum(dec_times), "am_s": am_timer.seconds(),
            "am_flops": sum(r * v for r, v in zip(runs, valid))
            * counts.am_flops_per_frame(layers),
            "bytes": {k: sum(r * cb[k] for r, cb in zip(runs, census))
                      for k in census[0]},
            "trace": prof, "peaks": ctx.peaks,
        }
        ctx.note(f"# device ops by raw name: {prof.get('raw_top')!r}")
    t_ref = time.perf_counter()
    checks = compare(ctx, pool, last_hyps, kept_am, keep, layers, left,
                     right, graph, big, dc["am_scale"], mix)
    ctx.note(f"# seconds a pass over the pool: {cycles!r}; of which the "
             f"host was inside batched_logp: {cycles_am!r}")
    host_pace(ctx)
    ctx.note(f"# seconds: setup {setup_s!r} window {window!r} counts "
             f"{t_ref - t_after!r} reference {time.perf_counter() - t_ref!r}")
    return Outcome(e2e=e2e, records=records, checks=checks,
                   attempted=attempted, failed=0, memory_peak=peak,
                   busy_s=prof.get("busy_s"), window_s=window,
                   breakdown=({"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
                              if prof else None))


def replay_counts(ctx: Ctx, dec, pool, mix, am, graph, big) -> List[dict]:
    """Each pool batch's decoder bytes: the batch decoded again through the
    decoder's frame loop one frame at a time, the beam read at every frame
    boundary (after the window; it times nothing)."""
    init_beam_batch, decode_chunk = system.decode_layer()
    gc = counts.GraphCounts(graph, ctx.device)
    lm_walk = counts.LmWalk(big, ctx.device) if big is not None else None
    out = []
    with torch.no_grad():
        for batch in pool:
            am_lp, lengths = system.batched_logp(am, batch.waves)
            logp = (batch.planted + mix * am_lp).transpose(0, 1)
            del am_lp
            b = len(lengths)
            beam, _ = init_beam_batch(dec.cfg, b, dec.dfst, dec.dlm)
            lens = torch.as_tensor(lengths, device=ctx.device)
            census = counts.FrameCensus(gc, lm_walk)
            for f in range(logp.shape[0]):
                valid = f < lens
                new, _ = decode_chunk(dec.cfg, dec.dfst, beam, logp[f:f + 1],
                                      valid[None], dec.dlm)
                census.frame(beam.states, beam.lm, valid, new.states)
                beam = new
            out.append(census.totals())
            del logp
    return out


def compare(ctx: Ctx, pool, last_hyps, kept_am, keep, layers, left, right,
            graph, big, am_scale, mix) -> List[Check]:
    """`logp_err`: the widest gap between the kept batch's AM
    log-likelihoods (the window's own output) and the reference's;
    `cost_gap`: over a sample of the pool's utterances (their last decode
    in the window), the widest `judge.bulk_gaps`, and over all of them the
    widest `judge.floor_excess`."""
    batch = pool[keep]
    ref_am = ref.am_logp(layers, batch.waves, left, right, graph.num_pdfs,
                         ctx.device)
    logp_err = max(float((kept_am[u, :n].double() - ref_am[u]).abs().max())
                   for u, n in enumerate(batch.lengths))
    del kept_am, ref_am
    rows = sample_rows(ctx, pool)
    logps = ref_logps(ctx, pool, rows, layers, left, right, graph, mix)
    answers = [(list(last_hyps[j][u].words), float(last_hyps[j][u].weight))
               for j, u in rows]
    truths = [pool[j].truth[u] for j, u in rows]
    rg = ref.Graph(graph)
    lm = ref.DeltaLm(big) if big is not None else None
    rg.check_floor(lm)
    gaps = judge.bulk_gaps(rg, lm, answers, truths, logps, am_scale,
                           ctx.device)
    for j, b in enumerate(pool):  # every utterance above the cost floor
        for u, lp in enumerate(ref_logps(ctx, pool, [(j, x) for x in range(
                len(b.waves))], layers, left, right, graph, mix)):
            gaps.append(judge.floor_excess(rg, lp, b.lengths[u], am_scale,
                                           float(last_hyps[j][u].weight)))
    if ctx.control:
        ctx.control_readings.update(control(
            ctx, pool, rows, layers, left, right, graph, rg, lm, truths,
            logps, am_scale, mix))
    return [Check("logp_err", logp_err, ctx.limits["logp_err"]),
            Check("cost_gap", float(max(gaps)), ctx.limits["cost_gap"])]


def sample_rows(ctx: Ctx, pool) -> List:
    """(batch, utterance) of the sampled utterances: the traffic's
    `sample` of them drawn from the seed, and the longest."""
    flat = [(j, u) for j, b in enumerate(pool) for u in range(len(b.waves))]
    pick = set(seed_sample(ctx.seed, len(flat), ctx.traffic["sample"] - 1,
                           "sample"))
    pick.add(max(range(len(flat)),
                 key=lambda i: pool[flat[i][0]].lengths[flat[i][1]]))
    return [flat[i] for i in sorted(pick)]


def ref_logps(ctx: Ctx, pool, rows, layers, left, right, graph, mix,
              precision: str = "float64") -> List[torch.Tensor]:
    """The reference's log-likelihoods of the sampled utterances:
    planted + mix * its own AM."""
    am = ref.am_logp(layers, [pool[j].waves[u] for j, u in rows], left,
                     right, graph.num_pdfs, ctx.device, precision)
    return [pool[j].planted[u, :pool[j].lengths[u]].double()
            + mix * a.double() for (j, u), a in zip(rows, am)]


def control(ctx, pool, rows, layers, left, right, graph, rg, lm, truths,
            logps, am_scale, mix) -> dict:
    """The reference in the program's place, a precision lower: the AM
    with TF32 matmuls (its `logp_err` against the float64 AM), and the
    planted words' costs, ending anywhere, summed in bfloat16 as the
    answers (their `cost_gap`)."""
    j = seed_sample(ctx.seed, len(pool), 1, "keep")[0]
    waves = pool[j].waves
    a64 = ref.am_logp(layers, waves, left, right, graph.num_pdfs, ctx.device)
    a32 = ref.am_logp(layers, waves, left, right, graph.num_pdfs, ctx.device,
                      "tf32")
    logp_err = max(float((x.double() - y).abs().max())
                   for x, y in zip(a32, a64))
    low = ref_logps(ctx, pool, rows, layers, left, right, graph, mix, "tf32")
    jobs = [ref.Job(i, t, False) for i, t in enumerate(truths)]
    cost = ref.align(rg, jobs, low, am_scale, ctx.device, "bfloat16")
    answers = []
    for t, c in zip(truths, cost):
        total = c + (lm.cost(t, False) if lm is not None else 0.0)
        answers.append((t, float(torch.tensor(total).to(torch.bfloat16))))
    gaps = judge.bulk_gaps(rg, lm, answers, truths, logps, am_scale,
                           ctx.device)
    return {"logp_err": logp_err, "cost_gap": float(max(gaps))}
