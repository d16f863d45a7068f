"""Bulk traffic on a chain model: closed-loop offline batch transcription
with Kaldi's TDNN-F, as `catears <conf> <scp> --batch=16 --ivectors=...`
runs it.

`bulk.py`'s traffic, pool and window, with what a chain model changes:
each utterance carries its i-vector (drawn from the traffic's
`content_seed`), the AM gives one row every `frame_subsampling_factor`
frames (30 ms), the planted pseudo-likelihood paths follow the chain
topology at that rate (`chain_gen.plant_chain_targets`) and are scaled by
`plant.scale`, and the decoder runs at the configuration's acoustic scale.
The timed path per batch is the program's `batched_logp(am, waves,
ivectors)`, the planted add (planted + mix * AM), and
`BatchDecoder.decode(..., final_fallback=True)`; `bulk_xrt` is the
window's audio over its wall time.

A traced run switches the program's tracing on for the window (spans and
counters, `chain_system`) and records what the `.chain` metrics read: the
`logp` spans' and `decode.frames` spans' CUDA-event seconds, the counters
`am_flops`, `am_rows_full_rate`, `am_rows_subsampled` and
`overflow_retries` over the window, the planned FLOPs
(`chain_counts`), and the decoder's bytes as `bulk.py` counts them, with
the beam's occupancy (mean and peak live tokens over `beam_size`, over
the valid rows and frames) beside them.  `correct` compares the kept
batch's AM output with `chain_ref` in float64 (`logp_err`) and sampled
decodes with `ref.align`'s exact costs, as `bulk.py` does, or, where the
configured pruned search loses the planted path, with that search's own
answer (`cost_gap`, `chain_gaps`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from asrbench import (chain_counts, chain_gen, chain_ref, chain_system,
                      counts, gen, judge, ref, system)
from asrbench.harness import (Check, Ctx, Outcome, freeze_setup, host_pace,
                              memory_peak, profiled, reset_memory,
                              seed_sample, window_notes)
from asrbench.kinds.bulk import _tuples, sample_rows


@dataclass
class Batch:
    waves: List[np.ndarray]
    ivectors: np.ndarray  # [B, dim]
    lengths: List[int]  # output rows (30 ms) of each utterance
    planted: torch.Tensor  # [B, R_max, P] on the card
    truth: List[List[int]]
    audio_s: float


def build_model(ctx: Ctx):
    """(graph, TDNN-F model dict on the device): the graph is the
    configuration's deployment, drawn from its `model_seed`; the weights
    come from the run's seed, lda's standardization from noise at the
    traffic's level (`chain_gen.feature_stats`)."""
    c = ctx.config
    graph_cfg = {k: v for k, v in c["graph"].items() if k != "topology"}
    graph = chain_gen.make_chain_graph(
        np.random.RandomState(c["model_seed"]), **_tuples(graph_cfg))
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, "weights"))
    stats = chain_gen.feature_stats(
        gen.rng_for(ctx.traffic["content_seed"], "lda"),
        ctx.traffic["wave_rms"], c["am"])
    return graph, chain_gen.tdnnf_device(g, ctx.device, c["am"],
                                         graph.num_pdfs, stats)


def make_pool(ctx: Ctx, graph) -> List[Batch]:
    """The traffic's utterances and i-vectors (the same for every seed),
    dealt into batches in the run's seed's order."""
    t, am = ctx.traffic, ctx.config["am"]
    ln, plant = t["length_s"], t["plant"]
    f = am["frame_subsampling_factor"]
    n_utts = t["batch"] * t["pool_batches"]
    lengths = np.sort(gen.quantile_lengths(n_utts, ln["mean"], ln["sigma"],
                                           ln["min"], ln["max"]))
    content = t["content_seed"]
    rng_w = gen.rng_for(content, "waves")
    rng_p = gen.rng_for(content, "plant")
    ivs = chain_gen.ivectors(gen.rng_for(content, "ivectors"), n_utts,
                             am["ivector_dim"])
    utts = []
    for i, secs in enumerate(lengths):
        wave = gen.pcm_noise(rng_w, int(round(secs * 16000)), t["wave_rms"])
        n = -(-ref.num_frames(wave.size) // f)
        targets, words = chain_gen.plant_chain_targets(
            rng_p, graph, n, tuple(plant["dur"]))
        g = torch.Generator(device=ctx.device)
        g.manual_seed(gen.torch_seed(content, f"noise{i}"))
        planted = plant["scale"] * gen.plant_device(
            [targets], graph.num_pdfs, plant["amp"], g, ctx.device)[0]
        utts.append((wave, n, planted, words, ivs[i]))
    pool = []
    for idx in gen.stratified_batches(gen.rng_for(ctx.seed, "deal"),
                                      len(utts), t["pool_batches"]):
        members = [utts[i] for i in idx]
        r_max = max(m[1] for m in members)
        planted = torch.stack([torch.nn.functional.pad(
            m[2], (0, 0, 0, r_max - m[1])) for m in members])
        pool.append(Batch([m[0] for m in members],
                          np.stack([m[4] for m in members]),
                          [m[1] for m in members], planted,
                          [m[3] for m in members],
                          sum(m[0].size for m in members) / 16000.0))
    return pool


def run(ctx: Ctx) -> Outcome:
    chain_system.require_program()
    c, t = ctx.config, ctx.traffic
    dc, am_cfg = c["decoder"], c["am"]
    mix = t["plant"]["mix"]
    reset_memory(ctx)
    graph, model = build_model(ctx)
    am = chain_system.acoustic_model(model, am_cfg, graph.num_pdfs,
                                     graph.tid2pdf, ctx.device)
    dec = system.batch_decoder(graph, dc, None, ctx.device)
    pool = make_pool(ctx, graph)

    def step(batch: Batch):
        am_lp, lengths = chain_system.batched_logp(am, batch.waves,
                                                   batch.ivectors)
        with torch.no_grad():
            logp = batch.planted + mix * am_lp
        return am_lp, dec.decode(logp, lengths, final_fallback=True)

    for batch in pool:  # warm every shape of the window
        step(batch)
    ctx.sync()
    freeze_setup()
    setup_s = time.perf_counter() - ctx.t_start

    keep = seed_sample(ctx.seed, len(pool), 1, "keep")[0]
    last_hyps: List = [None] * len(pool)
    kept_am = None
    runs = [0] * len(pool)
    prof: dict = {}
    audio = 0.0
    before = chain_system.counters()
    if ctx.trace:
        chain_system.start_tracing()
    with window_notes(ctx), profiled(ctx, prof):
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            for j, batch in enumerate(pool):
                am_lp, hyps = step(batch)
                last_hyps[j] = hyps
                runs[j] += 1
                audio += batch.audio_s
                if j == keep:
                    kept_am = am_lp
                del am_lp
            if time.perf_counter() >= deadline:
                break
        window = time.perf_counter() - t0
    spans = chain_system.stop_tracing() if ctx.trace else []
    after = chain_system.counters()
    peak = memory_peak(ctx)
    attempted = sum(runs[j] * len(b.waves) for j, b in enumerate(pool))
    moved = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in ("am_flops", "am_rows_full_rate",
                       "am_rows_subsampled", "overflow_retries")}
    ctx.note(f"# program counters over the window: {moved!r}")

    records = {}
    t_after = time.perf_counter()
    if ctx.trace:
        valid = sum(r * sum(b.lengths) for r, b in zip(runs, pool))
        stack = chain_counts.stack_flops_per_frame(am_cfg, graph.num_pdfs)
        front = chain_counts.frontend_flops_per_frame(am_cfg)
        census, occupancy = replay_counts(ctx, dec, pool, mix, am, graph)
        frames = [s for s in spans if s.name == "decode.frames"]
        logps = [s for s in spans if s.name == "logp"]
        records = {
            "kind": "bulk_chain", "window_s": window, "audio_s": audio,
            "logp_device_s": sum(s.device_s or 0.0 for s in logps),
            "frames_device_s": sum(s.device_s or 0.0 for s in frames),
            "frames_stepped": sum(s.attrs.get("frames", 0) for s in frames),
            "program_am_flops": moved["am_flops"],
            "am_rows_subsampled": moved["am_rows_subsampled"],
            "stack_flops_per_frame": stack,
            "am_flops": valid * (stack + front),  # planned, valid rows
            "bytes": {k: sum(r * cb[k] for r, cb in zip(runs, census))
                      for k in census[0]},
            "trace": prof, "peaks": ctx.peaks,
        }
        hiwater = [s.attrs.get("hiwater") for s in spans
                   if s.name == "decode" and s.attrs.get("hiwater")]
        ctx.note(f"# beam occupancy (live tokens / beam_size over valid "
                 f"rows and frames): mean {occupancy[0]!r} peak "
                 f"{occupancy[1]!r}; decoder hiwater (emit lanes, eps, lm, "
                 f"select, cold) at most "
                 f"{[max(h[i] for h in hiwater) for i in range(5)] if hiwater else None!r}"
                 f" of lanes {next((s.attrs.get('lanes') for s in spans if s.name == 'decode'), None)!r}; "
                 f"logp spans {len(logps)}, decode.frames spans {len(frames)}")
        ctx.note(f"# window split: logp spans' device s "
                 f"{records['logp_device_s']!r}, decode.frames spans' "
                 f"device s {records['frames_device_s']!r} of the window's "
                 f"{window!r} s")
        ctx.note(f"# device ops by raw name: {prof.get('raw_top')!r}")
    t_ref = time.perf_counter()
    checks = compare(ctx, pool, last_hyps, kept_am, keep, model, graph,
                     am, dc["am_scale"], mix)
    host_pace(ctx)
    ctx.note(f"# seconds: setup {setup_s!r} window {window!r} counts "
             f"{t_ref - t_after!r} reference {time.perf_counter() - t_ref!r}")
    return Outcome(e2e={"bulk_xrt": audio / window, "setup_s": setup_s},
                   records=records, checks=checks, attempted=attempted,
                   failed=0, memory_peak=peak, busy_s=prof.get("busy_s"),
                   window_s=window,
                   breakdown=({"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
                              if prof else None))


def replay_counts(ctx: Ctx, dec, pool, mix, am, graph):
    """Each pool batch's decoder bytes (`bulk.replay_counts`: the batch
    decoded again a frame at a time, the beam read at every frame
    boundary, after the window) and the beam's (mean, peak) occupancy
    over the valid rows and frames."""
    init_beam_batch, decode_chunk = system.decode_layer()
    gc = counts.GraphCounts(graph, ctx.device)
    k = dec.cfg.beam_size
    out = []
    live = torch.zeros((), dtype=torch.float64, device=ctx.device)
    peak = torch.zeros((), dtype=torch.int64, device=ctx.device)
    rows = 0
    with torch.no_grad():
        for batch in pool:
            am_lp, lengths = chain_system.batched_logp(am, batch.waves,
                                                       batch.ivectors)
            logp = (batch.planted + mix * am_lp).transpose(0, 1)
            del am_lp
            beam, _ = init_beam_batch(dec.cfg, len(lengths), dec.dfst,
                                      dec.dlm)
            lens = torch.as_tensor(lengths, device=ctx.device)
            census = counts.FrameCensus(gc)
            for f in range(logp.shape[0]):
                valid = f < lens
                new, _ = decode_chunk(dec.cfg, dec.dfst, beam, logp[f:f + 1],
                                      valid[None], dec.dlm)
                census.frame(beam.states, beam.lm, valid, new.states)
                kept = ((new.states >= 0) & valid[:, None]).sum(dim=1)
                live += kept.sum()
                peak = torch.maximum(peak, kept.max())
                beam = new
            rows += sum(lengths)
            out.append(census.totals())
            del logp
    return out, (float(live) / max(rows, 1) / k, int(peak) / k)


def compare(ctx: Ctx, pool, last_hyps, kept_am, keep, model, graph, am,
            am_scale, mix) -> List[Check]:
    """`logp_err`: the widest gap between the kept batch's AM outputs (the
    window's own) and `chain_ref`'s in float64; `cost_gap`: over a sample
    of the pool's utterances the widest `chain_gaps`, and over all of
    them the widest `judge.floor_excess` (`bulk.compare`'s)."""
    batch = pool[keep]
    ref_am = chain_ref.logp(model, batch.waves, batch.ivectors, ctx.device)
    logp_err = max(float((kept_am[u, :n].double() - ref_am[u]).abs().max())
                   for u, n in enumerate(batch.lengths))
    del ref_am
    rows = sample_rows(ctx, pool)
    inputs, same = program_rows(pool, rows + [(keep, 0)], am, mix, kept_am)
    ctx.note(f"# the decoder's rows taken again: the kept batch's AM "
             f"output bit-equal to the window's: {same!r}")
    del kept_am
    logps = ref_logps(ctx, pool, rows, model, mix)
    answers = [(list(last_hyps[j][u].words), float(last_hyps[j][u].weight))
               for j, u in rows]
    truths = [pool[j].truth[u] for j, u in rows]
    rg = ref.Graph(graph)
    rg.check_floor()
    gaps = chain_gaps(ctx, rg, answers, truths, logps, inputs[:len(rows)],
                      am_scale)
    for j, b in enumerate(pool):
        every = ref_logps(ctx, pool, [(j, x) for x in range(len(b.waves))],
                          model, mix)
        for u, lp in enumerate(every):
            gaps.append(judge.floor_excess(rg, lp, b.lengths[u], am_scale,
                                           float(last_hyps[j][u].weight)))
    if ctx.control:
        ctx.control_readings.update(control(
            ctx, pool, rows, model, rg, truths, logps, am_scale, mix))
    return [Check("logp_err", logp_err, ctx.limits["logp_err"]),
            Check("cost_gap", float(max(gaps)), ctx.limits["cost_gap"])]


def program_rows(pool, rows, am, mix, kept_am):
    """The rows the decoder took for the given (batch, utterance) pairs:
    the program's AM output for their batches taken again (the same
    batches, so the same shapes and numbers) + the planted rows, as
    `run`'s step makes them; and whether the kept batch's output came
    out bit-equal to the window's (`kept_am`, a batch of `rows`)."""
    out, same = {}, None
    with torch.no_grad():
        for j in sorted({j for j, _ in rows}):
            b = pool[j]
            am_lp, _ = chain_system.batched_logp(am, b.waves, b.ivectors)
            if am_lp.shape == kept_am.shape and j == rows[-1][0]:
                same = bool(torch.equal(am_lp, kept_am))
            logp = b.planted + mix * am_lp
            del am_lp
            for jj, u in rows:
                if jj == j:
                    out[(j, u)] = logp[u, :b.lengths[u]].clone()
            del logp
    return [out[r] for r in rows], same


def chain_gaps(ctx: Ctx, rg, answers, truths, logps, inputs, am_scale,
               whose: str = "the program's") -> List[float]:
    """Per sampled utterance the smaller of two readings.  Exact:
    `judge.bulk_gaps`, the answer against the exact best costs of its
    words and of the planted words over the reference's rows (`logps`).
    Pruned: |the answer's cost - the cost of the plain pruned search's
    answer| (`ref.beam_search` at the configuration's beam_size and beam,
    over the rows the decoder took, `inputs`), infinite where their words
    differ; that answer is the decoder's (`final_fallback`): the best
    final token, or where none is final the cheapest.  At max-active
    7,000 the recipe's search can lose the planted path; a decode that
    gives what that search gives is then right, and a decode that gives
    the exact best is right either way."""
    dc = ctx.config["decoder"]
    exact = judge.bulk_gaps(rg, None, answers, truths, logps, am_scale,
                            ctx.device)
    cost, whash, fcost, fhash = ref.beam_search(
        rg, inputs, [x.shape[0] for x in inputs], am_scale,
        dc["beam_size"], dc["beam"], ctx.device)
    pruned = []
    for i, (words, weight) in enumerate(answers):
        final = math.isfinite(fcost[i])
        c, h = (fcost[i], fhash[i]) if final else (cost[i], whash[i])
        pruned.append(abs(weight - float(c))
                      if ref.word_hash(words) == int(h) else math.inf)
    ctx.note(f"# {whose} cost_gap readings per sampled utterance (exact, "
             f"pruned): {list(zip(exact, pruned))!r}")
    return [min(e, p) for e, p in zip(exact, pruned)]


def ref_logps(ctx: Ctx, pool, rows, model, mix,
              precision: str = "float64") -> List[torch.Tensor]:
    """The reference's log-likelihoods of the given utterances: planted +
    mix * its own AM output."""
    am = chain_ref.logp(model, [pool[j].waves[u] for j, u in rows],
                        [pool[j].ivectors[u] for j, u in rows], ctx.device,
                        precision)
    return [pool[j].planted[u, :pool[j].lengths[u]].double()
            + mix * a.double() for (j, u), a in zip(rows, am)]


def control(ctx, pool, rows, model, rg, truths, logps, am_scale,
            mix) -> dict:
    """The reference in the program's place, a precision lower: the AM
    with TF32 matmuls (its `logp_err` against the float64 AM), and the
    planted words' costs, ending anywhere, summed in bfloat16 as the
    answers (their `cost_gap`, the rows the stand-in decoder took being
    the TF32 AM's)."""
    j = seed_sample(ctx.seed, len(pool), 1, "keep")[0]
    waves, ivs = pool[j].waves, pool[j].ivectors
    a64 = chain_ref.logp(model, waves, ivs, ctx.device)
    a32 = chain_ref.logp(model, waves, ivs, ctx.device, "tf32")
    logp_err = max(float((x.double() - y).abs().max())
                   for x, y in zip(a32, a64))
    low = ref_logps(ctx, pool, rows, model, mix, "tf32")
    jobs = [ref.Job(i, t, False) for i, t in enumerate(truths)]
    cost = ref.align(rg, jobs, low, am_scale, ctx.device, "bfloat16")
    answers = [(t, float(torch.tensor(c).to(torch.bfloat16)))
               for t, c in zip(truths, cost)]
    gaps = chain_gaps(ctx, rg, answers, truths, logps,
                      [x.float() for x in low], am_scale, "the control's")
    return {"logp_err": logp_err, "cost_gap": float(max(gaps))}
