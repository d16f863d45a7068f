"""Bulk traffic on a bidirectional recurrent chain model: closed-loop
offline batch transcription with Kaldi's chain BLSTM, evaluated in
Kaldi's chunks, as `catears <conf> <scp> --batch=16 --ivectors=...` runs
it with the configuration's chunk settings.

`bulk_chain.py`'s traffic, pool, window, decoder and comparisons (its
pool, replay counts, the rows the decoder took and `chain_gaps` are
imported), with the AM in the TDNN-F's place: `blstm_gen`'s weights,
`blstm_system`'s NN02 spec and the configuration's `chunk` settings
through the program's public constructors, `blstm_ref` as the reference.
The cell differs from `bulk-chain` and `bulk-chain-lstm` in the AM
alone.

A traced run switches the program's tracing on for the window and
records what the `.blstm` metrics read: the `logp`, `am.recurrence` and
`decode.frames` spans' CUDA-event seconds, the counters `am_chunks`,
`am_chunk_rows`, `am_chunk_rows_needed` and `lstm_recurrence_launches`
over the window and the batches run, the planned AM FLOPs and the
recurrences' least time (`blstm_counts`: Kaldi's chunk windows), and the
decoder's bytes as `bulk_chain` counts them.  `correct` compares the
kept batch's AM output with `blstm_ref` in float64 (`logp_err`) and the
decodes as `bulk_chain` does (`cost_gap`).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from asrbench import (blstm_counts, blstm_gen, blstm_ref, blstm_system,
                      chain_counts, chain_gen, chain_system, gen, judge, ref,
                      system)
from asrbench.harness import (Check, Ctx, Outcome, freeze_setup, host_pace,
                              memory_peak, profiled, reset_memory,
                              seed_sample, window_notes)
from asrbench.kinds.bulk import _tuples, sample_rows
from asrbench.kinds.bulk_chain import (Batch, chain_gaps, make_pool,
                                       program_rows, replay_counts)

COUNTERS = ("am_chunks", "am_chunk_rows", "am_chunk_rows_needed",
            "lstm_steps", "lstm_steps_needed", "lstm_recurrence_launches",
            "am_flops", "overflow_retries")


def build_model(ctx: Ctx):
    """(graph, BLSTM model dict on the device): the graph is
    bulk-chain's, drawn from the configuration's `model_seed`; the weights
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
    return graph, blstm_gen.blstm_device(g, ctx.device, c["am"],
                                         graph.num_pdfs, stats)


def run(ctx: Ctx) -> Outcome:
    blstm_system.require_program()
    c, t = ctx.config, ctx.traffic
    dc, am_cfg, chunk = c["decoder"], c["am"], c["chunk"]
    mix = t["plant"]["mix"]
    reset_memory(ctx)
    graph, model = build_model(ctx)
    am = blstm_system.acoustic_model(model, am_cfg, chunk, graph.num_pdfs,
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
    moved = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in COUNTERS}
    ctx.note(f"# program counters over the window: {moved!r}")

    records: Dict = {}
    t_after = time.perf_counter()
    if ctx.trace:
        valid = sum(r * sum(b.lengths) for r, b in zip(runs, pool))
        front = chain_counts.frontend_flops_per_frame(am_cfg)
        census, occupancy = replay_counts(ctx, dec, pool, mix, am, graph)

        def device_s(name):
            return sum(s.device_s or 0.0 for s in spans if s.name == name)

        frames = [s for s in spans if s.name == "decode.frames"]
        records = {
            "kind": "bulk_chain_blstm", "window_s": window, "audio_s": audio,
            "batches": sum(runs),
            "logp_device_s": device_s("logp"),
            "recurrence_device_s": device_s("am.recurrence"),
            "frames_device_s": sum(s.device_s or 0.0 for s in frames),
            "frames_stepped": sum(s.attrs.get("frames", 0) for s in frames),
            "am_chunk_rows": moved["am_chunk_rows"],
            "am_chunk_rows_needed": moved["am_chunk_rows_needed"],
            "lstm_recurrence_launches": moved["lstm_recurrence_launches"],
            "am_flops": valid * front + sum(  # planned: Kaldi's windows
                r * blstm_counts.stack_flops(am_cfg, chunk, graph.num_pdfs,
                                             b.lengths)
                for r, b in zip(runs, pool)),
            "recurrence_least_s": sum(
                r * blstm_counts.recurrence_least_s(am_cfg, chunk,
                                                    [b.lengths], ctx.peaks)
                for r, b in zip(runs, pool)),
            "bytes": {k: sum(r * cb[k] for r, cb in zip(runs, census))
                      for k in census[0]},
            "trace": prof, "peaks": ctx.peaks,
        }
        ctx.note(f"# beam occupancy (live tokens / beam_size over valid "
                 f"rows and frames): mean {occupancy[0]!r} peak "
                 f"{occupancy[1]!r}; recurrence spans "
                 f"{sum(s.name == 'am.recurrence' for s in spans)}")
        ctx.note(f"# window split: logp spans' device s "
                 f"{records['logp_device_s']!r} (am.recurrence "
                 f"{records['recurrence_device_s']!r}), decode.frames "
                 f"spans' device s {records['frames_device_s']!r} of the "
                 f"window's {window!r} s")
        ctx.note(f"# device ops by raw name: {prof.get('raw_top')!r}")
    t_ref = time.perf_counter()
    checks = compare(ctx, pool, last_hyps, kept_am, keep, model, graph, am,
                     dc["am_scale"], mix)
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


def compare(ctx: Ctx, pool, last_hyps, kept_am, keep, model, graph, am,
            am_scale, mix) -> List[Check]:
    """`logp_err`: the widest gap between the kept batch's AM outputs (the
    window's own) and `blstm_ref`'s in float64; `cost_gap`: over a sample
    of the pool's utterances the widest `chain_gaps`, and over all of
    them the widest `judge.floor_excess` (`bulk_chain.compare`'s)."""
    chunk = ctx.config["chunk"]
    refs = [blstm_ref.logp(model, b.waves, b.ivectors, ctx.device, chunk)
            for b in pool]
    logp_err = max(float((kept_am[u, :n].double() - refs[keep][u]).abs()
                         .max())
                   for u, n in enumerate(pool[keep].lengths))
    rows = sample_rows(ctx, pool)
    inputs, same = program_rows(pool, rows + [(keep, 0)], am, mix, kept_am)
    ctx.note(f"# the decoder's rows taken again: the kept batch's AM "
             f"output bit-equal to the window's: {same!r}")
    del kept_am

    def planted(j, u, am_u):
        return pool[j].planted[u, :pool[j].lengths[u]].double() \
            + mix * am_u.double()

    logps = [planted(j, u, refs[j][u]) for j, u in rows]
    answers = [(list(last_hyps[j][u].words), float(last_hyps[j][u].weight))
               for j, u in rows]
    truths = [pool[j].truth[u] for j, u in rows]
    rg = ref.Graph(graph)
    rg.check_floor()
    gaps = chain_gaps(ctx, rg, answers, truths, logps, inputs[:len(rows)],
                      am_scale)
    for j, b in enumerate(pool):
        for u in range(len(b.waves)):
            gaps.append(judge.floor_excess(rg, planted(j, u, refs[j][u]),
                                           b.lengths[u], am_scale,
                                           float(last_hyps[j][u].weight)))
    del refs
    if ctx.control:
        ctx.control_readings.update(control(
            ctx, pool, rows, model, rg, truths, logps, am_scale, mix))
    return [Check("logp_err", logp_err, ctx.limits["logp_err"]),
            Check("cost_gap", float(max(gaps)), ctx.limits["cost_gap"])]


def ref_logps(pool, rows, model, mix, device, chunk, precision: str
              ) -> List[torch.Tensor]:
    """The reference's log-likelihoods of the given utterances (one at a
    time): planted + mix * its own AM output."""
    am = blstm_ref.logp(model, [pool[j].waves[u] for j, u in rows],
                        np.stack([pool[j].ivectors[u] for j, u in rows]),
                        device, chunk, precision)
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
    chunk = ctx.config["chunk"]
    a64 = blstm_ref.logp(model, waves, ivs, ctx.device, chunk)
    a32 = blstm_ref.logp(model, waves, ivs, ctx.device, chunk, "tf32")
    logp_err = max(float((x.double() - y).abs().max())
                   for x, y in zip(a32, a64))
    low = ref_logps(pool, rows, model, mix, ctx.device, chunk, "tf32")
    jobs = [ref.Job(i, t, False) for i, t in enumerate(truths)]
    cost = ref.align(rg, jobs, low, am_scale, ctx.device, "bfloat16")
    answers = [(t, float(torch.tensor(c).to(torch.bfloat16)))
               for t, c in zip(truths, cost)]
    gaps = chain_gaps(ctx, rg, answers, truths, logps,
                      [x.float() for x in low], am_scale, "the control's")
    return {"logp_err": logp_err, "cost_gap": float(max(gaps))}
