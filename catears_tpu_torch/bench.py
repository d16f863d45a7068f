"""Benchmark of the port: full-pipeline ASR throughput on the card (port of
the repo's bench.py, every mode).

    python -m catears_tpu_torch.bench

The workload, the knobs and the output are bench.py's.  The same `BENCH_*`
environment variables select it; one JSON line goes to stdout and `# ...`
summary lines to stderr.  The pipeline runs on the card: raw 16 kHz samples
-> fbank -> TDNN acoustic model (float, or int8 with BENCH_QUANT=1, whose
linears launch the hand-written `qmatmul` kernel) -> batched WFST Viterbi
beam search -> device backtrace.  The metric is audio seconds decoded per
wall second (xRT).

Modes (BENCH_MODE):
  (unset)    the headline: `build_bench_setup`'s 50k-word trie with planted
             paths, 16 x 10 s, LM off, then LM on with the bench's G'
             (`audio_seconds_per_sec_per_chip`, `lm_on_xrt`, WER)
  product    the public batch path, `BatchDecoder.decode`
             (`product_batch_audio_seconds_per_sec`)
  streaming  a solo `Utterance` over 1024-byte pushes, or BENCH_STREAMS=N
             live streams of `create_stream_batch(N)`
             (`streaming_audio_seconds_per_sec`,
             `batched_streaming_audio_seconds_per_sec`)
  am         the AM forward alone, float or BENCH_QUANT=1 (calibrated on
             one utterance unless BENCH_CALIBRATE=0)
             (`am_forward_audio_seconds_per_sec_{float,int8}`)
  scaling    `parallel.ShardedPipeline` over 1/2/4/8 devices on a 20k-word
             sub-trie, 8 x 2 s ragged (`dp_sharding_efficiency_8dev`);
             with fewer than 8 cards the shards share them round-robin

The random stream is drawn in bench.py's order (trie, planted paths, nnet,
G' if BENCH_LM=1, wave), so the planted frames, true words, wave and
weights are the JAX bench's own.  Every timed call ends in a synchronize
(a host copy of its result or `torch.cuda.synchronize()`); `value` is
audio / min(run times), as in bench.py, and stderr also carries every run's
time and their median, and the card's name and power limit.

It runs on the card and fails with a one-line `catears: ...` error without
one; BENCH_DEVICE=cpu runs it on the CPU (for the tests), the counterpart
of JAX_PLATFORMS=cpu.  The decode variants take bench.py's knobs:
BENCH_REORDER=bfs|freq|hot renumbers the trie's states (freq and hot from
the visit counts of a calibration decode, `_calibrate_counts`), hot with
the hot/cold emit split (BENCH_HOT_ROWS hot states, default 175,000;
BENCH_COLD cold lanes, default 1024), and BENCH_SELECT_COMPACT compacts
the selection.  A BENCH_REORDER value bench.py does not know raises.
JAX_CACHE_DIR is ignored.

Regression bound (PERF.md, section 2): compare a change with its parent in
one call on one card, in turns.  A median run time more than 10% above the
parent's (15% for the LM-on pass and `am`), or any change in a planted WER
or in the words, is a regression.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from catears_tpu_torch.utils.device import resolve_device
from catears_tpu_torch.utils.errors import CatEarsError

REORDERS = ("", "bfs", "freq", "hot")  # BENCH_REORDER's values


def check_knobs() -> None:
    """Raise CatEarsError for a knob value that has no counterpart in
    bench.py (which ignores an unknown BENCH_REORDER)."""
    reorder = os.environ.get("BENCH_REORDER", "")
    if reorder not in REORDERS:
        raise CatEarsError(f"BENCH_REORDER={reorder}: expected one of "
                           f"{', '.join(REORDERS[1:])}")


def bench_device() -> torch.device:
    """The card, or the CPU when BENCH_DEVICE=cpu; CatEarsError without a
    card."""
    name = os.environ.get("BENCH_DEVICE", "cuda")
    if name not in ("cuda", "cpu"):
        raise CatEarsError(f"BENCH_DEVICE={name}: expected cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise CatEarsError("no CUDA device is available (BENCH_DEVICE=cpu "
                           "runs the bench on the CPU)")
    return torch.device(name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device: torch.device) -> str:
    """`name, power limit` of the card as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _report_times(tag: str, times: List[float], device: torch.device) -> None:
    print(f"# [{tag}] run_s={times} min_s={min(times)} "
          f"median_s={float(np.median(times))} max_s={max(times)} "
          f"card={_card(device)}", file=sys.stderr)


def build_bench_setup(batch: int, seconds: float, seed: int = 0,
                      device=None):
    """Returns (am, fst, dfst, dlm, cfg, wave, planted, true_words), as
    bench.py's build_bench_setup does, on `device` (bench_device() unless
    given): the AcousticModel, the decode graph (FlatFst), its DeviceFst,
    a DeviceLm when BENCH_LM=1 (else None), the BeamConfig, the [B, S]
    wave tensor, the [B, T, P] planted frames (numpy) and the true words
    (None for BENCH_GRAPH=loop).

    BENCH_GRAPH=trie (default): the mkgraph-shaped 50k-word prefix-trie
    HCLG with planted pseudo-likelihoods that walk real graph paths, its
    states renumbered by BENCH_REORDER; `loop`: the 2k-word phone loop
    decoding raw noise.
    """
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet
    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.frontend.fbank import num_frames
    from catears_tpu_torch.graph.device import DeviceFst, DeviceLm
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.graph.transform import prepare_decode_graph
    from catears_tpu_torch.tools.toy import (make_phone_loop_graph,
                                             make_toy_nnet)

    check_knobs()
    device = bench_device() if device is None else resolve_device(device)
    rng = np.random.RandomState(seed)
    kind = os.environ.get("BENCH_GRAPH", "trie")
    hidden = int(os.environ.get("BENCH_HIDDEN", 1024))
    samples = int(seconds * 16000)
    planted = true_words = None
    hot_rows = 0
    if kind == "trie":
        from catears_tpu_torch.tools.biggraph import (make_trie_graph,
                                                      plant_logp)
        num_words = int(os.environ.get("BENCH_WORDS", 50000))
        tg = make_trie_graph(rng, num_words=num_words)
        fst, tid2pdf, num_pdfs = tg.fst, tg.tid2pdf, tg.num_pdfs
        planted, true_words = plant_logp(rng, tg, batch,
                                         num_frames(samples))
        # bench.py's geometry: block G=2, CSR rows of 16 arcs, beam 2048,
        # expand sized from the measured high-water mark.
        group, beam, expand, eps_expand = 2, 2048, 32768, 1024
        fst, hot_rows = _reorder(fst, tid2pdf, planted, device)
    else:
        num_pdfs = int(os.environ.get("BENCH_PDFS", 4096))
        num_words = int(os.environ.get("BENCH_WORDS", 2000))
        max_fanout = int(os.environ.get("BENCH_FANOUT", 0))
        graph = make_phone_loop_graph(rng, num_words=num_words,
                                      phones_per_word=(3, 6),
                                      num_pdfs=num_pdfs,
                                      max_fanout=max_fanout)
        fst, tid2pdf = FlatFst.from_raw(graph.fst), graph.tid2pdf
        group, beam, expand, eps_expand = 2, 2048, 2048, 2048
    nnet = make_toy_nnet(rng, hidden=hidden, num_pdfs=num_pdfs,
                         num_tdnn_layers=5)
    nnet_def, params = build_nnet(nnet)
    prior = np.full(num_pdfs, 1.0 / num_pdfs, np.float32)
    am = AcousticModel(nnet_def, params, np.log(prior), tid2pdf,
                       nnet.left_context, nnet.right_context,
                       chunk_size=50, num_pdfs=num_pdfs,
                       quantized=os.environ.get("BENCH_QUANT") == "1",
                       device=device)
    fst, olab2, mode = prepare_decode_graph(fst)
    print(f"# decode graph mode={mode}: {fst.num_states} states, "
          f"{fst.num_arcs} arcs", file=sys.stderr)
    csr_default = 16 if kind == "trie" else 0
    dfst = DeviceFst.build(fst, tid2pdf,
                           group=int(os.environ.get("BENCH_GROUP", group)),
                           csr_group=int(os.environ.get("BENCH_CSR_GROUP",
                                                        csr_default)) or None,
                           eps_depth_cap=1 if mode != "raw" else None,
                           olabel2=olab2, hot_rows=hot_rows, device=device)
    dlm = None
    if os.environ.get("BENCH_LM") == "1":
        from catears_tpu_torch.tools.biggraph import make_big_lm
        big = make_big_lm(rng, num_words=num_words)
        dlm = DeviceLm.build(big.delta_lm(), device=device)
        print(f"# delta-LM G': {big.num_states} states, {big.num_arcs} "
              f"arcs", file=sys.stderr)
    cfg = BeamConfig(
        beam_size=int(os.environ.get("BENCH_BEAM", beam)),
        expand_size=int(os.environ.get("BENCH_EXPAND", expand)),
        eps_expand_size=int(os.environ.get("BENCH_EPS_EXPAND", eps_expand)),
        lm_expand_size=int(os.environ.get("BENCH_LM_EXPAND", 0)),
        select_compact=int(os.environ.get("BENCH_SELECT_COMPACT", 0)),
        # The hot/cold split's cold lanes (BENCH_REORDER=hot); size from
        # hiwater slot 4.
        cold_expand_size=int(os.environ.get(
            "BENCH_COLD", 1024 if hot_rows else 0)),
        max_eps_iters=3,
        beam=16.0,
    )
    wave = (rng.randn(batch, samples) * 1000).astype(np.float32)
    return (am, fst, dfst, dlm, cfg, torch.from_numpy(wave).to(device),
            planted, true_words)


def _reorder(fst, tid2pdf, planted, device):
    """(fst, hot_rows) after BENCH_REORDER, as bench.py applies it to the
    trie: bfs, freq (visit counts, BFS order on ties) or hot (the
    BENCH_HOT_ROWS most visited states first, for the hot/cold split)."""
    from catears_tpu_torch.graph.transform import (bfs_order,
                                                   frequency_order,
                                                   hot_order,
                                                   renumber_states)

    reorder = os.environ.get("BENCH_REORDER", "")
    if reorder == "bfs":
        t0 = time.time()
        fst = renumber_states(fst, bfs_order(fst))
        print(f"# reorder=bfs in {time.time() - t0:.0f}s", file=sys.stderr)
    elif reorder == "freq":
        counts = _calibrate_counts(fst, tid2pdf, planted, device)
        fst = renumber_states(
            fst, frequency_order(counts, tie_break=bfs_order(fst)))
    elif reorder == "hot":
        hot_rows = int(os.environ.get("BENCH_HOT_ROWS", 175_000))
        counts = _calibrate_counts(fst, tid2pdf, planted, device)
        return renumber_states(fst, hot_order(counts, hot_rows)), hot_rows
    return fst, 0


def _calibrate_counts(fst, tid2pdf, planted, device) -> np.ndarray:
    """Per-state beam-visit counts [S] from a short calibration decode
    (bench.py's): up to 4 planted utterances x 300 frames on the original
    layout, the beam's states counted after every 20-frame chunk."""
    from catears_tpu_torch.decode.beam import (BeamConfig, decode_chunk,
                                               init_beam_batch)
    from catears_tpu_torch.graph.device import DeviceFst
    from catears_tpu_torch.graph.transform import prepare_decode_graph

    t0 = time.time()
    dec_fst, olab2, mode = prepare_decode_graph(fst)
    dfst = DeviceFst.build(dec_fst, tid2pdf, group=2, csr_group=16,
                           eps_depth_cap=1 if mode != "raw" else None,
                           olabel2=olab2, device=device)
    cfg = BeamConfig(beam_size=2048, expand_size=32768,
                     eps_expand_size=1024, max_eps_iters=3)
    b = min(4, planted.shape[0])
    frames = min(300, planted.shape[1])
    lp = torch.from_numpy(np.ascontiguousarray(np.transpose(
        planted[:b, :frames], (1, 0, 2)))).to(device)
    beam, _ = init_beam_batch(cfg, b, dfst)
    counts = np.zeros(fst.num_states, np.int64)
    chunk = 20
    for off in range(0, frames, chunk):
        part = lp[off:off + chunk]
        beam, _tr = decode_chunk(cfg, dfst, beam, part, torch.ones(
            part.shape[:2], dtype=torch.bool, device=device))
        s = beam.states.cpu().numpy().ravel()
        counts += np.bincount(s[s >= 0], minlength=fst.num_states)
    print(f"# calibration: {int((counts > 0).sum())} states visited "
          f"({time.time() - t0:.0f}s)", file=sys.stderr)
    return counts


def am_forward(am, wave: torch.Tensor, t_frames: int) -> torch.Tensor:
    """[B, S] waves -> [B, T, P] log-likelihoods: fbank, the first and last
    frames replicated over the left and right context, the AM (bench.py's
    am_forward over the batch)."""
    from catears_tpu_torch.frontend.fbank import fbank_from_wave

    with torch.no_grad():
        feats = fbank_from_wave(wave, t_frames)
        b = feats.shape[0]
        padded = torch.cat([feats[:, :1].expand(b, am.left_context, -1),
                            feats,
                            feats[:, -1:].expand(b, am.right_context, -1)],
                           dim=1)
        return am.forward_padded(padded)


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """[B, K] -> [B] index of the row minimum, the first one on ties (as
    jnp.argmin picks it), on any device."""
    k = x.shape[1]
    idx = torch.arange(k, device=x.device).expand_as(x)
    lo = torch.amin(x, dim=1, keepdim=True)
    return torch.amin(torch.where(x == lo, idx, k), dim=1)


def decode_planted(am, dfst, dlm, cfg, wave, planted_dev, chunk: int):
    """One headline run (bench.py's run_once): the AM forward, logp =
    planted + 1e-3 * AM (two roundings, as bench.py's eager ops), the beam
    search in chunks of `chunk` frames (the tail zero-padded, masked
    invalid), the final-weight pick and the device backtrace.  Returns
    (words [B, T, W], costs, overflow, hiwater) as numpy: the host copies
    end the run."""
    from catears_tpu_torch.decode.beam import (FrameTrace, backtrace_device,
                                               decode_chunk, init_beam_batch)
    from catears_tpu_torch.frontend.fbank import num_frames

    batch, t_frames = wave.shape[0], num_frames(wave.shape[1])
    dev = wave.device
    with torch.no_grad():
        logp_t = am_forward(am, wave, t_frames).transpose(0, 1)  # [T, B, P]
        if planted_dev is not None:
            logp_t = planted_dev + 1e-3 * logp_t
        beam, init_trace = init_beam_batch(cfg, batch, dfst, dlm)
        prevs, words = [], []
        for off in range(0, t_frames, chunk):
            n = min(chunk, t_frames - off)
            if n == chunk:
                lp = logp_t[off:off + n]
            else:
                lp = torch.cat([logp_t[off:off + n],
                                torch.zeros((chunk - n, batch,
                                             logp_t.shape[2]),
                                            dtype=torch.float32, device=dev)])
            valid = torch.zeros((chunk, batch), dtype=torch.bool, device=dev)
            valid[:n] = True
            beam, trace = decode_chunk(cfg, dfst, beam, lp, valid, dlm)
            prevs.append(trace.prev_slot[:n])
            words.append(trace.words[:n])
        # The init trace is 1 word wide where an eps-free graph has no
        # epsilon arc; zero words widen it exactly (BatchDecoder does too).
        init_words = torch.nn.functional.pad(
            init_trace.words, (0, words[0].shape[-1]
                               - init_trace.words.shape[-1]))
        traces = FrameTrace(torch.cat([init_trace.prev_slot[None]] + prevs),
                            torch.cat([init_words[None]] + words))
        final = dfst.final[torch.clamp(beam.states, min=0).long()]
        total = beam.costs + torch.where(beam.states >= 0, final,
                                         torch.full_like(final, np.inf))
        has_final = torch.isfinite(total).any(dim=1)
        best_slots = torch.where(has_final, first_argmin(total),
                                 first_argmin(beam.costs))
        out = backtrace_device(traces, best_slots)
        return (out.cpu().numpy(), beam.costs.cpu().numpy(),
                beam.overflow.cpu().numpy(), beam.hiwater.cpu().numpy())


def _wer(true_words, hyps) -> float:
    from catears_tpu_torch.tools.score import edit_distance

    errs = sum(edit_distance(t, h)[0] for t, h in zip(true_words, hyps))
    return errs / max(1, sum(len(t) for t in true_words))


def measure_headline(setup, cfg, dlm, tag: str, batch: int, seconds: float,
                     chunk: int):
    """bench.py's measure(): one warm-up run (words, WER, the overflow
    assert and the high-water marks), then BENCH_RUNS timed runs.  Returns
    (xRT, WER or None)."""
    from catears_tpu_torch.decode.hyp import assemble_words
    from catears_tpu_torch.frontend.fbank import num_frames

    am, _, dfst, _, _, wave, planted, true_words = setup
    dev = wave.device
    t_frames = num_frames(wave.shape[1])
    planted_dev = (None if planted is None else torch.from_numpy(
        np.ascontiguousarray(np.transpose(planted, (1, 0, 2)))).to(dev))
    run = lambda: decode_planted(am, dfst, dlm, cfg, wave,  # noqa: E731
                                 planted_dev, chunk)
    words, costs, overflow, hiwater = run()  # warm-up
    hyps = [assemble_words(words[b]) for b in range(batch)]
    assert np.isfinite(costs).any(), "beam died"
    hw = tuple(int(x) for x in hiwater.max(axis=0))  # slots actually needed
    assert not overflow.any(), (
        f"capacity overflowed: needed (emit_over, eps, lm, select, cold) "
        f"<= {hw}; raise BENCH_EXPAND/BENCH_EPS_EXPAND/BENCH_LM_EXPAND/"
        f"BENCH_SELECT_COMPACT/BENCH_COLD respectively")
    wer = None if true_words is None else _wer(true_words, hyps)
    runs = int(os.environ.get("BENCH_RUNS", 3))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        words, costs, overflow, hiwater = run()
        times.append(time.perf_counter() - t0)
    value = batch * seconds / min(times)
    n_words = sum(len(h) for h in hyps)
    occupancy = float(np.isfinite(costs).mean())
    extra = "" if wer is None else f", WER={wer:.3f}"
    print(f"# [{tag}] graph={os.environ.get('BENCH_GRAPH', 'trie')} "
          f"lm={int(dlm is not None)} batch={batch} x {seconds}s, "
          f"frames={t_frames}, beam={cfg.beam_size}, "
          f"times={[round(t, 3) for t in times]}, "
          f"hyp0_words={len(hyps[0])}, words/audio-sec="
          f"{n_words / (batch * seconds):.2f}, "
          f"beam_occupancy={occupancy:.3f}, "
          f"capacity_hiwater={hw}{extra}", file=sys.stderr)
    _report_times(tag, times, dev)
    return value, wer


def main() -> int:
    """The headline: LM off (or on with BENCH_LM=1), then the LM-on pass
    with the bench's G' unless BENCH_SKIP_LM=1 or BENCH_GRAPH=loop."""
    import dataclasses

    from catears_tpu_torch.graph.device import DeviceLm
    from catears_tpu_torch.tools.biggraph import make_big_lm

    batch = int(os.environ.get("BENCH_BATCH", 16))
    seconds = float(os.environ.get("BENCH_SECONDS", 10.0))
    chunk = int(os.environ.get("BENCH_CHUNK", 100))
    setup = build_bench_setup(batch, seconds)
    dlm, cfg, dev = setup[3], setup[4], setup[5].device
    value, wer = measure_headline(setup, cfg, dlm,
                                  "lm-on" if dlm is not None else "lm-off",
                                  batch, seconds, chunk)
    record = {
        "metric": "audio_seconds_per_sec_per_chip",
        "value": round(value, 3),
        "unit": "xRT",
        "vs_baseline": round(value, 3),
    }
    if wer is not None:
        record["wer"] = round(wer, 4)
    if dlm is None and os.environ.get("BENCH_SKIP_LM") != "1" \
            and os.environ.get("BENCH_GRAPH", "trie") == "trie":
        num_words = int(os.environ.get("BENCH_WORDS", 50000))
        big = make_big_lm(np.random.RandomState(0), num_words=num_words)
        dlm2 = DeviceLm.build(big.delta_lm(), device=dev)
        print(f"# delta-LM G': {big.num_states} states, {big.num_arcs} "
              f"arcs", file=sys.stderr)
        # Walk cap 384: bench.py's (its measured lm hiwater x 1.5).
        cfg_lm = dataclasses.replace(
            cfg, lm_expand_size=int(os.environ.get("BENCH_LM_EXPAND",
                                                   384)))
        lm_value, lm_wer = measure_headline(setup, cfg_lm, dlm2, "lm-on",
                                            batch, seconds, chunk)
        record["lm_on_xrt"] = round(lm_value, 3)
        record["lm_on_ratio_off_over_on"] = round(value / lm_value, 3)
        if lm_wer is not None:
            record["lm_on_wer"] = round(lm_wer, 4)
    print(json.dumps(record))
    return 0


def main_product() -> int:
    """Throughput of the public batch path (`BatchDecoder.decode`, what
    decode_scp and `cli --batch` run) on the headline's workload and
    geometry, the setup's DeviceFst adopted; logp stays on the device."""
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.frontend.fbank import num_frames

    batch = int(os.environ.get("BENCH_BATCH", 16))
    seconds = float(os.environ.get("BENCH_SECONDS", 10.0))
    chunk = int(os.environ.get("BENCH_CHUNK", 100))
    am, fst, dfst, dlm, cfg, wave, planted, true_words = build_bench_setup(
        batch, seconds)
    dev = wave.device
    t_frames = num_frames(wave.shape[1])
    planted_dev = (None if planted is None
                   else torch.from_numpy(planted).to(dev))

    def logp_of(wave):
        logp = am_forward(am, wave, t_frames)
        if planted_dev is not None:
            logp = planted_dev + 1e-3 * logp
        return logp

    dec = BatchDecoder(fst, am.tid2pdf, config=cfg, chunk_frames=chunk,
                       dfst=dfst)
    # final_fallback: planted paths may end mid-word; score the cheapest
    # token there, as the headline does.
    decode = lambda lp: dec.decode(lp, final_fallback=True)  # noqa: E731
    hyps = decode(logp_of(wave))  # warm-up
    wer = (None if true_words is None
           else _wer(true_words, [h.words for h in hyps]))
    runs = int(os.environ.get("BENCH_RUNS", 3))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        decode(logp_of(wave))  # ends in the host copy of words and costs
        times.append(time.perf_counter() - t0)
    value = batch * seconds / min(times)
    rec = {
        "metric": "product_batch_audio_seconds_per_sec",
        "value": round(value, 3),
        "unit": "xRT",
        "vs_baseline": round(value, 3),
    }
    if wer is not None:
        rec["wer"] = round(wer, 4)
    print(json.dumps(rec))
    print(f"# product path (BatchDecoder.decode) batch={batch} x "
          f"{seconds}s times={[round(t, 3) for t in times]}",
          file=sys.stderr)
    _report_times("product", times, dev)
    return 0


def main_streaming() -> int:
    """Single-utterance streaming decode throughput (the latency path), or
    BENCH_STREAMS=N live streams."""
    import tempfile

    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.io.wav import WaveFormat
    from catears_tpu_torch.runtime.recognizer import Recognizer
    from catears_tpu_torch.tools.toy import write_toy_model

    check_knobs()
    device = bench_device()
    seconds = float(os.environ.get("BENCH_SECONDS", 10.0))
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as model_dir:
        with_lm = os.environ.get("BENCH_STREAM_LM") == "1"
        if os.environ.get("BENCH_STREAM", "trie") == "trie":
            # The 50k-word trie HCLG + TDNN-1024 (BENCH_STREAM=toy: the
            # 200-word loop); BENCH_STREAM_LM=1 adds the G' delta-LM.
            from catears_tpu_torch.tools.biggraph import write_trie_model
            conf = write_trie_model(
                model_dir, rng,
                num_words=int(os.environ.get("BENCH_WORDS", 50000)),
                hidden=int(os.environ.get("BENCH_HIDDEN", 1024)),
                with_lm=with_lm)
            geo = (2048, 32768, 8192)
        else:
            conf = write_toy_model(model_dir, rng=rng, num_words=200,
                                   hidden=512, num_pdfs=1024)
            geo = (2048, 8192, 2048)
        cfg = BeamConfig(
            beam_size=int(os.environ.get("BENCH_BEAM", geo[0])),
            expand_size=int(os.environ.get("BENCH_EXPAND", geo[1])),
            eps_expand_size=int(os.environ.get("BENCH_EPS_EXPAND", geo[2])),
            lm_expand_size=int(os.environ.get("BENCH_LM_EXPAND",
                                              512 if with_lm else 0)),
            max_eps_iters=3)
        rec = Recognizer(conf, beam_config=cfg, device=device)
        pcm = (rng.randn(int(seconds * 16000)) * 1000).astype("<i2").tobytes()
        fmt = WaveFormat(1, 16000, 16)
        n_streams = int(os.environ.get("BENCH_STREAMS", 1))
        if n_streams > 1:
            return _bench_stream_batch(rec, pcm, cfg, n_streams, seconds,
                                       device)

        def run(step_times=None):
            utt = rec.create_utterance(fmt)
            decoded = 0
            for off in range(0, len(pcm), 1024):
                t0 = time.perf_counter()
                utt.process(pcm[off:off + 1024])
                _sync(device)
                dt = time.perf_counter() - t0
                # Calls that advanced the decoder ran a fused chunk step
                # (20 frames = 200 ms of audio): a live stream's latency.
                now = utt.session.num_frames_decoded
                if step_times is not None and now > decoded:
                    step_times.append(dt)
                decoded = now
            utt.end_of_stream()
            return utt.hyp

        run()  # warm-up
        runs = int(os.environ.get("BENCH_RUNS", 3))
        times = []
        step_times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run(step_times)  # ends in the host's hypothesis
            times.append(time.perf_counter() - t0)
    value = seconds / min(times)
    st = np.sort(np.asarray(step_times)) * 1e3
    p50 = st[len(st) // 2]
    p95 = st[int(len(st) * 0.95)]
    print(json.dumps({
        "metric": "streaming_audio_seconds_per_sec",
        "value": round(value, 3),
        "unit": "xRT",
        "vs_baseline": round(value, 3),
    }))
    print(f"# streaming 1 utt x {seconds}s, beam={cfg.beam_size}, "
          f"times={[round(t, 3) for t in times]}, per-20-frame-chunk "
          f"latency p50={p50:.1f}ms p95={p95:.1f}ms (chunk=200ms audio)",
          file=sys.stderr)
    print(f"# [streaming] chunk_ms_p50={p50} chunk_ms_p95={p95} "
          f"chunks={len(st)}", file=sys.stderr)
    _report_times("streaming", times, device)
    return 0


def _bench_stream_batch(rec, pcm, cfg, n_streams: int, seconds: float,
                        device: torch.device) -> int:
    """N concurrent live streams through BatchStreamingSession: every
    stream gets a 200 ms chunk per tick (one fused [N] chunk step) and,
    unless BENCH_STREAM_PARTIALS=0, every stream's partial hypothesis is
    refreshed after each step; a decode-only tick ends in a synchronize."""
    samples = np.frombuffer(pcm, dtype="<i2").astype(np.float32)
    partials = os.environ.get("BENCH_STREAM_PARTIALS", "1") == "1"
    feed = 3200  # 200 ms of audio per stream per tick

    def run(step_times=None):
        sess = rec.create_stream_batch(n_streams)
        decoded = 0
        for off in range(0, samples.size, feed):
            chunk = samples[off:off + feed]
            t0 = time.perf_counter()
            sess.process_batch([chunk] * n_streams)
            now = sess.num_frames_decoded[0]
            if now > decoded and partials:
                sess.partials()  # every stream's, one host copy
            elif now > decoded:
                _sync(device)
            dt = time.perf_counter() - t0
            if now > decoded and step_times is not None:
                step_times.append(dt)
            decoded = now
        for u in range(n_streams):
            sess.end_of_stream(u)
        return [sess.best_path(u, end_of_stream=True)
                for u in range(n_streams)]

    hyps = run()  # warm-up
    assert all(h.words is not None for h in hyps)
    runs = int(os.environ.get("BENCH_RUNS", 3))
    times, step_times = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        run(step_times)  # ends in the host's best paths
        times.append(time.perf_counter() - t0)
    value = n_streams * seconds / min(times)
    st = np.sort(np.asarray(step_times)) * 1e3
    p50 = st[len(st) // 2]
    p95 = st[int(len(st) * 0.95)]
    print(json.dumps({
        "metric": "batched_streaming_audio_seconds_per_sec",
        "value": round(value, 3),
        "unit": "xRT",
        "vs_baseline": round(value, 3),
    }))
    print(f"# batched streaming {n_streams} streams x {seconds}s, "
          f"beam={cfg.beam_size}, partials={int(partials)}, "
          f"times={[round(t, 3) for t in times]}, per-stream xRT="
          f"{value / n_streams:.2f}, per-tick (20 frames x {n_streams} "
          f"streams) latency p50={p50:.1f}ms p95={p95:.1f}ms",
          file=sys.stderr)
    print(f"# [streaming-{n_streams}] tick_ms_p50={p50} tick_ms_p95={p95} "
          f"ticks={len(st)}", file=sys.stderr)
    _report_times(f"streaming-{n_streams}", times, device)
    return 0


def main_am() -> int:
    """AM-forward-only throughput (BENCH_QUANT=1 for the int8 path, whose
    every linear is one `qmatmul` launch on the card)."""
    from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames

    batch = int(os.environ.get("BENCH_BATCH", 16))
    seconds = float(os.environ.get("BENCH_SECONDS", 10.0))
    am, _, _, _, _, wave, _, _ = build_bench_setup(batch, seconds)
    dev = wave.device
    t_frames = num_frames(wave.shape[1])
    if am.quantized and os.environ.get("BENCH_CALIBRATE", "1") == "1":
        # The deployment int8 path: static activation ranges from one
        # utterance (BENCH_CALIBRATE=0: the dynamic ranges instead).
        with torch.no_grad():
            feats = fbank_from_wave(wave[0], t_frames)
        am.calibrate(torch.cat([feats[:1].expand(am.left_context, -1), feats,
                                feats[-1:].expand(am.right_context, -1)]))
    out = am_forward(am, wave, t_frames)  # warm-up
    assert np.isfinite(out[:, ::50].cpu().numpy()).all()
    runs = int(os.environ.get("BENCH_RUNS", 5))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        # The output stays on the device, where the decoder reads it.
        am_forward(am, wave, t_frames)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    value = batch * seconds / min(times)
    quant = os.environ.get("BENCH_QUANT") == "1"
    print(json.dumps({
        "metric": "am_forward_audio_seconds_per_sec"
                  + ("_int8" if quant else "_float"),
        "value": round(value, 3),
        "unit": "xRT",
        "vs_baseline": round(value, 3),
    }))
    print(f"# am-only quant={int(quant)} batch={batch} x {seconds}s "
          f"times={[round(t, 3) for t in times]}", file=sys.stderr)
    _report_times("am-int8" if quant else "am-float", times, dev)
    return 0


def main_scaling() -> int:
    """Data-parallel scaling: the same fixed ragged batch through
    `ShardedPipeline.full_step` over 1/2/4/8 devices of a ('data',
    'model') mesh (bench.py's main_scaling; efficiency = xRT at 8 / xRT
    at 1).

    With 8 cards each shard has its own card.  With fewer, the shards go
    round-robin over the cards there are, and the measurement is the cost
    of splitting the batch over host threads and streams, not a
    multi-card speed-up; BENCH_DEVICE=cpu: n logical CPU devices.

    The workload is bench.py's: a 20k-word sub-trie at the headline beam
    geometry (beam 2048, expand 32768), TDNN-256, 8 x 2 s with ragged
    lengths (RandomState(7)), 3 timed runs.
    """
    from catears_tpu_torch.frontend.fbank import num_frames
    from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                                 logical_devices, make_mesh)

    device = bench_device()
    batch = int(os.environ.get("BENCH_BATCH", 8))
    seconds = float(os.environ.get("BENCH_SECONDS", 2.0))
    if batch % 8:
        raise CatEarsError(f"BENCH_BATCH={batch} does not split evenly over "
                           f"the scaling mode's 8 devices")
    defaults = {"BENCH_GRAPH": "trie", "BENCH_WORDS": "20000",
                "BENCH_HIDDEN": "256", "BENCH_BEAM": "2048",
                "BENCH_EXPAND": "32768", "BENCH_EPS_EXPAND": "1024"}
    unset = [k for k in defaults if k not in os.environ]
    os.environ.update({k: defaults[k] for k in unset})
    try:
        am, fst, dfst, _, cfg, wave, _, _ = build_bench_setup(batch, seconds)
    finally:
        for k in unset:
            del os.environ[k]
    t_frames = num_frames(wave.shape[1])
    runs = int(os.environ.get("BENCH_RUNS", 3))
    # Ragged batch: lengths span 50%..100% of the padded frame budget.
    rng = np.random.RandomState(7)
    lengths = torch.from_numpy(rng.randint(t_frames // 2, t_frames + 1,
                                           size=batch).astype(np.int32))
    audio_seconds = float(lengths.sum()) / 100.0

    results = {}
    for n_dev in (1, 2, 4, 8):
        devices = logical_devices(n_dev, device)
        mesh = make_mesh(n_dev, model_parallel=1, devices=devices)
        pipe = ShardedPipeline(am, dfst, None, cfg, mesh)
        step = pipe.jit_full_step(t_frames)

        def run_once():
            beam = pipe.make_beam(batch)
            _, beam, _ = step(wave, beam, lengths)
            return beam.costs.cpu().numpy()

        costs = run_once()  # warm-up
        assert np.isfinite(costs).any()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run_once()
            times.append(time.perf_counter() - t0)
        results[n_dev] = audio_seconds / min(times)
        print(f"# devices={n_dev}: {results[n_dev]:.2f} xRT (ragged "
              f"lengths {int(lengths.min())}..{int(lengths.max())}; shards "
              f"on {[str(d) for d in devices]})", file=sys.stderr)
        _report_times(f"scaling-{n_dev}", times, device)
    eff = results[8] / results[1]
    print(json.dumps({
        "metric": "dp_sharding_efficiency_8dev",
        "value": round(eff, 3),
        "unit": "ratio",
        "vs_baseline": round(eff / 0.8, 3),
    }))
    distinct = len(set(logical_devices(8, device)))
    note = ("8 cards: measures multi-card scaling" if distinct == 8 else
            f"{distinct} distinct device(s) for 8 shards: measures the cost "
            f"of splitting the batch over host threads and streams, not "
            f"multi-card speed-up")
    print(f"# xRT by devices: "
          f"{ {k: round(v, 2) for k, v in results.items()} } ({note})",
          file=sys.stderr)
    return 0


MODES = {"streaming": main_streaming, "am": main_am,
         "product": main_product, "scaling": main_scaling}


def run() -> int:
    """The mode BENCH_MODE names (the headline when unset); raises
    CatEarsError for a refused knob and without a card."""
    mode = os.environ.get("BENCH_MODE", "")
    check_knobs()
    bench_device()
    return MODES.get(mode, main)()


if __name__ == "__main__":
    try:
        sys.exit(run())
    except CatEarsError as e:
        print(f"catears: {e}", file=sys.stderr)
        sys.exit(1)
