"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's offline batch decode (`catears_tpu_torch.cli --batch`) and
its live-stream path (`Recognizer.create_stream_batch`, fed in 20-frame
ticks, and a solo `Utterance`) on the card with the full-width int8 model
the JAX bench runs (TDNN-1024 on the 50k-word trie, 617,940 states; random
weights from seed 0), LM off and with delta-LM rescoring by the bench's
50k-word G' (`write_trie_model(..., with_lm=True)`, walk capacity
lm_expand_size = 384), and checks every phase; exits non-zero if any fails:

  device      a CUDA card is present (exit 1 otherwise, before any result)
  build       the hand-written kernels compile from catears_tpu_torch/csrc
              (nvcc's register and spill summary printed)
  kernel      matmul_s8 (CUDA) == matmul_s8_ref exactly, at the AM's
              shapes, at ragged ones and on misaligned views (storage
              offsets 1 and 8); per AM shape the call's device time (CUDA
              graph replay) and its time with the host's (CUDA events)
              beside the plain version's, its bound, its share of the
              bound, and torch._int_mm's device time (the yardstick, never
              called by the port)
  qkernel     the fused linear qmatmul(..., bias=) (CUDA) == qmatmul_ref
              bit for bit, with dynamic, static (`rng`) and guarded
              (`grng`) activation scales, at the AM's shapes and at ragged
              ones; per AM shape the call's device and host times beside
              the plain version's and its bound; at the bench's shapes
              (16 x 10 s, BENCH_SHAPES) and at the streaming shapes (one
              20-frame chunk window of B = 1 and 8 streams, one scale per
              stream), with their device times
  lstm-kernel csrc/lstm_recurrence.cu (am.lstm.lstm_recurrence on cuda)
              against its plain loop (lstm_recurrence_ref) on the card at
              the chain TDNN-LSTM's widths (cell 1,024, projections 256 +
              256), B 16 and 1,167 steps: the largest gap within 1e-5 of
              the output's scale, two runs bit-equal; the launch's ms
              (CUDA events), the plain loop's, the bound (the larger of the
              recurrence's FLOPs at 67 TFLOP/s and its compulsory bytes at
              3.35 TB/s) and its share; then the benchmark's TDNN-LSTM
              (asrbench/configs/swbd-tdnnlstm-chain-lex200k.json, weights
              from seed 0) through batched_logp on 16 utterances of 3-35 s:
              one launch a LSTM layer and batch, the AM's ms
  blstm-kernel the same kernel at a chunked BLSTM's batch, 87 windows of
              20-84 rows x 84 steps, forward and backward (each window's
              rows reversed within its length): one launch, within 1e-5 of
              the plain loop's scale, each row bit-equal to launches of 16
              rows; its ms, the 16-row launches' ms, the plain loop's, the
              bound and its share; then the benchmark's BLSTM
              (asrbench/configs/swbd-blstm-chain-lex200k.json, weights from
              seed 0, Kaldi's 150-frame chunks) through batched_logp on 16
              utterances of 1.5-35 s: one launch a layer and direction
              (6), the AM's ms
  am          quantized batched_logp on cuda vs the same on the CPU, for
              two utterances: max error < 1% of the output range (the CPU
              tests' bar for the int8 stack); one fused launch per linear
  calibrated  AcousticModel.calibrate on one utterance, static (`rng`)
              and guarded (`grng`), then batched_logp of two utterances:
              cuda vs cpu < 1% of range, one fused launch per linear;
              device busy time of the dynamic and calibrated AMs
  lm          the DeviceLm built for cuda is byte-equal to the CPU's;
              lm_propagate on 65,536 mixed (state, label) queries: equal
              states and bit-equal weights on cuda and cpu; build and walk
              times
  lm-kernel   csrc/lm_walk.cu (lm_propagate_capped on cuda) == its plain
              version on the card, on the lanes the decoder's walk is given
              at the last of 100 planted frames of 16 utterances: all 16
              rows at the bench's cap (384), the first 8 (the smoke's
              batch), and uncapped; equal states, bit-equal weights, equal
              needed; device ms (CUDA graph replay), the call's ms, the
              plain version's ms, the bound from these lanes' bytes and its
              share
  decoder     BatchDecoder.decode of the same log-probs on cuda and on the
              CPU: identical words, bit-equal costs; plus the WER of
              planted trie paths decoded on cuda
  decoder-lm  the same with the delta-LM, and the planted WER under it
  decoder-closed, decoder-raw, decoder-raw-dynamic
              the trie with its epsilon arcs: closed (close_epsilons, the
              tables built with eps_depth_cap = 1 on cuda and on the CPU,
              adopted by BatchDecoder(dfst=...)), raw (BatchDecoder(
              close_eps=False): depth 2, two static closure rounds) and
              raw at max_eps_iters = 1 (depth 2 > 1: the arena closure).
              The AM's 2 utterances on the card with no device read in
              the frame loop (ms per frame, host clock between
              synchronizes, and the high-water marks), their first
              CUT_FRAMES frames on cuda and cpu (identical words, bit-equal
              costs), and the planted WER on the card (not held to a bar
              for raw-dynamic: 1 round truncates the closure)
  decoder-closed-lm, decoder-raw-lm
              closed and raw with the G', all on CUT_FRAMES frames
  variant-*   the exact decode variants on the trie (LM off, the smoke's
              beam geometry), each through BatchDecoder on the same 2 x 500
              planted frames: the default, select_compact at K and at the
              default decode's hiwater[3], the hot_order graph (counts from
              bench._calibrate_counts on the card) with hot_rows 175,000 and
              1024 cold lanes, and the bfs and freq renumberings.  Each:
              the default's words, costs bit-equal (within 1e-3 on a
              renumbered graph), no device read in the frame loop (ms per
              frame, hiwater, build seconds), overflow without the retry
              reported (then the retry decodes), cuda == cpu on the first
              VARIANT_CPU_FRAMES (50) frames.  variant-cold-overflow: a
              cold cap of 8 raises (hiwater[4] > 8), and its one retry
              gives the default's words or raises again (reported);
              variant-select-overflow: select_compact=1 at beam 1e9
              raises (hiwater[3] > K)
  e2e         cli.main(["--batch=8", conf, scp]) on cuda: exit 0, one line
              per utterance, no capacity overflow, the fused kernel
              launched once per linear layer per batch, and the first
              CPU_UTTS transcripts equal to the same command with
              --device=cpu on those utterances
  backtrace-kernel
              csrc/backtrace.cu (backtrace_device on cuda) == its plain
              version on the card, bit for bit, on the traces and best
              slots of the e2e run (998 frames x 8 utterances x beam 2048);
              device ms, the call's ms, the plain version's ms, the bound
              from the chains' bytes and its share
  e2e-lm      the same with the delta-LM config, on the first
              E2E_LM_UTTS utterances
  e2e-raw     the same with a config whose graph is the trie plus one
              unreachable epsilon path carrying two words, so
              prepare_decode_graph returns 'raw': no device read in the
              frame loop, its ms per frame and high-water marks
  stream      the toy model with online CMVN (tests/data/cmvn_stats.bin),
              float and int8, over en-us-hello.wav and en-us-cat.wav: the
              fused Utterance equals the componentized one on the card and
              both equal the same run on the CPU, transcripts non-empty,
              the fused kernel launched in every int8 run
  stream-decoder
              planted trie log-probs through the single-utterance Decoder
              on the card, LM off and with the G': the words BatchDecoder
              gives on the card, and the planted WER
  stream-decoder-raw
              the same through Decoder(close_eps=False) against
              BatchDecoder(close_eps=False), no device read in the
              Decoder's frame loop
  stream-trie 8 streams of the seeded waves through create_stream_batch(8),
              fed by process_batch in 20-frame ticks, then end_of_stream
              per stream: the first CPU_STREAMS streams' transcripts
              equal those of the same streams on the CPU (the whole 8 do
              not fit the time limit with the CPU's LM-on decode), no
              capacity overflow, the fused kernel launched once per linear
              per chunk step; the tick latency p50/p99 (host clock around
              a synchronize), audio seconds per wall second, and a solo
              Utterance over the 10 s wave (its chunk latency)
  stream-trie-lm  the same with the delta-LM config
  argmin      the headline's final-slot pick (bench.first_argmin) on the
              card takes the first index on ties, as numpy and jnp do
  bench       `python -m catears_tpu_torch.bench` in a subprocess at its
              defaults (the 50k-word trie with planted paths, TDNN-1024 x
              5, beam 2048, 16 x 10 s), BENCH_RUNS=1, LM off then on:
              exit 0, bench.py's JSON keys, no capacity overflow (the
              bench asserts it), the planted WER LM off and on <= 0.25,
              the run times
  bench-product, bench-am, bench-am-int8, bench-streaming,
  bench-streaming-16
              the bench's other modes in this process at BENCH_SECONDS=2,
              BENCH_RUNS=2: `product`, `am` float and with BENCH_QUANT=1
              (calibrated; one `qmatmul` launch per linear per AM forward,
              warm-up included, counted from 0 just before the run), and
              `streaming` solo and with BENCH_STREAMS=16: each prints its
              bench.py metric
  parallel    `parallel.ShardedPipeline` at the smoke's width (the trie
              model's float TDNN-1024 x 2, as JAX's pipeline runs the float
              params; beam 2048, expand 32768), batch 8 of the seeded waves
              (ragged), over make_mesh(2, 1) and make_mesh(4, 2) of logical
              shards of the card (of the cards, where there are more): held
              to the unsharded step on the card (log-probs within 2e-4,
              states and words equal, costs within 1e-3); each step's wall
              time; no int8 launch
  distributed two processes, rank 0 and 1, in one gloo group on localhost,
              each on its card (cuda:0 for both on one card): each decodes
              its local_batch_slice through a ShardedPipeline, equal to the
              parallel phase's unsharded reference, and global_sum gives
              the total frames; a timeout per rank
  dryrun      graft_entry.dryrun_multichip(8) on the card (sharded ==
              unsharded), then entry()'s step once
  bench-scaling
              BENCH_MODE=scaling at its defaults (20k-word sub-trie,
              TDNN-256, beam 2048, batch 8, ragged) cut to 1 s per
              utterance, BENCH_RUNS=1: its JSON line, xRT per mesh size
              (1/2/4/8 shards of the card)
  native      the native host library builds (or the phase fails with the
              compiler's output); load_wav_batch (the 8 WAVs), the 50k
              trie written as a ConstFst and read back, a random
              1000-frame backtrace and 200 edit distances equal the Python
              paths; host ms of the WAV load native vs Python and seconds of
              the trie's pk::fst_0 read and ConstFst parse (native, Python)
  synth       tools.synth.train_am on the card at tests/test_synth.py's size
              (dev accuracy > 0.5 after 800 steps; WER < 0.15 on 3 fresh
              utterances through Recognizer(device=cuda)), then at
              scripts/realism.py's width (TDNN-1024 x 5, 3600 pdfs, the
              smoke's 50k-word trie): the first step's loss (1e-5
              relative) and gradients (1e-4 of each one's range) on cuda
              against the same step on the CPU in float64 (the CPU's
              float32 error beside it), steps per second and dev accuracy

Cut in depth (never in width) to stay well inside the time limit, which
a slow host nearly filled (1026 s) before these cuts: decoder and
decoder-lm compare DECODER_FRAMES (500, LM on 200) frames of the 2
utterances, and their planted WER takes 4 x 1000 frames (LM on 2 x 300);
stream-decoder-lm 2 x 150 planted frames (LM off 2 x 500); the closed and
raw phases compare CUT_FRAMES (200, LM on 50) frames on the CPU, LM on
decode only those on the card, and take their planted WER on 2 x 500
frames (LM on 2 x 200); every e2e phase runs its CPU side on the first
CPU_UTTS (1) utterance, the longest, and e2e-lm runs the first
E2E_LM_UTTS (2); stream-trie compares CPU_STREAMS (1) stream with the
CPU; the LM-on live streams take the first STREAM_LM_S (2) seconds of each
wave, its solo Utterance SOLO_LM_S (2); the bench's modes other than the
headline run 2 s of audio, 2 timed runs.  The parallel and distributed
phases decode the first 20% of each wave (60-200 frames), bench-scaling
runs 0.5 s per utterance (BENCH_SECONDS=0.5; 1 s took 52 s), once per
mesh size, and the synth phase's full-width part trains
SYNTH_FULL_STEPS (200) steps on SYNTH_FULL_UTTS (8) utterances of 8 s.
The variant phases decode VARIANT_PLANTED (2 x 500) planted frames.
The last cuts (e2e-lm 4 -> 2 utterances, the LM-on streams 3 -> 2 s,
bench-scaling 1 -> 0.5 s) came when the variant phases (56 s) brought the
whole run to 844 s on an NVIDIA H100 80GB HBM3 at 700 W.

Every decode phase (decoder*, e2e*, stream-decoder*, stream-trie*, the
bench and its modes) prints the launches of the decoder's four kernels
in its run, counted from 0 just before it, and fails when an LM-on run
made no lm_walk launch (or an LM-off run one), a bulk decode
(BatchDecoder, the CLI's --batch, the bench's headline and product) no
backtrace launch, an eps-free decode no launch of frame_expand or of
frame_select (the variant phases too: the hot/cold split and
select_compact run in the kernels, which each variant also holds to their
plain versions on its last frame's arguments), or a decode of a closed or
raw graph (plain PyTorch frame steps) one of them.  The bench's
headline runs in a subprocess that prints its counts last on stderr.
`decoder` and `decoder-lm` also hold the card's high-water marks to the
CPU's.  `expand-kernel` and `select-kernel` (LM off after `decoder`, LM
on after `lm-kernel`) hold csrc/frame_expand.cu and csrc/frame_select.cu
to their plain versions bit for bit on the arguments of the last of 100
planted frames of 16 utterances (the bench's 16 x 38,912 lanes, beam
2048), with device, call and plain ms, the bytes bound, its share and
the SMs the grid covers.  `select-kernel` also prints the cluster launch
(CTAs, CTAs per row's cluster, the table's storage: shared or global)
and the device ms of each of the kernel's phases, read from the
%globaltimer stamps it writes when given a stamp buffer (the decode
passes none); `select-kernel-b1` holds the kernel to its plain version
on the first row alone, and `select-kernel-global` (with LM on) on 2
synthetic rows of 100,000 lanes at beam 8192, whose table takes global
memory.  `select-kernel-mask-shared` and `-global` (after `select-kernel`,
LM off) run it at the held cells' selections, 16 x 38,912 lanes at beam
2,048 and 16 x 209,416 at 7,000, with every row valid and with a row mask
of 5 live rows: bit-equal to the plain version under each, device ms,
launches a call, the clusters one wave holds, each phase's ms and the
table slots of the rows that ran.  `expand-kernel-mask` (after them)
runs frame_expand.cu at bulk-chain's expansion on the trie (16 rows of
7,000 live tokens, 209,416 lanes a row) with every row valid and with 5
live rows of 16: bit-equal to the plain version under each mask on the
rows that ran, a masked row's flags 0, device and plain ms, the bytes
bound of the rows that ran and its share, the blocks launched and those
that work.

Before the last line come {"kernels": [...]} and the card's name and power
limit; the last line is {"ok": true, "device": {...}}.  Each kernel is
listed once, by the entry point the main path launches it through, with
its launches summed over the main path's runs (the e2e runs, LM off, on
and raw; stream, stream-trie and stream-trie-lm; the bench's headline and
bench-am-int8), each counted from 0 just before its run:
  matmul_s8.cu  `qmatmul`, the fused epilogue: error, times and bound
              summed over the AM's three shapes (the e2e batch of 8).  Its
              int32 entry point (`matmul_s8`, which the main path does not
              launch) is nested in the entry with its own launches, error,
              times, bound and torch._int_mm's time;
  lm_walk.cu  `lm_propagate_capped`: times and bound at the bench's shape
              (lm-kernel's first line);
  backtrace.cu  `backtrace_device`: backtrace-kernel's times and bound;
  lstm_recurrence.cu  `lstm_recurrence`: lstm-kernel's times and bound, its
              launches those of lstm-kernel's TDNN-LSTM run; nested,
              `chunk_batch`: blstm-kernel's (backward) times and bound, its
              launches those of blstm-am's BLSTM run;
  frame_expand.cu  `expand_emitting`: expand-kernel's (LM off) times and
              bound;
  frame_select.cu  `select_beam`: select-kernel's (LM off) times and
              bound.
No single PyTorch call computes the walk, the backtrace, the expansion or
the selection: their library_ms is null.  The epsilon closure of closed
and raw graphs is plain PyTorch.
Bounds: the larger of the bytes the
function must move (each input read once, the output written once) over
3.35 TB/s and its int8 operations over 1,979 TOP/s (H100 SXM, dense); the
two device loops move bytes only (their integer hashing is negligible
beside either peak), counted from this run's data.
Everything it writes goes to a scratch directory under
catears_tpu_torch/_build/, removed at the end.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
import wave
from unittest import mock

import numpy as np
import torch

from catears_tpu_torch.am import quant
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.decode import decoder as tdecoder
from catears_tpu_torch.graph import device as tdevice
from catears_tpu_torch.kernels import BUILD_DIR, BUILD_LOG, load_kernels
from catears_tpu_torch.tools.biggraph import (make_trie_graph, plant_logp,
                                              write_trie_model)
from catears_tpu_torch.tools.score import token_errors
from catears_tpu_torch.utils import log

NUM_WORDS = 50_000
HIDDEN = 1024
BENCH_GEOMETRY = ("quantized = true", "beam_size = 2048",
                  "expand_size = 32768", "eps_expand_size = 1024",
                  "max_eps_iters = 3", "beam = 16")
LM_GEOMETRY = ("lm_expand_size = 384",)  # the bench's LM-on walk cap
LM_KEYS = ("large_lm", "original_lm")
# (batch, M, K, N) of the three linears when the longest of 8 utterances
# is 10 s: 1636 bucketed frames + 2 x 2 context rows, narrowed per layer.
KERNEL_SHAPES = [(8, 1638, 120, 1024), (8, 1636, 3072, 1024),
                 (8, 1636, 1024, 3600)]
EXACT_SHAPES = [(1, 37, 7, 5), (3, 300, 130, 1000), (2, 129, 33, 17),
                (8, 1646, 120, 1024), (8, 1646, 3072, 1024),
                (8, 1646, 1024, 3600)]
# (rows, K, N) of the three linears in one streaming chunk step: the window
# is L + 20 + R = 24 rows (L = R = 2), narrowed by 2 per splice.
STREAM_SHAPES = [(22, 120, 1024), (20, 3072, 1024), (20, 1024, 3600)]
STREAM_GEOMETRY = ("beam_size = 256", "expand_size = 2048",
                   "eps_expand_size = 1024", "max_eps_iters = 6", "beam = 1e9")
TICK = 3200  # samples per live tick: 20 frames of 10 ms
# Depth cuts (the card's time moves up to 1.4x between calls with the
# host's; the CPU sides and the LM-on decodes are the slow parts):
CPU_STREAMS = 1  # of the 8 live streams, also decoded on the CPU
CPU_UTTS = 1  # of the e2e utterances, also decoded on the CPU
E2E_LM_UTTS = 2  # utterances of the LM-on e2e run
# Frames of the 2 AM utterances decoded on the CPU (and, LM on, on the card)
# by the closed and raw phases, LM off / LM on:
CUT_FRAMES = {False: 200, True: 50}
# Frames of the 2 AM utterances decoder and decoder-lm decode, LM off / on:
DECODER_FRAMES = {False: 500, True: 200}
# Planted frames per utterance: (utterances, frames), LM off / LM on.
PLANTED = {False: (4, 1000), True: (2, 300)}
CLOSURE_PLANTED = {False: (2, 500), True: (2, 200)}
STREAM_LM_S = 2.0  # seconds of each wave the LM-on live streams take
SOLO_LM_S = 2.0  # seconds of the 10 s wave the LM-on solo Utterance takes
# (batch, M, K, N) of the bench's distinct linears at 16 x 10 s (998 frames
# + 5 + 5 context rows, narrowed by 2 per splice): the first, the four
# hidden ones, the output.
BENCH_SHAPES = [(16, 1006, 120, 1024), (16, 1004, 3072, 1024),
                (16, 998, 1024, 3600)]
BENCH_JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "wer",
                   "lm_on_xrt", "lm_on_ratio_off_over_on", "lm_on_wer"}
BENCH_MODE_SECONDS = "2"  # BENCH_SECONDS of the product, am, streaming runs
BENCH_MODE_RUNS = "2"  # their BENCH_RUNS
BENCH_STREAMS = "16"
# The last slice's phases, cut in depth: the parallel and distributed
# phases decode the first 20% of each seeded wave (60-200 frames),
# bench-scaling runs 1 s of each utterance (its 8-shard mesh alone took 60
# s at 2 s), and the synth phase at full width trains SYNTH_FULL_STEPS
# steps on SYNTH_FULL_UTTS utterances of SYNTH_FULL_S seconds.
PARALLEL_FRACTION = 0.2
SCALING_SECONDS = "0.5"  # bench-scaling's BENCH_SECONDS (its default: 2)
PARALLEL_MESHES = ((2, 1), (4, 2))  # (devices, model_parallel)
DIST_TIMEOUT = 600  # seconds per rank
NATIVE_REPS = 5  # host timings: best of
SYNTH_STEPS = 800  # tests/test_synth.py's
SYNTH_FULL_UTTS, SYNTH_FULL_S, SYNTH_FULL_STEPS = 8, 8.0, 200
# The decode-variants phase: planted trie paths, (utterances, frames) on the
# card, their first VARIANT_CPU_FRAMES frames also on the CPU; the hot
# graph's hot rows and cold lanes are the bench's defaults; the loud
# overflow checks decode OVERFLOW_FRAMES frames.
VARIANT_PLANTED = (2, 500)
VARIANT_CPU_FRAMES = 50
VARIANT_HOT_ROWS, VARIANT_COLD = 175_000, 1024
OVERFLOW_FRAMES = 20
# The lm-kernel phase: the walk's inputs at the last of LM_KERNEL_FRAMES
# planted frames of LM_KERNEL_UTTS utterances (the bench's batch), decoded
# on the card with the bench's walk cap; the smoke's batch is their first 8.
LM_KERNEL_UTTS, LM_KERNEL_FRAMES, SMOKE_BATCH = 16, 100, 8
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1.979e15  # H100 SXM, dense


START = time.perf_counter()


def phase(name, **numbers):
    """One line per check: its numbers, then the seconds since the start."""
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{name}] {fields} t={time.perf_counter() - START:.1f}",
          flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def time_ms(fn, iters=20):
    """Mean ms per call on the card (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Mean device ms per call of fn: `iters` calls captured in one CUDA
    graph and replayed between CUDA events, after warm-up.  No host time
    is in it: this is the call's device work (the kernel with any operand
    copy its wrapper makes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def profiled(fn):
    """(wall ms, device busy ms, device op count, key averages) of one
    profiled call.  Busy time is the union of the device ops' intervals
    (kernels, copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and not e.is_user_annotation)
    busy_us, covered = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, covered))
        covered = max(covered, end)
    return wall * 1e3, busy_us / 1e3, len(spans), prof.key_averages()


def write_wavs(out_dir, rng, n):
    """n seeded 16 kHz 16-bit mono WAVs of 3-10 s; returns the scp path."""
    scp = os.path.join(out_dir, "smoke.scp")
    with open(scp, "w") as fd:
        for i in range(n):
            secs = 10.0 if i == 0 else rng.uniform(3.0, 10.0)
            samples = np.clip(rng.randn(int(secs * 16000)) * 1500,
                              -32768, 32767).astype("<i2")
            path = os.path.join(out_dir, f"utt{i}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(samples.tobytes())
            fd.write(f"utt{i} {path}\n")
    return scp


def write_confs(work):
    """The trie model with its G' (seed 0), and its two configs: LM off
    (the LM keys dropped) and LM on, both at the bench geometry."""
    base = write_trie_model(work, np.random.RandomState(0),
                            num_words=NUM_WORDS, hidden=HIDDEN, with_lm=True)
    with open(base) as fd:
        lines = fd.read().splitlines()
    confs = []
    for name, keep_lm, extra in (("off.conf", False, ()),
                                 ("lm.conf", True, LM_GEOMETRY)):
        path = os.path.join(work, name)
        with open(path, "w") as fd:
            for line in lines + list(BENCH_GEOMETRY) + list(extra):
                if keep_lm or not line.startswith(LM_KEYS):
                    fd.write(line + "\n")
        confs.append(path)
    return confs


def range_error(ref, got, lengths):
    """max over utterances of max |ref - got| / range(ref), valid frames."""
    worst = 0.0
    for u, t in enumerate(lengths):
        r = ref[u, :t].cpu().numpy().astype(np.float64)
        g_ = got[u, :t].cpu().numpy().astype(np.float64)
        worst = max(worst, np.abs(r - g_).max() / (r.max() - r.min()))
    return worst


def bound(b, m, k, n, out_bytes=4, extra_bytes=0):
    """(ms, "bytes" or "operations"): the least time the card could take
    for [b*m, k] int8 @ [k, n] int8 with a 4-byte output."""
    rows = b * m
    t_bytes = ((rows * k + k * n + out_bytes * rows * n + extra_bytes)
               / HBM_BYTES_PER_S)
    t_ops = 2.0 * rows * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def add_timing(totals, ms, plain_ms, bound_ms, bound_by, library_ms=None):
    """Sums over the AM's shapes; bound_by is the side that bounds most of
    the summed bound."""
    totals["ms"] += ms
    totals["plain_ms"] += plain_ms
    totals["bound_ms"] += bound_ms
    totals["by"][bound_by] += bound_ms
    if library_ms is not None:
        totals["library_ms"] = (totals["library_ms"] or 0.0) + library_ms


def new_totals():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
            "max_abs_err": 0, "by": {"bytes": 0.0, "operations": 0.0}}


def zero_counts():
    """Every kernel entry point's launch count to 0, just before a run."""
    quant.matmul_s8.launches = quant.qmatmul.launches = 0
    tdevice.lm_propagate_capped.launches = 0
    tbeam.backtrace_device.launches = 0
    tbeam.expand_emitting.launches = tbeam.select_beam.launches = 0


def counts():
    """Launches since zero_counts(), by the entry point the main path
    launches each kernel through."""
    return {"matmul_s8": quant.matmul_s8.launches,
            "qmatmul": quant.qmatmul.launches,
            "lm_walk": tdevice.lm_propagate_capped.launches,
            "backtrace": tbeam.backtrace_device.launches,
            "frame_expand": tbeam.expand_emitting.launches,
            "frame_select": tbeam.select_beam.launches}


def loop_launches(name, launched, lm, bulk, eps_free=True):
    """The phase line's fields for the decoder's four kernels; fails when
    an LM-on run walked without lm_walk, an LM-off run launched it, a bulk
    decode (BatchDecoder, the CLI's --batch) backtraced without the
    backtrace kernel, an eps-free decode made no launch of either frame
    kernel, or a decode of a graph that keeps its epsilon arcs (whose
    emitting step and closure are plain PyTorch) launched one."""
    if bool(launched["lm_walk"]) != lm:
        fail(f"{name}: {launched['lm_walk']} lm_walk launches with the LM "
             f"{'on' if lm else 'off'}")
    if bulk and not launched["backtrace"]:
        fail(f"{name}: a bulk decode made no backtrace launch")
    frame = (launched["frame_expand"], launched["frame_select"])
    if (all(frame) if eps_free else any(frame)) != eps_free:
        fail(f"{name}: {frame} frame_expand / frame_select launches in "
             f"{'an eps-free' if eps_free else 'a closure'} decode")
    return {"lm_walk_launches": launched["lm_walk"],
            "backtrace_launches": launched["backtrace"],
            "expand_launches": frame[0], "select_launches": frame[1]}


@contextlib.contextmanager
def spied(module, name, keep):
    """While entered, module.name(*args, **kw) also stores its last
    positional args in `keep` (the tensors a kernel's wrapper is given on
    the main path).  The keywords are passed on and not kept: the frames
    the phases replay are valid in every row, so select_beam's row mask
    (row_valid) would mask none."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        keep[:] = args
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield keep
    finally:
        setattr(module, name, fn)


def randint8(g, shape, cuda):
    return torch.randint(-128, 128, shape, dtype=torch.int8,
                         generator=g).to(cuda)


def kernel_phase(card):
    cuda = torch.device("cuda:0")
    g = torch.Generator().manual_seed(0)
    totals = new_totals()
    for shape in EXACT_SHAPES + KERNEL_SHAPES:
        b, m, k, n = shape
        a, w = randint8(g, (b, m, k), cuda), randint8(g, (k, n), cuda)
        got = quant.matmul_s8(a, w)
        ref = quant.matmul_s8_ref(a, w)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        if err or not torch.equal(got, ref):
            fail(f"matmul_s8 differs from matmul_s8_ref at {shape}: "
                 f"max abs err {err}")
        if shape not in KERNEL_SHAPES:
            phase("kernel", shape=f"{b}x{m}x{k}x{n}", equal=True)
            continue
        bt = quant.transpose_pad(w)
        t_k = device_ms(lambda: quant.matmul_s8(a, w, bt=bt))
        t_call = time_ms(lambda: quant.matmul_s8(a, w, bt=bt))
        t_p = time_ms(lambda: quant.matmul_s8_ref(a, w))
        # The yardstick: cuBLASLt's int8 GEMM on the flattened batch (the
        # weight is shared, so this is the same product), weight
        # column-major as it requires.
        a2, w_cm = a.reshape(b * m, k), w.t().contiguous().t()
        try:
            lib_equal = torch.equal(torch._int_mm(a2, w_cm).view(b, m, n),
                                    ref)
            t_lib = device_ms(lambda: torch._int_mm(a2, w_cm))
        except RuntimeError as e:  # this build's cuBLASLt refuses the shape
            print(f"[kernel] torch._int_mm at {shape}: {e}", flush=True)
            lib_equal, t_lib = None, None
        b_ms, b_by = bound(b, m, k, n)
        add_timing(totals, t_k, t_p, b_ms, b_by, t_lib)
        phase("kernel", shape=f"{b}x{m}x{k}x{n}", equal=True,
              tile_width=quant.tile_width(n), ms=f"{t_k:.4f}",
              call_ms=f"{t_call:.4f}", plain_ms=f"{t_p:.4f}",
              bound_ms=f"{b_ms:.4f}", bound_by=b_by,
              share_of_bound=f"{b_ms / t_k:.3f}",
              int8_tops=f"{2.0 * b * m * k * n / (t_k * 1e-3) / 1e12:.1f}",
              library_ms=t_lib, library_equal=lib_equal,
              card=f"'{card}'")
    # Contiguous views whose data does not start on a 16-byte boundary (K a
    # multiple of 16, so the wrapper's realignment is what is checked).
    b, m, k, n = KERNEL_SHAPES[2]
    for offset in (1, 8):
        a_buf = randint8(g, (offset + b * m * k,), cuda)
        w_buf = randint8(g, (offset + k * n,), cuda)
        a, w = a_buf[offset:].view(b, m, k), w_buf[offset:].view(k, n)
        if not torch.equal(quant.matmul_s8(a, w), quant.matmul_s8_ref(a, w)):
            fail(f"matmul_s8 differs from matmul_s8_ref on a view at "
                 f"offset {offset}")
        phase("kernel", shape=f"{b}x{m}x{k}x{n}", storage_offset=offset,
              equal=True)
    return totals


def quantized_operands(b, m, k, n, scales, g, cuda):
    """Activations quantized per utterance (`dynamic`), with one static
    range (`rng`) or with the range widened per utterance (`grng`); a
    quantized weight with its column sums and a bias; all on the card."""
    x = (torch.randn((b, m, k), generator=g) * 2.0
         + torch.rand((b, 1, 1), generator=g) - 0.5).to(cuda)
    lo, hi = torch.tensor(-1.5, device=cuda), torch.tensor(2.5, device=cuda)
    if scales == "dynamic":
        aq = quant.quantize(x)
    elif scales == "rng":
        aq = quant.quantize_static(x, lo, hi)
    else:
        aq = quant.quantize_static(
            x, torch.minimum(torch.amin(x, dim=(-2, -1)), lo),
            torch.maximum(torch.amax(x, dim=(-2, -1)), hi))
    wq = quant.quantize((torch.randn((k, n), generator=g) / k ** 0.5)
                        .to(cuda))
    colsum = torch.sum(wq.values.to(torch.int32), dim=0).to(torch.float32)
    bias = (torch.randn(n, generator=g) * 0.1).to(cuda)
    return aq, wq, colsum, bias


def qkernel_phase(card):
    """The fused linear against its plain version on the card."""
    cuda = torch.device("cuda:0")
    g = torch.Generator().manual_seed(1)
    totals = new_totals()
    for shape in EXACT_SHAPES[:3] + KERNEL_SHAPES:
        b, m, k, n = shape
        for scales in ("dynamic", "rng", "grng"):
            aq, wq, colsum, bias = quantized_operands(b, m, k, n, scales, g,
                                                      cuda)
            bt = quant.transpose_pad(wq.values)
            got = quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
            ref = quant.qmatmul_ref(aq, wq, colsum, bias)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
            if not torch.equal(got, ref):
                fail(f"qmatmul differs from qmatmul_ref at {shape} "
                     f"({scales}): max abs err {err}")
            if shape not in KERNEL_SHAPES or scales != "dynamic":
                phase("qkernel", shape=f"{b}x{m}x{k}x{n}", scales=scales,
                      bit_equal=True)
                continue
            fused = lambda: quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
            t_k, t_call = device_ms(fused), time_ms(fused)
            t_p = time_ms(lambda: quant.qmatmul_ref(aq, wq, colsum, bias))
            # Beyond the matmul's bytes: column sums and bias (4 N each),
            # the per-utterance scales and zero points.
            b_ms, b_by = bound(b, m, k, n, extra_bytes=8 * n + 8 * b)
            add_timing(totals, t_k, t_p, b_ms, b_by)
            phase("qkernel", shape=f"{b}x{m}x{k}x{n}", scales=scales,
                  bit_equal=True, ms=f"{t_k:.4f}", call_ms=f"{t_call:.4f}",
                  plain_ms=f"{t_p:.4f}",
                  bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                  share_of_bound=f"{b_ms / t_k:.3f}", card=f"'{card}'")
    # The bench's batch of 16 x 10 s (`python -m catears_tpu_torch.bench`
    # with BENCH_QUANT=1): bit-equal, with the device time per shape.
    for b, m, k, n in BENCH_SHAPES:
        aq, wq, colsum, bias = quantized_operands(b, m, k, n, "dynamic", g,
                                                  cuda)
        bt = quant.transpose_pad(wq.values)
        got = quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
        ref = quant.qmatmul_ref(aq, wq, colsum, bias)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        if not torch.equal(got, ref):
            fail(f"qmatmul differs from qmatmul_ref at the bench's shape "
                 f"{b}x{m}x{k}x{n}: max abs err {err}")
        fused = lambda: quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
        b_ms, b_by = bound(b, m, k, n, extra_bytes=8 * n + 8 * b)
        t_k = device_ms(fused)
        phase("qkernel", shape=f"{b}x{m}x{k}x{n}", bench=True,
              bit_equal=True, ms=f"{t_k:.4f}", bound_ms=f"{b_ms:.4f}",
              bound_by=b_by, share_of_bound=f"{b_ms / t_k:.3f}",
              card=f"'{card}'")
    # The streaming chunk step: M far below the tile height, one scale per
    # stream (B = 8 packs 8 windows into the tiles' rows).
    for b in (1, 8):
        for m, k, n in STREAM_SHAPES:
            aq, wq, colsum, bias = quantized_operands(b, m, k, n, "dynamic",
                                                      g, cuda)
            bt = quant.transpose_pad(wq.values)
            got = quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
            ref = quant.qmatmul_ref(aq, wq, colsum, bias)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
            if not torch.equal(got, ref):
                fail(f"qmatmul differs from qmatmul_ref at the streaming "
                     f"shape {b}x{m}x{k}x{n}: max abs err {err}")
            fused = lambda: quant.qmatmul(aq, wq, colsum, bias=bias, bt=bt)
            b_ms, b_by = bound(b, m, k, n, extra_bytes=8 * n + 8 * b)
            t_k = device_ms(fused)
            phase("qkernel", shape=f"{b}x{m}x{k}x{n}", streaming=True,
                  scales=b, bit_equal=True, ms=f"{t_k:.4f}",
                  call_ms=f"{time_ms(fused):.4f}", bound_ms=f"{b_ms:.4f}",
                  bound_by=b_by, share_of_bound=f"{b_ms / t_k:.3f}",
                  card=f"'{card}'")
    return totals


def calibrated_phase(conf, waves, batch_waves, card):
    """The int8 AM calibrated on one utterance, static (`rng`) and guarded
    (`grng`): cuda vs cpu on `waves`, then the dynamic and both calibrated
    AMs' device busy time (profiler) measured in turns on `batch_waves`."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.io.config import Configuration
    from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames
    from catears_tpu_torch.runtime.batch import batched_logp

    t0 = time.perf_counter()
    cuda = torch.device("cuda:0")
    config = Configuration.read(conf)
    am_cpu = AcousticModel.read(config, device=torch.device("cpu"))
    wave = torch.from_numpy(waves[0])
    feats = fbank_from_wave(wave[None], num_frames(wave.shape[0]))[0]
    left, right = am_cpu.left_context, am_cpu.right_context
    padded = torch.cat([feats[:1].expand(left, -1), feats,
                        feats[-1:].expand(right, -1)])
    ams = {"dynamic": AcousticModel.read(config, device=cuda)}
    for key in ("rng", "grng"):
        ams[key] = AcousticModel.read(config, device=cuda)
        for am in (ams[key], am_cpu):
            am.calibrate(padded, guard=key == "grng")
        before = quant.qmatmul.launches
        logp, lengths = batched_logp(ams[key], waves)
        torch.cuda.synchronize()
        launched = quant.qmatmul.launches - before
        ref, _ = batched_logp(am_cpu, waves)
        worst = range_error(ref, logp, lengths)
        phase("calibrated", key=key, utts=len(waves),
              max_err_over_range=f"{worst:.3e}", fused_launches=launched,
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not np.isfinite(logp.cpu().numpy()).all():
            fail(f"non-finite calibrated ({key}) log-probs on cuda")
        if worst >= 0.01:
            fail(f"calibrated ({key}) int8 AM on cuda vs cpu: error "
                 f"{worst:.3e} of range")
        if launched != linears(ams[key]):
            fail(f"the calibrated ({key}) AM made {launched} fused launches "
                 f"for {linears(ams[key])} linears")
    busy = {key: [] for key in ams}
    order = list(ams)
    for key in order:
        batched_logp(ams[key], batch_waves)  # warm-up
    for turn in range(6):
        for key in (order if turn % 2 == 0 else order[::-1]):
            busy[key].append(profiled(
                lambda: batched_logp(ams[key], batch_waves))[1])
    phase("calibrated-time", utts=len(batch_waves), card=f"'{card}'",
          **{f"{key}_device_ms": f"{float(np.median(v)):.4f}"
             for key, v in busy.items()})


def lm_phase(delta, card):
    """DeviceLm tables and the walk, cuda vs cpu, at the bench's G'."""
    cuda = torch.device("cuda:0")
    t0 = time.perf_counter()
    dlm_cpu = tdevice.DeviceLm.build(delta, device=torch.device("cpu"))
    build_s = time.perf_counter() - t0
    dlm_gpu = tdevice.DeviceLm.build(delta, device=cuda)
    for name in tdevice.LM_TABLES:
        a, b = getattr(dlm_cpu, name), getattr(dlm_gpu, name).cpu()
        if a.dtype != b.dtype or a.numpy().tobytes() != b.numpy().tobytes():
            fail(f"DeviceLm.{name} on cuda differs from the CPU build")
    rng = np.random.RandomState(3)
    n, v = 65536, NUM_WORDS
    n_states = dlm_cpu.state_tab.shape[0]
    states = np.concatenate([
        np.zeros(n // 8, np.int64), rng.randint(1, v + 1, size=n // 2),
        rng.randint(v + 3, n_states, size=n // 4),
        np.full(n // 8, v + 1)]).astype(np.int32)
    labels = np.minimum(np.where(
        rng.rand(n) < 0.7, 1 + (rng.pareto(1.0, n) * 40).astype(np.int64),
        rng.randint(0, v + 3, size=n)), v + 2).astype(np.int32)
    s_cpu, l_cpu = torch.from_numpy(states), torch.from_numpy(labels)
    s_gpu, l_gpu = s_cpu.to(cuda), l_cpu.to(cuda)
    ref = tdevice.lm_propagate(dlm_cpu, s_cpu, l_cpu)
    got = tdevice.lm_propagate(dlm_gpu, s_gpu, l_gpu)
    same = all(r.numpy().tobytes() == g.cpu().numpy().tobytes()
               for r, g in zip(ref, got))
    moved = int((ref[0] != s_cpu).sum())
    walk_ms = time_ms(lambda: tdevice.lm_propagate(dlm_gpu, s_gpu, l_gpu))
    # The frame step's shape: 8 utterances x the 384-slot capped walk.
    s8, l8 = s_gpu[:8 * 384].view(8, 384), l_gpu[:8 * 384].view(8, 384)
    walk8_ms = time_ms(lambda: tdevice.lm_propagate(dlm_gpu, s8, l8))
    phase("lm", states=n_states, buckets=dlm_cpu.hash_tab.shape[0],
          build_s=f"{build_s:.2f}", queries=n, moved=moved,
          equal=same, walk_ms=f"{walk_ms:.4f}",
          walk_8x384_ms=f"{walk8_ms:.4f}",
          iterations=tdevice.lm_iterations(dlm_gpu), card=f"'{card}'")
    if not same:
        fail("lm_propagate on cuda and cpu disagree")
    if moved < n // 4:
        fail(f"only {moved} of {n} LM queries moved")


def same_bytes(ref, got):
    return all(r.dtype == g.dtype and r.shape == g.shape
               and r.cpu().numpy().tobytes() == g.cpu().numpy().tobytes()
               for r, g in zip(ref, got))


def lm_kernel_phase(dec, tg, card, cuda=torch.device("cuda:0")):
    """csrc/lm_walk.cu (lm_propagate_capped on cuda) against its plain
    version on the card, on the lanes the decoder's walk is given: the last
    of LM_KERNEL_FRAMES planted frames of LM_KERNEL_UTTS utterances, at the
    bench's cap (all rows: the bench's batch; the first SMOKE_BATCH: the
    smoke's) and uncapped.  Equal states, bit-equal weights, equal needed;
    device ms (CUDA graph replay), the call's ms with the host's, the plain
    version's ms, the bound from the bytes these lanes need (16 B a lane
    streamed; per walked lane 12 B of unigram tables, 64 B a hash probe, 8
    B a backoff-row read) and its share.  Returns the totals of the bench's
    shape for the kernels line."""
    planted = plant_logp(np.random.RandomState(4), tg, LM_KERNEL_UTTS,
                         LM_KERNEL_FRAMES)[0]
    dec.drop_graphs()  # captured anew: the spied wrapper is called
    with spied(tbeam, "lm_propagate_capped", []) as walk:
        dec.decode(torch.from_numpy(planted).to(cuda), final_fallback=True)
    dlm, states, labels, cap = walk
    totals = new_totals()
    for rows, c in ((LM_KERNEL_UTTS, cap), (SMOKE_BATCH, cap),
                    (LM_KERNEL_UTTS, 0)):
        st, lab = states[:rows].contiguous(), labels[:rows].contiguous()
        got = tdevice.lm_propagate_capped(dlm, st, lab, c)
        work = {}
        ref = tdevice.lm_propagate_capped_ref(dlm, st, lab, c, work)
        torch.cuda.synchronize()
        equal = same_bytes(ref, got)
        err = float((got[1] - ref[1]).abs().max())
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        t_k = device_ms(lambda: tdevice.lm_propagate_capped(dlm, st, lab, c))
        t_call = time_ms(lambda: tdevice.lm_propagate_capped(dlm, st, lab, c))
        t_p = time_ms(lambda: tdevice.lm_propagate_capped_ref(dlm, st, lab,
                                                              c), iters=5)
        e = st.shape[-1]
        n_bytes = (16 * rows * e + 4 * rows + 12 * work["walked"]
                   + 64 * work["probes"] + 8 * work["misses"])
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        phase("lm-kernel", rows=rows, lanes=e, cap=c,
              needed=got[2].tolist(), walked=work["walked"],
              probes=work["probes"], backoff_reads=work["misses"],
              equal=equal, max_abs_err=err, ms=f"{t_k:.4f}",
              call_ms=f"{t_call:.4f}", plain_ms=f"{t_p:.4f}",
              bound_ms=f"{b_ms:.5f}", bound_by="bytes",
              share_of_bound=f"{b_ms / t_k:.4f}",
              latency_chain=f"<= {tdevice.lm_iterations(dlm)} gathers",
              card=f"'{card}'")
        if not equal:
            fail(f"lm-kernel: the kernel differs from lm_propagate_capped_ref "
                 f"at {rows} x {e}, cap {c}")
        if not work["walked"]:
            fail("lm-kernel: the captured lanes carry no word")
        if rows == LM_KERNEL_UTTS and c == cap:
            add_timing(totals, t_k, t_p, b_ms, "bytes")
    return totals


def kernel_equals_plain(fn, ref_fn, args):
    """(kernel's outputs, plain version's, every output bit-equal) of a
    frame kernel's wrapper on `args`."""
    got, ref = fn(*args), ref_fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    equal = all(r is not None and g is not None and same_bytes([r], [g])
                for r, g in zip(ref, got) if r is not None or g is not None)
    return got, ref, equal


def expand_bytes(args, got):
    """The bytes expand_emitting must move on `args` (got: its outputs),
    each input read once: the beam's states (and each live token's cost
    and lm), each distinct live state's emit row (the batch shares the
    graph's rows), the over_packed rows the CSR slots use (per state its
    first ones, as many as its busiest token used), logp at each distinct
    (row, pdf) a valid lane reads; and every output written once.  Returns
    (bytes, the counts)."""
    cfg, dfst, beam, logp, need_lm = args
    b, k = beam.states.shape
    e = got.state.shape[1]
    dev = beam.states.device
    lm_b = 4 if need_lm else 0
    live = beam.states >= 0
    st = beam.states.clamp(0, dfst.num_states - 1).long()
    states = int(torch.unique(st[live]).numel())
    gc = dfst.csr_group
    csr0 = k + k * dfst.group
    used = torch.zeros((b, k), dtype=torch.int64, device=dev).scatter_add_(
        1, got.tok[:, csr0::gc].long(),
        (got.state[:, csr0::gc] < tbeam.SENTINEL_STATE).long())
    per_state = torch.zeros(dfst.num_states, dtype=torch.int64,
                            device=dev).scatter_reduce_(
        0, st.flatten(), used.flatten(), "amax")
    csr_rows = int(per_state.sum())
    c = tbeam._expand(cfg, dfst, beam, cfg.expand_size, True, need_lm=False,
                      need_bp=False)
    p = logp.shape[1]
    reads = c.valid & (c.pdf >= 0) & (c.pdf < p)
    row_pdf = torch.arange(b, device=dev)[:, None] * p + c.pdf.long()
    logp_reads = int(torch.unique(row_pdf[reads]).numel())
    n_bytes = (4 * b * k + int(live.sum()) * (4 + lm_b)
               + states * 4 * dfst.emit_block.shape[1]
               + csr_rows * gc * 4 * dfst.ARC_LANES + 4 * logp_reads
               + b * e * (20 + lm_b) + 5 * b)
    return n_bytes, dict(live_tokens=int(live.sum()), distinct_states=states,
                         csr_rows=csr_rows, logp_reads=logp_reads)


# The phases frame_select.cu stamps (%globaltimer after each, CTA 0 of a
# row's cluster), in order; the stamp buffer's last column is the radix
# passes the row ran.
SELECT_PHASES = ("clear", "route", "route_sync", "claim", "scan", "select",
                 "compact", "sort", "counts", "rank_write")


def select_geometry_line(e, b):
    """The select kernel's launch for b rows of e lanes: CTAs, cluster
    size, the SMs they cover, the table's storage (select_geometry)."""
    cluster, log2cap, shared = tbeam.select_geometry(e)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(ctas=b * cluster, cluster=cluster,
                sms_used=f"{min(b * cluster, sms)}/{sms}", table_slots=1
                << log2cap, storage="shared" if shared else "global")


def select_phase_ms(args, calls=10, row_valid=None):
    """Device ms of each of frame_select.cu's phases on `args` (the mean
    over the rows row_valid keeps and over calls of the kernel's own
    stamps), and per such row (means) the radix passes, CTA 0's
    candidates and selected keys, and the table's slots."""
    b = args[1].shape[0]
    stamps = torch.zeros((b, tbeam.SELECT_STAMPS), dtype=torch.int64,
                         device=args[1].device)
    rows = (np.ones(b, bool) if row_valid is None
            else row_valid.cpu().numpy())
    spans = []
    for _ in range(calls):
        tbeam.select_beam(*args, stamps=stamps, row_valid=row_valid)
        torch.cuda.synchronize()
        st = stamps.cpu().numpy()[rows]
        spans.append(np.diff(st[:, :len(SELECT_PHASES) + 1], axis=1)
                     .mean(0) / 1e6)
    ms = np.mean(spans, 0)
    return dict({f"{n}_ms": f"{m:.5f}" for n, m in zip(SELECT_PHASES, ms)},
                radix_passes=float(st[:, -1].mean()),
                cta0_candidates=float(st[:, 11].mean()),
                cta0_selected=float(st[:, 12].mean()),
                row_table_slots=float(st[:, 13].mean()))


def synthetic_select_args(seed, b, e, k, lm_on, cuda):
    """select_beam's arguments over b rows of e lanes shaped like a frame's
    candidates (a quarter dead, the rest on about e/3 (state, lm) groups,
    costs 100-120 with cross-group ties, weights in eighths), beam k."""
    rng = np.random.RandomState(seed)
    groups = max(1, e // 3)
    pick = rng.randint(0, groups, (b, e))
    state = rng.randint(0, 4 * e, groups)[pick].astype(np.int32)
    lm = rng.randint(0, 50, groups)[pick].astype(np.int32)
    cost = (100 + rng.uniform(0, 20, (b, e))).astype(np.float32)
    tie = rng.rand(b, e) < 0.2
    cost[tie] = np.round(cost[tie] * 4) / 4
    dead = rng.rand(b, e) < 0.25
    state[dead] = tbeam.SENTINEL_STATE
    cost[dead] = np.inf
    w1 = (rng.randint(-8, 8, (b, e)) / 8).astype(np.float32)
    w2 = (rng.randint(0, 8, (b, e)) / 8).astype(np.float32)
    pay = [rng.randint(0, 10**6, (b, e)).astype(np.int32) for _ in range(3)]
    cols = [state, lm if lm_on else None, cost, w1 if lm_on else None,
            w2 if lm_on else None, *pay]
    cfg = tbeam.BeamConfig(beam_size=k, beam=16.0)
    return [cfg] + [None if c is None else torch.from_numpy(c).to(cuda)
                    for c in cols]


def frame_kernel_phase(dec, tg, card, cuda=torch.device("cuda:0")):
    """csrc/frame_expand.cu (expand_emitting on cuda) and
    csrc/frame_select.cu (select_beam) against their plain versions on the
    card, on the arguments the decoder gives them at the last of
    LM_KERNEL_FRAMES planted frames of LM_KERNEL_UTTS utterances (the
    bench's batch and lanes; LM off or on with the decoder): every output
    bit-equal; device ms (CUDA graph replay), the call's ms with the
    host's, the plain version's ms, the bound from the bytes these inputs
    need (each read once, each output written once: expand_bytes for the
    expansion) and its share, and the SMs the grid covers.  The selection
    also prints its launch (CTAs, cluster size, table storage), its device
    ms per phase from the kernel's stamps, and is held to its plain
    version on the first row alone (B = 1) and, with LM on, on synthetic
    rows that put its table in global memory (K = 8192 over 100,000
    lanes).  Returns both kernels' totals."""
    lm = dec.dlm is not None
    planted = plant_logp(np.random.RandomState(4), tg, LM_KERNEL_UTTS,
                         LM_KERNEL_FRAMES)[0]
    dec.drop_graphs()  # captured anew: the spied wrapper is called
    with spied(tbeam, "expand_emitting", []) as ex, \
            spied(tbeam, "select_beam", []) as sel:
        dec.decode(torch.from_numpy(planted).to(cuda), final_fallback=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, fn, ref_fn, args, cost in (
            ("expand-kernel", tbeam.expand_emitting,
             tbeam.expand_emitting_ref, ex, "cost"),
            ("select-kernel", tbeam.select_beam, tbeam.select_beam_ref,
             sel, "costs")):
        got, ref, equal = kernel_equals_plain(fn, ref_fn, args)
        r_cost, g_cost = getattr(ref, cost), getattr(got, cost)
        err = float(torch.where(torch.isfinite(r_cost),
                                (g_cost - r_cost).abs(), 0.0).max())
        t_k = device_ms(lambda: fn(*args))
        t_call = time_ms(lambda: fn(*args))
        t_p = time_ms(lambda: ref_fn(*args), iters=5)
        if name == "expand-kernel":
            b, k = args[2].states.shape
            e = got.state.shape[1]
            n_bytes, counted = expand_bytes(args, got)
            counted["valid_lanes"] = int(
                (got.state < tbeam.SENTINEL_STATE).sum())
            blocks = -(-e // 4096) * b  # frame_expand.cu kLanesPerBlock
            launch = dict(blocks=blocks, sms_used=f"{min(blocks, sms)}/{sms}")
        else:
            cfg, state, lms, _c, w1, w2 = args[:6]
            b, e = state.shape
            k = cfg.beam_size
            read = 8 + 4 * sum(x is not None for x in (lms, w1, w2))
            kept = int(torch.isfinite(got.costs).sum())
            n_bytes = b * e * read + 12 * kept + b * k * 24 + 4 * b
            counted = dict(kept=kept, demand=got.demand.tolist())
            launch = dict(**select_geometry_line(e, b),
                          **select_phase_ms(args))
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        phase(name, lm="on" if lm else "off", rows=b, lanes=e, beam=k,
              **counted, equal=equal, max_abs_err=err, ms=f"{t_k:.4f}",
              call_ms=f"{t_call:.4f}", plain_ms=f"{t_p:.4f}",
              bound_ms=f"{b_ms:.5f}", bound_by="bytes",
              share_of_bound=f"{b_ms / t_k:.4f}", **launch, card=f"'{card}'")
        if not equal:
            fail(f"{name}: the kernel differs from its plain version "
                 f"(LM {'on' if lm else 'off'})")
        totals = new_totals()
        totals["max_abs_err"] = err
        add_timing(totals, t_k, t_p, b_ms, "bytes")
        out[name] = totals
    # The selection on one row, and (LM on) on a table in global memory.
    shapes = [("select-kernel-b1", [sel[0]] + [
        None if x is None else x[:1].contiguous() for x in sel[1:]])]
    if lm:
        shapes.append(("select-kernel-global",
                       synthetic_select_args(5, 2, 100_000, 8192, True,
                                             cuda)))
    for name, args in shapes:
        got, _, equal = kernel_equals_plain(tbeam.select_beam,
                                            tbeam.select_beam_ref, args)
        b, e = args[1].shape
        t_k = device_ms(lambda: tbeam.select_beam(*args))
        phase(name, lm="on" if lm else "off", rows=b, lanes=e,
              beam=args[0].beam_size, demand=got.demand.tolist(),
              kept=int(torch.isfinite(got.costs).sum()), equal=equal,
              ms=f"{t_k:.4f}", **select_geometry_line(e, b),
              card=f"'{card}'")
        if not equal:
            fail(f"{name}: frame_select.cu differs from select_beam_ref at "
                 f"{b} x {e} lanes, beam {args[0].beam_size}")
    return out["expand-kernel"], out["select-kernel"]


def select_mask_phase(card, cuda=torch.device("cuda:0")):
    """frame_select.cu at the held cells' selections, 16 rows of frame-like
    candidates (synthetic_select_args, LM off): bulk-lmoff's 38,912 lanes
    at beam 2,048 (the table in shared memory) and bulk-chain's 209,416 at
    7,000 (in global memory, sized to each row's live lanes), each with
    every row valid and with 5 live rows of 16 (row_valid): bit-equal to
    select_beam_ref under the same mask; device ms (CUDA graph replay),
    launches a call, the clusters one wave of the launch holds
    (cudaOccupancyMaxActiveClusters) and the rows' phase ms and table
    slots from the stamps."""
    valid = np.zeros(16, bool)
    valid[[0, 3, 6, 9, 12]] = True
    for name, e, k in (("select-kernel-mask-shared", 38_912, 2048),
                       ("select-kernel-mask-global", 209_416, 7000)):
        args = synthetic_select_args(6, 16, e, k, False, cuda)
        for rows, mask in (("16", None),
                           ("5-of-16", torch.from_numpy(valid).to(cuda))):
            def fn(*a, mask=mask):
                return tbeam.select_beam(*a, row_valid=mask)

            def ref_fn(*a, mask=mask):
                return tbeam.select_beam_ref(*a, row_valid=mask)

            got, _, equal = kernel_equals_plain(fn, ref_fn, args)
            before = tbeam.select_beam.launches
            fn(*args)
            launches = tbeam.select_beam.launches - before
            t_k = device_ms(lambda: fn(*args))
            phase(name, rows_valid=rows, lanes=e, beam=k, equal=equal,
                  kept=int(torch.isfinite(got.costs).sum()),
                  ms=f"{t_k:.4f}", launches=launches,
                  wave_clusters=tbeam.select_clusters(e, k),
                  **select_geometry_line(e, 16),
                  **select_phase_ms(args, row_valid=mask), card=f"'{card}'")
            if not equal:
                fail(f"{name}: frame_select.cu differs from select_beam_ref "
                     f"with {rows} rows valid")
            if launches != 1:
                fail(f"{name}: one call launched {launches} kernels")


def expand_mask_phase(dec, num_pdfs, card, b=16, k=7000, expand=188_416,
                      cuda=torch.device("cuda:0")):
    """frame_expand.cu at bulk-chain's expansion, on the decoder's graph
    (the 50k-word trie): 16 rows of 7,000 live tokens (half on states with
    more arcs than the first-G block), expand 188,416, 209,416 lanes a
    row, acoustic scale 1.0; with every row valid and with a row mask of 5
    live rows of 16 (expand_emitting(..., row_valid=)).  The kernel's
    unmasked rows bit-equal to expand_emitting_ref's under the same mask,
    a masked row's overflow and needed 0; device ms (CUDA graph replay),
    the plain version's ms on the card, the bytes bound of the rows that
    ran (expand_bytes) and its share, and the blocks the launch holds and
    those that work."""
    dfst = dec.dfst
    rng = np.random.RandomState(7)
    cfg = tbeam.BeamConfig(beam_size=k, expand_size=expand, am_scale=1.0)
    e = tbeam.emit_lanes(cfg, dfst)
    if e != k + k * dfst.group + expand:  # 209,416 at bulk-chain's shape
        fail(f"expand-kernel-mask: {e} lanes a row, not {k} + {k} x "
             f"{dfst.group} + {expand}")
    n_emit = dfst.state_packed[:, 3].cpu().numpy()
    wide = np.flatnonzero(n_emit > dfst.group)
    states = np.where(rng.rand(b, k) < 0.5, rng.choice(wide, (b, k)),
                      rng.randint(0, dfst.num_states, (b, k)))
    beam = tbeam.BeamState(
        torch.from_numpy(states.astype(np.int32)).to(cuda),
        torch.zeros((b, k), dtype=torch.int32, device=cuda),
        torch.from_numpy(rng.uniform(0, 12, (b, k)).astype(np.float32))
        .to(cuda),
        torch.arange(k, dtype=torch.int32, device=cuda).expand(b, k),
        torch.zeros(b, dtype=torch.bool, device=cuda),
        torch.zeros((b, 5), dtype=torch.int32, device=cuda))
    logp = torch.from_numpy(np.log(rng.dirichlet(np.ones(num_pdfs), b))
                            .astype(np.float32)).to(cuda)
    valid = np.zeros(b, bool)
    valid[::3][:5] = True  # rows 0, 3, 6, 9 and 12 of 16
    per_row = -(-e // 4096)  # frame_expand.cu kLanesPerBlock
    args = (cfg, dfst, beam, logp, False)
    for rows, mask in (("16", None),
                       ("5-of-16", torch.from_numpy(valid).to(cuda))):
        def fn(*a, mask=mask):
            return tbeam.expand_emitting(*a, row_valid=mask)

        def ref_fn(*a, mask=mask):
            return tbeam.expand_emitting_ref(*a, row_valid=mask)

        got, ref = fn(*args), ref_fn(*args)
        torch.cuda.synchronize()
        keep = (torch.ones(b, dtype=torch.bool, device=cuda) if mask is None
                else mask)
        equal = all(same_bytes([r[keep]], [g[keep]])
                    for r, g in zip(ref, got) if r is not None)
        dead_flags = mask is None or not (
            got.overflow[~keep].any() or got.needed[~keep].any())
        t_k = device_ms(lambda: fn(*args))
        t_p = time_ms(lambda: ref_fn(*args), iters=3)
        sub = (cfg, dfst, tbeam.BeamState(*(x[keep] for x in beam)),
               logp[keep], False)
        n_bytes, counted = expand_bytes(
            sub, tbeam.EmitCands(*(None if x is None else x[keep]
                                   for x in got)))
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        phase("expand-kernel-mask", rows_valid=rows, lanes=e, beam=k,
              **counted, needed_max=int(got.needed[keep].max()),
              equal=equal, dead_flags=dead_flags, ms=f"{t_k:.4f}",
              plain_ms=f"{t_p:.4f}", bound_ms=f"{b_ms:.5f}",
              bound_by="bytes", share_of_bound=f"{b_ms / t_k:.4f}",
              blocks=per_row * b, blocks_working=per_row * int(keep.sum()),
              card=f"'{card}'")
        if not (equal and dead_flags):
            fail(f"expand-kernel-mask: frame_expand.cu differs from "
                 f"expand_emitting_ref with {rows} rows valid")


def lstm_kernel_phase(card, cuda=torch.device("cuda:0")):
    """csrc/lstm_recurrence.cu against its plain loop on the card at the
    TDNN-LSTM's widths, then the benchmark's TDNN-LSTM through
    batched_logp (see the module docstring); returns (its totals, the AM
    run's launches)."""
    from catears_tpu_torch.am import lstm as tlstm
    from catears_tpu_torch.runtime.batch import batched_logp

    b, t, c, r, p = 16, 1167, 1024, 256, 256
    g = torch.Generator().manual_seed(0)
    args = [x.to(cuda) for x in (
        torch.randn(b, t, 4 * c, generator=g),
        torch.randn(r, 4 * c, generator=g) / np.sqrt(1280.0),
        0.5 * torch.randn(3, c, generator=g),
        torch.randn(c, r + p, generator=g) / np.sqrt(c),
        0.1 * torch.randn(r + p, generator=g))]
    got = tlstm.lstm_recurrence(*args, 0.85)
    again = tlstm.lstm_recurrence(*args, 0.85)
    want = tlstm.lstm_recurrence_ref(*args, 0.85)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    same = torch.equal(got, again)
    t_k = time_ms(lambda: tlstm.lstm_recurrence(*args, 0.85), iters=5)
    t_p = time_ms(lambda: tlstm.lstm_recurrence_ref(*args, 0.85), iters=1)
    flops = b * t * (2.0 * r * 4 * c + 2.0 * c * (r + p) + 20 * c)
    n_bytes = 4.0 * (r * 4 * c + c * (r + p) + r + p + 3 * c) \
        + 4.0 * b * t * (4 * c + r + p + c)
    t_ops, t_bytes = flops / 67e12 * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    b_ms = max(t_ops, t_bytes)
    b_by = "operations" if t_ops >= t_bytes else "bytes"
    phase("lstm-kernel", batch=b, steps=t, cells=c, max_abs_err=f"{err:.3e}",
          scale=f"{scale:.3f}", bit_equal_runs=same, ms=f"{t_k:.4f}",
          us_per_step=f"{1e3 * t_k / t:.3f}", plain_ms=f"{t_p:.4f}",
          bound_ms=f"{b_ms:.6f}", bound_by=b_by,
          share_of_bound=f"{b_ms / t_k:.6f}", card=f"'{card}'")
    if err > 1e-5 * scale or not same:
        fail(f"lstm-kernel: gap {err!r} of {scale!r}, bit-equal runs {same}")
    del args, got, again, want
    totals = new_totals()
    totals["max_abs_err"] = err
    add_timing(totals, t_k, t_p, b_ms, b_by)

    from asrbench import chain_gen, lstm_gen, lstm_system

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "asrbench", "configs",
                           "swbd-tdnnlstm-chain-lex200k.json")) as fd:
        am_cfg = json.load(fd)["am"]
    rng = np.random.RandomState(3)
    stats = chain_gen.feature_stats(rng, 1000.0, am_cfg, seconds=2.0)
    model = lstm_gen.tdnnlstm_device(torch.Generator(cuda).manual_seed(0),
                                     cuda, am_cfg, 7000, stats)
    am = lstm_system.acoustic_model(model, am_cfg, 7000,
                                    np.zeros(14001, np.int32), cuda)
    waves = [(rng.randn(int(s * 16000)) * 1000).astype(np.float32)
             for s in np.linspace(3.0, 35.0, 16)]
    ivs = rng.randn(16, am_cfg["ivector_dim"]).astype(np.float32)
    batched_logp(am, waves, ivs)
    before = tlstm.lstm_recurrence.launches
    logp, lengths = batched_logp(am, waves, ivs)
    torch.cuda.synchronize()
    launched = tlstm.lstm_recurrence.launches - before
    t_am = time_ms(lambda: batched_logp(am, waves, ivs), iters=3)
    phase("lstm-am", utts=16, audio_s=f"{sum(w.size for w in waves) / 16000:.1f}",
          rows_max=max(lengths), launches=launched, ms=f"{t_am:.2f}",
          finite=bool(torch.isfinite(logp).all()), card=f"'{card}'")
    if launched != 3 or not torch.isfinite(logp).all():
        fail(f"lstm-am: {launched} recurrence launches for 3 LSTM layers")
    return totals, launched


def blstm_kernel_phase(card, cuda=torch.device("cuda:0")):
    """csrc/lstm_recurrence.cu at a chunked BLSTM's batch: 87 chunk windows
    of up to 84 rows in one launch, forward and backward (each window's
    rows reversed within its own length, `am.nnet.reverse_rows`), against
    the plain loop; then the benchmark's BLSTM through batched_logp (see
    the module docstring); returns (its totals, the AM run's launches)."""
    from catears_tpu_torch.am import lstm as tlstm
    from catears_tpu_torch.am.nnet import reverse_rows
    from catears_tpu_torch.runtime.batch import batched_logp

    b, t, c, r, p = 87, 84, 1024, 256, 256
    g = torch.Generator().manual_seed(1)
    weights = [x.to(cuda) for x in (
        torch.randn(r, 4 * c, generator=g) / np.sqrt(1280.0),
        0.5 * torch.randn(3, c, generator=g),
        torch.randn(c, r + p, generator=g) / np.sqrt(c),
        0.1 * torch.randn(r + p, generator=g))]
    gx = torch.randn(b, t, 4 * c, generator=g).to(cuda)
    lengths = torch.as_tensor(np.random.RandomState(1).randint(20, t + 1, b),
                              device=cuda)
    lengths[0] = t
    worst = 0.0
    for direction in ("forward", "backward"):
        x = gx if direction == "forward" else reverse_rows(gx, lengths)
        before = tlstm.lstm_recurrence.launches
        got = tlstm.lstm_recurrence(x, *weights, 0.85)
        launched = tlstm.lstm_recurrence.launches - before
        want = tlstm.lstm_recurrence_ref(x, *weights, 0.85)
        narrow = torch.cat([tlstm.lstm_recurrence(x[lo:lo + 16], *weights,
                                                  0.85)
                            for lo in range(0, b, 16)])
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        rows_equal = torch.equal(got, narrow)
        t_k = time_ms(lambda: tlstm.lstm_recurrence(x, *weights, 0.85),
                      iters=5)
        t_n = time_ms(lambda: [tlstm.lstm_recurrence(x[lo:lo + 16],
                                                     *weights, 0.85)
                               for lo in range(0, b, 16)], iters=3)
        t_p = time_ms(lambda: tlstm.lstm_recurrence_ref(x, *weights, 0.85),
                      iters=1)
        flops = b * t * (2.0 * r * 4 * c + 2.0 * c * (r + p) + 20 * c)
        n_bytes = 4.0 * (r * 4 * c + c * (r + p) + r + p + 3 * c) \
            + 4.0 * b * t * (4 * c + r + p + c)
        t_ops, t_bytes = flops / 67e12 * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        b_ms = max(t_ops, t_bytes)
        phase("blstm-kernel", direction=direction, batch=b, steps=t,
              launches=launched, max_abs_err=f"{err:.3e}",
              scale=f"{scale:.3f}", rows_equal_to_16_row_launches=rows_equal,
              ms=f"{t_k:.4f}", us_per_step=f"{1e3 * t_k / t:.3f}",
              ms_16_row_launches=f"{t_n:.4f}", plain_ms=f"{t_p:.4f}",
              bound_ms=f"{b_ms:.6f}", share_of_bound=f"{b_ms / t_k:.6f}",
              card=f"'{card}'")
        if err > 1e-5 * scale or not rows_equal or launched != 1:
            fail(f"blstm-kernel {direction}: gap {err!r} of {scale!r}, "
                 f"rows equal to 16-row launches {rows_equal}, {launched} "
                 f"launches")
    del gx, got, want, narrow
    totals = new_totals()
    totals["max_abs_err"] = worst
    add_timing(totals, t_k, t_p, b_ms,
               "operations" if t_ops >= t_bytes else "bytes")

    from asrbench import blstm_gen, blstm_system, chain_gen

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "asrbench", "configs",
                           "swbd-blstm-chain-lex200k.json")) as fd:
        cfg = json.load(fd)
    am_cfg = cfg["am"]
    rng = np.random.RandomState(3)
    stats = chain_gen.feature_stats(rng, 1000.0, am_cfg, seconds=2.0)
    model = blstm_gen.blstm_device(torch.Generator(cuda).manual_seed(0),
                                   cuda, am_cfg, 7000, stats)
    am = blstm_system.acoustic_model(model, am_cfg, cfg["chunk"], 7000,
                                     np.zeros(14001, np.int32), cuda)
    waves = [(rng.randn(int(s * 16000)) * 1000).astype(np.float32)
             for s in np.linspace(1.5, 35.0, 16)]
    ivs = rng.randn(16, am_cfg["ivector_dim"]).astype(np.float32)
    batched_logp(am, waves, ivs)
    before = tlstm.lstm_recurrence.launches
    logp, lengths = batched_logp(am, waves, ivs)
    torch.cuda.synchronize()
    launched = tlstm.lstm_recurrence.launches - before
    t_am = time_ms(lambda: batched_logp(am, waves, ivs), iters=3)
    phase("blstm-am", utts=16,
          audio_s=f"{sum(w.size for w in waves) / 16000:.1f}",
          rows_max=max(lengths), launches=launched, ms=f"{t_am:.2f}",
          finite=bool(torch.isfinite(logp).all()), card=f"'{card}'")
    if launched != 6 or not torch.isfinite(logp).all():
        fail(f"blstm-am: {launched} recurrence launches for 3 BLSTM layers")
    return totals, launched


def backtrace_kernel_phase(traces, best, card):
    """csrc/backtrace.cu (backtrace_device on cuda) against its plain
    version on the card, on the traces and best slots the e2e run's
    BatchDecoder backtraced: bit-equal words; device ms (CUDA graph
    replay), the call's ms, the plain version's ms, and the bound from the
    bytes the chase needs (a backpointer and a word row a frame while the
    chain lasts, the [B, T, W] output); returns its totals."""
    got = tbeam.backtrace_device(traces, best)
    ref = tbeam.backtrace_device_ref(traces, best)
    torch.cuda.synchronize()
    equal = torch.equal(got, ref)
    err = int((got - ref).abs().max())
    t_k = device_ms(lambda: tbeam.backtrace_device(traces, best), iters=5)
    t_call = time_ms(lambda: tbeam.backtrace_device(traces, best), iters=5)
    t_p = time_ms(lambda: tbeam.backtrace_device_ref(traces, best), iters=3)
    t, b, k, w = traces.words.shape
    prev = traces.prev_slot.cpu().numpy()
    steps = 0  # frames each chain is live for, summed
    for u, slot in enumerate(np.maximum(best.cpu().numpy(), 0)):
        for f in range(t - 1, -1, -1):
            steps += 1
            slot = prev[f, u, slot]
            if slot < 0:
                break
    n_bytes = steps * 4 * (1 + w) + 4 * b * t * w + 4 * b
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    phase("backtrace-kernel", frames=t, utts=b, beam=k, words_per_frame=w,
          chain_steps=steps, equal=equal, max_abs_err=err, ms=f"{t_k:.4f}",
          call_ms=f"{t_call:.4f}", plain_ms=f"{t_p:.4f}",
          bound_ms=f"{b_ms:.6f}", bound_by="bytes",
          share_of_bound=f"{b_ms / t_k:.6f}",
          latency_chain=f"{t} dependent loads", card=f"'{card}'")
    if not equal:
        fail("backtrace-kernel: the kernel differs from "
             "backtrace_device_ref")
    totals = new_totals()
    totals["max_abs_err"] = err
    add_timing(totals, t_k, t_p, b_ms, "bytes")
    return totals


def planted_wer(dec, tg, lm, planted_frames):
    """(WER, reference words, decode seconds, utterances, frames) of
    planted trie paths decoded on the card, as the JAX bench scores them:
    the cheapest token where an utterance ends mid-word."""
    n, frames = planted_frames[lm]
    planted, truth = plant_logp(np.random.RandomState(2), tg, n, frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = dec.decode(torch.from_numpy(planted).to(torch.device("cuda:0")),
                      final_fallback=True)
    dt = time.perf_counter() - t0
    errors = sum(token_errors([str(w) for w in t], [str(w) for w in h.words])
                 for t, h in zip(truth, hyps))
    n_ref = sum(len(t) for t in truth)
    return errors / n_ref, n_ref, dt, n, frames


def decoder_phase(name, dec, dec_cpu, logp, lengths, tg, card):
    """The same log-probs decoded on cuda and cpu, then planted trie paths
    on cuda; returns nothing, fails on a disagreement or a high WER.  The
    log-probs are cut to DECODER_FRAMES[lm] frames."""
    cuda = torch.device("cuda:0")
    lm = dec.dlm is not None
    logp = logp[:, :DECODER_FRAMES[lm]]
    lengths = [min(n, DECODER_FRAMES[lm]) for n in lengths]
    t0 = time.perf_counter()
    # final_fallback: random-weight acoustics rarely end in a final state;
    # backtrace the cheapest token so the paths compared are real.
    zero_counts()
    loops = FrameLoop(), FrameLoop()
    with loops[0]:
        hyp_gpu = dec.decode(logp, lengths, final_fallback=True)
    launched = loop_launches(name, counts(), lm, bulk=True)
    with loops[1]:
        hyp_cpu = dec_cpu.decode(logp.cpu(), lengths, final_fallback=True)
    same_words = [h.words for h in hyp_gpu] == [h.words for h in hyp_cpu]
    same_cost = ([np.float64(h.weight) for h in hyp_gpu]
                 == [np.float64(h.weight) for h in hyp_cpu])
    hiwater = [loop.marks() for loop in loops]
    phase(name, utts=len(lengths), frames=lengths,
          same_words=same_words, bit_equal_costs=same_cost,
          words=[len(h.words) for h in hyp_gpu],
          costs=[h.weight for h in hyp_gpu], hiwater=hiwater[0],
          same_hiwater=hiwater[0] == hiwater[1],
          ms_per_frame=loops[0].ms_per_frame(), **launched,
          seconds=f"{time.perf_counter() - t0:.2f}")
    if not (same_words and same_cost):
        fail(f"{name} on cuda and cpu disagree")
    if hiwater[0] != hiwater[1]:
        fail(f"{name}: high-water marks {hiwater[0]} on cuda, "
             f"{hiwater[1]} on cpu")

    wer, n_ref, dt, n, frames = planted_wer(dec, tg, lm, PLANTED)
    # Planted paths carry words: 3 s of two of them, on cuda and cpu.
    part = plant_logp(np.random.RandomState(2), tg, 2, 300)[0]
    hyp_gpu = dec.decode(torch.from_numpy(part).to(cuda),
                         final_fallback=True)
    hyp_cpu = dec_cpu.decode(part, final_fallback=True)
    same = ([(h.words, np.float64(h.weight)) for h in hyp_gpu]
            == [(h.words, np.float64(h.weight)) for h in hyp_cpu])
    tag = "planted" if name == "decoder" else "planted-lm"
    audio_s = n * frames / 100.0
    phase(tag, utts=n, audio_s=audio_s, wer=f"{wer:.4f}",
          ref_words=n_ref, decode_s=f"{dt:.2f}", xrt=f"{audio_s / dt:.2f}",
          cuda_equals_cpu_3s=same,
          words_3s=[len(h.words) for h in hyp_gpu], card=f"'{card}'")
    if wer > 0.25:
        fail(f"{name}: planted-path WER {wer:.3f} is too high")
    if not same or not all(h.words for h in hyp_gpu):
        fail(f"{name}: planted frames on cuda and cpu disagree")


class FrameLoop:
    """While entered, BatchDecoder's frame loop is read from its spans
    (log.start_tracing): its frames (the `decode.frames` spans'), its time
    on the host clock (from each decode's first `decode.frames` to the end
    of its `decode.read`, where the host waits for the last chunk), and
    the high-water marks the last `decode` span took from its final beam.
    On the card each chunk is a replayed CUDA graph, which holds no device
    read: its capture would have raised on one."""

    def __init__(self):
        self.spans = None  # the spans recorded, once exited

    def __enter__(self):
        log.start_tracing()
        return self

    def __exit__(self, *exc):
        log.stop_tracing()
        self.spans = log.spans()

    def _read(self):
        """(seconds, frames, high-water marks) of the decodes so far."""
        seconds, frames, hiwater, start = 0.0, 0, None, None
        for s in self.spans if self.spans is not None else log.spans():
            if s.name == "decode.frames":
                frames += s.attrs["frames"]
                start = s.start_ns if start is None else start
            elif s.name == "decode.read" and start is not None:
                seconds += (s.end_ns - start) / 1e9
                start = None
            elif s.name == "decode" and "hiwater" in s.attrs:
                hiwater = s.attrs["hiwater"]
        return seconds, frames, hiwater

    @property
    def frames(self):
        return self._read()[1]

    def ms_per_frame(self):
        seconds, frames, _ = self._read()
        return f"{seconds * 1e3 / frames:.3f}"

    def marks(self):
        """The five high-water slots, max over the batch."""
        return [int(x) for x in self._read()[2]]


class StepLoop:
    """While entered, the single-utterance Decoder's `decode_chunk` runs
    with every device read raising (torch.cuda.set_sync_debug_mode("error"))
    and timed on the host clock between two synchronizes; the high-water
    marks of the last chunk's beam are kept."""

    def __init__(self):
        from catears_tpu_torch.decode import decoder

        self.module, self.chunk = decoder, decoder.decode_chunk
        self.hiwater, self.seconds, self.frames = None, 0.0, 0

    def _watched(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            beam, trace = self.chunk(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.frames += args[3].shape[0]  # the chunk's log-prob rows
        self.hiwater = beam.hiwater
        return beam, trace

    def __enter__(self):
        self.module.decode_chunk = self._watched
        return self

    def __exit__(self, *exc):
        self.module.decode_chunk = self.chunk

    def ms_per_frame(self):
        return f"{self.seconds * 1e3 / self.frames:.3f}"

    def marks(self):
        """The five high-water slots, max over the batch."""
        return [int(x) for x in self.hiwater.amax(0).cpu()]


def closure_decoders(rec, delta_lm, cfg, dynamic=True):
    """{mode: (BatchDecoder on cuda, the same on the CPU)} of the trie with
    its epsilon arcs: 'closed' (close_epsilons, depth capped at 1, prebuilt
    tables adopted), 'raw' (close_eps=False, depth 2: the static rounds)
    and, if `dynamic`, 'raw-dynamic' (the raw tables at max_eps_iters = 1:
    the arena)."""
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.graph.device import DeviceFst
    from catears_tpu_torch.graph.transform import close_epsilons

    closed, ok = close_epsilons(rec.fst)
    if not ok:
        fail("close_epsilons refused the trie")
    tid2pdf = rec.am.tid2pdf
    decs = {}
    for dev in (torch.device("cuda:0"), torch.device("cpu")):
        dfst = DeviceFst.build(closed, tid2pdf, group=rec.arc_group,
                               eps_depth_cap=1, csr_group=rec.csr_group,
                               device=dev)
        decs.setdefault("closed", []).append(BatchDecoder(
            closed, tid2pdf, config=cfg, dfst=dfst, delta_lm=delta_lm))
        raw = BatchDecoder(rec.fst, tid2pdf, config=cfg,
                           arc_group=rec.arc_group, close_eps=False,
                           csr_group=rec.csr_group, device=dev,
                           delta_lm=delta_lm)
        decs.setdefault("raw", []).append(raw)
        if dynamic:
            decs.setdefault("raw-dynamic", []).append(BatchDecoder(
                rec.fst, tid2pdf,
                config=dataclasses.replace(cfg, max_eps_iters=1),
                dfst=raw.dfst, delta_lm=delta_lm))
    for mode, (dec, _) in decs.items():
        depth = 1 if mode == "closed" else 2
        static = depth <= dec.cfg.max_eps_iters
        if (dec.dfst.eps_removed or dec.dfst.eps_depth != depth
                or static != (mode != "raw-dynamic")):
            fail(f"{mode}: the trie's graph has eps_depth "
                 f"{dec.dfst.eps_depth} (eps_removed "
                 f"{dec.dfst.eps_removed}), not the {mode} path")
    return decs


def closure_phase(name, dec, dec_cpu, logp, lengths, tg, card,
                  require_wer=True):
    """A closed or raw decoder on the card: the AM's log-probs (LM on, cut
    to CUT_FRAMES[True]) timed per frame with no device read in the frame
    loop, then the first CUT_FRAMES[lm] of them on cuda and cpu (identical
    words, bit-equal costs), then the planted-path WER on the card."""
    cuda = torch.device("cuda:0")
    lm = dec.dlm is not None
    cut_frames = CUT_FRAMES[lm]
    frames = cut_frames if lm else logp.shape[1]
    cut = [min(n, cut_frames) for n in lengths]
    loop = FrameLoop()
    retries = log.metrics().get("overflow_retries", 0)
    zero_counts()
    with loop:
        hyp_gpu = dec.decode(logp[:, :frames],
                             [min(n, frames) for n in lengths],
                             final_fallback=True)
        ms_per_frame, hiwater = loop.ms_per_frame(), loop.marks()
    if frames != cut_frames:
        hyp_gpu = dec.decode(logp[:, :cut_frames], cut, final_fallback=True)
    wer, n_ref, planted_s, n, planted_frames = planted_wer(
        dec, tg, lm, CLOSURE_PLANTED)
    launched = loop_launches(name, counts(), lm, bulk=True, eps_free=False)
    t0 = time.perf_counter()
    hyp_cpu = dec_cpu.decode(logp[:, :cut_frames].cpu(), cut,
                             final_fallback=True)
    cpu_s = time.perf_counter() - t0
    same_words = [h.words for h in hyp_gpu] == [h.words for h in hyp_cpu]
    same_cost = ([np.float64(h.weight) for h in hyp_gpu]
                 == [np.float64(h.weight) for h in hyp_cpu])
    retried = log.metrics().get("overflow_retries", 0) - retries
    phase(name, utts=len(lengths), frames=frames, cpu_frames=cut,
          same_words=same_words, bit_equal_costs=same_cost,
          no_device_read_in_frame_loop=True,
          ms_per_frame=ms_per_frame, hiwater=hiwater,
          eps_depth=dec.dfst.eps_depth,
          max_eps_iters=dec.cfg.max_eps_iters, overflow_retries=retried,
          planted_utts=n, planted_frames=planted_frames,
          planted_wer=f"{wer:.4f}", planted_ref_words=n_ref,
          planted_ms_per_frame=f"{planted_s * 1e3 / planted_frames:.3f}",
          **launched, cpu_s=f"{cpu_s:.2f}", card=f"'{card}'")
    if not (same_words and same_cost):
        fail(f"{name} on cuda and cpu disagree")
    if require_wer and wer > 0.25:
        fail(f"{name}: planted-path WER {wer:.3f} is too high")


def variant_tables(fst, tid2pdf, rec, dev, hot_rows=0):
    """(decode graph, DeviceFst on the CPU, the same on `dev`, build
    seconds) of `fst` in eps-free mode at the smoke config's groups."""
    from catears_tpu_torch.graph.device import DeviceFst, build_arrays
    from catears_tpu_torch.graph.transform import prepare_decode_graph

    t0 = time.perf_counter()
    dec_fst, olab2, mode = prepare_decode_graph(fst)
    if mode != "eps_free":
        fail(f"variants: the graph's mode is {mode}, not eps_free")
    arrays, meta = build_arrays(dec_fst, tid2pdf, group=rec.arc_group,
                                csr_group=rec.csr_group, eps_depth_cap=1,
                                olabel2=olab2, hot_rows=hot_rows)
    on_cpu, on_cuda = (DeviceFst.from_numpy(arrays, meta, device=d)
                       for d in (torch.device("cpu"), dev))
    sync(dev)
    return dec_fst, on_cpu, on_cuda, time.perf_counter() - t0


def expect_overflow(dec, logp, slot, cap, name):
    """The hiwater of a decode that must raise BeamCapacityError with
    hiwater[slot] > cap (no retry)."""
    from catears_tpu_torch.utils.errors import BeamCapacityError

    try:
        dec.decode(logp, retry_on_overflow=False, final_fallback=True)
    except BeamCapacityError as err:
        if err.hiwater[slot] <= cap:
            fail(f"{name}: hiwater[{slot}] {err.hiwater[slot]} <= {cap}")
        return list(err.hiwater)
    fail(f"{name}: no BeamCapacityError")


def cold_overflow(dec_fst, dfst, cfg, default, tg, over):
    """A cold cap of 8 on the hot graph must raise (hiwater[4] > 8); its
    one regrow-and-retry must give the default decode's words or raise
    again, never other words.  The retry grows the cold lanes from the
    truncated decode's mark, a lower bound of the demand (cold tokens that
    read a wrong row steer the beam elsewhere), so one retry may not be
    enough: JAX's policy, which the port keeps."""
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.utils.errors import BeamCapacityError

    dec8 = BatchDecoder(dec_fst, tg.tid2pdf, dfst=dfst,
                        config=dataclasses.replace(cfg, cold_expand_size=8))
    hw8 = expect_overflow(dec8, over, 4, 8, "cold cap 8")
    want = [h.words for h in BatchDecoder(
        default[0], tg.tid2pdf, dfst=default[2], config=dataclasses.replace(
            cfg, cold_expand_size=0)).decode(over, final_fallback=True)]
    try:
        got = [h.words for h in dec8.decode(over, final_fallback=True)]
        retry = "recovered"
    except BeamCapacityError as err:
        got, retry = None, f"raised_again_hiwater={list(err.hiwater)}"
    phase("variant-cold-overflow", cold_expand_size=8, frames=over.shape[1],
          hiwater=hw8, retry=retry, retry_words_equal=got == want)
    if got is not None and got != want:
        fail("cold cap 8: the retry's words differ from the default's")


def variants_phase(rec, tg, card, cuda=torch.device("cuda:0")):
    """The exact decode variants on the smoke's trie model, LM off: the
    same planted log-probs through BatchDecoder with each (select_compact
    at K and at the default decode's hiwater[3]; the hot_order graph with
    the hot/cold split; the bfs and freq renumberings).  Each decodes the
    default's words, its costs equal (within 1e-3 on a renumbered graph),
    with no device read in the frame loop, and cuda == cpu on the first
    VARIANT_CPU_FRAMES frames.  A variant that overflows without the retry
    is reported and decoded again with it.  Then the loud overflows:
    select_compact=1 at beam 1e9 raises, and so does a cold cap of 8
    (`cold_overflow`)."""
    from catears_tpu_torch import bench
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.graph.transform import (bfs_order,
                                                   frequency_order,
                                                   hot_order,
                                                   renumber_states)
    from catears_tpu_torch.utils.errors import BeamCapacityError

    cfg = rec.beam_config
    n, frames = VARIANT_PLANTED
    planted = plant_logp(np.random.RandomState(3), tg, n, frames)[0]
    planted_dev = torch.from_numpy(planted).to(cuda)
    cut = planted[:, :VARIANT_CPU_FRAMES]
    over = planted_dev[:, :OVERFLOW_FRAMES]
    t0 = time.perf_counter()
    visits = bench._calibrate_counts(
        tg.fst, tg.tid2pdf,
        plant_logp(np.random.RandomState(4), tg, 4, 300)[0], cuda)
    calibration_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bfs = bfs_order(tg.fst)
    graphs = {"hot": renumber_states(tg.fst,
                                     hot_order(visits, VARIANT_HOT_ROWS)),
              "bfs": renumber_states(tg.fst, bfs),
              "freq": renumber_states(tg.fst,
                                      frequency_order(visits, tie_break=bfs))}
    phase("variants-setup", planted_utts=n, frames=frames,
          calibrated_states=int((visits > 0).sum()),
          calibration_s=f"{calibration_s:.2f}",
          renumber_s=f"{time.perf_counter() - t0:.2f}")
    default = variant_tables(tg.fst, tg.tid2pdf, rec, cuda)
    specs = [("default", None, {}),
             ("select-compact-K", None, {"select_compact": cfg.beam_size}),
             ("select-compact-hiwater", None, "hiwater"),
             ("hot", "hot", {"cold_expand_size": VARIANT_COLD}),
             ("bfs", "bfs", {}), ("freq", "freq", {})]
    ref = None
    for name, key, changes in specs:
        tables = default if key is None else variant_tables(
            graphs.pop(key), tg.tid2pdf, rec, cuda,
            hot_rows=VARIANT_HOT_ROWS if key == "hot" else 0)
        dec_fst, on_cpu, on_cuda, build_s = tables
        if changes == "hiwater":
            changes = {"select_compact": ref[2][3]}
        vcfg = dataclasses.replace(cfg, **changes)
        dec = BatchDecoder(dec_fst, tg.tid2pdf, config=vcfg, dfst=on_cuda)
        loop = FrameLoop()
        overflowed = None
        zero_counts()
        with loop, spied(tbeam, "expand_emitting", []) as ex, \
                spied(tbeam, "select_beam", []) as sel:
            try:
                hyps = dec.decode(planted_dev, retry_on_overflow=False,
                                  final_fallback=True)
            except BeamCapacityError as err:
                overflowed = list(err.hiwater)
        ms_per_frame, hiwater = loop.ms_per_frame(), loop.marks()
        # The knobs run in the kernels: both launch every frame, and each
        # equals its plain version on the decode's last frame.
        launched = counts()
        frame = (launched["frame_expand"], launched["frame_select"])
        if not all(frame):
            fail(f"variant-{name}: {frame} frame_expand / frame_select "
                 f"launches")
        kernels_equal = [kernel_equals_plain(fn, ref_fn, args)[2]
                         for fn, ref_fn, args in (
                             (tbeam.expand_emitting,
                              tbeam.expand_emitting_ref, ex),
                             (tbeam.select_beam, tbeam.select_beam_ref,
                              sel))]
        if not all(kernels_equal):
            fail(f"variant-{name}: the frame kernels differ from their "
                 f"plain versions (expand, select: {kernels_equal})")
        if overflowed:  # the regrow-and-retry
            hyps = dec.decode(planted_dev, final_fallback=True)
        words = [h.words for h in hyps]
        costs = np.array([h.weight for h in hyps], np.float64)
        if ref is None:
            ref = (words, costs, hiwater)
        cost_diff = float(np.abs(costs - ref[1]).max())
        cost_ok = cost_diff <= 1e-3 if key else bool((costs == ref[1]).all())
        hyp_gpu = dec.decode(planted_dev[:, :VARIANT_CPU_FRAMES],
                             final_fallback=True)
        t0 = time.perf_counter()
        hyp_cpu = BatchDecoder(dec_fst, tg.tid2pdf, config=vcfg,
                               dfst=on_cpu).decode(cut, final_fallback=True)
        cpu_s = time.perf_counter() - t0
        cpu_same = ([(h.words, np.float64(h.weight)) for h in hyp_gpu]
                    == [(h.words, np.float64(h.weight)) for h in hyp_cpu])
        phase(f"variant-{name}", build_s=f"{build_s:.2f}",
              ms_per_frame=ms_per_frame, hiwater=hiwater,
              select_compact=vcfg.select_compact,
              cold_expand_size=vcfg.cold_expand_size,
              hot_rows=on_cuda.hot_rows,
              emit_lanes=on_cuda.emit_block.shape[1],
              overflowed_without_retry=overflowed,
              expand_launches=frame[0], select_launches=frame[1],
              kernels_equal_plain=kernels_equal,
              words=[len(w) for w in words], same_words=words == ref[0],
              max_cost_diff=f"{cost_diff:.3e}", cuda_equals_cpu=cpu_same,
              cpu_frames=VARIANT_CPU_FRAMES, cpu_s=f"{cpu_s:.2f}",
              card=f"'{card}'")
        if words != ref[0] or not all(words):
            fail(f"variant-{name}: words differ from the default decode's")
        if not cost_ok:
            fail(f"variant-{name}: costs {costs} against {ref[1]}")
        if not cpu_same:
            fail(f"variant-{name}: cuda and cpu disagree")
        if key == "hot":
            cold_overflow(dec_fst, on_cuda, vcfg, default, tg, over)
        del tables, on_cpu, on_cuda, dec
        if cuda.type == "cuda":
            torch.cuda.empty_cache()
    hw1 = expect_overflow(
        BatchDecoder(default[0], tg.tid2pdf, dfst=default[2],
                     config=dataclasses.replace(cfg, select_compact=1,
                                                beam=1e9)),
        over, 3, cfg.beam_size, "select_compact=1")
    phase("variant-select-overflow", select_compact=1, beam="1e9",
          hiwater=hw1)


def write_raw_conf(work, conf, fst):
    """A copy of `conf` whose graph is `fst` plus one epsilon path s
    -eps:1-> s+1 -eps:2-> s+2 on three new states, unreachable from the
    start.  close_epsilons refuses a path with two output labels, so
    prepare_decode_graph returns 'raw' and every frame runs the closure
    rounds; the transcripts are the trie's."""
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.graph.transform import prepare_decode_graph
    from catears_tpu_torch.io import binfmt

    n = fst.num_states
    state_of_arc = np.repeat(np.arange(n), np.diff(fst.offsets))
    raw = FlatFst.from_arrays(
        fst.start, np.concatenate([fst.final,
                                   np.full(3, np.inf, np.float32)]),
        np.concatenate([state_of_arc, [n, n + 1]]),
        np.concatenate([fst.arc_next, [n + 1, n + 2]]).astype(np.int32),
        np.concatenate([fst.arc_ilabel, [0, 0]]).astype(np.int32),
        np.concatenate([fst.arc_olabel, [1, 2]]).astype(np.int32),
        np.concatenate([fst.arc_weight, [0.5, 0.5]]).astype(np.float32))
    mode = prepare_decode_graph(raw)[2]
    if mode != "raw":
        fail(f"the trie with a two-word epsilon path is '{mode}', not raw")
    with open(os.path.join(work, "raw.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, raw.to_raw())
    path = os.path.join(work, "raw.conf")
    with open(conf) as src, open(path, "w") as dst:
        dst.writelines([x for x in src if not x.startswith("fst ")]
                       + ["fst = raw.fst\n"])
    return path


def linears(am):
    return sum(1 for layer in am.nnet_def if layer[0] == "linear")


def run_cli(argv):
    """(exit code, stdout lines, stderr) of cli.main(argv)."""
    from catears_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue().strip()


def e2e_phase(name, conf, scp, cpu_scp, linears, card, watch=False,
              lm=False, backtrace=None, eps_free=True):
    """cli.main(["--batch=8", conf, scp]) on cuda, then the same with
    --device=cpu on `cpu_scp`, the first CPU_UTTS utterances (the longest
    among them, so the AM's bucket and each utterance's result are the
    batch's); returns the launches the card run made through each kernel's
    entry point, counted from 0 just before it (the LM walk's only with
    `lm`, the frame kernels' only with `eps_free`).  With `watch`, the
    card run's frame loop must make no device
    read, and its ms per frame and high-water marks are printed.  A list
    `backtrace` receives the card run's last backtrace_device arguments."""
    from catears_tpu_torch.io.wav import read_scp
    from catears_tpu_torch.runtime.batch import load_waves

    n_utts = len(read_scp(scp))
    audio_s = sum(w.shape[0] for w in load_waves(
        [p for _, p in read_scp(scp)])) / 16000.0
    retries = log.metrics().get("overflow_retries", 0)
    torch.cuda.synchronize()
    zero_counts()
    loop = FrameLoop() if watch else contextlib.nullcontext()
    t0 = time.perf_counter()
    with loop, spied(tdecoder, "backtrace_device",
                     [] if backtrace is None else backtrace):
        rc, lines, err = run_cli(["--batch=8", conf, scp])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    extra = {} if not watch or not loop.frames else dict(
        ms_per_frame=loop.ms_per_frame(), hiwater=loop.marks())
    launches = counts()
    overflowed = log.metrics().get("overflow_retries", 0) != retries
    t0 = time.perf_counter()
    cpu_rc, cpu_lines, cpu_err = run_cli(["--batch=8", "--device=cpu", conf,
                                          cpu_scp])
    cpu_dt = time.perf_counter() - t0
    same = lines[:len(cpu_lines)] == cpu_lines
    if rc != 0:
        fail(f"{name}: cli exited {rc}: {err}")
    phase(name, rc=rc, lines=len(lines), utts=n_utts,
          words=[len(line.split()) - 1 for line in lines],
          cpu_utts=len(cpu_lines), same_as_cpu=same,
          fused_launches=launches["qmatmul"],
          int32_launches=launches["matmul_s8"], linears=linears,
          **loop_launches(name, launches, lm, bulk=True, eps_free=eps_free),
          overflow=overflowed,
          wall_s=f"{dt:.2f}", audio_s=f"{audio_s:.2f}",
          audio_s_per_s=f"{audio_s / dt:.2f}", cpu_wall_s=f"{cpu_dt:.2f}",
          **extra, card=f"'{card}'")
    if len(lines) != n_utts or any(
            not line.startswith(f"utt{i}") for i, line in enumerate(lines)):
        fail(f"{name}: expected one line per utterance, got {lines!r}")
    if overflowed:
        fail(f"{name}: the decode overflowed its capacities")
    if launches["qmatmul"] != linears * -(-n_utts // 8):
        fail(f"{name}: {launches['qmatmul']} fused kernel launches for "
             f"{linears} linear layers")
    if cpu_rc != 0:
        fail(f"{name}: cli --device=cpu exited {cpu_rc}: {cpu_err}")
    if len(cpu_lines) != CPU_UTTS or not same:
        fail(f"{name}: transcripts on cuda {lines!r} differ from the CPU's "
             f"{cpu_lines!r}")
    return launches


def decode_utterance(rec, payload, fused, chunk_bytes=1024):
    """An Utterance over PCM bytes (16 kHz, 16-bit mono): its hypothesis."""
    from catears_tpu_torch.io.wav import WaveFormat
    from catears_tpu_torch.runtime.recognizer import Utterance

    utt = Utterance(rec, WaveFormat(1, 16000, 16), fused=fused)
    for off in range(0, len(payload), chunk_bytes):
        utt.process(payload[off:off + chunk_bytes])
    utt.end_of_stream()
    return utt.hyp


def stream_phase(work, card):
    """The toy model with online CMVN, float and int8, through Utterance
    fused and componentized on cuda and on the CPU; returns the fused
    kernel's launches in the card's int8 runs (each counted from 0)."""
    from catears_tpu_torch.io.wav import read_pcm_header
    from catears_tpu_torch.runtime.recognizer import Recognizer
    from catears_tpu_torch.tools.toy import write_toy_model

    cuda, cpu = torch.device("cuda:0"), torch.device("cpu")
    data = os.path.join(REPO, "tests", "data")
    d = os.path.join(work, "toy")
    base = write_toy_model(d, num_words=5, hidden=32, num_pdfs=24)
    shutil.copy(os.path.join(data, "cmvn_stats.bin"), d)
    launches = 0
    for quantized in (False, True):
        conf = os.path.join(d, f"stream{int(quantized)}.conf")
        with open(base) as src, open(conf, "w") as dst:
            dst.write(src.read() + "".join(
                f"{x}\n" for x in STREAM_GEOMETRY
                + ("cmvn_stats = cmvn_stats.bin",)
                + (("quantized = true",) if quantized else ())))
        recs = {"cuda": Recognizer(conf, device=cuda),
                "cpu": Recognizer(conf, device=cpu)}
        for wav in ("hello", "cat"):
            with open(os.path.join(data, f"en-us-{wav}.wav"), "rb") as fd:
                read_pcm_header(fd)
                payload = fd.read()
            hyps, runs = {}, []
            t0 = time.perf_counter()
            for dev, rec in recs.items():
                for fused in (True, False):
                    torch.cuda.synchronize()
                    quant.qmatmul.launches = 0
                    hyps[dev, fused] = decode_utterance(rec, payload, fused)
                    if dev == "cuda":
                        runs.append(quant.qmatmul.launches)
            launches += sum(runs)
            same = len(set(hyps.values())) == 1
            phase("stream", wav=wav, quantized=quantized, cmvn=True,
                  hyp=f"'{hyps['cuda', True]}'", all_equal=same,
                  fused_launches=runs[0], componentized_launches=runs[1],
                  seconds=f"{time.perf_counter() - t0:.2f}")
            if not same:
                fail(f"stream {wav} (quantized={quantized}): fused and "
                     f"componentized on cuda and cpu disagree: {hyps}")
            if not hyps["cuda", True]:
                fail(f"stream {wav} (quantized={quantized}): empty "
                     f"transcript")
            if quantized and not all(runs):
                fail(f"stream {wav}: an int8 run on cuda launched the fused "
                     f"kernel {runs} times")
            if not quantized and any(runs):
                fail(f"stream {wav}: the float AM launched the int8 kernel")
    return launches


def decoder_words(dec, row):
    """The single-utterance Decoder over [T, P] log-probs: its
    end-of-stream words, or, when no final state is reachable, the cheapest
    token's (BatchDecoder's final_fallback)."""
    dec.process(row)
    dec.end_of_stream()
    dec.check_capacity()
    hyp = dec.best_path()
    if not hyp.words and hyp.weight == 0.0:  # best_path's "no final"
        dec.is_end_of_stream = False
        hyp = dec.best_path()
    return hyp.words


def stream_decoder_phase(name, rec, tg, card, frames, decoder=None,
                         batch_decoder=None, eps_free=True):
    """Planted trie log-probs (2 x `frames`) through the single-utterance
    Decoder on the card (the Recognizer's cached graph, or `decoder`
    re-initialized per utterance): the words BatchDecoder (the
    Recognizer's, or `batch_decoder`) gives on the card, and the planted
    WER.  With `decoder`, no device read in its frame loop, and the
    high-water marks."""
    from catears_tpu_torch.decode.decoder import Decoder
    from catears_tpu_torch.runtime.batch import get_batch_decoder
    from catears_tpu_torch.runtime.recognizer import AM_SCALE

    cuda = torch.device("cuda:0")
    planted, truth = plant_logp(np.random.RandomState(2), tg, 2, frames)
    cfg, dfst, dlm = rec._decode_graph()

    def fresh():
        if decoder is None:
            return Decoder(rec.fst, rec.am.tid2pdf, am_scale=AM_SCALE,
                           delta_lm=rec.delta_lm, config=cfg, dfst=dfst,
                           dlm=dlm)
        decoder.initialize()
        return decoder

    loop = StepLoop() if decoder is not None else contextlib.nullcontext()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with loop:
            words = [decoder_words(fresh(), row) for row in planted]
    except RuntimeError as e:  # set_sync_debug_mode("error") raised
        fail(f"{name}: a device read in the Decoder's frame loop: {e}")
    dt = time.perf_counter() - t0
    launched = loop_launches(name, counts(), rec.delta_lm is not None,
                             bulk=False, eps_free=eps_free)
    batch = (batch_decoder or get_batch_decoder(rec)).decode(
        torch.from_numpy(planted).to(cuda), final_fallback=True)
    same = words == [h.words for h in batch]
    errors = sum(token_errors([str(w) for w in t], [str(w) for w in h])
                 for t, h in zip(truth, words))
    n_ref = sum(len(t) for t in truth)
    extra = {} if decoder is None else dict(
        eps_depth=decoder.dfst.eps_depth, hiwater=loop.marks(),
        step_ms_per_frame=loop.ms_per_frame(),
        no_device_read_in_frame_loop=True)
    phase(name, utts=2, frames=frames, same_as_batch_decoder=same,
          words=[len(w) for w in words], wer=f"{errors / n_ref:.4f}",
          ref_words=n_ref, decode_s=f"{dt:.2f}",
          ms_per_frame=f"{dt * 1e3 / (2 * frames):.3f}", **extra,
          **launched, card=f"'{card}'")
    if not same:
        fail(f"{name}: the Decoder's words differ from BatchDecoder's")
    if errors / n_ref > 0.25:
        fail(f"{name}: planted-path WER {errors / n_ref:.3f} is too high")


def percentile_ms(seconds, q):
    return f"{float(np.percentile(np.asarray(seconds) * 1e3, q)):.2f}"


def run_streams(rec, waves, timed):
    """The waves as live streams of one BatchStreamingSession: TICK samples
    per stream per tick through process_batch, then end_of_stream per
    stream.  Returns (words per stream, tick seconds, partials() seconds,
    chunk steps, wall seconds)."""
    batch = rec.create_stream_batch(len(waves))
    steps = [0]
    step_group = batch._step_group

    def counted(group, first):
        steps[0] += 1
        step_group(group, first)

    batch._step_group = counted
    sync = torch.cuda.synchronize if timed else (lambda: None)
    ticks, partials = [], []
    n_ticks = max(-(-w.shape[0] // TICK) for w in waves)
    sync()
    t_start = time.perf_counter()
    for t in range(n_ticks):
        t0 = time.perf_counter()
        batch.process_batch([w[t * TICK:(t + 1) * TICK] for w in waves])
        sync()
        t1 = time.perf_counter()
        if timed:
            batch.partials()
        ticks.append(t1 - t0)
        partials.append(time.perf_counter() - t1)
    for u in range(len(waves)):
        batch.end_of_stream(u)
    words = [batch.best_path(u, end_of_stream=True).words
             for u in range(len(waves))]
    sync()
    return words, ticks, partials, steps[0], time.perf_counter() - t_start


def solo_utterance(rec, wave):
    """One Utterance over a wave fed TICK samples per call: per-call
    seconds (host clock around a synchronize) and the wall seconds."""
    from catears_tpu_torch.io.wav import WaveFormat
    from catears_tpu_torch.runtime.recognizer import Utterance

    pcm = wave.astype("<i2").tobytes()
    utt = Utterance(rec, WaveFormat(1, 16000, 16))
    calls = []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for off in range(0, len(pcm), 2 * TICK):
        t0 = time.perf_counter()
        utt.process(pcm[off:off + 2 * TICK])
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    utt.end_of_stream()
    torch.cuda.synchronize()
    return calls, time.perf_counter() - t_start


def stream_trie_phase(name, rec, conf, waves, n_linears, card,
                      solo_s=10.0):
    """8 live streams on the card, the first CPU_STREAMS of them checked
    against the same streams on the CPU (each stream's result does not
    depend on the others), then a solo Utterance; returns the launches of
    the card's stream run."""
    from catears_tpu_torch.runtime.recognizer import Recognizer

    from catears_tpu_torch.utils.errors import BeamCapacityError

    audio_s = sum(w.shape[0] for w in waves) / 16000.0
    try:
        run_streams(rec, [w[:2 * TICK] for w in waves], True)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        words, ticks, partials, steps, wall = run_streams(rec, waves, True)
        launches = counts()
        t0 = time.perf_counter()
        cpu_words = run_streams(Recognizer(conf, device=torch.device("cpu")),
                                waves[:CPU_STREAMS], False)[0]
        cpu_s = time.perf_counter() - t0
        solo = waves[0][:int(solo_s * 16000)]
        calls, solo_wall = solo_utterance(rec, solo)
    except BeamCapacityError as e:
        fail(f"{name}: {e}")
    solo_audio = solo.shape[0] / 16000.0
    phase(name, streams=len(waves), ticks=len(ticks), chunk_steps=steps,
          words=[len(w) for w in words], cpu_streams=CPU_STREAMS,
          same_as_cpu=words[:CPU_STREAMS] == cpu_words,
          fused_launches=launches["qmatmul"], linears=n_linears,
          **loop_launches(name, launches, rec.delta_lm is not None,
                          bulk=False),
          tick_ms_p50=percentile_ms(ticks, 50),
          tick_ms_p99=percentile_ms(ticks, 99),
          partials_ms_p50=percentile_ms(partials, 50),
          partials_ms_p99=percentile_ms(partials, 99),
          wall_s=f"{wall:.2f}", audio_s=f"{audio_s:.2f}",
          audio_s_per_s=f"{audio_s / wall:.3f}", cpu_wall_s=f"{cpu_s:.2f}",
          solo_audio_s=f"{solo_audio:.2f}", solo_wall_s=f"{solo_wall:.2f}",
          solo_audio_s_per_s=f"{solo_audio / solo_wall:.3f}",
          solo_chunk_ms_p50=percentile_ms(calls, 50),
          solo_chunk_ms_p99=percentile_ms(calls, 99), card=f"'{card}'")
    if words[:CPU_STREAMS] != cpu_words:
        fail(f"{name}: transcripts on cuda {words[:CPU_STREAMS]} differ from "
             f"the CPU's {cpu_words}")
    # Each chunk step runs every linear once; so does each stream's
    # end-of-stream tail.
    if launches["qmatmul"] != n_linears * (steps + len(waves)):
        fail(f"{name}: {launches['qmatmul']} fused launches for {steps} "
             f"chunk steps and {len(waves)} tails of {n_linears} linears")
    return launches


def bench_env(**knobs):
    """os.environ without any BENCH_* knob, plus `knobs`."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs)
    return env


def run_times(stderr, tag):
    """The run seconds a bench printed for `tag` (its `# [tag] run_s=`)."""
    for line in stderr.splitlines():
        if line.startswith(f"# [{tag}] run_s="):
            return json.loads(line.split("run_s=", 1)[1].split(" min_s")[0])
    fail(f"the bench printed no run times for {tag}")


def argmin_phase():
    """The headline's final-slot pick on the card: bench.first_argmin takes
    the first index on ties (-0.0 == 0.0, rows of +inf), as jnp.argmin and
    numpy do; torch.argmin's choice on the card is printed beside it."""
    from catears_tpu_torch.bench import first_argmin

    rng = np.random.RandomState(5)
    x = rng.randint(0, 4, (16, 2048)).astype(np.float32)
    x[0] = np.inf
    x[1, 7:] = np.inf
    x[2, ::2], x[2, 1::2] = -0.0, 0.0
    want = np.argmin(x, axis=1)
    x_gpu = torch.from_numpy(x).to(torch.device("cuda:0"))
    got = first_argmin(x_gpu).cpu().numpy()
    lib = torch.argmin(x_gpu, dim=1).cpu().numpy()
    phase("argmin", rows=x.shape[0], first_on_ties=bool((got == want).all()),
          torch_argmin_first=bool((lib == want).all()))
    if not (got == want).all():
        fail(f"first_argmin on cuda picked {got}, not {want}")


# `python -m catears_tpu_torch.bench`, then the launches of the decoder's
# kernels it made (warm-up and timed runs, LM off and on) on stderr.
BENCH_COUNTED = """
import runpy, sys
from catears_tpu_torch.decode.beam import (backtrace_device, expand_emitting,
                                           select_beam)
from catears_tpu_torch.graph.device import lm_propagate_capped
try:
    runpy.run_module("catears_tpu_torch.bench", run_name="__main__")
finally:
    print(f"# [launches] lm_walk={lm_propagate_capped.launches} "
          f"backtrace={backtrace_device.launches} "
          f"frame_expand={expand_emitting.launches} "
          f"frame_select={select_beam.launches}", file=sys.stderr)
"""


def bench_phase(card):
    """`python -m catears_tpu_torch.bench` in a subprocess at its defaults
    (the 50k-word trie, TDNN-1024 x 5, beam 2048, 16 x 10 s), BENCH_RUNS=1:
    exit 0, bench.py's JSON keys, a planted WER LM off and on, no capacity
    overflow (the bench asserts it after its warm-up run), and launches of
    lm_walk (LM on) and backtrace; returns them."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", BENCH_COUNTED],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=900, env=bench_env(BENCH_RUNS="1"))
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("# ["):
            print(f"[bench] {line[2:]}", flush=True)
    if proc.returncode != 0:
        fail(f"bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    summaries = [x for x in proc.stderr.splitlines()
                 if x.startswith(("# [lm-off] graph=", "# [lm-on] graph="))]
    line = [x for x in proc.stderr.splitlines()
            if x.startswith("# [launches] ")][-1]
    launched = {"matmul_s8": 0, "qmatmul": 0,  # the bench's AM is float
                **{k: int(v) for k, v in (x.split("=")
                                          for x in line.split()[2:])}}
    phase("bench", rc=proc.returncode, xrt=record.get("value"),
          wer=record.get("wer"), lm_on_xrt=record.get("lm_on_xrt"),
          lm_on_wer=record.get("lm_on_wer"),
          ratio=record.get("lm_on_ratio_off_over_on"),
          lm_off_s=run_times(proc.stderr, "lm-off"),
          lm_on_s=run_times(proc.stderr, "lm-on"), wall_s=f"{wall:.2f}",
          **loop_launches("bench", launched, True, bulk=True),
          card=f"'{card}'")
    if set(record) != BENCH_JSON_KEYS:
        fail(f"bench printed keys {sorted(record)}, not "
             f"{sorted(BENCH_JSON_KEYS)}")
    if record["metric"] != "audio_seconds_per_sec_per_chip":
        fail(f"bench printed metric {record['metric']}")
    if len(summaries) != 2 or not all("capacity_hiwater=" in x
                                      and "WER=" in x for x in summaries):
        fail(f"bench printed no LM-off and LM-on summaries: {summaries}")
    if record["wer"] > 0.25 or record["lm_on_wer"] > 0.25:
        fail(f"bench planted WER {record['wer']} / {record['lm_on_wer']} "
             f"is too high")
    return launched


def bench_mode_phase(name, metric, card, **knobs):
    """One mode of the bench in this process (`bench.run()`, stdout and
    stderr captured) at BENCH_SECONDS=2: its JSON line carries `metric`;
    returns the launches it made through each entry point of the kernel,
    counted from 0 just before it."""
    from catears_tpu_torch import bench

    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(bench_env(**{"BENCH_SECONDS": BENCH_MODE_SECONDS,
                                   "BENCH_RUNS": BENCH_MODE_RUNS, **knobs}))
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.run()
    except Exception as e:  # noqa: BLE001 - any failure fails the phase
        fail(f"{name}: {type(e).__name__}: {e}\n{err.getvalue()[-2000:]}")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    torch.cuda.synchronize()
    launches = counts()
    wall = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        if line.startswith("# ") and ("latency" in line or "times=" in line
                                      or " xRT" in line):
            print(f"[{name}] {line[2:]}", flush=True)
    record = json.loads(out.getvalue().strip().splitlines()[-1])
    phase(name, rc=rc, metric=record["metric"], xrt=record["value"],
          wer=record.get("wer"), fused_launches=launches["qmatmul"],
          **loop_launches(name, launches, False,
                          bulk=knobs.get("BENCH_MODE") == "product",
                          eps_free=knobs.get("BENCH_MODE") != "am"),
          wall_s=f"{wall:.2f}", card=f"'{card}'")
    if rc != 0 or record["metric"] != metric or not record["value"] > 0 \
            or not {"metric", "value", "unit", "vs_baseline"} <= set(record):
        fail(f"{name}: rc {rc}, record {record}")
    if record.get("wer", 0.0) > 0.25:
        fail(f"{name}: planted WER {record['wer']} is too high")
    return launches


def bench_modes(card):
    """bench-product, bench-am (float, then int8 with its `qmatmul`
    launches: one per linear per AM forward, the warm-up's included) and
    bench-streaming (solo and BENCH_STREAMS streams); returns the int8
    run's launches."""
    bench_mode_phase("bench-product", "product_batch_audio_seconds_per_sec",
                     card, BENCH_MODE="product")
    launches = bench_mode_phase("bench-am",
                                "am_forward_audio_seconds_per_sec_float",
                                card, BENCH_MODE="am")
    if launches["qmatmul"] or launches["matmul_s8"]:
        fail(f"bench-am: the float AM launched the int8 kernel {launches}")
    launches = bench_mode_phase("bench-am-int8",
                                "am_forward_audio_seconds_per_sec_int8",
                                card, BENCH_MODE="am", BENCH_QUANT="1")
    forwards = 1 + int(BENCH_MODE_RUNS)  # warm-up + timed runs
    if launches["qmatmul"] != 6 * forwards or launches["matmul_s8"]:
        fail(f"bench-am-int8: {launches} launches for {forwards} forwards "
             f"of 6 linears")
    bench_mode_phase("bench-streaming", "streaming_audio_seconds_per_sec",
                     card, BENCH_MODE="streaming")
    bench_mode_phase("bench-streaming-16",
                     "batched_streaming_audio_seconds_per_sec", card,
                     BENCH_MODE="streaming", BENCH_STREAMS=BENCH_STREAMS)
    return launches


# -- the last slice: parallel, distributed, dryrun, scaling, native, synth --


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parallel_batch(waves):
    """The first PARALLEL_FRACTION of each wave, zero-padded into one
    [B, S] batch, and the ragged frame counts."""
    from catears_tpu_torch.frontend.fbank import num_frames

    cut = [w[:int(w.shape[0] * PARALLEL_FRACTION)] for w in waves]
    batch = np.zeros((len(cut), max(w.shape[0] for w in cut)), np.float32)
    for i, w in enumerate(cut):
        batch[i, :w.shape[0]] = w
    return batch, np.array([num_frames(w.shape[0]) for w in cut], np.int32)


def unsharded_step(am, dfst, cfg, wave, lengths):
    """The float AM over the whole batch and one decode_chunk, on dfst's
    device: (logp [B, T, P], beam, traces)."""
    from catears_tpu_torch.decode.beam import decode_chunk, init_beam_batch
    from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames

    dev = dfst.device
    t = num_frames(wave.shape[1])
    with torch.no_grad():
        feats = fbank_from_wave(torch.from_numpy(wave).to(dev), t)
        b = feats.shape[0]
        padded = torch.cat([feats[:, :1].expand(b, am.left_context, -1),
                            feats,
                            feats[:, -1:].expand(b, am.right_context, -1)],
                           dim=1)
        logp = am.float_nnet(padded) - am.log_prior
        beam, _ = init_beam_batch(cfg, b, dfst)
        valid = (torch.arange(t, device=dev)[:, None]
                 < torch.from_numpy(lengths).to(dev)[None, :])
        beam, traces = decode_chunk(cfg, dfst, beam, logp.transpose(0, 1),
                                    valid)
    return logp, beam, traces


def held_to(name, got, ref):
    """Sharded (logp, beam, traces) against the unsharded step: log-probs
    within 2e-4, states and words equal, costs within 1e-3 (the JAX
    dryrun's bars); returns the numbers for the phase line."""
    err = float((got[0].cpu() - ref[0].cpu()).abs().max())
    finite = torch.isfinite(ref[1].costs.cpu())
    cost_err = float((got[1].costs.cpu() - ref[1].costs.cpu())[finite]
                     .abs().max())
    states = torch.equal(got[1].states.cpu(), ref[1].states.cpu())
    words = torch.equal(got[2].words.cpu(), ref[2].words.cpu())
    if not (err <= 2e-4 and states and words and cost_err <= 1e-3
            and torch.equal(torch.isfinite(got[1].costs.cpu()), finite)):
        fail(f"{name}: sharded != unsharded: logp err {err:.3e}, states "
             f"{states}, words {words}, cost err {cost_err:.3e}")
    return dict(max_logp_err=f"{err:.3e}", states_equal=states,
                words_equal=words, max_cost_err=f"{cost_err:.3e}")


def parallel_phase(conf, waves, card, dev=torch.device("cuda:0")):
    """ShardedPipeline on the card at the smoke's width (the trie model's
    float TDNN-1024, beam 2048, expand 32768), batch 8 of the seeded waves
    (their first PARALLEL_FRACTION, ragged), over each mesh of
    PARALLEL_MESHES (logical shards of the cards there are), held to the
    unsharded step; returns (batch, lengths, the unsharded reference) for
    the distributed phase."""
    from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                                 logical_devices, make_mesh)
    from catears_tpu_torch.runtime.recognizer import Recognizer

    from catears_tpu_torch.frontend.fbank import num_frames

    rec = Recognizer(conf, device=dev)
    cfg, dfst, _ = rec._decode_graph()
    wave, lengths = parallel_batch(waves)
    quant.matmul_s8.launches = quant.qmatmul.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    ref = unsharded_step(rec.am, dfst, cfg, wave, lengths)
    words = ref[2].words.cpu()
    phase("parallel", mesh="unsharded", utts=len(lengths),
          frames=lengths.tolist(), step_s=f"{time.perf_counter() - t0:.3f}",
          card=f"'{card}'")
    for n, mp in PARALLEL_MESHES:
        devices = logical_devices(n, dev)
        pipe = ShardedPipeline(rec.am, dfst, None, cfg,
                               make_mesh(n, mp, devices=devices))
        step = pipe.jit_full_step(num_frames(wave.shape[1]))
        sync(dev)
        t0 = time.perf_counter()
        got = step(torch.from_numpy(wave), pipe.make_beam(len(wave)),
                   torch.from_numpy(lengths))
        got[2].words.cpu()
        wall = time.perf_counter() - t0
        phase("parallel", mesh=f"{n // mp}x{mp}",
              devices=[str(d) for d in devices], step_s=f"{wall:.3f}",
              **held_to(f"parallel {n // mp}x{mp}", got, ref),
              card=f"'{card}'")
    if quant.qmatmul.launches or quant.matmul_s8.launches:
        fail("parallel: the float AM launched the int8 kernel")
    return wave, lengths, {"states": ref[1].states.cpu().numpy(),
                           "costs": ref[1].costs.cpu().numpy(),
                           "words": words.numpy(),
                           "logp": ref[0].cpu().numpy()}


DIST_WORKER = r"""
import sys, time
import numpy as np
import torch

rank, port, conf, data, kind = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4], sys.argv[5])
from catears_tpu_torch.parallel import distributed

distributed.initialize(f"localhost:{port}", num_processes=2, process_id=rank)
from catears_tpu_torch.frontend.fbank import num_frames
from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                             logical_devices, make_mesh)
from catears_tpu_torch.runtime.recognizer import Recognizer

ref = np.load(data)
dev = logical_devices(2, kind)[rank]
rec = Recognizer(conf, device=dev)
cfg, dfst, _ = rec._decode_graph()
lo, hi = distributed.local_batch_slice(len(ref["lengths"]))
pipe = ShardedPipeline(rec.am, dfst, None, cfg, make_mesh(1, devices=[dev]))
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
t0 = time.perf_counter()
logp, beam, traces = pipe.full_step(
    torch.from_numpy(ref["wave"][lo:hi]), pipe.make_beam(hi - lo),
    torch.from_numpy(ref["lengths"][lo:hi]),
    n_frames=num_frames(ref["wave"].shape[1]))
states = beam.states.cpu().numpy()
wall = time.perf_counter() - t0
costs = beam.costs.cpu().numpy()
assert np.array_equal(states, ref["states"][lo:hi]), "states"
assert np.array_equal(traces.words.cpu().numpy(), ref["words"][:, lo:hi])
fin = np.isfinite(ref["costs"][lo:hi])
assert np.array_equal(np.isfinite(costs), fin)
assert np.abs(costs[fin] - ref["costs"][lo:hi][fin]).max() <= 1e-3
assert np.abs(logp.cpu().numpy() - ref["logp"][lo:hi]).max() <= 2e-4
frames = distributed.global_sum(float(ref["lengths"][lo:hi].sum()))
assert frames == float(ref["lengths"].sum()), frames
print(f"rank {rank} ok slice={lo}:{hi} device={dev} step_s={wall:.3f} "
      f"total_frames={frames:.0f}", flush=True)
distributed.shutdown()
"""


def distributed_phase(work, conf, wave, lengths, ref, card, kind="cuda"):
    """Two processes, rank 0 and 1, in one gloo group over localhost, each
    on its card (cuda:0 for both on a one-card machine): each decodes its
    local_batch_slice of the parallel phase's batch through a
    ShardedPipeline, equal to the in-process unsharded reference, and
    global_sum gives the total frames.  Each process has a timeout."""
    import socket

    data = os.path.join(work, "dist_ref.npz")
    np.savez(data, wave=wave, lengths=lengths, **ref)
    script = os.path.join(work, "dist_worker.py")
    with open(script, "w") as fd:
        fd.write(DIST_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, str(r), str(port),
                               conf, data, kind], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"distributed: a rank ran past {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"rank {r} ok" not in out:
            fail(f"distributed: rank {r} exited {p.returncode}:\n"
                 f"{out[-3000:]}")
    lines = [x.split(" ok ", 1)[1] for out in outs for x in out.splitlines()
             if " ok slice=" in x]
    phase("distributed", ranks=2, backend="gloo", results=lines,
          wall_s=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")


def dryrun_phase(card, kind="cuda"):
    """graft_entry.dryrun_multichip(8) on the card (it holds the sharded
    step to the unsharded one and raises otherwise), then entry()'s step
    once."""
    from catears_tpu_torch import graft_entry

    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            graft_entry.dryrun_multichip(8, kind)
        fn, args = graft_entry.entry(kind)
        t1 = time.perf_counter()
        logp, costs = fn(*args)
        finite = bool(torch.isfinite(costs).any())
        step = time.perf_counter() - t1
    except Exception as e:  # noqa: BLE001 - any failure fails the phase
        fail(f"dryrun: {type(e).__name__}: {e}")
    if "dryrun_multichip OK" not in out.getvalue() or not finite:
        fail(f"dryrun: {out.getvalue()!r}, finite costs {finite}")
    phase("dryrun", result=f"'{out.getvalue().strip()}'",
          entry_shapes=[tuple(logp.shape), tuple(costs.shape)],
          entry_step_s=f"{step:.3f}",
          wall_s=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")


def native_phase(work, conf, scp, card):
    """The native host library builds (its compiler output on failure);
    each entry point equals the Python path: the smoke's 8 WAVs, the trie
    written as a ConstFst, a random backtrace, edit distances.  Host times
    (best of NATIVE_REPS) of load_waves native vs Python and of the trie's
    FlatFst.read: pk::fst_0 (what Recognizer reads), ConstFst native and
    Python."""
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.io.config import Configuration
    from catears_tpu_torch.io.openfst import (ConstFst, read_const_fst_file,
                                              write_const_fst)
    from catears_tpu_torch.io.wav import read_16k_pcm, read_scp
    from catears_tpu_torch.decode.hyp import HostTrace, backtrace
    from catears_tpu_torch.tools.score import edit_distance
    from catears_tpu_torch.utils import native

    t0 = time.perf_counter()
    if native.load() is None:
        fail(f"native: the library did not build:\n{native.BUILD_LOG}")
    build_s = time.perf_counter() - t0

    def best(fn):
        times = []
        for _ in range(NATIVE_REPS):
            t = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t)
        return out, min(times)

    paths = [p for _, p in read_scp(scp)]
    nat, wav_nat = best(lambda: native.load_wav_batch(paths))
    py, wav_py = best(lambda: [read_16k_pcm(p) for p in paths])
    wav_equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(nat, py)) and len(nat) == len(py)

    pk_path = Configuration.read(conf).get_path("fst")
    fst, pk_s = best(lambda: FlatFst.read(pk_path))
    hclg = os.path.join(work, "trie.hclg")
    with open(hclg, "wb") as fd:
        write_const_fst(fd, ConstFst(
            start=fst.start, final=fst.final,
            arc_pos=fst.offsets[:-1].astype(np.int64),
            arc_count=np.diff(fst.offsets).astype(np.int32),
            arc_ilabel=fst.arc_ilabel, arc_olabel=fst.arc_olabel,
            arc_weight=fst.arc_weight, arc_next=fst.arc_next))
    f_nat, const_nat = best(lambda: FlatFst.read(hclg))
    f_py, const_py = best(lambda: FlatFst.from_const_fst(
        read_const_fst_file(hclg)))
    fst_equal = f_nat.start == f_py.start == fst.start and all(
        np.array_equal(getattr(f_nat, k), getattr(f_py, k))
        and np.array_equal(getattr(f_nat, k), getattr(fst, k))
        for k in ("final", "offsets", "arc_ilabel", "arc_olabel",
                  "arc_weight", "arc_next"))

    rng = np.random.RandomState(3)
    t_len, k, w = 1000, 2048, 2
    prev = rng.randint(0, k, (t_len, k)).astype(np.int32)
    prev[0] = -1
    words = np.where(rng.rand(t_len, k, w) < 0.05,
                     rng.randint(1, 50000, (t_len, k, w)), 0).astype(np.int32)
    traces = [HostTrace(prev[f], words[f]) for f in range(t_len)]
    slots = [int(s) for s in rng.randint(0, k, 8)]
    bt_nat = [native.backtrace(prev, words, s) for s in slots]
    with mock.patch.object(native, "available", lambda: False):
        bt_py = [backtrace(traces, s) for s in slots]  # the Python walk
    bt_equal = bt_nat == bt_py and any(bt_py)
    pairs = [(list(rng.randint(0, 30, rng.randint(0, 60))),
              list(rng.randint(0, 30, rng.randint(0, 60))))
             for _ in range(200)]
    ed_equal = all(native.edit_distance(a, b) == edit_distance(a, b)[0]
                   for a, b in pairs)
    phase("native", build_s=f"{build_s:.2f}", wavs=len(paths),
          wav_equal=wav_equal, load_ms_native=f"{wav_nat * 1e3:.3f}",
          load_ms_python=f"{wav_py * 1e3:.3f}", states=fst.num_states,
          arcs=fst.num_arcs, fst_equal=fst_equal,
          pk_read_s=f"{pk_s:.4f}", const_read_s_native=f"{const_nat:.4f}",
          const_read_s_python=f"{const_py:.4f}",
          backtrace_equal=bt_equal, edit_distance_equal=ed_equal,
          card=f"'{card}'")
    if not (wav_equal and fst_equal and bt_equal and ed_equal):
        fail("native: an entry point differs from the Python path")


def synth_data(synthesizer, fbank, rng, n, frames, left, right):
    """n synthesized utterances as train_am's (features, labels) pairs,
    and every utterance's frame labels."""
    from catears_tpu_torch.frontend.fbank import num_frames
    from catears_tpu_torch.tools.synth import fbank_labels

    data, labels = [], []
    for _ in range(n):
        s, t, _ = synthesizer.utterance(rng, frames)
        nf = num_frames(s.shape[0])
        lab = fbank_labels(t, nf)
        labels.append(lab)
        data.append((fbank.compute(s), lab[left:nf - right]))
    return data, labels


def first_step_loss(nnet_def, params, x, y):
    """tools.synth.loss_fn in float64 (loss_fn itself is float32:
    nnet_forward reads its inputs as float32): the gradients' reference."""
    from catears_tpu_torch.am.nnet import apply_layer

    for layer, p in zip(nnet_def, params):
        x = (torch.matmul(x, p["w"]) + p["b"] if layer[0] == "linear"
             else apply_layer(layer[0], layer, x, p))
    return -torch.mean(torch.gather(x, 2, y[:, :, None].long())[:, :, 0])


def synth_phase(work, tg, card, cuda=torch.device("cuda:0")):
    """tools.synth on the card: train_am at tests/test_synth.py's size
    meets its bars (dev accuracy > 0.5 after 800 steps, WER < 0.15 on 3
    fresh utterances through Recognizer(device=cuda)); then at the full
    width of scripts/realism.py (TDNN-1024 x 5 on the smoke's 50k-word
    trie, 200 phones x 6 variants = 3600 pdfs), cut in depth to
    SYNTH_FULL_UTTS utterances of SYNTH_FULL_S seconds and
    SYNTH_FULL_STEPS steps: the first step's loss and gradients on cuda
    vs cpu, steps per second and dev accuracy (no WER bar: variants are
    built to be near-indistinguishable)."""
    from catears_tpu_torch.am.nnet import build_nnet
    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.frontend.fbank import Fbank
    from catears_tpu_torch.runtime.recognizer import (Recognizer,
                                                      decode_wav_file)
    from catears_tpu_torch.tools import synth
    from catears_tpu_torch.tools.toy import make_toy_nnet

    fbank = Fbank(device=cuda)
    rng = np.random.RandomState(0)
    g = make_trie_graph(rng, num_words=60, num_phones=20, variants=1,
                        bigram_states=15, phones_per_word=(3, 5))
    synthesizer = synth.Synthesizer(g, 20, 1, rng)
    spec = make_toy_nnet(rng, hidden=64, num_pdfs=g.num_pdfs,
                         num_tdnn_layers=2)
    data, labels = synth_data(synthesizer, fbank, rng, 24, 300,
                              spec.left_context, spec.right_context)
    sync(cuda)
    t0 = time.perf_counter()
    spec2, acc = synth.train_am(spec, data, steps=SYNTH_STEPS, batch=8,
                                device=cuda)
    sync(cuda)
    train_s = time.perf_counter() - t0
    d = os.path.join(work, "synth")
    conf, _ = synth.write_trained_model(
        d, g, spec2, synth.empirical_prior(labels, g.num_pdfs))
    rec = Recognizer(conf, beam_config=BeamConfig(
        beam_size=512, expand_size=4096, eps_expand_size=2048,
        max_eps_iters=3), device=cuda)
    test_rng = np.random.RandomState(77)
    errs = ref_len = 0
    for i in range(3):
        s, _, words = synthesizer.utterance(test_rng, 300)
        wav = os.path.join(d, f"t{i}.wav")
        synth.write_wav(wav, s)
        truth = [f"word{w}" for w in words]
        errs += token_errors(truth, decode_wav_file(rec, wav).split())
        ref_len += len(truth)
    wer = errs / max(1, ref_len)
    phase("synth", size="test_synth", pdfs=g.num_pdfs, steps=SYNTH_STEPS,
          train_s=f"{train_s:.2f}",
          steps_per_s=f"{SYNTH_STEPS / train_s:.1f}", dev_acc=f"{acc:.4f}",
          wer=f"{wer:.4f}", card=f"'{card}'")
    if not (acc > 0.5 and wer < 0.15):
        fail(f"synth: dev accuracy {acc:.4f} (bar > 0.5), WER {wer:.4f} "
             f"(bar < 0.15)")

    t0 = time.perf_counter()
    rng = np.random.RandomState(1)
    synthesizer = synth.Synthesizer(tg, 200, 6, rng, markov=True)
    spec = make_toy_nnet(rng, hidden=HIDDEN, num_pdfs=tg.num_pdfs,
                         num_tdnn_layers=5)
    data, _ = synth_data(synthesizer, fbank, rng, SYNTH_FULL_UTTS,
                         int(SYNTH_FULL_S * 100), spec.left_context,
                         spec.right_context)
    data_s = time.perf_counter() - t0
    spec_bn, feats, labs, n_dev = synth.training_windows(spec, data)
    nnet_def, params = build_nnet(spec_bn)
    idx = np.random.RandomState(0).randint(0, feats.shape[0] - n_dev, 8)
    runs = []
    for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"),
                                                torch.float32),
                       (torch.device("cpu"), torch.float64)):
        p = [{k: torch.tensor(v, device=dev, dtype=dtype, requires_grad=True)
              for k, v in layer.items()} for layer in params]
        x = torch.from_numpy(feats[n_dev:][idx]).to(dev, dtype)
        fn = synth.loss_fn if dtype == torch.float32 else first_step_loss
        loss = fn(nnet_def, p, x, torch.from_numpy(labs[n_dev:][idx]).to(dev))
        loss.backward()
        runs.append((loss.item(), [(f"{i}.{k}", v.grad.cpu().double())
                                   for i, layer in enumerate(p)
                                   for k, v in layer.items()]))
    (loss_dev, g_dev), (loss_cpu, g_cpu), (loss_64, g_64) = runs

    def worst(grads):
        """max over tensors of max |g - g64| / max |g64|, and which."""
        return max((float((g - r).abs().max() / r.abs().max()), name)
                   for (name, g), (_, r) in zip(grads, g_64))
    loss_err = abs(loss_dev - loss_64) / abs(loss_64)
    loss_err_cpu = abs(loss_cpu - loss_64) / abs(loss_64)
    (grad_err, grad_at), (grad_err_cpu, grad_at_cpu) = (worst(g_dev),
                                                        worst(g_cpu))
    sync(cuda)
    t0 = time.perf_counter()
    _, acc = synth.train_am(spec, data, steps=SYNTH_FULL_STEPS, batch=8,
                            device=cuda)
    sync(cuda)
    train_s = time.perf_counter() - t0
    phase("synth", size="realism", words=tg.num_words, pdfs=tg.num_pdfs,
          hidden=HIDDEN, utts=SYNTH_FULL_UTTS, windows=feats.shape[0],
          data_s=f"{data_s:.2f}", first_loss=f"{loss_64:.6f}",
          loss_rel_err=f"{loss_err:.3e}", loss_rel_err_cpu=f"{loss_err_cpu:.3e}",
          grad_rel_err=f"{grad_err:.3e}@{grad_at}",
          grad_rel_err_cpu=f"{grad_err_cpu:.3e}@{grad_at_cpu}",
          steps=SYNTH_FULL_STEPS, train_s=f"{train_s:.2f}",
          steps_per_s=f"{SYNTH_FULL_STEPS / train_s:.1f}",
          dev_acc=f"{acc:.4f}", card=f"'{card}'")
    if not (loss_err <= 1e-5 and grad_err <= 1e-4 and np.isfinite(acc)):
        fail(f"synth: first step on cuda vs the CPU's float64: loss "
             f"{loss_err:.3e} (bar 1e-5), gradients {grad_err:.3e} of their "
             f"range (bar 1e-4)")



def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    print(card, flush=True)
    phase("device", kind=f"'{torch.cuda.get_device_name(0)}'",
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    load_kernels()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for name, log_text in BUILD_LOG.items():
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    totals = {"matmul_s8": kernel_phase(card), "qmatmul": qkernel_phase(card)}
    totals["lstm_recurrence"], lstm_launches = lstm_kernel_phase(card)
    totals["lstm_recurrence_chunks"], blstm_launches = \
        blstm_kernel_phase(card)

    from catears_tpu_torch.decode.decoder import BatchDecoder, Decoder
    from catears_tpu_torch.io.wav import read_scp
    from catears_tpu_torch.runtime.batch import (batched_logp,
                                                 get_batch_decoder,
                                                 load_waves)
    from catears_tpu_torch.runtime.recognizer import AM_SCALE, Recognizer

    work = os.path.join(BUILD_DIR, "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        conf, lm_conf = write_confs(work)
        scp = write_wavs(work, np.random.RandomState(1), 8)
        phase("model", words=NUM_WORDS, hidden=HIDDEN,
              seconds=f"{time.perf_counter() - t0:.2f}")

        # -- am: the same two waves through the int8 AM on cuda and cpu ----
        t0 = time.perf_counter()
        cuda = torch.device("cuda:0")
        rec = Recognizer(conf, device=cuda)
        if not rec.am.quantized:
            fail("the smoke config did not select the int8 AM")
        waves = load_waves([p for _, p in read_scp(scp)[:2]])
        before = quant.qmatmul.launches
        logp, lengths = batched_logp(rec.am, waves)
        torch.cuda.synchronize()
        launched = quant.qmatmul.launches - before
        rec_cpu = Recognizer(conf, device=torch.device("cpu"))
        ref, _ = batched_logp(rec_cpu.am, waves)
        worst = range_error(ref, logp, lengths)
        phase("am", utts=2, frames=lengths, max_err_over_range=f"{worst:.3e}",
              fused_launches=launched,
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not np.isfinite(logp.cpu().numpy()).all():
            fail("non-finite log-probs on cuda")
        if worst >= 0.01:
            fail(f"int8 AM on cuda vs cpu: error {worst:.3e} of range")
        if launched != linears(rec.am):
            fail(f"the AM on cuda made {launched} fused launches for "
                 f"{linears(rec.am)} linears")

        calibrated_phase(conf, waves, load_waves(
            [p for _, p in read_scp(scp)]), card)

        # -- decoder: same log-probs on cuda and cpu, LM off then on -------
        tg = make_trie_graph(np.random.RandomState(0), num_words=NUM_WORDS)
        dec_cpu = BatchDecoder(rec_cpu.fst, rec_cpu.am.tid2pdf,
                               config=rec_cpu.beam_config,
                               arc_group=rec_cpu.arc_group,
                               csr_group=rec_cpu.csr_group,
                               device=torch.device("cpu"))
        decoder_phase("decoder", get_batch_decoder(rec), dec_cpu, logp,
                      lengths, tg, card)
        del dec_cpu, rec_cpu
        totals["frame_expand"], totals["frame_select"] = frame_kernel_phase(
            get_batch_decoder(rec), tg, card)
        select_mask_phase(card)
        expand_mask_phase(get_batch_decoder(rec),
                          int(np.asarray(rec.am.tid2pdf).max()) + 1, card)

        t0 = time.perf_counter()
        rec_lm = Recognizer(lm_conf, device=cuda)
        if rec_lm.delta_lm is None:
            fail("the LM config did not load a delta-LM")
        phase("lm-config", lm_expand_size=rec_lm.beam_config.lm_expand_size,
              seconds=f"{time.perf_counter() - t0:.2f}")
        lm_phase(rec_lm.delta_lm, card)
        t0 = time.perf_counter()
        dec_lm = get_batch_decoder(rec_lm)
        dec_lm_cpu = BatchDecoder(rec_lm.fst, rec_lm.am.tid2pdf,
                                  config=rec_lm.beam_config,
                                  arc_group=rec_lm.arc_group,
                                  csr_group=rec_lm.csr_group,
                                  device=torch.device("cpu"),
                                  delta_lm=rec_lm.delta_lm)
        phase("lm-decoders", seconds=f"{time.perf_counter() - t0:.2f}")
        totals["lm_walk"] = lm_kernel_phase(dec_lm, tg, card)
        frame_kernel_phase(dec_lm, tg, card)
        decoder_phase("decoder-lm", dec_lm, dec_lm_cpu, logp, lengths, tg,
                      card)
        del dec_lm_cpu

        # -- the trie with its epsilon arcs: closed and raw decodes --------
        for r, delta, tag in ((rec, None, ""), (rec_lm, rec_lm.delta_lm,
                                                "-lm")):
            t0 = time.perf_counter()
            decs = closure_decoders(r, delta, r.beam_config,
                                    dynamic=delta is None)
            phase(f"closure-decoders{tag}",
                  seconds=f"{time.perf_counter() - t0:.2f}")
            for mode, (dec, dec_c) in decs.items():
                closure_phase(f"decoder-{mode}{tag}", dec, dec_c, logp,
                              lengths, tg, card,
                              require_wer=mode != "raw-dynamic")
            if delta is None:
                raw_dec = decs["raw"][0]
            del decs, dec, dec_c

        # -- the exact decode variants (select_compact, hot/cold, orders) -
        variants_phase(rec, tg, card)

        # -- e2e: the CLI's batch path on cuda, LM off, on, raw graph ------
        n_linears = linears(rec.am)
        cpu_scp = os.path.join(work, "smoke_cpu.scp")
        lm_scp = os.path.join(work, "smoke_lm.scp")
        for path, n in ((cpu_scp, CPU_UTTS), (lm_scp, E2E_LM_UTTS)):
            with open(scp) as src, open(path, "w") as dst:
                dst.writelines(src.readlines()[:n])
        raw_conf = write_raw_conf(work, conf, rec.fst)
        traced = []
        runs = [e2e_phase("e2e", conf, scp, cpu_scp, n_linears, card,
                          backtrace=traced)]
        totals["backtrace"] = backtrace_kernel_phase(*traced, card)
        del traced
        runs += [e2e_phase("e2e-lm", lm_conf, lm_scp, cpu_scp, n_linears,
                           card, lm=True),
                 e2e_phase("e2e-raw", raw_conf, scp, cpu_scp, n_linears,
                           card, watch=True, eps_free=False)]

        # -- the live-stream path: toy model, Decoder, 8 trie streams ------
        runs.append({"matmul_s8": 0, "qmatmul": stream_phase(work, card),
                     "lm_walk": 0, "backtrace": 0, "frame_expand": 0,
                     "frame_select": 0})
        stream_decoder_phase("stream-decoder", rec, tg, card, 500)
        stream_decoder_phase("stream-decoder-lm", rec_lm, tg, card, 150)
        stream_decoder_phase(
            "stream-decoder-raw", rec, tg, card, 500,
            decoder=Decoder(rec.fst, rec.am.tid2pdf, am_scale=AM_SCALE,
                            config=rec.beam_config, arc_group=rec.arc_group,
                            close_eps=False, csr_group=rec.csr_group,
                            device=cuda),
            batch_decoder=raw_dec, eps_free=False)
        del raw_dec
        waves = load_waves([p for _, p in read_scp(scp)])
        runs.append(stream_trie_phase("stream-trie", rec, conf, waves,
                                      n_linears, card))
        runs.append(stream_trie_phase(
            "stream-trie-lm", rec_lm, lm_conf,
            [w[:int(STREAM_LM_S * 16000)] for w in waves], n_linears, card,
            SOLO_LM_S))

        # -- the port's benchmark: the headline, then its other modes ------
        del rec, rec_lm
        torch.cuda.empty_cache()
        argmin_phase()
        runs.append(bench_phase(card))
        runs.append(bench_modes(card))

        # -- the last slice: multi-GPU, native host library, synth -------
        wave, lengths, ref = parallel_phase(conf, waves, card)
        distributed_phase(work, conf, wave, lengths, ref, card)
        del ref
        dryrun_phase(card)
        bench_mode_phase("bench-scaling", "dp_sharding_efficiency_8dev",
                         card, BENCH_MODE="scaling", BENCH_RUNS="1",
                         BENCH_SECONDS=SCALING_SECONDS)
        native_phase(work, conf, scp, card)
        synth_phase(work, tg, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def entry(name, t, launches=None):
        return {"launches": (sum(run[name] for run in runs)
                             if launches is None else launches),
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": max(t["by"], key=t["by"].get),
                "library_ms": t["library_ms"]}

    kernels = [{"name": "matmul_s8", "route": "cuda",
                "source": "catears_tpu_torch/csrc/matmul_s8.cu",
                "replaces": "catears_tpu/am/quant.py:84",
                "entry_point": "qmatmul", **entry("qmatmul", totals["qmatmul"]),
                "int32_entry_point": {"name": "matmul_s8",
                                      **entry("matmul_s8",
                                              totals["matmul_s8"])}},
               {"name": "lm_walk", "route": "cuda",
                "source": "catears_tpu_torch/csrc/lm_walk.cu",
                "replaces": "catears_tpu/graph/device.py:610",
                "entry_point": "lm_propagate_capped",
                **entry("lm_walk", totals["lm_walk"])},
               {"name": "backtrace", "route": "cuda",
                "source": "catears_tpu_torch/csrc/backtrace.cu",
                "replaces": "catears_tpu/decode/beam.py:1064",
                "entry_point": "backtrace_device",
                **entry("backtrace", totals["backtrace"])},
               {"name": "frame_expand", "route": "cuda",
                "source": "catears_tpu_torch/csrc/frame_expand.cu",
                "replaces": "catears_tpu/decode/beam.py:452",
                "entry_point": "expand_emitting",
                **entry("frame_expand", totals["frame_expand"])},
               {"name": "frame_select", "route": "cuda",
                "source": "catears_tpu_torch/csrc/frame_select.cu",
                "replaces": "catears_tpu/decode/beam.py:257",
                "entry_point": "select_beam",
                **entry("frame_select", totals["frame_select"])},
               {"name": "lstm_recurrence", "route": "cuda",
                "source": "catears_tpu_torch/csrc/lstm_recurrence.cu",
                "replaces": None, "entry_point": "lstm_recurrence",
                **entry("lstm_recurrence", totals["lstm_recurrence"],
                        lstm_launches),
                "chunk_batch": entry("lstm_recurrence",
                                     totals["lstm_recurrence_chunks"],
                                     blstm_launches)}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
