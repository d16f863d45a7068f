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
              the plain version's and its bound; and at the streaming
              shapes (one 20-frame chunk window of B = 1 and 8 streams,
              one scale per stream), with their device times
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
  e2e         cli.main(["--batch=8", conf, scp]) on cuda: exit 0, one line
              per utterance, no capacity overflow, the fused kernel
              launched once per linear layer per batch, and the first
              CPU_UTTS transcripts equal to the same command with
              --device=cpu on those utterances
  e2e-lm      the same with the delta-LM config
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
              per stream: the first 2 streams' transcripts equal those of
              the same 2 streams on the CPU (the whole 8 do not fit the
              time limit with the CPU's LM-on decode), no
              capacity overflow, the fused kernel launched once per linear
              per chunk step; the tick latency p50/p99 (host clock around
              a synchronize), audio seconds per wall second, and a solo
              Utterance over the 10 s wave (its chunk latency)
  stream-trie-lm  the same with the delta-LM config

Cut in depth (never in width) to stay well inside the time limit: LM on,
decoder-lm compares LM_FRAMES frames of the 2 utterances and its planted
WER takes 4 x 300 frames (LM off 4 x 1000); stream-decoder-lm 2 x 150
planted frames (LM off 2 x 500); the closed and raw phases compare
CUT_FRAMES frames on the CPU, LM on decode only those on the card, and
take their planted WER on 2 x 500 frames (LM on 2 x 200); every e2e
phase runs its CPU side on the first CPU_UTTS utterances; the LM-on solo
Utterance of stream-trie-lm takes the first SOLO_LM_S seconds of the
10 s wave.

Before the last line come {"kernels": [...]} and the card's name and power
limit; the last line is {"ok": true, "device": {...}}.  The one kernel,
matmul_s8.cu, is listed once, by the entry point the main path launches it
through (`qmatmul`, the fused epilogue): launches summed over the e2e
(LM off, on and raw), stream and stream-trie runs, each counted from 0
just before its run; error, times and bound from this run, summed over
the AM's three shapes.  Its int32 entry point (`matmul_s8`, which the
main path does not launch) is nested in the entry with its own launches,
error, times, bound and torch._int_mm's time.  The epsilon closure is
plain PyTorch, like the rest of the decoder: no kernel of its own.
Bounds: the larger of the bytes the
function must move (each input read once, the output written once) over
3.35 TB/s and its int8 operations over 1,979 TOP/s (H100 SXM, dense).
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

import numpy as np
import torch

from catears_tpu_torch.am import quant
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
CPU_STREAMS = 2  # of the 8 live streams, also decoded on the CPU
CPU_UTTS = 2  # of the 8 utterances of an e2e run, also decoded on the CPU
CUT_FRAMES = 200  # frames of the 2 AM utterances decoded on the CPU (and
#                   LM on, on the card) by the closed and raw phases
LM_FRAMES = 300  # frames of the 2 AM utterances in decoder-lm
# Planted frames per utterance: (utterances, frames), LM off / LM on.
PLANTED = {False: (4, 1000), True: (4, 300)}
CLOSURE_PLANTED = {False: (2, 500), True: (2, 200)}
SOLO_LM_S = 5.0  # seconds of the 10 s wave the LM-on solo Utterance takes
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1.979e15  # H100 SXM, dense


def phase(name, **numbers):
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{name}] {fields}", flush=True)


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
    from catears_tpu_torch.graph import device as tdevice

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
    on cuda; returns nothing, fails on a disagreement or a high WER.  LM on,
    the log-probs are cut to LM_FRAMES frames."""
    cuda = torch.device("cuda:0")
    lm = dec.dlm is not None
    if lm:
        logp = logp[:, :LM_FRAMES]
        lengths = [min(n, LM_FRAMES) for n in lengths]
    t0 = time.perf_counter()
    # final_fallback: random-weight acoustics rarely end in a final state;
    # backtrace the cheapest token so the paths compared are real.
    hyp_gpu = dec.decode(logp, lengths, final_fallback=True)
    hyp_cpu = dec_cpu.decode(logp.cpu(), lengths, final_fallback=True)
    same_words = [h.words for h in hyp_gpu] == [h.words for h in hyp_cpu]
    same_cost = ([np.float64(h.weight) for h in hyp_gpu]
                 == [np.float64(h.weight) for h in hyp_cpu])
    phase(name, utts=len(lengths), frames=lengths,
          same_words=same_words, bit_equal_costs=same_cost,
          words=[len(h.words) for h in hyp_gpu],
          costs=[h.weight for h in hyp_gpu],
          seconds=f"{time.perf_counter() - t0:.2f}")
    if not (same_words and same_cost):
        fail(f"{name} on cuda and cpu disagree")

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
    """While entered, the decoders' `decode_chunk` runs with every device
    read raising (torch.cuda.set_sync_debug_mode("error")) and timed on the
    host clock between two synchronizes; the high-water marks of the last
    chunk's beam are kept."""

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
    to CUT_FRAMES) timed per frame with no device read in the frame loop,
    then CUT_FRAMES of them on cuda and cpu (identical words, bit-equal
    costs), then the planted-path WER on the card."""
    cuda = torch.device("cuda:0")
    lm = dec.dlm is not None
    frames = CUT_FRAMES if lm else logp.shape[1]
    cut = [min(n, CUT_FRAMES) for n in lengths]
    loop = FrameLoop()
    retries = log.metrics().get("overflow_retries", 0)
    try:
        with loop:
            hyp_gpu = dec.decode(logp[:, :frames],
                                 [min(n, frames) for n in lengths],
                                 final_fallback=True)
            ms_per_frame, hiwater = loop.ms_per_frame(), loop.marks()
            if frames != CUT_FRAMES:
                hyp_gpu = dec.decode(logp[:, :CUT_FRAMES], cut,
                                     final_fallback=True)
            wer, n_ref, planted_s, n, planted_frames = planted_wer(
                dec, tg, lm, CLOSURE_PLANTED)
    except RuntimeError as e:  # set_sync_debug_mode("error") raised
        fail(f"{name}: a device read in the decode's frame loop: {e}")
    t0 = time.perf_counter()
    hyp_cpu = dec_cpu.decode(logp[:, :CUT_FRAMES].cpu(), cut,
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
          cpu_s=f"{cpu_s:.2f}", card=f"'{card}'")
    if not (same_words and same_cost):
        fail(f"{name} on cuda and cpu disagree")
    if require_wer and wer > 0.25:
        fail(f"{name}: planted-path WER {wer:.3f} is too high")


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


def e2e_phase(name, conf, scp, cpu_scp, linears, card, watch=False):
    """cli.main(["--batch=8", conf, scp]) on cuda, then the same with
    --device=cpu on `cpu_scp`, the first CPU_UTTS utterances (the longest
    among them, so the AM's bucket and each utterance's result are the
    batch's); returns the launches the card run made through each entry
    point of the kernel, counted from 0 just before it.  With `watch`, the
    card run's frame loop must make no device read, and its ms per frame
    and high-water marks are printed."""
    from catears_tpu_torch.io.wav import read_scp
    from catears_tpu_torch.runtime.batch import load_waves

    n_utts = len(read_scp(scp))
    audio_s = sum(w.shape[0] for w in load_waves(
        [p for _, p in read_scp(scp)])) / 16000.0
    retries = log.metrics().get("overflow_retries", 0)
    torch.cuda.synchronize()
    quant.matmul_s8.launches = quant.qmatmul.launches = 0
    loop = FrameLoop() if watch else contextlib.nullcontext()
    t0 = time.perf_counter()
    with loop:
        rc, lines, err = run_cli(["--batch=8", conf, scp])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    extra = {} if not watch or not loop.frames else dict(
        ms_per_frame=loop.ms_per_frame(), hiwater=loop.marks())
    launches = {"matmul_s8": quant.matmul_s8.launches,
                "qmatmul": quant.qmatmul.launches}
    overflowed = log.metrics().get("overflow_retries", 0) != retries
    t0 = time.perf_counter()
    cpu_rc, cpu_lines, cpu_err = run_cli(["--batch=8", "--device=cpu", conf,
                                          cpu_scp])
    cpu_dt = time.perf_counter() - t0
    same = lines[:len(cpu_lines)] == cpu_lines
    phase(name, rc=rc, lines=len(lines), utts=n_utts,
          words=[len(line.split()) - 1 for line in lines],
          cpu_utts=len(cpu_lines), same_as_cpu=same,
          fused_launches=launches["qmatmul"],
          int32_launches=launches["matmul_s8"], linears=linears,
          overflow=overflowed,
          wall_s=f"{dt:.2f}", audio_s=f"{audio_s:.2f}",
          audio_s_per_s=f"{audio_s / dt:.2f}", cpu_wall_s=f"{cpu_dt:.2f}",
          **extra, card=f"'{card}'")
    if rc != 0:
        fail(f"{name}: cli exited {rc}: {err}")
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
                         batch_decoder=None):
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

    loop = FrameLoop() if decoder is not None else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with loop:
            words = [decoder_words(fresh(), row) for row in planted]
    except RuntimeError as e:  # set_sync_debug_mode("error") raised
        fail(f"{name}: a device read in the Decoder's frame loop: {e}")
    dt = time.perf_counter() - t0
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
          card=f"'{card}'")
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
        quant.matmul_s8.launches = quant.qmatmul.launches = 0
        words, ticks, partials, steps, wall = run_streams(rec, waves, True)
        launches = {"matmul_s8": quant.matmul_s8.launches,
                    "qmatmul": quant.qmatmul.launches}
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

        # -- e2e: the CLI's batch path on cuda, LM off, on, raw graph ------
        n_linears = linears(rec.am)
        cpu_scp = os.path.join(work, "smoke_cpu.scp")
        with open(scp) as src, open(cpu_scp, "w") as dst:
            dst.writelines(src.readlines()[:CPU_UTTS])
        raw_conf = write_raw_conf(work, conf, rec.fst)
        runs = [e2e_phase("e2e", conf, scp, cpu_scp, n_linears, card),
                e2e_phase("e2e-lm", lm_conf, scp, cpu_scp, n_linears, card),
                e2e_phase("e2e-raw", raw_conf, scp, cpu_scp, n_linears, card,
                          watch=True)]

        # -- the live-stream path: toy model, Decoder, 8 trie streams ------
        runs.append({"matmul_s8": 0, "qmatmul": stream_phase(work, card)})
        stream_decoder_phase("stream-decoder", rec, tg, card, 500)
        stream_decoder_phase("stream-decoder-lm", rec_lm, tg, card, 150)
        stream_decoder_phase(
            "stream-decoder-raw", rec, tg, card, 500,
            decoder=Decoder(rec.fst, rec.am.tid2pdf, am_scale=AM_SCALE,
                            config=rec.beam_config, arc_group=rec.arc_group,
                            close_eps=False, csr_group=rec.csr_group,
                            device=cuda),
            batch_decoder=raw_dec)
        del raw_dec
        waves = load_waves([p for _, p in read_scp(scp)])
        runs.append(stream_trie_phase("stream-trie", rec, conf, waves,
                                      n_linears, card))
        runs.append(stream_trie_phase("stream-trie-lm", rec_lm, lm_conf,
                                      waves, n_linears, card, SOLO_LM_S))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def entry(name, t):
        return {"launches": sum(run[name] for run in runs),
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
                                              totals["matmul_s8"])}}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
