"""Where the time goes in the PyTorch port's batch decode, on one CUDA card.

Builds chip_smoke.py's configuration (int8 TDNN-1024 on the 50k-word trie,
bench geometry, 8 seeded utterances of 3-10 s; with --lm, its delta-LM
config: the 50k-word G' and lm_expand_size = 384) and times, on the host
clock around work that ends in a synchronize: the batch's WAV load
(`load_waves`), set-up, `batched_logp`, the
whole `BatchDecoder.decode`, `init_beam_batch`, one 50-frame
`decode_chunk` and `backtrace_device` over the batch's frames; and, on the
live-stream path, one steady 20-frame tick of 8 streams
(`BatchStreamingSession.process_batch`) and one steady chunk of a solo
`StreamingSession`.  Then it profiles one 50-frame chunk, one
`batched_logp`, one tick and one solo chunk with torch.profiler: device
busy time, the device's idle share of the unprofiled wall time and device
ops (kernels, copies, memsets) per frame; with --lm also one capped LM
walk at the frame's shape (8 x 384 word lanes out of the expansion).

Run from the repo root on a machine with a card (no JAX needed):

    python3 scripts/torch_profile.py [--lm] [--reps 5] [--out profile.txt]
                                     [--checkout DIR] [--mode MODE]

--mode picks the decode graph of the trie: `eps_free` (the Recognizer's,
the default), `closed` (close_epsilons, depth capped at 1), `raw`
(close_eps=False: depth 2, the static closure rounds) or `raw-dynamic`
(the raw graph at max_eps_iters = 1: the arena closure).  Modes other than
eps_free time and profile the decoder only: set-up, `init_beam_batch`,
one 50-frame chunk and the backtrace.

--out also writes the profiler tables, which are long, to that file.
--checkout DIR also times the WAV load of the catears_tpu_torch in DIR (a
checkout of another commit) against this tree's on the same files: four
child processes in turns (DIR, this tree, this tree, DIR), each timing
--reps calls of its `load_waves` after one warm-up.
"""

import argparse
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

import chip_smoke as cs
from catears_tpu_torch.decode import beam as tb
from catears_tpu_torch.decode.decoder import BatchDecoder
from catears_tpu_torch.graph.device import DeviceFst, lm_propagate_capped
from catears_tpu_torch.graph.transform import close_epsilons
from catears_tpu_torch.io.wav import read_scp
from catears_tpu_torch.runtime.batch import (batched_logp, get_batch_decoder,
                                             load_waves)
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.runtime.streaming import StreamingSession

CHUNK = 50
MODES = ("eps_free", "closed", "raw", "raw-dynamic")
# Run with the checkout as the working directory, so that its
# catears_tpu_torch is the one imported: argv = [reps, path, ...].
LOAD_TIMER = """\
import sys, time
from catears_tpu_torch.runtime.batch import load_waves
reps, paths = int(sys.argv[1]), sys.argv[2:]
load_waves(paths)
secs = []
for _ in range(reps):
    t = time.perf_counter()
    load_waves(paths)
    secs.append(time.perf_counter() - t)
print(repr(secs))
"""


def host_times(fn, reps):
    """Host-clock seconds of `reps` synchronized calls (after one warm-up)."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def report(name, secs, scale=1e3, unit="ms"):
    vals = [s * scale for s in secs]
    print(f"[{name}] median_{unit}={float(np.median(vals))!r} "
          f"all_{unit}={vals!r}", flush=True)


def load_turns(checkout, paths, reps):
    """load_waves of `checkout` and of this tree, each in its own process,
    in turns (checkout, this, this, checkout)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for tag, where in (("checkout", checkout), ("this", here),
                       ("this", here), ("checkout", checkout)):
        out = subprocess.run(
            [sys.executable, "-c", LOAD_TIMER, str(reps), *paths],
            cwd=where, capture_output=True, text=True, timeout=600,
            check=True)
        report(f"load_waves:{tag}",
               ast.literal_eval(out.stdout.splitlines()[-1]))


def mode_decoder(rec, mode):
    """The Recognizer's cached BatchDecoder (eps_free), or one of the trie
    with its epsilon arcs on the Recognizer's device."""
    if mode == "eps_free":
        return get_batch_decoder(rec)
    tid2pdf, cfg = rec.am.tid2pdf, rec.beam_config
    if mode == "closed":
        closed = close_epsilons(rec.fst)[0]
        dfst = DeviceFst.build(closed, tid2pdf, group=rec.arc_group,
                               eps_depth_cap=1, csr_group=rec.csr_group,
                               device=rec.device)
        return BatchDecoder(closed, tid2pdf, config=cfg, dfst=dfst,
                            delta_lm=rec.delta_lm)
    if mode == "raw-dynamic":
        cfg = dataclasses.replace(cfg, max_eps_iters=1)
    return BatchDecoder(rec.fst, tid2pdf, config=cfg,
                        arc_group=rec.arc_group, close_eps=False,
                        csr_group=rec.csr_group, device=rec.device,
                        delta_lm=rec.delta_lm)


def stream_items(rec, waves, reps):
    """The live-stream path: steady chunk steps (the first chunk, which
    takes F + R frames, is fed before timing), on waves tiled to 60 s so
    that every call steps every stream.  Returns the profiler's work items
    and a check, run after them, that every call stepped every stream
    once (None, or what went wrong)."""
    long = [np.tile(w, -(-60 * 16000 // w.size))[:60 * 16000]
            for w in waves]
    streams = rec.create_stream_batch(len(waves))
    solo = StreamingSession(rec.am, rec.fst, rec.delta_lm,
                            *rec._decode_graph())
    fed = [0, 0]

    def tick():
        lo = fed[0]
        fed[0] += cs.TICK
        streams.process_batch([w[lo:lo + cs.TICK] for w in long])

    def solo_chunk():
        lo = fed[1]
        fed[1] += cs.TICK
        solo.process(long[0][lo:lo + cs.TICK])

    for _ in range(2):
        tick()
        solo_chunk()
    tick_secs = host_times(tick, reps)
    solo_secs = host_times(solo_chunk, reps)
    report("stream_tick", tick_secs)
    report("stream_solo_chunk", solo_secs)
    # The idle share is taken against the unprofiled median wall time:
    # the profiler slows the host, not the device.
    logp_fn = lambda: batched_logp(rec.am, waves)
    items = [("batched_logp", logp_fn, 1,
              float(np.median(host_times(logp_fn, reps)))),
             ("stream_tick", tick, streams.f, float(np.median(tick_secs))),
             ("stream_solo_chunk", solo_chunk, streams.f,
              float(np.median(solo_secs)))]

    def check():
        # N ticks of TICK samples hold 20 N - 1 frames: the first chunk
        # (F + R) steps at the second tick, then one chunk per tick.
        want = [(fed[0] // cs.TICK - 1) * streams.f] * len(waves)
        want.append((fed[1] // cs.TICK - 1) * streams.f)
        got = streams.num_frames_decoded + [solo.num_frames_decoded]
        if got != want:
            return (f"a tick did not step every stream once ({got}; "
                    f"wanted {want})")
        return None

    return items, check


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the profiler tables here")
    ap.add_argument("--lm", action="store_true",
                    help="profile the delta-LM config")
    ap.add_argument("--checkout", help="also time this checkout's WAV load")
    ap.add_argument("--mode", default="eps_free", choices=MODES,
                    help="the trie's decode graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    cuda = torch.device("cuda:0")

    work = os.path.join(cs.BUILD_DIR, "profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        conf, lm_conf = cs.write_confs(work)
        if args.lm:
            conf = lm_conf
        scp = cs.write_wavs(work, np.random.RandomState(1), 8)
        paths = [p for _, p in read_scp(scp)]
        waves = load_waves(paths)
        report("load_waves", host_times(lambda: load_waves(paths), args.reps))
        if args.checkout:
            load_turns(os.path.abspath(args.checkout), paths, args.reps)

        t0 = time.perf_counter()
        rec = Recognizer(conf, device=cuda)
        dec = mode_decoder(rec, args.mode)
        torch.cuda.synchronize()
        print(f"[setup] recognizer_and_graph_s={time.perf_counter() - t0!r}",
              flush=True)

        logp, lengths = batched_logp(rec.am, waves)
        frames = max(lengths)
        audio_s = sum(w.size for w in waves) / 16000.0
        print(f"[batch] utts={len(waves)} audio_s={audio_s!r} "
              f"frames={frames} lm={dec.dlm is not None} mode={args.mode} "
              f"eps_depth={dec.dfst.eps_depth} "
              f"max_eps_iters={dec.cfg.max_eps_iters}", flush=True)
        eps_free = args.mode == "eps_free"
        if eps_free:
            report("batched_logp", host_times(
                lambda: batched_logp(rec.am, waves), args.reps))
            report("decode", host_times(lambda: dec.decode(logp, lengths),
                                        max(1, args.reps - 2)), 1.0, "s")

        cfg, dfst, dlm = dec.cfg, dec.dfst, dec.dlm
        b = len(waves)
        report("init_beam_batch", host_times(
            lambda: tb.init_beam_batch(cfg, b, dfst, dlm), args.reps))
        beam, _ = tb.init_beam_batch(cfg, b, dfst, dlm)
        lp_t = logp.transpose(0, 1)[:CHUNK].contiguous()
        valid = torch.ones((CHUNK, b), dtype=torch.bool, device=cuda)
        chunk = lambda: tb.decode_chunk(cfg, dfst, beam, lp_t, valid, dlm)
        chunk_secs = host_times(chunk, max(1, args.reps - 2))
        report("frame", [s / CHUNK for s in chunk_secs])
        _, tr = chunk()
        reps_t = -(-frames // CHUNK)
        traces = tb.FrameTrace(tr.prev_slot.repeat(reps_t, 1, 1)[:frames],
                               tr.words.repeat(reps_t, 1, 1, 1)[:frames])
        best = torch.zeros(b, dtype=torch.int64, device=cuda)
        report("backtrace_device", host_times(
            lambda: tb.backtrace_device(traces, best),
            max(1, args.reps - 2)))

        work_items = [("chunk", chunk, CHUNK, float(np.median(chunk_secs)))]
        check = lambda: None
        if eps_free:
            items, check = stream_items(rec, waves, args.reps)
            work_items += items
        if dlm is not None:
            # One capped walk at the frame's shape: the expansion's lanes,
            # a beam's worth of LM states and ~300 word labels per row.
            rng = np.random.RandomState(0)
            e = cfg.beam_size * (1 + dfst.group) + cfg.expand_size
            lanes = np.zeros((b, e), np.int32)
            for u in range(b):
                lanes[u, rng.choice(e, 300, replace=False)] = rng.randint(
                    1, cs.NUM_WORDS, 300)
            lab = torch.from_numpy(lanes).to(cuda)
            st = torch.from_numpy(rng.randint(
                0, cs.NUM_WORDS, (b, e)).astype(np.int32)).to(cuda)
            walk = lambda: lm_propagate_capped(dlm, st, lab,
                                               cfg.lm_expand_size)
            walk_secs = host_times(walk, args.reps)
            report("lm_walk", walk_secs)
            work_items.append(("lm_walk", walk, 1,
                               float(np.median(walk_secs))))
        tables = []
        for name, fn, per, plain in work_items:
            wall, busy, ops, ka = cs.profiled(fn)
            print(f"[profile:{name}] profiled_wall_ms={wall!r} "
                  f"wall_ms={plain * 1e3!r} device_busy_ms={busy!r} "
                  f"idle_share={1 - busy / (plain * 1e3)!r} "
                  f"device_ops_per_{'frame' if per > 1 else 'call'}="
                  f"{ops / per!r}", flush=True)
            tables.append(f"== {name} ==\n" + ka.table(
                sort_by="self_device_time_total", row_limit=25,
                max_name_column_width=60))
        fault = check()
        if fault:
            print(f"torch_profile: {fault}", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv"],
            capture_output=True, text=True, timeout=60).stdout
        print(smi, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fd:
                fd.write(f"{card}\n\n" + "\n\n".join(tables) + "\n")
        else:
            print("\n\n".join(tables))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
