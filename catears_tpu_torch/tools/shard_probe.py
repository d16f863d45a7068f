"""Where the time of a sharded step goes on one card: host threads vs one.

`parallel.ShardedPipeline` runs each data block from its own host thread on
its own CUDA stream.  On one card the blocks are logical shards, so the
frame loops' launches (about 280 per frame, each a few microseconds of host
work) come from n threads at once.  This script times, on the scaling
mode's workload (`BENCH_MODE=scaling`'s defaults: the 20k-word sub-trie,
TDNN-256, beam 2048, 8 x 2 s ragged), one full step of the batch:

  unsharded   one `decode_chunk` over all 8 utterances in this thread
  serial-n    n data blocks run one after another in this thread
  threads-n   ShardedPipeline as it is: n threads, n streams
  nostream-n  n threads on the default stream

for n in 2 and 8, best of --reps, each after a warm-up; then a launch
micro-benchmark: 16,000 `add_` launches on a 4-element tensor from one
thread, and the same count split over 2 and 8 threads (each on its own
stream).  Host clock around work that ends in a synchronize.

    python -m catears_tpu_torch.tools.shard_probe [--reps 2]

on a machine with a card (no JAX needed).
"""

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

SCALING_DEFAULTS = {"BENCH_GRAPH": "trie", "BENCH_WORDS": "20000",
                    "BENCH_HIDDEN": "256", "BENCH_BEAM": "2048",
                    "BENCH_EXPAND": "32768", "BENCH_EPS_EXPAND": "1024"}


def best(fn, reps):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def launches(n_threads, total=16000):
    x = [torch.zeros(4, device="cuda") for _ in range(n_threads)]
    streams = [torch.cuda.Stream() for _ in range(n_threads)]

    def one(i):
        with torch.cuda.stream(streams[i]):
            for _ in range(total // n_threads):
                x[i].add_(1)
        streams[i].synchronize()

    def run():
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("shard_probe: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ.update({k: v for k, v in SCALING_DEFAULTS.items()
                       if k not in os.environ})
    os.environ["BENCH_DEVICE"] = "cuda"
    from catears_tpu_torch.bench import _card, build_bench_setup
    from catears_tpu_torch.frontend.fbank import num_frames
    from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                                 logical_devices, make_mesh)

    card = _card(torch.device("cuda"))
    am, _, dfst, _, cfg, wave, _, _ = build_bench_setup(8, 2.0)
    t = num_frames(wave.shape[1])
    lengths = torch.from_numpy(np.random.RandomState(7).randint(
        t // 2, t + 1, size=8).astype(np.int32))

    def pipeline(n, mode):
        pipe = ShardedPipeline(am, dfst, None, cfg, make_mesh(
            n, devices=logical_devices(n)))
        if mode == "serial":
            def serial(batch, work):
                with torch.no_grad():
                    return [work(*blk) for blk in pipe._blocks(batch)]
            pipe._run = serial
        elif mode == "nostream":
            pipe._streams = {}
        return lambda: pipe.full_step(wave, pipe.make_beam(8), lengths,
                                      n_frames=t)

    print(f"# card={card} frames={t} lengths={lengths.tolist()}", flush=True)
    print(f"[probe] unsharded_s={best(pipeline(1, 'threads'), args.reps)}",
          flush=True)
    for n in (2, 8):
        for mode in ("serial", "threads", "nostream"):
            print(f"[probe] {mode}-{n}_s={best(pipeline(n, mode), args.reps)}",
                  flush=True)
    for n in (1, 2, 8):
        print(f"[probe] launches_16000_threads-{n}_s="
              f"{best(launches(n), args.reps)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
