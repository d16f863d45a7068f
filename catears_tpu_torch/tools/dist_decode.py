"""Data-parallel batch decode over processes with the PyTorch port.

Each process (rank) joins one gloo process group
(`catears_tpu_torch.parallel.initialize()`, from the variables `torchrun`
sets), takes its contiguous slice of the scp (`local_batch_slice`),
decodes it on its card (rank r on cuda:r modulo the cards there are; two
ranks share a one-card machine) through the public batch path
(`batched_logp` + `BatchDecoder.decode`, as `cli --batch` does), prints
`name words` per utterance, and rank 0 prints the audio seconds and
utterances summed over all ranks (`global_sum`) and the slowest rank's
wall seconds.

    torchrun --nproc-per-node=2 -m catears_tpu_torch.tools.dist_decode \
        model.conf list.scp [--device=cpu]

Alone (`python -m catears_tpu_torch.tools.dist_decode ...`) it is one
rank that decodes everything.
"""

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from catears_tpu_torch.io.wav import read_scp
from catears_tpu_torch.parallel import distributed
from catears_tpu_torch.parallel.mesh import logical_devices
from catears_tpu_torch.runtime.batch import (batched_logp, get_batch_decoder,
                                             load_waves)
from catears_tpu_torch.runtime.recognizer import Recognizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("conf")
    parser.add_argument("scp")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    if "WORLD_SIZE" in os.environ:  # started by torchrun
        distributed.initialize()  # env://
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    entries = read_scp(args.scp)
    lo, hi = distributed.local_batch_slice(len(entries))
    device = logical_devices(world, args.device)[rank]
    t0 = time.perf_counter()
    rec = Recognizer(args.conf, device=device)
    lines, audio_s = [], 0.0
    if hi > lo:
        waves = load_waves([path for _, path in entries[lo:hi]])
        audio_s = sum(w.shape[0] for w in waves) / 16000.0
        logp, lengths = batched_logp(rec.am, waves)
        hyps = get_batch_decoder(rec).decode(logp, lengths)
        lines = [f"{name} {' '.join(rec.symbol_table.get(w) for w in h.words)}"
                 for (name, _), h in zip(entries[lo:hi], hyps)]
    wall = time.perf_counter() - t0
    for line in lines:
        print(line, flush=True)
    total_s = distributed.global_sum(audio_s)
    utts = distributed.global_sum(float(hi - lo))
    walls = torch.zeros(world, dtype=torch.float64)
    walls[rank] = wall
    if world > 1:
        dist.all_reduce(walls)  # every rank's wall, then the slowest
    slowest = float(walls.max())
    if rank == 0:
        print(f"# ranks={world} utterances={utts:.0f} audio_s={total_s:.2f} "
              f"slowest_rank_wall_s={slowest:.2f} (set-up included)",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
