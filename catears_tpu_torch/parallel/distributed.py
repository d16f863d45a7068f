"""Multi-process runtime initialization and cross-process utilities (port
of catears_tpu/parallel/distributed.py).

A multi-process deployment calls `initialize()` once per process before
building its mesh with `parallel.mesh.make_mesh()`; each process decodes
its own contiguous slice of the global utterance batch
(`local_batch_slice`), and the only cross-process traffic is the metric
reduction of `global_sum`: the beam search is independent per utterance.

The process group uses gloo, not NCCL: its one collective is a host scalar
(as JAX's `process_allgather` is host-side too), and gloo serves processes
that share one card, which NCCL refuses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group wrapper; no-op when
    single-process.

    coordinator_address is `host:port` of rank 0 (`tcp://` rendezvous).
    With no address, the process group reads the environment `torchrun`
    sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK: `env://`).
    """
    if num_processes is not None and num_processes <= 1:
        return
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _world() -> Tuple[int, int]:
    """(process count, this process's index); (1, 0) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of this process's utterances in a global batch."""
    n, idx = _world()
    per = global_batch // n
    extra = global_batch % n
    start = idx * per + min(idx, extra)
    stop = start + per + (1 if idx < extra else 0)
    return start, stop


def global_sum(x: float) -> float:
    """Sum a process-local scalar across all processes (metrics
    reduction)."""
    if _world()[0] == 1:
        return float(x)
    total = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(total)
    return float(total[0])
