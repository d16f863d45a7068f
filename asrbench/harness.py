"""What every traffic kind shares: the run's context, the card's clock and
memory, the profiler around a traced window, and the comparisons that
decide `correct`."""

from __future__ import annotations

import contextlib
import gc
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from asrbench import trace as tr


@dataclass
class Ctx:
    """One run: the cell's configuration and traffic (parsed JSON), the
    seed, the window's length, whether it is traced, the device, the
    process's start on the host clock, and where scratch files go."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    scratch: str
    peaks: dict
    limits: Dict[str, float]
    control: bool = False  # also read the control (asrbench/control.py)
    log: List[str] = field(default_factory=list)
    control_readings: Dict[str, float] = field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, msg: str) -> None:
        """A line for standard error, printed before the result."""
        self.log.append(msg)


@dataclass
class Check:
    """One number compared for `correct`: value, limit (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(math.isfinite(self.value) and self.value <= self.limit)


@dataclass
class Outcome:
    """What a kind returns to the runner."""

    e2e: Dict[str, float]
    records: Dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None


def reset_memory(ctx: Ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)


def memory_peak(ctx: Ctx) -> int:
    if ctx.device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(ctx.device))
    return 0


class DeviceTimer:
    """CUDA events around calls, summed once the window has closed (host
    clock with a synchronise on the CPU)."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.pairs: List = []
        self.host = 0.0

    @contextlib.contextmanager
    def span(self):
        if self.ctx.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.pairs.append((a, b))
        else:
            t = time.perf_counter()
            yield
            self.host += time.perf_counter() - t

    def seconds(self) -> float:
        self.ctx.sync()
        return self.host + sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


@contextlib.contextmanager
def profiled(ctx: Ctx, out: Dict):
    """Profile the card over the block (traced runs only); `out` gets the
    reduced trace.  On the CPU nothing is profiled."""
    if not ctx.trace or ctx.device.type != "cuda":
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    ctx.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        ctx.sync()
    out.update(tr.reduce(tr.device_ops(prof)))


def freeze_setup() -> None:
    """End of set-up: collect, then move every object alive into the
    collector's permanent generation, so that the window's collections
    scan only what the window makes (the program's garbage is still
    collected) and not the graph, pool and tables set-up left behind."""
    gc.collect()
    gc.freeze()


@contextlib.contextmanager
def window_notes(ctx: Ctx):
    """Around the window: the garbage collector's passes and seconds in it,
    and the card allocator's new segments (cudaMalloc calls), as a line
    for standard error."""
    spent = {"s": 0.0, "n": 0, "t": None}

    def clock(phase, info):
        if phase == "start":
            spent["t"] = time.perf_counter()
        elif spent["t"] is not None:
            spent["s"] += time.perf_counter() - spent["t"]
            spent["n"] += 1
            spent["t"] = None

    segments = _segments(ctx)
    gc.callbacks.append(clock)
    try:
        yield
    finally:
        gc.callbacks.remove(clock)
        ctx.note(f"# window: gc passes {spent['n']} seconds {spent['s']!r}; "
                 f"device segments allocated {_segments(ctx) - segments}")


def _segments(ctx: Ctx) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(ctx.device).get(
        "segment.all.allocated", 0))


def host_pace(ctx: Ctx) -> None:
    """The host's pace in this process, read once the run is over (it
    times nothing of the program): the seconds of a fixed pure-Python
    loop, and the host microseconds of one launch of a one-element add,
    each the median of three.  The bulk and live windows are bound by the
    host's launches, so these say how fast a host the run was given."""
    loops, launches = [], []
    x = torch.zeros(1, device=ctx.device)
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(1_000_000):
            acc += i & 7
        loops.append(time.perf_counter() - t)
        ctx.sync()
        t = time.perf_counter()
        for _ in range(4000):
            x.add_(1.0)
        launches.append((time.perf_counter() - t) / 4000 * 1e6)
        ctx.sync()
    ctx.note(f"# host pace: python loop s {sorted(loops)[1]!r} launch us "
             f"{sorted(launches)[1]!r}")


def seed_sample(seed: int, n: int, k: int, stream: str) -> List[int]:
    """k of range(n), drawn from the seed."""
    from asrbench.gen import rng_for

    return sorted(rng_for(seed, stream).choice(n, size=min(k, n),
                                               replace=False).tolist())


def env_scratch(root: str) -> str:
    """The run's scratch directory: under TMPDIR (the driver gives each
    side its own), else inside the checkout."""
    base = os.environ.get("TMPDIR") or os.path.join(root, ".asrbench_tmp")
    path = os.path.join(base, "asrbench")
    os.makedirs(path, exist_ok=True)
    return path
