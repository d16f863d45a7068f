"""Reduction of a `torch.profiler` trace of the card to the numbers the
per-layer metrics read: busy time (the union of the device operations'
intervals: kernels, copies, memsets), kernels by name, and the longest
idle gaps, each named by the device operation that ended it (the host was
getting that one ready)."""

from __future__ import annotations

from typing import Dict, List, Tuple

def short_name(name: str) -> str:
    """A kernel's name without its argument list and template prefix."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].strip()
    for prefix in ("void ", "at::native::"):
        if base.startswith(prefix):
            base = base[len(prefix):]
    return base[:96] or "(unnamed)"


def device_ops(prof) -> List[Tuple[str, float, float, bool]]:
    """(name, start us, end us, is a kernel) of every device operation."""
    ops = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        for e in results.events():
            if e.device_type().name != "CUDA":
                continue
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") \
                else float(e.start_us())
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") \
                else float(e.duration_us())
            name = e.name()
            is_kernel = not (name.startswith("Memcpy")
                             or name.startswith("Memset"))
            ops.append((name, start, start + dur, is_kernel))
        return ops
    for e in prof.events():
        if e.device_type.name == "CUDA" and not e.is_user_annotation:
            is_kernel = not (e.name.startswith("Memcpy")
                             or e.name.startswith("Memset"))
            ops.append((e.name, e.time_range.start, e.time_range.end,
                        is_kernel))
    return ops


def reduce(ops: List[Tuple[str, float, float, bool]]) -> Dict:
    """busy seconds, kernel launches, seconds and launches by short name,
    the ten longest device operations' names by total seconds, and the ten
    longest idle gaps."""
    ops = sorted(ops, key=lambda x: x[1])
    busy_us, covered = 0.0, float("-inf")
    by_name: Dict[str, List[float]] = {}
    gaps: List[Tuple[float, str]] = []
    for name, start, end, is_kernel in ops:
        if covered != float("-inf") and start > covered:
            gaps.append((start - covered, short_name(name)))
        busy_us += max(0.0, end - max(start, covered))
        covered = max(covered, end)
        entry = by_name.setdefault(short_name(name), [0.0, 0.0])
        entry[0] += (end - start) / 1e6
        entry[1] += 1 if is_kernel else 0
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    raw: Dict[str, float] = {}
    for name, start, end, _ in ops:
        raw[name] = raw.get(name, 0.0) + (end - start) / 1e6
    return {
        "raw_top": sorted(raw.items(), key=lambda kv: -kv[1])[:12],
        "busy_s": busy_us / 1e6,
        "launches": sum(1 for op in ops if op[3]),
        "by_name": {k: {"s": v[0], "n": v[1]} for k, v in by_name.items()},
        "device_ops": [[k, v[0]] for k, v in top],
        "idle_gaps": [["before " + n, g / 1e6] for g, n in gaps[:10]],
    }


def kernel_seconds(reduced: Dict, needle: str) -> float:
    """Summed seconds of the kernels whose name contains `needle`."""
    return sum(v["s"] for k, v in reduced["by_name"].items() if needle in k)
