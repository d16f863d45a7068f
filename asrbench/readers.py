"""Arithmetic the per-layer metric readers share, over a traced run's
records (see the kinds): shares are in percent."""

from __future__ import annotations

from typing import Optional

from asrbench.trace import kernel_seconds


def traced(rec: dict) -> bool:
    """Whether the run holds a trace of the card with device time in it."""
    return bool(rec.get("trace")) and rec["trace"].get("busy_s", 0) > 0


def roofline(rec: dict, kernel: str) -> Optional[float]:
    """A kernel's share of its bandwidth bound: the least time its counted
    bytes take at the card's peak over the time its launches took."""
    if not traced(rec) or not rec.get("bytes", {}).get(kernel):
        return None
    secs = kernel_seconds(rec["trace"], kernel)
    if secs <= 0:
        return None
    least = rec["bytes"][kernel] / rec["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least / secs


def idle_share(rec: dict) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    if not traced(rec):
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["window_s"])


def step_mfu(rec: dict) -> Optional[float]:
    """The window's least time over its wall time: the AM's FLOPs at the
    float32 peak plus the decoder's counted bytes at the HBM peak."""
    if "am_flops" not in rec:
        return None
    p = rec["peaks"]
    least = (rec["am_flops"] / p["fp32_flops_per_s"]
             + sum(rec["bytes"].values()) / p["hbm_bytes_per_s"])
    return 100.0 * least / rec["window_s"]
