"""Logging, lightweight metrics and spans (the port's copy of
catears_tpu/utils/log.py, plus the spans).

A namespaced stdlib logger plus a tiny counter/timer registry: the runtime
counts `audio_seconds` (Utterance, decode_scp), `frames_decoded` (Decoder,
the streaming sessions, BatchDecoder), `overflow_retries` and
`decode_host_syncs` (BatchDecoder: the times a decode's host waits for
the card, 2 a decode), `lstm_steps`, `lstm_steps_needed` (am/nnet.py: a
recurrence's sequential steps run, and those its valid outputs read) and
`lstm_recurrence_launches` (am/lstm.py), `am_chunks`, `am_chunk_rows` and
`am_chunk_rows_needed` (am/model.py: a chunked model's windows, the rows
its recurrences step, padding included, and the windows' own rows), and
times the `frontend`/`am`/`decode`/`process` stages of an Utterance —
queryable via `metrics()`.  The AM spans each recurrence as
`am.recurrence` (layer, steps, batch, direction; CUDA events on a card)
and a chunked model's window gather and output scatter as `am.chunks`
(part, chunks, window, batch; CUDA events).

Spans name what the host is doing: `with span("decode", batch=16):`
records a name, a start and an end in ns, the id of the enclosing span of
the same thread (`parent`), the attributes given (or set later with
`Span.set` / `annotate`) and, for a top-level span, its sequence number
among the top-level spans of its name (the k-th `logp` and the k-th
`decode` of a bulk decode both carry k).  Tracing is off by default:
`start_tracing()` starts a fresh in-memory list, `stop_tracing()` stops
adding to it, `spans()` returns it.  Off, `span()` is one module-level
flag check returning a shared no-op context: nothing is recorded, nothing
synchronises.  `span(..., device=True)` also records a pair of CUDA events
on the current stream while tracing is on; `spans()` resolves them into
`Span.device_s` (it waits for the second event), so nothing waits inside a
traced window.

The clock is `time.time_ns()`, Unix-epoch ns: the clock `torch.profiler`
gives its kineto events (torch 2.x converts its approximate clock to it),
so a host span and a device operation of one traced window compare
directly.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("catears_tpu_torch")


def info(msg: str, *args) -> None:
    logger.info(msg, *args)


def warn(msg: str, *args) -> None:
    logger.warning(msg, *args)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args)


_counters: Dict[str, float] = defaultdict(float)


def count(name: str, value: float = 1.0) -> None:
    _counters[name] += value


@contextmanager
def timed(name: str):
    """Adds the block's host seconds (`time.perf_counter`, no synchronise:
    device work is timed at its enqueue) to `<name>_seconds`; while
    tracing, the block is also a span named `name`."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _counters[f"{name}_seconds"] += time.perf_counter() - t0


def metrics() -> Dict[str, float]:
    return dict(_counters)


def reset_metrics() -> None:
    _counters.clear()


# -- spans -------------------------------------------------------------------

_tracing = False
_spans: List["Span"] = []
_seq: Dict[str, int] = defaultdict(int)
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's open spans, innermost last


@dataclass(eq=False)
class Span:
    """One span: ns on the `time.time_ns()` clock (`end_ns` None while
    open); `device_s` the CUDA-event seconds of a device span, resolved by
    `spans()`."""

    name: str
    id: int
    parent: Optional[int]
    seq: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    attrs: dict = field(default_factory=dict)
    device_s: Optional[float] = None
    _events: Optional[tuple] = field(default=None, repr=False)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.time_ns()
        stack = _open()
        if self in stack:  # not if tracing restarted while it was open
            stack.remove(self)
        return False


class _NoSpan:
    """What `span()` returns while tracing is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def _open() -> List[Span]:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name: str, device: bool = False, **attrs):
    """A context that records a span while tracing is on (see the module
    docstring); `device=True` adds CUDA events on the current stream."""
    if not _tracing:
        return _NO_SPAN
    stack = _open()
    parent = stack[-1].id if stack else None
    seq = None
    if parent is None:
        seq = _seq[name]
        _seq[name] += 1
    events = None
    if device:
        import torch

        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    s = Span(name, next(_ids), parent, seq, time.time_ns(), attrs=attrs,
             _events=events)
    if events is not None:
        events[0].record()
    stack.append(s)
    _spans.append(s)
    return s


def annotate(name: str, **attrs) -> None:
    """Sets attributes on the innermost open span named `name` of this
    thread (nothing while tracing is off, or if none is open)."""
    if not _tracing:
        return
    for s in reversed(_open()):
        if s.name == name:
            s.attrs.update(attrs)
            return


def tracing() -> bool:
    """Whether spans are being recorded (for work done only then)."""
    return _tracing


def start_tracing() -> None:
    """Starts recording spans into a fresh list."""
    global _tracing
    _spans.clear()
    _seq.clear()
    _open().clear()
    _tracing = True


def stop_tracing() -> None:
    """Stops recording; the list stays for `spans()`."""
    global _tracing
    _tracing = False


def spans() -> List[Span]:
    """The spans recorded since `start_tracing()`, in the order they
    started, device spans resolved (waiting for their events)."""
    for s in _spans:
        if s._events is not None and s.device_s is None \
                and s.end_ns is not None:
            s._events[1].synchronize()
            s.device_s = s._events[0].elapsed_time(s._events[1]) / 1e3
    return list(_spans)
