"""Logging + lightweight metrics (the port's copy of
catears_tpu/utils/log.py).

A namespaced stdlib logger plus a tiny counter/timer registry: the runtime
counts `audio_seconds` (Utterance, decode_scp), `frames_decoded` (Decoder,
the streaming sessions, BatchDecoder) and `overflow_retries`
(BatchDecoder), and times the `frontend`/`am`/`decode`/`process` stages of
an Utterance — queryable via `metrics()`.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

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
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _counters[f"{name}_seconds"] += time.perf_counter() - t0


def metrics() -> Dict[str, float]:
    return dict(_counters)


def reset_metrics() -> None:
    _counters.clear()
