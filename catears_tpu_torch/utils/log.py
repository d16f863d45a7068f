"""Counters of the runtime (the port's copy of the metrics half of
catears_tpu/utils/log.py).

The batch runtime counts `audio_seconds` (decode_scp), `frames_decoded`
and `overflow_retries` (BatchDecoder), queryable via `metrics()`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

_counters: Dict[str, float] = defaultdict(float)


def count(name: str, value: float = 1.0) -> None:
    _counters[name] += value


def metrics() -> Dict[str, float]:
    return dict(_counters)
