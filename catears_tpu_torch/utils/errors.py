"""Error types mirroring the reference's Status codes (the port's copy of
catears_tpu/utils/errors.py).

The reference propagates a `Status` value with codes IOError / Corruption /
RuntimeError / NotImplemented (reference src/status.h:37-103) surfacing to a
C-API `last_error` buffer (reference src/ce_stt.cc:65,375-377).  Pythonic
equivalent: typed exceptions, with the same names and messages as the JAX
package's, plus a module-level last-error record used by the C-API-parity
wrappers in catears_tpu_torch.runtime.capi.
"""

from __future__ import annotations

_last_error: str = ""


class CatEarsError(Exception):
    """Base error for catears_tpu (Status analogue)."""

    code = "RuntimeError"

    def __init__(self, message: str = ""):
        super().__init__(message)
        record_error(f"{self.code}: {message}" if message else self.code)


class IOError_(CatEarsError):
    code = "IOError"


class CorruptionError(CatEarsError):
    code = "Corruption"


class RuntimeError_(CatEarsError):
    code = "RuntimeError"


class NotImplementedError_(CatEarsError):
    code = "NotImplemented"


class BeamCapacityError(CatEarsError):
    """Decode expansion overflowed its static capacity: candidates were
    dropped and the hypothesis may be wrong.  Raise instead of returning a
    plausible-but-wrong path (the reference iterates all arcs and can never
    truncate, reference src/decoder.cc:337-377).  Fix: raise
    BeamConfig.expand_size / eps_expand_size (see
    graph.device.expansion_bounds for the graph's worst case)."""

    code = "RuntimeError"

    def __init__(self, message: str = "", hiwater=None):
        # hiwater: the decode's (emit_over, eps, lm_walk, select) capacity
        # high-water marks at overflow time — lets the runtime regrow
        # geometry from measured demand and retry (decode_batch).
        super().__init__(message)
        self.hiwater = hiwater


def record_error(message: str) -> None:
    global _last_error
    _last_error = message


def last_error() -> str:
    """Last recorded error message (ce_stt_last_error analogue)."""
    return _last_error
