"""Error types mirroring the reference's Status codes (the port's copy of
catears_tpu/utils/errors.py, without the C-API last-error record).

The reference propagates a `Status` value with codes IOError / Corruption /
RuntimeError / NotImplemented (reference src/status.h:37-103).  Pythonic
equivalent: typed exceptions, with the same names and messages as the JAX
package's.
"""

from __future__ import annotations

class CatEarsError(Exception):
    """Base error for catears_tpu (Status analogue)."""

    code = "RuntimeError"


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
