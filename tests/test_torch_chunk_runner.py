"""BatchDecoder's chunk runner on the CPU: the frame loop over static
buffers, the last chunk padded with invalid frames, equals the plain eager
loop over the batch's real frames byte for byte (beams with their overflow
flags and high-water marks, traces, words and weights).  On a card the same
runner replays one CUDA graph per chunk: tests/test_torch_cuda.py holds
that to the eager loop on the card."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from _torch_parity import CPU, assert_runner_equals_eager, runner_trie
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.tools.biggraph import plant_logp

C = 4  # chunk_frames: the lengths below straddle it
CFG = BeamConfig(beam_size=64, expand_size=2048, eps_expand_size=1024,
                 max_eps_iters=4, beam=12.0, lm_expand_size=64)
# Capacities too small for the trie: the first decode overflows, and the
# decoder regrows them and decodes once more.
TINY = BeamConfig(beam_size=64, expand_size=16, eps_expand_size=16,
                  max_eps_iters=4, beam=1e9)


@functools.lru_cache(maxsize=None)
def _decoder(mode, lm, cfg=CFG):
    """One decoder per (mode, LM, config), reused by every case."""
    return runner_trie(mode, lm, CPU, C, cfg)


def _batch(seed, b, t):
    """Planted [B, T, P] log-probs; the rows after the first are shorter."""
    dec, tg = _decoder("eps-free", False)
    logp, _ = plant_logp(np.random.RandomState(seed), tg, b, t)
    lengths = [t] + [max(1, t - 3 * u - 1) for u in range(1, b)]
    return logp, lengths


CASES = [(mode, lm, b, t) for mode in ("eps-free", "closed")
         for lm in (False, True) for b in (1, 3)
         for t in (1, C - 1, C, C + 1, 2 * C + 7)]
CASES += [(mode, lm, "reuse", None) for mode in ("eps-free", "closed")
          for lm in (False, True)]
CASES += [(mode, False, "retry", None) for mode in ("eps-free", "closed")]


@pytest.mark.parametrize("mode,lm,b,t", CASES, ids=[
    "-".join(str(x) for x in case if x is not None) for case in CASES])
def test_chunk_runner_equals_the_eager_loop(mode, lm, b, t):
    """Every T around the chunk (one frame, a short tail, whole chunks,
    one frame past, two chunks and a tail) at B 1 and 3, LM off and on,
    eps-free and closed; one decoder reused across shapes (A, B, then A
    again reads A's results: no buffer is stale); an overflow that
    regrows and retries."""
    if b == "retry":
        dec, _ = _decoder(mode, lm, TINY)
        logp, lengths = _batch(5, 2, 2 * C + 3)
        _, _, _, cfg = assert_runner_equals_eager(dec, logp, lengths,
                                                  final_fallback=True)
        assert cfg != TINY and cfg.expand_size > TINY.expand_size
        return
    dec, _ = _decoder(mode, lm)
    if b != "reuse":
        logp, lengths = _batch(2, b, t)
        assert_runner_equals_eager(dec, logp, lengths, final_fallback=True)
        return
    a = _batch(3, 3, 2 * C + 7)
    first = assert_runner_equals_eager(dec, *a, final_fallback=True)
    assert_runner_equals_eager(dec, *_batch(4, 1, C + 1),
                               final_fallback=True)
    again = assert_runner_equals_eager(dec, *a, final_fallback=True)
    assert [(h.words, h.weight) for h in first[0]] == [
        (h.words, h.weight) for h in again[0]]
    for x, y in zip(first[1] + first[2], again[1] + again[2]):
        assert x.tobytes() == y.tobytes()
