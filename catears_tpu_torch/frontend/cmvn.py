"""Online cepstral mean normalization (the port's copy of
catears_tpu/frontend/cmvn.py; numpy only, float64 on the host).

Per-frame stats are the sum over the trailing 600-frame window; when fewer
than 600 frames are available, up to 200 frames' worth of global training
stats are blended in; only the mean is subtracted (no variance
normalization).  Wired behind the optional `cmvn_stats` config key.  The
fused streaming session carries the same window as a float32 ring on the
device (runtime/streaming.py).
"""

from __future__ import annotations

import numpy as np

CMVN_WINDOW = 600
CMVN_GLOBAL_FRAMES = 200
FEAT_DIM = 40


class OnlineCMVN:
    """Vectorized online CMVN over a whole utterance (or a growing prefix)."""

    def __init__(self, global_stats: np.ndarray):
        global_stats = np.asarray(global_stats, np.float64)
        assert global_stats.shape == (FEAT_DIM + 1,)
        self.global_sum = global_stats[:FEAT_DIM]
        self.global_count = float(global_stats[FEAT_DIM])
        assert self.global_count > 0

    def apply(self, feats: np.ndarray) -> np.ndarray:
        """[T, 40] raw fbank -> [T, 40] mean-normalized, all frames at once."""
        t = feats.shape[0]
        if t == 0:
            return feats.astype(np.float32)
        x = feats.astype(np.float64)
        csum = np.cumsum(x, axis=0)
        win_sum = csum.copy()
        if t > CMVN_WINDOW:
            win_sum[CMVN_WINDOW:] = csum[CMVN_WINDOW:] - csum[:-CMVN_WINDOW]
        counts = np.minimum(np.arange(1, t + 1), CMVN_WINDOW).astype(np.float64)
        from_global = np.minimum(CMVN_WINDOW - counts, CMVN_GLOBAL_FRAMES)
        scalar = (from_global / self.global_count)[:, None]
        mean = ((win_sum + scalar * self.global_sum[None, :])
                / (counts[:, None] + scalar * self.global_count))
        return (x - mean).astype(np.float32)


class CMVNStream:
    """Streaming CMVN: identical output to OnlineCMVN.apply, frame at a time."""

    def __init__(self, global_stats: np.ndarray):
        self._cmvn = OnlineCMVN(global_stats)
        self._history = np.zeros((0, FEAT_DIM), np.float64)

    def process(self, feats: np.ndarray) -> np.ndarray:
        if feats.shape[0] == 0:
            return feats.astype(np.float32)
        start = self._history.shape[0]
        self._history = np.concatenate(
            [self._history, feats.astype(np.float64)])
        # Only the trailing window matters; recompute the affected suffix.
        out = self._cmvn.apply(self._history)
        return out[start:]
