"""Kaldi's MFCC as a linear map of the log-mel energies.

`compute-mfcc-feats` takes the same log-mel energies as `compute-fbank-feats`
(the same framing, window, mel bins and floor; see frontend/fbank.py), then
a DCT-II (row 0 scaled by sqrt(1/N), the others by sqrt(2/N)), keeps the
first NUM_CEPS coefficients and multiplies coefficient i by the lifter
1 + Q/2 sin(pi i / Q), Q = CEPSTRAL_LIFTER.  The chain recipes' hires
config (`conf/mfcc_hires.conf`) keeps all 40 cepstra of 40 mel bins at
Kaldi's default lifter 22, with `use-energy=false`, so nothing else
changes c0.  So an MFCC row is `logmel @ mfcc_matrix()`,
and a model whose first affine reads spliced MFCC rows can take the log-mel
rows instead once the matrix is folded into that affine
(`am.nnet.fold_feature_map`).
"""

from __future__ import annotations

import numpy as np

from catears_tpu_torch.frontend.fbank import NUM_BINS


NUM_CEPS = NUM_BINS
CEPSTRAL_LIFTER = 22.0


def mfcc_matrix() -> np.ndarray:
    """[NUM_BINS, NUM_CEPS] float64: Kaldi's DCT rows, liftered, as the
    columns of a map applied to a log-mel row."""
    n = np.arange(NUM_BINS, dtype=np.float64)
    k = np.arange(NUM_CEPS, dtype=np.float64)[:, None]
    dct = np.sqrt(2.0 / NUM_BINS) * np.cos(np.pi / NUM_BINS * (n + 0.5) * k)
    dct[0] = np.sqrt(1.0 / NUM_BINS)
    lifter = 1.0 + 0.5 * CEPSTRAL_LIFTER * np.sin(np.pi * k / CEPSTRAL_LIFTER)
    return (dct * lifter).T.copy()
