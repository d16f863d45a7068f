"""Levenshtein token errors (the port's copy of the counting half of
catears_tpu/tools/score.py, with the Python DP only)."""

from __future__ import annotations

from typing import List

import numpy as np


def edit_distance(ref: List[str], hyp: List[str]):
    """(errors, substitutions, deletions, insertions) via Levenshtein DP."""
    n, m = len(ref), len(hyp)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # Backtrack for the S/D/I split (compute-wer style reporting)
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dp[n, m]), subs, dels, ins


def token_errors(ref: List[str], hyp: List[str]) -> int:
    """Levenshtein error count."""
    return edit_distance(ref, hyp)[0]
