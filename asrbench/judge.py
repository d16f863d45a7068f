"""The comparisons that decide `correct`: the program's answers judged by
the reference's exact costs (`ref.align`)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from asrbench import ref


def bulk_gaps(g: ref.Graph, lm: Optional[ref.DeltaLm],
              answers: Sequence[Tuple[List[int], float]],
              truths: Sequence[List[int]], logps, am_scale: float, device,
              precision: str = "float64") -> List[float]:
    """Per utterance, how far the answer (words, cost) is from what a
    batch decode must give.  The decoder returns the best path that ends
    in a final state, or, where its beam kept none, the cheapest token (a
    path ending anywhere, no final weight).  For each reading the gap is
    the wider of |the answer's cost - the exact best cost of its words|
    and (that cost - the exact best cost of the planted words); the
    utterance's gap is the smaller of the two readings'."""
    jobs = []
    for i, ((words, _), truth) in enumerate(zip(answers, truths)):
        jobs += [ref.Job(i, words, True), ref.Job(i, truth, True),
                 ref.Job(i, words, False), ref.Job(i, truth, False)]
    cost = ref.align(g, jobs, logps, am_scale, device, precision)
    gaps = []
    for i, ((words, weight), truth) in enumerate(zip(answers, truths)):
        fw, ft, aw, at = cost[4 * i:4 * i + 4]
        if lm is not None:
            fw += lm.cost(words, True)
            ft += lm.cost(truth, True)
            aw += lm.cost(words, False)
            at += lm.cost(truth, False)
        final = max(abs(weight - fw), _excess(fw, ft))
        anywhere = max(abs(weight - aw), _excess(aw, at))
        gap = min(final, anywhere)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def floor_excess(g: ref.Graph, logp, frames: int, am_scale: float,
                 weight: float) -> float:
    """How far an answer's cost lies below the least any path over its
    frames can cost: each frame's cheapest emitting arc plus am_scale
    times its least -log-likelihood.  Every other term of a path's cost
    is >= 0 in these graphs (epsilon and final weights; with a delta LM a
    word's HCLG arc plus its delta is its G' cost, `ref.Graph.check_floor`).
    An answer for audio the program left out (cost 0) lies far below."""
    if frames == 0:
        return 0.0
    least = float((-logp[:frames]).min(dim=1).values.sum()) * am_scale
    return max(0.0, least + frames * g.min_emit_weight - weight)


def _excess(cost: float, best: float) -> float:
    """How far `cost` lies above `best`; nothing where no path gives
    `best` (planted words cut off by the utterance's end cannot end in a
    final state)."""
    return cost - best if math.isfinite(best) else -math.inf


def live_gaps(g: ref.Graph, partials: Sequence[Tuple[List[int], float]],
              finals: Sequence[Tuple[List[int], float]], logps,
              decoded: Sequence[int], am_scale: float, beam_size: int,
              beam: float, device) -> List[float]:
    """Per stream: |the last partial's cost - the reference beam search's
    best cost over the frames due|, and |the final hypothesis's cost - the
    reference's best final cost over every frame| (or, where the
    reference's beam keeps no final token, the final must be the empty
    hypothesis); infinite where the words differ from the reference
    token's.  An answer's words may be given as their `ref.word_hash`.
    The live audio gives no path a clear lead, so the pruned search, not
    an exact one, is the semantics to meet."""
    rows = [x[:n] for x, n in zip(logps, decoded)] + list(logps)
    frames = list(decoded) + [x.shape[0] for x in logps]
    cost, whash, fcost, fhash = ref.beam_search(
        g, rows, frames, am_scale, beam_size, beam, device)
    n = len(partials)
    gaps = []
    for i, ((ws, weight), (fwords, fweight)) in enumerate(
            zip(partials, finals)):
        gap = abs(weight - cost[i])
        if _hash(ws) != whash[i]:
            gap = math.inf
        j = n + i
        if math.isfinite(fcost[j]):
            end = abs(fweight - fcost[j])
            if _hash(fwords) != fhash[j]:
                end = math.inf
        else:
            end = 0.0 if (_hash(fwords) == 0 and fweight == 0.0) \
                else math.inf
        gaps.append(max(gap, end))
    return gaps


def _hash(words) -> int:
    """`ref.word_hash` of a word list, or the hash itself (0: no words)."""
    return int(words) if isinstance(words, (int, np.integer)) \
        else ref.word_hash(words)
