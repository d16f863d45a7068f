"""ARPA n-gram LM -> backoff WFST (pure-Python arpa2fst equivalent).
(The port's copy of catears_tpu/tools/arpa.py.)

The reference's graph recipe shells out to Kaldi's `arpa2fst` to build the
big-LM G' used for delta-LM rescoring (reference tool/mkgraph_hcl.sh:53-55);
this module removes that dependency: it builds the same standard backoff
construction directly as a FlatFst in the conventions our LmFst layer
expects (arcs (state, ilabel)-sorted, epsilon backoff arc first in each
span — reference src/fst.cc:199-233):

  * one state per n-gram history (unigram state = empty history), a
    dedicated superfinal state for </s>;
  * n-gram (h, w) with log10-prob p: arc state(h) --w:w/-p*ln10--> state(h')
    where h' is the longest suffix of (h, w) that is itself a history;
  * backoff weight b on history h: epsilon arc state(h) -> state(suffix(h))
    with weight -b*ln10;
  * start state = state(("<s>",)) when the LM has one, else the unigram
    state.

Weights are negated natural logs (costs), matching convert_unigram.py's
M_LN10 convention (reference tool/convert_unigram.py:76-101).
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.utils.errors import CorruptionError

LN10 = math.log(10.0)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, encoding="utf-8", errors="replace")


def parse_arpa(lines: Iterable[str]) -> List[Dict[Tuple[str, ...],
                                                  Tuple[float, float]]]:
    """[order-1] -> {ngram words: (log10 prob, log10 backoff)}."""
    grams: List[Dict] = []
    section = 0  # 0 = header, n>0 = n-grams
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line.startswith("\\") and line.endswith("-grams:"):
            section = int(line[1:line.index("-")])
            while len(grams) < section:
                grams.append({})
            continue
        if line == "\\end\\":
            break
        if section == 0 or line.startswith("ngram "):
            continue
        fields = line.split()
        if len(fields) < section + 1:
            raise CorruptionError(f"bad {section}-gram line: {line!r}")
        prob = float(fields[0])
        words = tuple(fields[1:1 + section])
        backoff = (float(fields[1 + section])
                   if len(fields) > 1 + section else 0.0)
        grams[section - 1][words] = (prob, backoff)
    if not grams:
        raise CorruptionError("no n-gram sections found (not an ARPA file?)")
    return grams


def arpa_to_fst(path: str, vocab: Optional[Dict[str, int]] = None,
                bos: str = "<s>", eos: str = "</s>"
                ) -> Tuple[FlatFst, Dict[str, int]]:
    """Build the backoff FST; returns (fst, word -> label id).

    vocab: existing words.txt mapping (ids preserved, OOV n-grams raise);
    when None, labels are assigned in first-seen order starting at 1.
    """
    with _open(path) as fd:
        grams = parse_arpa(fd)
    order = len(grams)

    own_vocab = vocab is None
    vocab = dict(vocab) if vocab else {}

    def label(w: str) -> int:
        if w not in vocab:
            if not own_vocab:
                raise CorruptionError(f"LM word {w!r} missing from vocab")
            vocab[w] = len(vocab) + 1
        return vocab[w]

    # Histories = prefixes of observed (n>=2)-grams, plus <s>.  Only these
    # need states: a gram with no continuations is an event, not a state.
    hist_set = {()}
    for n in range(1, order):
        for words in grams[n]:
            hist_set.add(words[:-1])
    if (bos,) in grams[0]:
        hist_set.add((bos,))
    hist_set.discard((eos,))
    state_of: Dict[Tuple[str, ...], int] = {
        h: i for i, h in enumerate(sorted(hist_set,
                                          key=lambda h: (len(h), h)))
    }
    superfinal = len(state_of)  # dedicated </s> destination

    def backoff_of(h: Tuple[str, ...]) -> float:
        entry = grams[len(h) - 1].get(h)
        return entry[1] if entry else 0.0

    def dest_state(words: Tuple[str, ...]) -> int:
        while words not in state_of:
            words = words[1:]
        return state_of[words]

    arcs: List[Tuple[int, int, int, int, float]] = []
    for n in range(order):
        for words, (prob, _bo) in grams[n].items():
            h, w = words[:-1], words[-1]
            if w == bos or h not in state_of:
                continue  # <s> is a history, not an event; orphan grams
            src = state_of[h]
            if w == eos:
                arcs.append((src, superfinal, label(w), label(w),
                             -prob * LN10))
            else:
                arcs.append((src, dest_state(words), label(w), label(w),
                             -prob * LN10))
    # Backoff epsilon arc for every non-unigram history: one step down,
    # accumulating the backoff weights of any skipped (stateless) suffixes.
    for h, src in state_of.items():
        if not h:
            continue
        wsum = backoff_of(h)
        s = h[1:]
        while s not in state_of:
            wsum += backoff_of(s)
            s = s[1:]
        arcs.append((src, state_of[s], 0, 0, -wsum * LN10))

    num_states = superfinal + 1
    final = np.full(num_states, np.inf, np.float32)
    final[superfinal] = 0.0
    arr = np.asarray(arcs, np.float64)
    fst = FlatFst.from_arrays(
        start=state_of.get((bos,), 0), final=final,
        state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))
    return fst, vocab


def sentence_cost(grams, words: List[str], bos="<s>", eos="</s>") -> float:
    """Reference ARPA scorer (backoff chain walked on the raw tables);
    returns the -ln cost of words + </s> given <s>.  For tests."""
    order = len(grams)
    hist: Tuple[str, ...] = (bos,)
    total = 0.0
    for w in list(words) + [eos]:
        while True:
            ng = hist + (w,)
            n = len(ng)
            if n <= order and ng in grams[n - 1]:
                total += -grams[n - 1][ng][0] * LN10
                hist = ng[-(order - 1):] if order > 1 else ()
                # shorten history to one that exists
                while hist and (len(hist) >= order
                                or hist not in grams[len(hist) - 1]):
                    hist = hist[1:]
                break
            if hist:
                if hist in grams[len(hist) - 1]:
                    total += -grams[len(hist) - 1][hist][1] * LN10
                hist = hist[1:]
            else:
                return float("inf")
    return total
