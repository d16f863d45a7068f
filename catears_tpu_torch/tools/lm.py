"""ARPA language-model utilities: unigram pruning and unigram cost vectors.
(The port's copy of catears_tpu/tools/lm.py.)

Parity with reference tool/prune_lm.py (strip an ARPA LM to order-1 for the
HCLG G and the delta-LM subtraction vector) and tool/convert_unigram.py
(ARPA unigram section + vocab -> VEC0 cost array in natural log, <s> := 0).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, List

import numpy as np

from catears_tpu_torch.io.binfmt import write_vec0

M_LN10 = math.log(10.0)


def prune_to_unigram(lines: Iterable[str]) -> List[str]:
    """Keep only the \\data\\ header (ngram 1 line) and \\1-grams section."""
    out: List[str] = []
    state = "begin"
    for raw in lines:
        line = raw.strip()
        if state == "begin":
            if line in ("", "iARPA"):
                continue
            if line == "\\data\\":
                out.append(line)
                state = "data"
            else:
                raise ValueError(f"unexpected line: {line}")
        elif state == "data":
            if line == "":
                out.append(line)
            elif "=" in line:
                if line.split("=")[0].strip() == "ngram 1":
                    out.append(line)
            elif line == "\\1-grams:":
                out.append(line)
                state = "unigram"
            else:
                raise ValueError(f"unexpected line: {line}")
        elif state == "unigram":
            if line == "":
                out.append(line)
            elif line.startswith("\\"):
                state = "end" if line == "\\end\\" else "ngram"
            else:
                fields = line.split()
                if len(fields) in (2, 3):
                    out.append(f"{fields[0]} {fields[1]}")
                else:
                    raise ValueError(f"unexpected line: {line}")
        elif state == "ngram":
            if line == "\\end\\":
                state = "end"
    if state != "end":
        raise ValueError("unexpected end-of-file")
    out.append("\\end\\")
    return out


def read_unigram_costs(path: str) -> Dict[str, float]:
    """Word -> log10 probability from an ARPA file's 1-grams section."""
    costs: Dict[str, float] = {}
    state = "begin"
    with open(path, encoding="utf-8") as fd:
        for raw in fd:
            line = raw.strip()
            if state == "begin":
                if line == "\\data\\":
                    state = "data"
            elif state == "data":
                if line == "\\1-grams:":
                    state = "unigram"
            elif state == "unigram":
                if not line:
                    continue
                if line == "\\end\\" or line.startswith("\\"):
                    state = "end"
                    break
                fields = line.split()
                if len(fields) in (2, 3):
                    costs[fields[1]] = float(fields[0])
    return costs


def build_cost_vector(costs: Dict[str, float],
                      vocab: Dict[str, int]) -> np.ndarray:
    """log10 probs + vocab ids -> natural-log cost array (-logp)."""
    size = max(vocab.values()) + 1
    arr = np.full(size, np.inf, np.float32)
    for word, logp in costs.items():
        if word not in vocab:
            if word == "<unk>":
                continue
            raise ValueError(f"unexpected word: {word}")
        arr[vocab[word]] = -logp * M_LN10
    return arr


def read_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as fd:
        for raw in fd:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise ValueError(f"unexpected vocab line: {line}")
            vocab[fields[0]] = int(fields[1])
    return vocab


def fit_bigram_arpa(sequences: List[List[str]], vocab: List[str],
                    bos: str = "<s>", eos: str = "</s>",
                    discount: float = 0.4,
                    interpolate: float = 0.0,
                    sharpness: float = 1.0) -> List[str]:
    """Fit an absolute-discounting backoff bigram on word sequences.

    Returns ARPA lines (the format tool/mkgraph_hcl.sh feeds arpa2fst,
    reference tool/mkgraph_hcl.sh:53-55).  Unigrams cover the WHOLE
    `vocab` so every HCLG output label has a finite unigram cost for the
    subtraction vector; bigrams are the observed ones with absolute
    discounting, mass released to the backoff.

    interpolate = lambda in (0, 1] mixes every observed bigram toward
    the unigram (Jelinek-Mercer): p(w|h) = l*p_bi + (1-l)*p_uni, with
    the backoff renormalized so each history still sums to 1.  Bounds
    the ADDITIVE part of the bigram/unigram ratio but not the ratio for
    rare words.  0 = pure discounted bigram.

    sharpness = s in (0, 1] geometrically flattens each observed bigram
    toward the unigram: p(w|h) proportional to p_uni(w) *
    (p_bi(w|h)/p_uni(w))^s.  This scales the LOG-ratio — exactly the
    per-word delta an on-the-fly rescoring decoder adds — by s, the
    estimation-side analogue of Kaldi's LM-scale sweep (the reference's
    delta-LM applies G' at fixed weight 1.0 against am_scale-0.1
    acoustics and has no balancing knob, src/ce_stt.cc:263).
    """
    from collections import Counter

    uni = Counter()
    bi = Counter()
    for seq in sequences:
        prev = bos
        for w in list(seq) + [eos]:
            uni[w] += 1
            bi[(prev, w)] += 1
            prev = w
        uni[bos] += 1
    words = [bos, eos] + [w for w in vocab if w not in (bos, eos)]
    # Unigrams by absolute discounting (NOT add-one: with V >> N add-one
    # crushes observed words' probabilities, which blows up the
    # bigram/unigram log-ratios a delta-LM applies as per-word bonuses).
    # <s> is a history, not an event (ARPA prints it at -99).
    events = {w: c for w, c in uni.items() if w != bos}
    n_ev = max(1, sum(events.values()))
    unseen = [w for w in words if w not in events and w != bos]
    released = discount * len(events) / n_ev
    p_floor = released / max(1, len(unseen))
    p_uni = {}
    for w in words:
        if w == bos:
            p_uni[w] = 1.0  # printed as -99 below
        elif w in events:
            p_uni[w] = (events[w] - discount) / n_ev
        else:
            p_uni[w] = p_floor

    lam = interpolate
    ctx_count = Counter()
    ctx_types = Counter()
    ctx_seen_uni = Counter()  # unigram mass of words seen after h
    for (h, w), c in bi.items():
        ctx_count[h] += c
        ctx_types[h] += 1
        ctx_seen_uni[h] += p_uni[w]

    # Sharpness flattening with mass preservation: the raw q =
    # p_uni * (p_bi/p_uni)^s can sum past the history's discounted seen
    # mass (blowing the backoff weight up to a prohibitive penalty for
    # every unseen continuation), so the flattened bigrams are
    # renormalized to carry exactly the mass the discounting left them.
    qs_sum = Counter()
    seen_mass = Counter()
    if sharpness != 1.0:
        for (h, w), c in bi.items():
            disc = (c - discount) / ctx_count[h]
            qs_sum[h] += p_uni[w] * (disc / p_uni[w]) ** sharpness
            seen_mass[h] += disc

    def p_bigram(h, w, c):
        disc = (c - discount) / ctx_count[h]
        if sharpness != 1.0:
            q = p_uni[w] * (disc / p_uni[w]) ** sharpness
            disc = seen_mass[h] * q / qs_sum[h]
        return lam * disc + (1.0 - lam) * p_uni[w] if lam else disc

    ctx_seen_bi = Counter()
    for (h, w), c in bi.items():
        ctx_seen_bi[h] += p_bigram(h, w, c)
    lines = ["\\data\\", f"ngram 1={len(words)}", f"ngram 2={len(bi)}", "",
             "\\1-grams:"]
    for w in words:
        p = math.log10(p_uni[w]) if w != bos else -99.0
        backoff = 0.0
        if ctx_count[w]:
            # Normalize: released mass of this history over the unigram
            # mass of its unseen continuations.
            unseen = max(1.0 - ctx_seen_uni[w], 1e-6)
            backoff = math.log10(max(1.0 - ctx_seen_bi[w], 1e-9) / unseen)
        lines.append(f"{p:.6f}\t{w}\t{backoff:.6f}")
    lines += ["", "\\2-grams:"]
    for (h, w), c in sorted(bi.items()):
        lines.append(f"{math.log10(p_bigram(h, w, c)):.6f}\t{h} {w}")
    lines += ["", "\\end\\"]
    return lines


def main_prune(argv=None) -> int:
    """stdin ARPA -> stdout order-1 ARPA (tool/prune_lm.py parity)."""
    for line in prune_to_unigram(sys.stdin):
        print(line)
    return 0


def main_convert_unigram(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("Usage: python -m catears_tpu_torch.tools.lm "
              "<lm_arpa> <vocab> <unigram_bin>")
        return 22
    costs = read_unigram_costs(argv[0])
    costs["<s>"] = 0.0
    vocab = read_vocab(argv[1])
    arr = build_cost_vector(costs, vocab)
    with open(argv[2], "wb") as fd:
        write_vec0(fd, arr)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main_convert_unigram())
