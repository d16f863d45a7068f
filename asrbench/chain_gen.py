"""The chain cell's inputs, made from the seed (beside `gen.py`, whose
helpers it reuses).

- `make_chain_graph`: `gen.make_trie_graph`'s mkgraph-shaped prefix-trie
  HCLG in Kaldi's chain topology: one state per phone of the trie, entered
  by a forward arc that emits the phone's pdf-class 0 and held by a
  self-loop that emits its pdf-class 1; the word-end epsilons, backoffs
  and bigram entries, costs and their ranges as in `make_trie_graph`.
  `word_pdf_flat` holds each phone's (class 0, class 1) pdf pair.
- `plant_chain_targets`: `gen.plant_targets` at 30 ms frames in that
  topology: each phone of a word 2-4 frames, the first on its class-0 pdf
  and the rest on its class-1 pdf.
- `tdnnf_device`: the TDNN-F's weights (the recipe's widths from the
  configuration), drawn on the card in two calls as `gen.tdnn_device`
  draws the TDNN's, with the same distributions: weights randn /
  sqrt(fan in), biases 0.1 randn, batchnorm scale 1 + 0.1 U and offset
  0.05 randn.  lda is that draw applied to the features standardized by
  `feature_stats` (Kaldi estimates `lda.mat` from its training features,
  whitening them), so that the stack's outputs keep the scale of a
  trained chain model's (units, not hundreds).  Returns the model dict
  `chain_ref` reads.
- `feature_stats`: the mean and deviation of each MFCC coefficient over
  seeded noise at the traffic's level, the data that lda is "estimated"
  on.
- `ivectors`: each utterance's i-vector, standard normal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from asrbench import gen


def make_chain_graph(rng: np.random.RandomState, num_words: int = 200_000,
                     num_phones: int = 350,
                     phones_per_word: Tuple[int, int] = (3, 8),
                     variants: int = 10, bigram_states: int = 5_000,
                     self_cost: Tuple[float, float] = (0.3, 0.7),
                     fwd_cost: Tuple[float, float] = (0.7, 1.5)
                     ) -> gen.Trie:
    """Prefix-trie HCLG over random pronunciations in chain topology:
    2 x num_phones x variants pdfs (each phone's class 0 and class 1, in
    one of `variants` contexts), the pdf of (phone, class, variant) at
    (2 phone + class) variants + variant."""
    lo, hi = phones_per_word
    lengths = rng.randint(lo, hi + 1, size=num_words + 1)
    lengths[0] = 0
    # One draw for every pronunciation (the same numbers as a draw a word).
    pron_off = np.zeros(num_words + 2, np.int64)
    np.cumsum(lengths, out=pron_off[1:])
    prons = rng.randint(0, num_phones, size=int(pron_off[-1]))

    # The trie a level at a time: a node is a (parent node, phone) pair;
    # nodes are numbered in the order a word-by-word insertion meets them
    # (first word, then depth).
    words = np.arange(num_words + 1)
    paths = np.full((num_words + 1, hi), -1, np.int64)
    node = np.full(num_words + 1, -1, np.int64)
    levels = []
    for d in range(hi):
        w = words[lengths > d]
        key = (node[w] + 1) * num_phones + prons[pron_off[w] + d]
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        node[w] = (sum(x[0].size for x in levels)) + inv
        paths[w, d] = node[w]
        levels.append((uniq, w[first], np.full(uniq.size, d)))
    uniq = np.concatenate([x[0] for x in levels])
    order = np.lexsort((np.concatenate([x[2] for x in levels]),
                        np.concatenate([x[1] for x in levels])))
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    parent_level = uniq // num_phones - 1
    edge_parent = np.where(parent_level < 0, -1,
                           rank[np.maximum(parent_level, 0)])[order]
    edge_phone = (uniq % num_phones)[order]
    paths = np.where(paths < 0, -1, rank[np.maximum(paths, 0)])
    word_first_edge = paths[:, 0].copy()
    word_last_edge = paths[words, np.maximum(lengths - 1, 0)]
    n_edges = order.size
    edge_variant = rng.randint(0, variants, size=n_edges).astype(np.int64)

    state = 1 + np.arange(n_edges, dtype=np.int64)  # one state a phone
    parent = np.where(edge_parent < 0, 0, state[edge_parent])
    lm_base = 1 + n_edges
    n_bigram = min(bigram_states, num_words)
    num_states = lm_base + n_bigram

    num_pdfs = 2 * num_phones * variants
    tid2pdf = np.zeros(2 * num_pdfs + 1, np.int32)
    tid2pdf[1:] = np.arange(2 * num_pdfs, dtype=np.int32) // 2

    def pdf_of(phone, cls, variant):
        return (phone * 2 + cls) * variants + variant

    def tid_of(phone, cls, variant):
        return 1 + 2 * pdf_of(phone, cls, variant) + cls

    w_fwd = rng.uniform(*fwd_cost, size=n_edges).astype(np.float32)
    w_self = rng.uniform(*self_cost, size=n_edges).astype(np.float32)
    hmm = (np.concatenate([parent, state]), np.concatenate([state, state]),
           np.concatenate([tid_of(edge_phone, 0, edge_variant),
                           tid_of(edge_phone, 1, edge_variant)]),
           np.zeros(2 * n_edges, np.int64), np.concatenate([w_fwd, w_self]))

    ranks = np.arange(1, num_words + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    unigram_cost = (-np.log(probs)).astype(np.float32)
    we_dst = np.where(np.arange(1, num_words + 1) <= n_bigram,
                      lm_base + np.arange(num_words), 0).astype(np.int64)
    we = (state[word_last_edge[1:]], we_dst, np.zeros(num_words, np.int64),
          np.arange(1, num_words + 1, dtype=np.int64), unigram_cost)

    lm_states = lm_base + np.arange(n_bigram, dtype=np.int64)
    backoff_w = rng.uniform(0.7, 2.5, size=n_bigram).astype(np.float32)
    bo = (lm_states, np.zeros(n_bigram, np.int64),
          np.zeros(n_bigram, np.int64), np.zeros(n_bigram, np.int64),
          backoff_w)
    deg = np.minimum(1 + (rng.pareto(1.2, n_bigram) * 8).astype(np.int64),
                     400)
    lm_of_arc = np.repeat(lm_states, deg)
    nxt_words = 1 + np.minimum(
        (rng.pareto(1.0, deg.sum()) * 50).astype(np.int64), num_words - 1)
    tgt_edge = word_first_edge[nxt_words]
    _, uniq = np.unique(lm_of_arc * np.int64(n_edges) + tgt_edge,
                        return_index=True)
    lm_of_arc, tgt_edge = lm_of_arc[uniq], tgt_edge[uniq]
    bg_w = (rng.uniform(0.1, 1.0, size=tgt_edge.size).astype(np.float32)
            + w_fwd[tgt_edge])
    bg = (lm_of_arc, state[tgt_edge],
          tid_of(edge_phone[tgt_edge], 0, edge_variant[tgt_edge]),
          np.zeros(tgt_edge.size, np.int64), bg_w)

    parts = [hmm, we, bo, bg]
    final = np.full(num_states, np.inf, np.float32)
    final[0] = 0.0
    final[lm_base:] = backoff_w

    word_pdf_off = 2 * pron_off
    path = paths[paths >= 0]  # each word's edges, in word order
    flat = pdf_of(edge_phone[path][:, None], np.arange(2)[None, :],
                  edge_variant[path][:, None]).ravel().astype(np.int32)
    return gen.Trie(
        start=0, final=final,
        src=np.concatenate([p[0] for p in parts]),
        dst=np.concatenate([p[1] for p in parts]),
        ilabel=np.concatenate([p[2] for p in parts]).astype(np.int64),
        olabel=np.concatenate([p[3] for p in parts]),
        weight=np.concatenate([p[4] for p in parts]).astype(np.float32),
        tid2pdf=tid2pdf, num_pdfs=num_pdfs, num_words=num_words,
        word_pdf_off=word_pdf_off, word_pdf_flat=flat)


def plant_chain_targets(rng: np.random.RandomState, graph: gen.Trie,
                        frames: int, dur: Tuple[int, int] = (2, 4)
                        ) -> Tuple[np.ndarray, List[int]]:
    """Frame-level pdf targets walking random word paths; each phone
    `dur` frames, its class-0 pdf first, then its class-1 pdf; the true
    words are those whose path was planted whole."""
    targets = np.zeros(frames, np.int32)
    words: List[int] = []
    t = 0
    while t < frames:
        w = 1 + min(int(rng.pareto(0.8) * 3), graph.num_words - 1)
        pairs = graph.word_pdf_flat[
            graph.word_pdf_off[w]:graph.word_pdf_off[w + 1]].reshape(-1, 2)
        durs = rng.randint(dur[0], dur[1] + 1, size=pairs.shape[0])
        seq = np.concatenate([np.concatenate([[a], np.repeat(b, d - 1)])
                              for (a, b), d in zip(pairs, durs)])
        n = min(seq.size, frames - t)
        targets[t:t + n] = seq[:n]
        t += n
        if n == seq.size:
            words.append(w)
    return targets, words


def tdnnf_shapes(am: Dict, num_pdfs: int) -> Dict[str, List[Tuple]]:
    """Each weight's [in, out] shape by the configuration's widths."""
    feat = len(am["splice"]) * am["num_ceps"] + am["ivector_dim"]
    dim, neck = am["tdnnf_dim"], am["bottleneck_dim"]
    small, big = am["prefinal_small_dim"], am["prefinal_big_dim"]
    blocks = [((2 if s else 1) * dim, neck, (2 if s else 1) * neck, dim)
              for s in am["time_strides"]]
    return {"lda": (feat, feat), "tdnn1": (feat, am["tdnn1_dim"]),
            "blocks": blocks, "prefinal_l": (dim, small),
            "w1": (small, big), "w2": (big, small),
            "output": (small, num_pdfs)}


def feature_stats(rng: np.random.RandomState, wave_rms: float, am: Dict,
                  seconds: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, deviation) [num_ceps] float64 of the MFCC (`chain_ref`) of
    `seconds` of seeded noise at `wave_rms`."""
    from asrbench import chain_ref

    wave = gen.pcm_noise(rng, int(seconds * 16000), wave_rms)
    feats = chain_ref.mfcc(chain_ref.fbank(torch.as_tensor(wave)),
                           am["num_ceps"], am["cepstral_lifter"])
    return feats.mean(0).numpy(), feats.std(0).numpy()


def tdnnf_device(g: torch.Generator, device, am: Dict, num_pdfs: int,
                 stats: Tuple[np.ndarray, np.ndarray]) -> Dict:
    """The TDNN-F's model dict (`chain_ref`'s layout, float32 tensors on
    `device`), drawn in one normal and one uniform call; lda reads the
    spliced MFCC standardized by `stats` (`feature_stats`; the i-vector,
    standard normal, as it is)."""
    sh = tdnnf_shapes(am, num_pdfs)
    dim, big, small = am["tdnnf_dim"], am["prefinal_big_dim"], \
        am["prefinal_small_dim"]
    mats = ([sh["lda"], sh["tdnn1"]]
            + [m for b in sh["blocks"] for m in ((b[0], b[1]), (b[2], b[3]))]
            + [sh["prefinal_l"], sh["w1"], sh["w2"], sh["output"]])
    vecs = (sh["lda"][1] + 2 * am["tdnn1_dim"] + 2 * dim * len(sh["blocks"])
            + 2 * big + small + num_pdfs)
    n_normal = sum(i * o for i, o in mats) + vecs
    n_uniform = am["tdnn1_dim"] + dim * len(sh["blocks"]) + big + small
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    pos = [0, 0]

    def take(n, u=False):
        pos[u] += n
        src = uniform if u else normal
        return src[pos[u] - n:pos[u]]

    def weight(shape):
        return take(shape[0] * shape[1]).view(*shape) / math.sqrt(shape[0])

    def bn(n):
        return {"scale": 1.0 + 0.1 * take(n, True), "offset": 0.05 * take(n)}

    mean, dev = (np.concatenate([np.tile(x, len(am["splice"])),
                                 np.full(am["ivector_dim"], y)])
                 for x, y in zip(stats, (0.0, 1.0)))
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    dev = torch.as_tensor(dev, dtype=torch.float32, device=device)
    w = weight(sh["lda"]) / dev[:, None]
    model = {"lda": {"w": w, "b": 0.1 * take(sh["lda"][1]) - mean @ w}}
    model["tdnn1"] = dict(w=weight(sh["tdnn1"]),
                          b=0.1 * take(am["tdnn1_dim"]),
                          **bn(am["tdnn1_dim"]))
    model["tdnnf"] = []
    for s, b in zip(am["time_strides"], sh["blocks"]):
        model["tdnnf"].append(dict(
            stride=s, w_l=weight(b[:2]), w_a=weight(b[2:]),
            b=0.1 * take(dim), **bn(dim)))
    model["bypass"] = am["bypass_scale"]
    model["prefinal_l"] = {"w": weight(sh["prefinal_l"])}
    first, second = bn(big), bn(small)
    model["prefinal_chain"] = {
        "w1": weight(sh["w1"]), "b1": 0.1 * take(big),
        "scale1": first["scale"], "offset1": first["offset"],
        "w2": weight(sh["w2"]), "scale2": second["scale"],
        "offset2": second["offset"]}
    model["output"] = {"w": weight(sh["output"]), "b": 0.1 * take(num_pdfs)}
    model.update(num_ceps=am["num_ceps"], lifter=am["cepstral_lifter"],
                 subsample=am["frame_subsampling_factor"])
    return model


def ivectors(rng: np.random.RandomState, n: int, dim: int) -> np.ndarray:
    """[n, dim] float32 i-vectors, standard normal."""
    return rng.randn(n, dim).astype(np.float32)
