"""The benchmark's inputs, made from the seed.

Frozen copies of the generators the repository's earlier records ran (the
mkgraph-shaped prefix-trie HCLG, planted pseudo-likelihood paths, the
ARPA-shaped backoff G' and the TDNN weights of `catears_tpu_torch.tools`
`biggraph` and `toy`).  They return plain numpy arrays: the harness hands
them to the program through its public constructors, and the reference
reads them as they are.  `tests/test_asrbench_gen.py` holds the copies to
the originals at seed 0.

Beside them, what the traffic needs: the device forms of the weights and
the planted frames (the same distributions, drawn on the card with a
`torch.Generator` in a few large calls), the utterance lengths and the
live schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


def rng_for(seed: int, stream: str) -> np.random.RandomState:
    """An independent numpy stream per (seed, purpose): the run's seed may
    exceed 32 bits, RandomState takes a list of 32-bit words."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in stream]
    return np.random.RandomState(words)


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit torch seed per (seed, purpose)."""
    return int(rng_for(seed, stream).randint(0, 2**62, dtype=np.int64))


# -- the trie HCLG (copy of tools/biggraph.py::make_trie_graph) -------------

@dataclass
class Trie:
    """A det(HCLG)-shaped graph as unsorted arc arrays plus planting data."""

    start: int
    final: np.ndarray  # f32 [S]
    src: np.ndarray  # i64 [A]
    dst: np.ndarray  # i64 [A]
    ilabel: np.ndarray  # i64 [A] transition id, 0 = epsilon
    olabel: np.ndarray  # i64 [A] word id, 0 = none
    weight: np.ndarray  # f32 [A]
    tid2pdf: np.ndarray  # i32 [num_tids + 1]
    num_pdfs: int
    num_words: int
    word_pdf_off: np.ndarray  # i64 [num_words + 2]
    word_pdf_flat: np.ndarray  # i32


def make_trie_graph(rng: np.random.RandomState, num_words: int = 50_000,
                    num_phones: int = 200,
                    phones_per_word: Tuple[int, int] = (3, 8),
                    variants: int = 6, bigram_states: int = 5_000,
                    self_cost: Tuple[float, float] = (0.3, 0.7),
                    fwd_cost: Tuple[float, float] = (0.7, 1.5)) -> Trie:
    """Prefix-trie HCLG over random pronunciations: 3-state HMM chains per
    trie edge (self-loop + forward, both emitting the state's pdf),
    word-end epsilon arcs carrying the word into an LM history state, an
    epsilon backoff from each history state to the root, bigram entry arcs
    from the histories back into the trie."""
    lo, hi = phones_per_word
    lengths = rng.randint(lo, hi + 1, size=num_words + 1)
    lengths[0] = 0
    prons = [rng.randint(0, num_phones, size=n) for n in lengths]

    children: dict = {}
    edge_parent: List[int] = []
    edge_phone: List[int] = []
    word_last_edge = np.zeros(num_words + 1, np.int64)
    word_first_edge = np.zeros(num_words + 1, np.int64)
    word_edge_paths: List[np.ndarray] = [np.zeros(0, np.int64)]
    for w in range(1, num_words + 1):
        node = -1
        path = np.empty(lengths[w], np.int64)
        for i, p in enumerate(prons[w]):
            key = (node, int(p))
            e = children.get(key)
            if e is None:
                e = len(edge_parent)
                children[key] = e
                edge_parent.append(node)
                edge_phone.append(int(p))
            path[i] = e
            node = e
        word_edge_paths.append(path)
        word_first_edge[w] = path[0]
        word_last_edge[w] = path[-1]

    n_edges = len(edge_parent)
    edge_parent = np.asarray(edge_parent, np.int64)
    edge_phone = np.asarray(edge_phone, np.int64)
    edge_variant = rng.randint(0, variants, size=n_edges).astype(np.int64)

    s1 = 1 + 3 * np.arange(n_edges, dtype=np.int64)
    exit_state = s1 + 2
    parent_exit = np.where(edge_parent < 0, 0, exit_state[edge_parent])
    lm_base = 1 + 3 * n_edges
    n_bigram = min(bigram_states, num_words)
    num_states = lm_base + n_bigram

    num_pdfs = 3 * num_phones * variants
    num_tids = 2 * num_pdfs
    tid2pdf = np.zeros(num_tids + 1, np.int32)
    tid2pdf[1:] = np.arange(num_tids, dtype=np.int32) // 2

    def pdf_of(phone, j, variant):
        return (phone * 3 + j) * variants + variant

    def tid_of(phone, j, variant, kind):
        return 1 + 2 * pdf_of(phone, j, variant) + kind

    src = np.stack([parent_exit, s1, s1, s1 + 1, s1 + 1, s1 + 2], 1)
    dst = np.stack([s1, s1, s1 + 1, s1 + 1, s1 + 2, s1 + 2], 1)
    j_of = np.array([0, 0, 1, 1, 2, 2])[None, :]
    kind = np.array([0, 1, 0, 1, 0, 1])[None, :]
    ilab = tid_of(edge_phone[:, None], j_of, edge_variant[:, None], kind)
    w_fwd = rng.uniform(*fwd_cost, size=(n_edges, 6)).astype(np.float32)
    w_self = rng.uniform(*self_cost, size=(n_edges, 6)).astype(np.float32)
    wgt = np.where(kind == 1, w_self, w_fwd)
    hmm = (src.ravel(), dst.ravel(), ilab.ravel().astype(np.int64),
           np.zeros(6 * n_edges, np.int64), wgt.ravel())

    ranks = np.arange(1, num_words + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    unigram_cost = np.zeros(num_words + 1, np.float32)
    unigram_cost[1:] = (-np.log(probs)).astype(np.float32)
    we_src = exit_state[word_last_edge[1:]]
    we_dst = np.where(np.arange(1, num_words + 1) <= n_bigram,
                      lm_base + np.arange(num_words), 0).astype(np.int64)
    we = (we_src, we_dst, np.zeros(num_words, np.int64),
          np.arange(1, num_words + 1, dtype=np.int64),
          unigram_cost[1:].copy())

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
    key = lm_of_arc * np.int64(n_edges) + tgt_edge
    _, uniq_idx = np.unique(key, return_index=True)
    lm_of_arc, tgt_edge = lm_of_arc[uniq_idx], tgt_edge[uniq_idx]
    bg_ilab = tid_of(edge_phone[tgt_edge], 0, edge_variant[tgt_edge], 0)
    bg_w = (rng.uniform(0.1, 1.0, size=tgt_edge.size).astype(np.float32)
            + w_fwd[tgt_edge, 0])
    bg = (lm_of_arc, s1[tgt_edge], bg_ilab.astype(np.int64),
          np.zeros(tgt_edge.size, np.int64), bg_w)

    parts = [hmm, we, bo, bg]
    final = np.full(num_states, np.inf, np.float32)
    final[0] = 0.0
    final[lm_base:] = backoff_w

    path_lens = lengths * 3
    word_pdf_off = np.zeros(num_words + 2, np.int64)
    np.cumsum(path_lens, out=word_pdf_off[1:])
    flat = np.empty(int(word_pdf_off[-1]), np.int32)
    for w in range(1, num_words + 1):
        path = word_edge_paths[w]
        pdfs = (pdf_of(edge_phone[path][:, None], np.arange(3)[None, :],
                       edge_variant[path][:, None])).ravel()
        flat[word_pdf_off[w]:word_pdf_off[w + 1]] = pdfs
    return Trie(
        start=0, final=final,
        src=np.concatenate([p[0] for p in parts]),
        dst=np.concatenate([p[1] for p in parts]),
        ilabel=np.concatenate([p[2] for p in parts]),
        olabel=np.concatenate([p[3] for p in parts]),
        weight=np.concatenate([p[4] for p in parts]).astype(np.float32),
        tid2pdf=tid2pdf, num_pdfs=num_pdfs, num_words=num_words,
        word_pdf_off=word_pdf_off, word_pdf_flat=flat)


# -- the backoff G' (copy of tools/biggraph.py::make_big_lm) ----------------

@dataclass
class BigLm:
    """An ARPA-shaped backoff LM as unsorted arc arrays (ilabel = olabel;
    a state's epsilon arc is its backoff) plus the unigram cost vector the
    delta-LM subtracts."""

    start: int
    final: np.ndarray  # f32 [S]
    src: np.ndarray  # i64 [A]
    dst: np.ndarray  # i64 [A]
    label: np.ndarray  # i64 [A]
    weight: np.ndarray  # f32 [A]
    small_lm: np.ndarray  # f32 [eos + 1]
    bos_id: int
    eos_id: int


def make_big_lm(rng: np.random.RandomState, num_words: int,
                num_trigrams: int = 0, max_bigram_deg: int = 400) -> BigLm:
    """State 0 the unigram terminal (an arc per word, <s>, </s>), states
    1..V the bigram histories (backoff first, heavy-tailed bigram arcs),
    V+1 the post-<s> history, V+2 the final </s> state, then trigram
    states backing off to a bigram history."""
    v = num_words
    bos, eos = v + 1, v + 2
    n_tri = num_trigrams if num_trigrams else v
    hist = 1 + np.arange(v, dtype=np.int64)
    bos_hist, final_state, tri_base = v + 1, v + 2, v + 3
    num_states = tri_base + n_tri

    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    uni = (-np.log(probs)).astype(np.float32)
    eos_cost = float(rng.rand() + 1.0)

    uni_arcs = (np.zeros(v + 2, np.int64),
                np.concatenate([hist, [bos_hist, final_state]]),
                np.concatenate([hist, [bos, eos]]),
                np.concatenate([uni, [0.0, eos_cost]]).astype(np.float32))

    bo_w = rng.uniform(0.3, 2.5, size=v + 1).astype(np.float32)
    bo_src = np.concatenate([hist, [bos_hist]])
    bo_arcs = (bo_src, np.zeros(v + 1, np.int64),
               np.zeros(v + 1, np.int64), bo_w)
    deg = np.minimum(1 + (rng.pareto(1.2, v + 1) * 6).astype(np.int64),
                     max_bigram_deg)
    bg_src = np.repeat(bo_src, deg)
    n_bg = int(deg.sum())
    bg_lab = 1 + np.minimum((rng.pareto(1.0, n_bg) * 40).astype(np.int64),
                            v - 1)
    key = bg_src * np.int64(v + 3) + bg_lab
    _, uniq = np.unique(key, return_index=True)
    bg_src, bg_lab = bg_src[uniq], bg_lab[uniq]
    bg_w = rng.uniform(0.1, 3.0, size=bg_src.size).astype(np.float32)
    bg_dst = bg_lab.copy()
    n_tri = min(n_tri, bg_src.size)
    promoted = rng.choice(bg_src.size, size=n_tri, replace=False)
    tri_states = tri_base + np.arange(n_tri, dtype=np.int64)
    bg_dst[promoted] = tri_states
    bg_arcs = (bg_src, bg_dst, bg_lab, bg_w)

    tri_bo = (tri_states, bg_lab[promoted].copy(),
              np.zeros(n_tri, np.int64),
              rng.uniform(0.2, 1.5, size=n_tri).astype(np.float32))
    tdeg = 1 + (rng.pareto(1.5, n_tri) * 3).astype(np.int64)
    t_src = np.repeat(tri_states, tdeg)
    n_tg = int(tdeg.sum())
    t_lab = 1 + np.minimum((rng.pareto(1.0, n_tg) * 40).astype(np.int64),
                           v - 1)
    tkey = t_src * np.int64(v + 3) + t_lab
    _, uniq = np.unique(tkey, return_index=True)
    t_src, t_lab = t_src[uniq], t_lab[uniq]
    tri_arcs = (t_src, t_lab.copy(), t_lab,
                rng.uniform(0.05, 2.0, size=t_src.size).astype(np.float32))

    parts = [uni_arcs, bo_arcs, bg_arcs, tri_bo, tri_arcs]
    final = np.full(num_states, np.inf, np.float32)
    final[final_state] = 0.0
    small_lm = np.full(eos + 1, np.inf, np.float32)
    small_lm[1:v + 1] = uni
    small_lm[0] = 0.0
    small_lm[bos] = 0.0
    small_lm[eos] = eos_cost
    return BigLm(
        start=0, final=final,
        src=np.concatenate([p[0] for p in parts]),
        dst=np.concatenate([p[1] for p in parts]),
        label=np.concatenate([p[2] for p in parts]),
        weight=np.concatenate([p[3] for p in parts]).astype(np.float32),
        small_lm=small_lm, bos_id=bos, eos_id=eos)


# -- planted paths (copy of tools/biggraph.py::plant_targets, plant_logp) ---

def plant_targets(rng: np.random.RandomState, graph: Trie, frames: int,
                  dur: Tuple[int, int] = (2, 4)
                  ) -> Tuple[np.ndarray, List[int]]:
    """Frame-level pdf targets walking random word paths (~3 words/s); the
    true words are those whose path was planted whole."""
    targets = np.zeros(frames, np.int32)
    words: List[int] = []
    t = 0
    while t < frames:
        w = 1 + min(int(rng.pareto(0.8) * 3), graph.num_words - 1)
        pdfs = graph.word_pdf_flat[
            graph.word_pdf_off[w]:graph.word_pdf_off[w + 1]]
        durs = rng.randint(dur[0], dur[1] + 1, size=pdfs.size)
        seq = np.repeat(pdfs, durs)
        n = min(seq.size, frames - t)
        targets[t:t + n] = seq[:n]
        t += n
        if n == seq.size:
            words.append(w)
    return targets, words


def plant_logp(rng: np.random.RandomState, graph: Trie, batch: int,
               frames: int, amp: float = 10.0
               ) -> Tuple[np.ndarray, List[List[int]]]:
    """[B, T, P] log_softmax(amp * onehot(target) + N(0, 1)) frames and
    the true word lists (the host form; `plant_device` is the card's)."""
    p = graph.num_pdfs
    logp = np.empty((batch, frames, p), np.float32)
    all_words: List[List[int]] = []
    for b in range(batch):
        targets, words = plant_targets(rng, graph, frames)
        z = rng.randn(frames, p).astype(np.float32)
        z[np.arange(frames), targets] += amp
        z -= z.max(axis=1, keepdims=True)
        np.exp(z, out=logp[b])
        norm = logp[b].sum(axis=1, keepdims=True)
        logp[b] = z - np.log(norm)
        all_words.append(words)
    return logp, all_words


def plant_device(targets: List[np.ndarray], num_pdfs: int, amp: float,
                 gen: torch.Generator, device) -> torch.Tensor:
    """[B, T_max, P] float32 planted frames on the card: the same
    distribution as plant_logp, the noise drawn in one call; rows past an
    utterance's end are zero."""
    b = len(targets)
    t_max = max(t.size for t in targets)
    z = torch.randn((b, t_max, num_pdfs), generator=gen, device=device)
    tgt = torch.zeros((b, t_max), dtype=torch.int64)
    valid = torch.zeros((b, t_max), dtype=torch.bool)
    for i, t in enumerate(targets):
        tgt[i, :t.size] = torch.from_numpy(t.astype(np.int64))
        valid[i, :t.size] = True
    tgt, valid = tgt.to(device), valid.to(device)
    z.scatter_add_(2, tgt[..., None],
                   torch.full((b, t_max, 1), amp, device=device))
    out = torch.log_softmax(z, dim=-1)
    return torch.where(valid[..., None], out, 0.0)


# -- the TDNN (copy of tools/toy.py::make_toy_nnet) -------------------------

def make_toy_nnet(rng: np.random.RandomState, feat_dim: int = 40,
                  hidden: int = 64, num_pdfs: int = 48,
                  num_tdnn_layers: int = 2,
                  context: Tuple[int, ...] = (-1, 0, 1)) -> List[dict]:
    """TDNN layer list: per hidden layer splice, narrow, linear ([in, out]
    weight), relu, batchnorm (scale, offset); then linear, logsoftmax."""
    layers: List[dict] = []
    in_dim = feat_dim
    for _ in range(num_tdnn_layers):
        nl = -min(min(context), 0)
        nr = max(max(context), 0)
        layers.append({"kind": "splice", "indices": tuple(context)})
        layers.append({"kind": "narrow", "left": nl, "right": nr})
        spliced = in_dim * len(context)
        w = (rng.randn(spliced, hidden) / np.sqrt(spliced)).astype(np.float32)
        b = (rng.randn(hidden) * 0.1).astype(np.float32)
        layers.append({"kind": "linear", "w": w, "b": b})
        layers.append({"kind": "relu"})
        scale = (1.0 + 0.1 * rng.rand(hidden)).astype(np.float32)
        offset = (0.05 * rng.randn(hidden)).astype(np.float32)
        layers.append({"kind": "batchnorm", "scale": scale,
                       "offset": offset})
        in_dim = hidden
    w = (rng.randn(in_dim, num_pdfs) / np.sqrt(in_dim)).astype(np.float32)
    b = (rng.randn(num_pdfs) * 0.1).astype(np.float32)
    layers.append({"kind": "linear", "w": w, "b": b})
    layers.append({"kind": "logsoftmax"})
    return layers


def tdnn_device(gen: torch.Generator, device, feat_dim: int, hidden: int,
                num_pdfs: int, num_tdnn_layers: int,
                context: Tuple[int, ...]) -> List[dict]:
    """make_toy_nnet's layers with the same distributions, drawn on the
    card in two calls (one normal, one uniform) and sliced; tensors are
    float32 on `device`."""
    shapes = []
    in_dim = feat_dim
    for _ in range(num_tdnn_layers):
        shapes.append((in_dim * len(context), hidden))
        in_dim = hidden
    shapes.append((in_dim, num_pdfs))
    n_normal = sum(i * o + o for i, o in shapes) + hidden * num_tdnn_layers
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(hidden * num_tdnn_layers, generator=gen,
                         device=device)
    pos = upos = 0

    def take(n):
        nonlocal pos
        pos += n
        return normal[pos - n:pos]

    layers: List[dict] = []
    nl = -min(min(context), 0)
    nr = max(max(context), 0)
    for n, (i, o) in enumerate(shapes):
        w = take(i * o).view(i, o) / math.sqrt(i)
        b = take(o) * 0.1
        if n < num_tdnn_layers:
            layers.append({"kind": "splice", "indices": tuple(context)})
            layers.append({"kind": "narrow", "left": nl, "right": nr})
            layers.append({"kind": "linear", "w": w, "b": b})
            layers.append({"kind": "relu"})
            scale = 1.0 + 0.1 * uniform[upos:upos + o]
            upos += o
            layers.append({"kind": "batchnorm", "scale": scale,
                           "offset": take(o) * 0.05})
        else:
            layers.append({"kind": "linear", "w": w, "b": b})
            layers.append({"kind": "logsoftmax"})
    return layers


def tdnn_context(layers: List[dict]) -> Tuple[int, int]:
    """(left, right) frames of context the layer stack consumes."""
    left = sum(x["left"] for x in layers if x["kind"] == "narrow")
    right = sum(x["right"] for x in layers if x["kind"] == "narrow")
    return left, right


# -- traffic ------------------------------------------------------------------

def quantile_lengths(n: int, mean_s: float, sigma: float, lo_s: float,
                     hi_s: float) -> np.ndarray:
    """n utterance lengths in seconds: the quantiles (i + 0.5) / n of a
    log-normal with this mean, clipped; every seed gets this same set."""
    from statistics import NormalDist

    mu = math.log(mean_s) - sigma * sigma / 2.0
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(mu + sigma * z), lo_s, hi_s)


def stratified_batches(rng: np.random.RandomState, n: int,
                       batches: int) -> List[np.ndarray]:
    """Deal utterances 0..n-1 (sorted by length) into `batches` batches,
    one of each stratum of `batches` neighbours per batch, in an order
    drawn from `rng`: every seed's pool holds the same utterances and
    steps the same frames (the sum of the batches' longest); the seed
    changes which utterances share a batch."""
    strata = np.arange(n).reshape(-1, batches)
    out = [[] for _ in range(batches)]
    for row in strata:
        for b, x in zip(rng.permutation(batches), row):
            out[b].append(x)
    return [rng.permutation(np.array(x)) for x in out]


def pcm_noise(rng: np.random.RandomState, samples: int,
              rms: float) -> np.ndarray:
    """Seeded 16-bit PCM noise as the float samples the frontend takes."""
    x = np.clip(np.round(rng.randn(samples) * rms), -32768, 32767)
    return x.astype(np.float32)


def live_phases(rng: np.random.RandomState, streams: int,
                period_s: float) -> np.ndarray:
    """Each stream's phase in [0, period): the evenly spaced set, dealt to
    the streams in an order drawn from `rng`; its chunk c is due at
    phase + (c + 1) * period after the window opens."""
    return rng.permutation((np.arange(streams) + 0.5) / streams * period_s)


def as_numpy_layers(layers: List[dict]) -> List[Dict]:
    """The layer list with every tensor as a numpy float32 array."""
    out = []
    for layer in layers:
        out.append({k: (v.detach().cpu().numpy().astype(np.float32)
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in layer.items()})
    return out
