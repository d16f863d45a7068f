"""Synthetic model/graph generators for tests and benchmarks (the port's
copy of catears_tpu/tools/toy.py).

The reference repo ships no acoustic model, so parity and performance work
uses synthetic-but-structurally-faithful artifacts: a TDNN-style NN02 nnet
(splice/narrow/linear/batchnorm/relu/logsoftmax, like tool/convert_am.py
emits), a phone-loop HCLG-style WFST (self-loops + forward arcs + epsilon
word-end arcs, transition-ids on inputs / word-ids on outputs), and the
matching tid2pdf / prior / symbol-table / config files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.binfmt import LayerSpec, NnetSpec, RawFst


def make_toy_nnet(rng: np.random.RandomState, feat_dim: int = 40,
                  hidden: int = 64, num_pdfs: int = 48,
                  num_tdnn_layers: int = 2,
                  context: Tuple[int, ...] = (-1, 0, 1)) -> NnetSpec:
    """TDNN-ish NN02 spec with the same layer grammar as convert_am.py."""
    layers: List[LayerSpec] = []
    left = right = 0
    in_dim = feat_dim
    for _ in range(num_tdnn_layers):
        nl = -min(min(context), 0)
        nr = max(max(context), 0)
        left += nl
        right += nr
        layers.append(LayerSpec(binfmt.LAYER_SPLICE, indices=tuple(context)))
        layers.append(LayerSpec(binfmt.LAYER_NARROW, narrow_left=nl,
                                narrow_right=nr))
        spliced = in_dim * len(context)
        w = (rng.randn(spliced, hidden) / np.sqrt(spliced)).astype(np.float32)
        b = (rng.randn(hidden) * 0.1).astype(np.float32)
        layers.append(LayerSpec(binfmt.LAYER_LINEAR, weight=w, bias=b))
        layers.append(LayerSpec(binfmt.LAYER_RELU))
        scale = (1.0 + 0.1 * rng.rand(hidden)).astype(np.float32)
        offset = (0.05 * rng.randn(hidden)).astype(np.float32)
        layers.append(LayerSpec(binfmt.LAYER_BATCHNORM, scale=scale,
                                offset=offset))
        in_dim = hidden
    w = (rng.randn(in_dim, num_pdfs) / np.sqrt(in_dim)).astype(np.float32)
    b = (rng.randn(num_pdfs) * 0.1).astype(np.float32)
    layers.append(LayerSpec(binfmt.LAYER_LINEAR, weight=w, bias=b))
    layers.append(LayerSpec(binfmt.LAYER_LOGSOFTMAX))
    return NnetSpec(left_context=left, right_context=right, layers=layers)


@dataclass
class ToyGraph:
    fst: RawFst
    words: List[str]  # word id -> text (id 0 = <eps>)
    num_transitions: int  # transition ids are 1..num_transitions
    tid2pdf: np.ndarray  # [num_transitions + 1] int32


def make_phone_loop_graph(rng: np.random.RandomState, num_words: int = 6,
                          phones_per_word: Tuple[int, int] = (2, 4),
                          num_pdfs: int = 48,
                          max_fanout: int = 0) -> ToyGraph:
    """Phone-loop WFST: HCLG-like shape with self-loops and eps word arcs.

    State 0 is start and final.  Each word w spans a chain of phone states;
    each phone state has an emitting self-loop and an emitting forward arc
    (fresh transition-ids, distinct pdfs while available); the last forward
    arc leaves on an epsilon-input arc carrying the word olabel back to the
    loop state.

    With max_fanout > 0, word entries hang off an epsilon tree of group
    states so no state's out-degree exceeds ~max_fanout — the bounded-degree
    graph shape large-vocabulary decoding needs (epsilon depth grows by the
    tree height).
    """
    arcs = []  # (src, dst, ilabel, olabel, weight)
    states = 1  # state 0 = loop state
    tid = 0
    tid2pdf = [0]
    words = ["<eps>"]

    def new_tid():
        nonlocal tid
        tid += 1
        tid2pdf.append((tid - 1) % num_pdfs)
        return tid

    # Word entry points: state 0 directly, or an epsilon group tree
    entry_of_word = [0] * (num_words + 1)
    if max_fanout and num_words > max_fanout:
        leaves = -(-num_words // max_fanout)
        level = [0]
        while len(level) < leaves:
            nxt = []
            for parent in level:
                for _ in range(max_fanout):
                    if len(nxt) == leaves:
                        break
                    g = states
                    states += 1
                    arcs.append((parent, g, 0, 0, 0.0))
                    nxt.append(g)
                if len(nxt) == leaves:
                    break
            level = nxt
        for w in range(1, num_words + 1):
            entry_of_word[w] = level[(w - 1) % len(level)]

    for w in range(1, num_words + 1):
        words.append(f"word{w}")
        n_phones = rng.randint(phones_per_word[0], phones_per_word[1] + 1)
        prev = entry_of_word[w]
        for p in range(n_phones):
            cur = states
            states += 1
            t_forward = new_tid()
            arcs.append((prev, cur, t_forward, 0,
                         float(rng.rand() * 2 + 0.1)))
            t_self = new_tid()
            arcs.append((cur, cur, t_self, 0, float(rng.rand() * 0.5 + 0.05)))
            prev = cur
        # word-end epsilon arc with the word olabel, back to the loop state
        arcs.append((prev, 0, 0, w, float(rng.rand() + 0.1)))

    final = np.full(states, np.inf, np.float32)
    final[0] = 0.0
    arr = np.array(arcs, dtype=np.float64)
    from catears_tpu_torch.graph.fst import FlatFst
    flat = FlatFst.from_arrays(
        start=0, final=final,
        state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))
    first_arc = np.full(states, -1, np.int32)
    for s in range(states):
        lo, hi = flat.arc_range(s)
        if hi > lo:
            first_arc[s] = lo
    raw = RawFst(start=0, final=final, first_arc=first_arc,
                 arc_next=flat.arc_next, arc_ilabel=flat.arc_ilabel,
                 arc_olabel=flat.arc_olabel, arc_weight=flat.arc_weight)
    return ToyGraph(fst=raw, words=words, num_transitions=tid,
                    tid2pdf=np.asarray(tid2pdf, np.int32))


def make_toy_lm(rng: np.random.RandomState, num_words: int,
                bos_id: int, eos_id: int) -> Tuple[RawFst, np.ndarray]:
    """Tiny backoff bigram LM as a pk-format FST + unigram cost vector.

    State 0 = unigram/backoff state: one arc per word (loops back to 0),
    plus <s> -> state 1 and </s> -> final state 2.  State 1 (post-BOS) has
    an epsilon backoff arc to state 0 (first in span, LmFst convention) and
    a few bigram arcs.  The unigram vector matches state 0's word costs so
    DeltaLmFst deltas are the bigram corrections.
    """
    arcs = []  # (src, dst, ilabel, olabel, weight)
    uni = {w: float(rng.rand() * 2 + 0.5) for w in range(1, num_words + 1)}
    for w, cost in uni.items():
        arcs.append((0, 0, w, w, cost))
    arcs.append((0, 1, bos_id, bos_id, 0.0))
    arcs.append((0, 2, eos_id, eos_id, float(rng.rand() + 0.2)))
    arcs.append((1, 0, 0, 0, float(rng.rand() * 0.5)))  # backoff
    for w in range(1, num_words + 1):
        if rng.rand() < 0.5:  # some bigrams P(w | <s>)
            arcs.append((1, 0, w, w, float(rng.rand() + 0.1)))
    final = np.full(3, np.inf, np.float32)
    final[2] = 0.0
    arr = np.array(arcs, dtype=np.float64)
    from catears_tpu_torch.graph.fst import FlatFst
    flat = FlatFst.from_arrays(
        start=0, final=final,
        state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))
    first_arc = np.full(3, -1, np.int32)
    for s in range(3):
        lo, hi = flat.arc_range(s)
        if hi > lo:
            first_arc[s] = lo
    raw = RawFst(start=0, final=final, first_arc=first_arc,
                 arc_next=flat.arc_next, arc_ilabel=flat.arc_ilabel,
                 arc_olabel=flat.arc_olabel, arc_weight=flat.arc_weight)
    small_lm = np.full(eos_id + 1, np.inf, np.float32)
    for w, cost in uni.items():
        small_lm[w] = cost
    small_lm[bos_id] = 0.0
    small_lm[eos_id] = float(rng.rand() + 0.2)
    return raw, small_lm


def write_toy_model(out_dir: str, rng: Optional[np.random.RandomState] = None,
                    num_words: int = 6, hidden: int = 64,
                    num_pdfs: int = 48) -> str:
    """Write a complete decodable model directory; returns config path."""
    rng = rng or np.random.RandomState(0)
    os.makedirs(out_dir, exist_ok=True)
    graph = make_phone_loop_graph(rng, num_words=num_words, num_pdfs=num_pdfs)
    nnet = make_toy_nnet(rng, hidden=hidden, num_pdfs=num_pdfs)

    with open(os.path.join(out_dir, "toy.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, nnet)
    prior = (np.ones(num_pdfs) / num_pdfs).astype(np.float32)
    with open(os.path.join(out_dir, "toy.prior"), "wb") as fd:
        binfmt.write_vec0(fd, prior)
    with open(os.path.join(out_dir, "toy.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, graph.tid2pdf)
    with open(os.path.join(out_dir, "toy.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, graph.fst)
    with open(os.path.join(out_dir, "words.txt"), "w") as fd:
        for i, w in enumerate(graph.words):
            fd.write(f"{w} {i}\n")
        fd.write(f"<s> {len(graph.words)}\n")
        fd.write(f"</s> {len(graph.words) + 1}\n")
    config_path = os.path.join(out_dir, "toy.conf")
    with open(config_path, "w") as fd:
        fd.write("fst = toy.fst\n")
        fd.write("nnet = toy.nnet\n")
        fd.write("prior = toy.prior\n")
        fd.write(f"left_context = {nnet.left_context}\n")
        fd.write(f"right_context = {nnet.right_context}\n")
        fd.write("chunk_size = 8\n")
        fd.write(f"num_pdfs = {num_pdfs}\n")
        fd.write("tid2pdf = toy.tid2pdf\n")
        fd.write("symbol_table = words.txt\n")
    return config_path
