"""mkgraph-shaped large-vocabulary benchmark graphs + planted audio paths
(the port's copy of catears_tpu/tools/biggraph.py).

Real HCLG graphs produced by the reference's recipe
(the reference's tool/mkgraph_hcl.sh -> Kaldi utils/mkgraph.sh) are
det(min(H o C o L o G)).  Structurally that means:

  * The lexicon determinizes into a phone-prefix TRIE: no state's fanout
    ever approaches vocab size (it is bounded by the phone inventory),
    words share HMM chains along common prefixes, and the olabel is
    emitted where the word becomes unique (approximated here by word-end
    epsilon arcs).
  * Each phone expands to a left-to-right HMM chain (3 emitting states,
    self-loop + forward per state, both emitting the state's pdf).
  * Word-end epsilon arcs carry the word olabel into an LM history state;
    LM states hold bigram entry arcs back into the trie plus an epsilon
    backoff arc to the shared unigram state (the trie root), giving the
    deep-but-bounded epsilon chains ProcessNonemitting exists for
    (reference src/decoder.cc:240-292).

`make_trie_graph` synthesizes graphs with exactly that shape at arbitrary
vocab scale (50k words ~= 1M states / 1.7M arcs), and `plant_logp` makes
pseudo-likelihood frames that walk real graph paths so benchmark decodes
emit words at a realistic rate (random noise parks the beam in self-loops
and under-exercises word-end epsilon traffic, LM propagation and
backtrace — the paths that dominate on real speech).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from catears_tpu_torch.graph.fst import FlatFst


@dataclass
class TrieGraph:
    """A synthetic det(HCLG)-shaped graph plus planting metadata."""

    fst: FlatFst
    tid2pdf: np.ndarray  # [num_tids + 1] int32 (tid 0 = eps, unused)
    num_pdfs: int
    num_words: int
    # Planting metadata: word w's HMM pdf sequence is
    # word_pdf_flat[word_pdf_off[w] : word_pdf_off[w + 1]].
    word_pdf_off: np.ndarray  # i64 [num_words + 2]
    word_pdf_flat: np.ndarray  # i32 [sum path lengths]
    unigram_cost: np.ndarray  # f32 [num_words + 1] (index 0 unused)


def make_trie_graph(rng: np.random.RandomState, num_words: int = 50_000,
                    num_phones: int = 200,
                    phones_per_word: Tuple[int, int] = (3, 8),
                    variants: int = 6, bigram_states: int = 5_000,
                    self_cost: Tuple[float, float] = (0.3, 0.7),
                    fwd_cost: Tuple[float, float] = (0.7, 1.5)) -> TrieGraph:
    """Prefix-trie HCLG over random pronunciations.

    variants: context-dependency fan: each trie edge draws one of
    `variants` pdf variants per (phone, hmm-state), so num_pdfs =
    3 * num_phones * variants (~3600 at the defaults), matching the pdf
    counts real tree-clustered models land on.
    """
    lo, hi = phones_per_word
    lengths = rng.randint(lo, hi + 1, size=num_words + 1)
    lengths[0] = 0  # word id 0 = eps
    prons = [rng.randint(0, num_phones, size=n) for n in lengths]

    # --- trie over pronunciations (edges keyed by (parent_node, phone)) ---
    children: dict = {}
    edge_parent: List[int] = []  # parent edge id, -1 = root
    edge_phone: List[int] = []
    word_last_edge = np.zeros(num_words + 1, np.int64)
    word_first_edge = np.zeros(num_words + 1, np.int64)
    word_edge_paths: List[np.ndarray] = [np.zeros(0, np.int64)]
    for w in range(1, num_words + 1):
        node = -1  # edge id whose exit state is the current trie node
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

    # --- state / tid / pdf numbering ---------------------------------------
    # root R = 0; edge e -> states 1+3e .. 3+3e (s1, s2, s3)
    s1 = 1 + 3 * np.arange(n_edges, dtype=np.int64)
    exit_state = s1 + 2
    parent_exit = np.where(edge_parent < 0, 0, exit_state[edge_parent])
    lm_base = 1 + 3 * n_edges
    n_bigram = min(bigram_states, num_words)
    num_states = lm_base + n_bigram

    # pdf(p, j, v) = (p*3 + j) * variants + v;  tid = 1 + pdf*2 + kind
    # (kind 0 = entry/forward, 1 = self-loop; both emit the state's pdf,
    #  like Kaldi transitions from one HMM state).
    num_pdfs = 3 * num_phones * variants
    num_tids = 2 * num_pdfs
    tid2pdf = np.zeros(num_tids + 1, np.int32)
    tid2pdf[1:] = np.arange(num_tids, dtype=np.int32) // 2

    def pdf_of(phone, j, variant):
        return (phone * 3 + j) * variants + variant

    def tid_of(phone, j, variant, kind):
        return 1 + 2 * pdf_of(phone, j, variant) + kind

    # --- HMM chain arcs: 6 per edge, fully vectorized -----------------------
    # entry(s1), self(s1), fwd(s2), self(s2), fwd(s3), self(s3)
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

    # --- word-end epsilon arcs (olabel = word) ------------------------------
    # Unigram costs ~ Zipf over word ids (low ids = frequent words).
    ranks = np.arange(1, num_words + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    unigram_cost = np.zeros(num_words + 1, np.float32)
    unigram_cost[1:] = (-np.log(probs)).astype(np.float32)
    we_src = exit_state[word_last_edge[1:]]
    we_dst = np.where(np.arange(1, num_words + 1) <= n_bigram,
                      lm_base + np.arange(num_words) ,
                      0).astype(np.int64)
    we = (we_src, we_dst, np.zeros(num_words, np.int64),
          np.arange(1, num_words + 1, dtype=np.int64),
          unigram_cost[1:].copy())

    # --- LM history states: backoff eps -> root, bigram entries into trie ---
    lm_states = lm_base + np.arange(n_bigram, dtype=np.int64)
    backoff_w = rng.uniform(0.7, 2.5, size=n_bigram).astype(np.float32)
    bo = (lm_states, np.zeros(n_bigram, np.int64),
          np.zeros(n_bigram, np.int64), np.zeros(n_bigram, np.int64),
          backoff_w)
    # Heavy-tailed bigram out-degree (Zipf-ish), arcs enter the shared trie
    # at the next word's first edge; dedup (lm_state, edge) pairs.
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
    state_of_arc = np.concatenate([p[0] for p in parts])
    arc_next = np.concatenate([p[1] for p in parts])
    arc_ilabel = np.concatenate([p[2] for p in parts])
    arc_olabel = np.concatenate([p[3] for p in parts])
    arc_weight = np.concatenate([p[4] for p in parts])

    final = np.full(num_states, np.inf, np.float32)
    final[0] = 0.0
    final[lm_base:] = backoff_w  # end-of-utterance via backoff

    fst = FlatFst.from_arrays(0, final, state_of_arc, arc_next, arc_ilabel,
                              arc_olabel, arc_weight.astype(np.float32))

    # --- planting metadata: per-word pdf sequences --------------------------
    path_lens = lengths * 3
    word_pdf_off = np.zeros(num_words + 2, np.int64)
    np.cumsum(path_lens, out=word_pdf_off[1:])
    flat = np.empty(int(word_pdf_off[-1]), np.int32)
    for w in range(1, num_words + 1):
        path = word_edge_paths[w]
        pdfs = (pdf_of(edge_phone[path][:, None], np.arange(3)[None, :],
                       edge_variant[path][:, None])).ravel()
        flat[word_pdf_off[w]:word_pdf_off[w + 1]] = pdfs
    return TrieGraph(fst=fst, tid2pdf=tid2pdf, num_pdfs=num_pdfs,
                     num_words=num_words, word_pdf_off=word_pdf_off,
                     word_pdf_flat=flat, unigram_cost=unigram_cost)


@dataclass
class BigLm:
    """ARPA-scale backoff G' for delta-LM rescoring stress tests."""

    lm: "LmFst"  # noqa: F821 - imported lazily below
    small_lm: np.ndarray  # f32 [eos + 1] unigram subtraction vector
    bos_id: int
    eos_id: int
    num_states: int
    num_arcs: int

    def delta_lm(self):
        """DeltaLmFst over this G' (what the decoder consumes)."""
        from catears_tpu_torch.graph.fst import DeltaLmFst
        from catears_tpu_torch.io.symbols import SymbolTable

        st = SymbolTable()
        st.bos_id, st.eos_id = self.bos_id, self.eos_id
        return DeltaLmFst(self.small_lm, self.lm, st)


def make_big_lm(rng: np.random.RandomState, num_words: int,
                num_trigrams: int = 0, max_bigram_deg: int = 400
                ) -> BigLm:
    """Synthetic ARPA-shaped backoff LM FST at real G' scale.

    Shape matches what tools/lm.py arpa_to_fst produces from a pruned
    ARPA (reference tool/prune_lm.py + format_lm):

      state 0            unigram/backoff terminal: one arc PER WORD
                         (vocab-sized span -> exercises the dense
                         bucket_0_-style fast path), plus <s>/</s> arcs
      states 1..V        bigram history per word: eps backoff -> 0 first
                         in span + heavy-tailed bigram arcs
      state V+1          post-<s> history (the DeltaLmFst start)
      state V+2          final </s> state
      states V+3..       optional trigram states: backoff -> the bigram
                         history (a 2-hop backoff chain, the deepest a
                         3-gram model produces)

    num_trigrams defaults to num_words so states ~ 2 * vocab (>= 100k at
    a 50k vocab).
    """
    from catears_tpu_torch.graph.fst import LmFst

    v = num_words
    bos, eos = v + 1, v + 2
    n_tri = num_trigrams if num_trigrams else v
    hist = 1 + np.arange(v, dtype=np.int64)  # hist(w) = w
    bos_hist, final_state, tri_base = v + 1, v + 2, v + 3
    num_states = tri_base + n_tri

    # Zipf unigram costs (low word ids = frequent).
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    uni = (-np.log(probs)).astype(np.float32)
    eos_cost = float(rng.rand() + 1.0)

    # state 0: one arc per word into its history state + <s> + </s>
    uni_arcs = (np.zeros(v + 2, np.int64),
                np.concatenate([hist, [bos_hist, final_state]]),
                np.concatenate([hist, [bos, eos]]),
                np.concatenate([uni, [0.0, eos_cost]]).astype(np.float32))

    # bigram histories: backoff first + heavy-tailed bigram arcs
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
    bg_dst = bg_lab.copy()  # -> hist(label)
    # promote n_tri bigram arcs' destinations to trigram states
    n_tri = min(n_tri, bg_src.size)
    promoted = rng.choice(bg_src.size, size=n_tri, replace=False)
    tri_states = tri_base + np.arange(n_tri, dtype=np.int64)
    bg_dst[promoted] = tri_states
    bg_arcs = (bg_src, bg_dst, bg_lab, bg_w)

    # trigram states: backoff -> the promoted arc's bigram history + a few
    # trigram arcs back into histories
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
    state_of_arc = np.concatenate([p[0] for p in parts])
    arc_next = np.concatenate([p[1] for p in parts])
    arc_ilabel = np.concatenate([p[2] for p in parts])
    arc_weight = np.concatenate([p[3] for p in parts]).astype(np.float32)

    final = np.full(num_states, np.inf, np.float32)
    final[final_state] = 0.0
    base = FlatFst.from_arrays(0, final, state_of_arc, arc_next,
                               arc_ilabel, arc_ilabel.copy(), arc_weight)
    small_lm = np.full(eos + 1, np.inf, np.float32)
    small_lm[1:v + 1] = uni
    small_lm[0] = 0.0
    small_lm[bos] = 0.0
    small_lm[eos] = eos_cost
    return BigLm(lm=LmFst(**base.__dict__), small_lm=small_lm,
                 bos_id=bos, eos_id=eos, num_states=num_states,
                 num_arcs=base.num_arcs)


def plant_targets(rng: np.random.RandomState, graph: TrieGraph,
                  frames: int, dur: Tuple[int, int] = (2, 4)
                  ) -> Tuple[np.ndarray, List[int]]:
    """Frame-level pdf targets walking random word paths (~3 words/sec)."""
    targets = np.zeros(frames, np.int32)
    words: List[int] = []
    t = 0
    while t < frames:
        # Zipf-ish word choice matching the unigram costs
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


def plant_logp(rng: np.random.RandomState, graph: TrieGraph, batch: int,
               frames: int, amp: float = 10.0
               ) -> Tuple[np.ndarray, List[List[int]]]:
    """[B, T, P] planted pseudo-log-likelihood frames + true word lists.

    Each frame is log_softmax(amp * onehot(target) + N(0,1)): the target
    pdf carries ~75% of the probability mass, the rest spreads over
    confusable pdfs — enough signal for the beam to track the path while
    keeping realistic competition.
    """
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


def write_trie_model(out_dir: str, rng: np.random.RandomState,
                     num_words: int = 50_000, hidden: int = 1024,
                     with_lm: bool = False, **trie_kwargs) -> str:
    """Write a decodable model directory around a trie HCLG.

    Same artifact set as tools.toy.write_toy_model (pk::fst_0 graph, NN02
    nnet, VEC0 prior/tid2pdf, words.txt, config) but at large-vocab bench
    scale — used by the streaming bench so its latency numbers come from
    the production-shaped graph, not a toy loop.  with_lm additionally
    writes an ARPA-scale G' + unigram vector and the `large_lm`/
    `original_lm` config keys (reference src/ce_stt.cc:82-110), so the
    runtime decodes with on-the-fly delta-LM rescoring.  Returns the
    config path.
    """
    import os

    from catears_tpu_torch.io import binfmt
    from catears_tpu_torch.tools.toy import make_toy_nnet

    os.makedirs(out_dir, exist_ok=True)
    g = make_trie_graph(rng, num_words=num_words, **trie_kwargs)
    nnet = make_toy_nnet(rng, hidden=hidden, num_pdfs=g.num_pdfs)
    with open(os.path.join(out_dir, "trie.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, nnet)
    prior = (np.ones(g.num_pdfs) / g.num_pdfs).astype(np.float32)
    with open(os.path.join(out_dir, "trie.prior"), "wb") as fd:
        binfmt.write_vec0(fd, prior)
    with open(os.path.join(out_dir, "trie.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, g.tid2pdf)
    with open(os.path.join(out_dir, "trie.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, g.fst.to_raw())
    with open(os.path.join(out_dir, "words.txt"), "w") as fd:
        fd.write("<eps> 0\n")
        for i in range(1, g.num_words + 1):
            fd.write(f"word{i} {i}\n")
        fd.write(f"<s> {g.num_words + 1}\n")
        fd.write(f"</s> {g.num_words + 2}\n")
    conf = os.path.join(out_dir, "trie.conf")
    with open(conf, "w") as fd:
        fd.write("fst = trie.fst\nnnet = trie.nnet\nprior = trie.prior\n")
        fd.write(f"left_context = {nnet.left_context}\n")
        fd.write(f"right_context = {nnet.right_context}\n")
        fd.write(f"chunk_size = 20\nnum_pdfs = {g.num_pdfs}\n")
        fd.write("tid2pdf = trie.tid2pdf\nsymbol_table = words.txt\n")
        # Device layout tuned for trie fanout (bench.py / frameprof sweep)
        fd.write("arc_group = 2\ncsr_group = 16\n")
        if with_lm:
            fd.write("large_lm = trie_g.fst\noriginal_lm = trie.unigram\n")
    if with_lm:
        big = make_big_lm(rng, num_words=num_words)
        with open(os.path.join(out_dir, "trie_g.fst"), "wb") as fd:
            binfmt.write_pkfst(fd, big.lm.to_raw())
        with open(os.path.join(out_dir, "trie.unigram"), "wb") as fd:
            binfmt.write_vec0(fd, big.small_lm)
    return conf
