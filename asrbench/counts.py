"""The work a cell's inputs need: FLOPs of the AM, bytes of the decoder's
kernels.  The yardstick for `*_roofline` and `step_mfu`.

Counts come from the benchmark's own graph and G' and from what the harness
observes at the decoder's layer boundary (the beam entering and leaving a
frame: its live tokens, their states and LM states), never from the
program's counters or layouts.  Each input byte is counted read once and
each output byte written once, whatever an implementation reads again:

- expansion: the live tokens (state, cost; LM state with an LM), the
  graph's arcs out of each distinct live state with the epsilon paths
  that follow them (12 B each: destination, label or pdf, weight), the
  log-likelihood of each distinct (row, pdf) the live tokens' emitting
  arcs read, and one candidate written per (token, arc, epsilon path)
  (destination, cost, source slot, word; LM state with an LM);
- selection: each candidate read (state, cost; LM state and weight with
  an LM), each kept token's source slot and word, and the kept beam
  written (state, cost, slot, word; LM state);
- LM walk: each word-carrying candidate's (LM state, word) read and
  result written, and for each distinct (LM state, word) its arc found
  through the backoff chain (16 B) and each backoff arc followed (12 B).

The AM's FLOPs are two per multiply-add of its linears on the frames that
carry output, plus the frontend's FFT (5 N log2 N) and mel bank.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

def am_flops_per_frame(layers: Sequence[dict], feat_dim: int = 40) -> float:
    """FLOPs per output frame: the TDNN's linears, the FFT and mel bank."""
    flops = 0.0
    for layer in layers:
        if layer["kind"] == "linear":
            i, o = tuple(layer["w"].shape)
            flops += 2.0 * i * o
    flops += 5 * 512 * math.log2(512) + 3 * 257 + 2 * 257 * feat_dim
    return flops


class GraphCounts:
    """Per-state counts of the work a token there makes in one frame:
    candidates (an emitting arc times the epsilon paths from its
    destination), emitting arcs, and word-carrying candidates; plus the
    emitting arcs' pdfs and each state's words, as device tensors."""

    def __init__(self, g, device):
        n = g.final.size
        src, dst = g.src.astype(np.int64), g.dst.astype(np.int64)
        olab, ilab = g.olabel.astype(np.int64), g.ilabel.astype(np.int64)
        eps = ilab == 0
        es, ed, ew = src[eps], dst[eps], olab[eps] != 0
        paths = np.ones(n)  # epsilon paths from each state, the empty one too
        worded = np.zeros(n)  # of those, the paths that carry a word
        for _ in range(64):
            p2 = 1.0 + np.bincount(es, weights=paths[ed], minlength=n)
            w2 = np.bincount(es, weights=np.where(ew, paths[ed], worded[ed]),
                             minlength=n)
            if np.array_equal(p2, paths) and np.array_equal(w2, worded):
                break
            paths, worded = p2, w2
        else:
            raise ValueError("the graph has an epsilon cycle")
        em = ~eps
        ms, md, mo = src[em], dst[em], olab[em]
        cand = np.bincount(ms, weights=paths[md], minlength=n)
        word = np.bincount(ms, weights=np.where(mo != 0, paths[md],
                                                worded[md]), minlength=n)
        order = np.argsort(ms, kind="stable")
        off = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(ms, minlength=n), out=off[1:])
        pdf = np.asarray(g.tid2pdf)[ilab[em][order]]
        # The words a token's candidates carry: an emitting arc's own, or
        # the first word on an epsilon path from its destination.
        eps_word = np.zeros(n, np.int64)
        eps_word[es[ew]] = olab[eps][ew]
        lane_word = np.where(mo != 0, mo, eps_word[md])
        wsrc = ms[lane_word > 0]
        kmul = int(olab.max()) + 1
        wpair = np.unique(wsrc * kmul + lane_word[lane_word > 0])
        wsrc_u = wpair // kmul
        woff = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(wsrc_u, minlength=n), out=woff[1:])
        self.device = device

        def t(x, dt=torch.int64):
            return torch.as_tensor(x, device=device).to(dt)

        self.cand = t(cand, torch.float64)
        self.word = t(word, torch.float64)
        self.emit_off = t(off)
        self.emit_pdf = t(pdf)
        self.word_off = t(woff)
        self.words = t(wpair % kmul)
        self.num_pdfs = int(np.asarray(g.tid2pdf).max()) + 1


class LmWalk:
    """The G' on the card for counting backoff levels: sorted arc keys."""

    def __init__(self, lm, device):
        kmul = int(lm.label.max()) + 1
        key = lm.src.astype(np.int64) * kmul + lm.label.astype(np.int64)
        order = np.argsort(key)
        self.kmul = kmul
        self.key = torch.as_tensor(key[order], device=device)
        self.dst = torch.as_tensor(lm.dst.astype(np.int64)[order],
                                   device=device)

    def levels(self, state: torch.Tensor, word: torch.Tensor
               ) -> torch.Tensor:
        """Backoff arcs followed before (state, word) finds its arc."""
        lv = torch.zeros_like(state)
        todo = torch.ones_like(state, dtype=torch.bool)
        for _ in range(8):
            k = state * self.kmul + word
            i = torch.searchsorted(self.key, k).clamp(max=self.key.numel() - 1)
            found = self.key[i] == k
            todo = todo & ~found
            if not bool(todo.any()):
                break
            b = torch.searchsorted(self.key, state * self.kmul).clamp(
                max=self.key.numel() - 1)
            has_bo = self.key[b] == state * self.kmul
            todo = todo & has_bo
            state = torch.where(todo, self.dst[b], state)
            lv = lv + todo.long()
        return lv


class FrameCensus:
    """Accumulates one cell's decoder bytes frame by frame, on the card:
    call `frame` with the beam entering a frame, the rows it is valid for
    and the beam leaving it."""

    def __init__(self, gc: GraphCounts, lm_walk=None):
        self.gc, self.lm = gc, lm_walk
        dev = gc.device
        self.bytes = {k: torch.zeros((), dtype=torch.float64, device=dev)
                      for k in ("frame_expand", "frame_select", "lm_walk")}

    def frame(self, states: torch.Tensor, lms: torch.Tensor,
              valid: torch.Tensor, kept_states: torch.Tensor,
              copies: int = 1) -> None:
        gc = self.gc
        with_lm = self.lm is not None
        live = (states >= 0) & valid[:, None]
        s = states.clamp(min=0).long()
        n_live = live.sum()
        cand = torch.where(live, gc.cand[s], 0.0)
        lanes = cand.sum()
        distinct = torch.unique(s[live])
        graph_bytes = 12.0 * gc.cand[distinct].sum()
        rows = torch.arange(s.shape[0], device=s.device)[:, None].expand_as(s)
        n_emit = torch.where(live, gc.emit_off[s + 1] - gc.emit_off[s], 0)
        rep = n_emit.flatten()
        first = torch.repeat_interleave(gc.emit_off[s].flatten(), rep)
        start = torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep)
        arc = first + torch.arange(first.numel(), device=s.device) - start
        row_pdf = (torch.repeat_interleave(rows.flatten(), rep)
                   * gc.num_pdfs + gc.emit_pdf[arc])
        logp_reads = torch.unique(row_pdf).numel()
        lm_b = 4.0 if with_lm else 0.0
        kept = ((kept_states >= 0) & valid[:, None]).sum()
        expand = ((8.0 + lm_b) * n_live + graph_bytes + 4.0 * logp_reads
                  + (16.0 + lm_b) * lanes)
        select = (8.0 + 2 * lm_b) * lanes + (8.0 + 16.0 + lm_b) * kept
        self.bytes["frame_expand"] += copies * expand
        self.bytes["frame_select"] += copies * select
        if with_lm:
            word_lanes = torch.where(live, gc.word[s], 0.0).sum()
            nw = torch.where(live, gc.word_off[s + 1] - gc.word_off[s], 0)
            rep = nw.flatten()
            w_first = torch.repeat_interleave(gc.word_off[s].flatten(), rep)
            w_start = torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep)
            w_idx = (w_first + torch.arange(w_first.numel(), device=s.device)
                     - w_start)
            lm_state = torch.repeat_interleave(lms.long().flatten(), rep)
            pair = torch.unique(lm_state * self.lm.kmul + gc.words[w_idx])
            levels = self.lm.levels(pair // self.lm.kmul,
                                    pair % self.lm.kmul)
            walk = 16.0 * word_lanes + 16.0 * pair.numel() \
                + 12.0 * levels.sum()
            self.bytes["lm_walk"] += copies * walk

    def totals(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.bytes.items()}
