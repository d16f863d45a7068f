"""The plain reference: what the program's outputs are judged against.

Plain numpy and PyTorch from the benchmark's own inputs (the generated
graph, G', TDNN weights, waves and planted frames); nothing here imports
the program.  Every quantity the program derives (its prepared graph,
tables, hashes, renumberings) is worked out again from the inputs:

- `fbank`: Kaldi-style log-mel features (snip-edges 25 ms / 10 ms frames,
  DC removal, pre-emphasis 0.97, Hamming window, 512-point power spectrum
  by FFT, 40 triangular mel bins over FFT bins [0, 256), floor, log).
- `tdnn`: the layer list with the edges replicated over its context,
  minus the log prior.
- `lm_cost`: the delta-LM cost of a word sequence: G' arcs found through
  the backoff chain, minus the unigram vector, with <s> and </s>.
- `align`: exact Viterbi costs over the graph, no pruning: the best path
  that emits a given word sequence (a product of the graph with the
  sequence, cut to the states that are both reachable and co-reachable),
  or the best path of all.  Many jobs run as one disjoint graph.

`precision` selects the arithmetic: "float64" is the reference;
"tf32" (the AM's matmuls on tensor cores in TF32) and "bfloat16" (every
cost rounded to bfloat16) are the controls, the nearest precisions below
the float32 the configurations state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FLT_EPSILON = 1.1920929e-07


# -- frontend and AM ----------------------------------------------------------

def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_bank(num_bins: int = 40, rate: int = 16000, n_fft: int = 512,
             low: float = 20.0) -> np.ndarray:
    """[n_fft // 2 + 1, num_bins] triangular weights (the Nyquist bin 0)."""
    half = n_fft // 2
    bin_mel = _mel(np.arange(half) * (rate / n_fft))
    lo, hi = _mel(low), _mel(rate / 2)
    step = (hi - lo) / (num_bins + 1)
    bank = np.zeros((half + 1, num_bins))
    for b in range(num_bins):
        left, centre, right = lo + b * step, lo + (b + 1) * step, lo + (b + 2) * step
        rise = (bin_mel - left) / (centre - left)
        fall = (right - bin_mel) / (right - centre)
        inside = (bin_mel > left) & (bin_mel < right)
        bank[:half, b] = np.where(inside, np.where(bin_mel <= centre, rise,
                                                   fall), 0.0)
    return bank


def num_frames(samples: int) -> int:
    return 0 if samples < 400 else 1 + (samples - 400) // 160


def fbank(wave: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """[S] samples -> [T, 40] log-mel features, computed in `dtype`."""
    t = num_frames(wave.shape[0])
    x = wave.to(dtype).unfold(0, 400, 160)[:t]
    x = x - x.mean(dim=1, keepdim=True)
    x = torch.cat([x[:, :1] * (1 - 0.97), x[:, 1:] - 0.97 * x[:, :-1]], 1)
    n = torch.arange(400, dtype=torch.float64, device=wave.device)
    x = x * (0.54 - 0.46 * torch.cos(2 * math.pi * n / 399)).to(dtype)
    power = torch.fft.rfft(x, n=512).abs() ** 2
    bank = torch.as_tensor(mel_bank(), dtype=dtype, device=wave.device)
    return torch.log(torch.clamp(power @ bank, min=FLT_EPSILON))


def tdnn(layers: Sequence[dict], feats: torch.Tensor, left: int, right: int,
         num_pdfs: int, dtype=torch.float64) -> torch.Tensor:
    """[T, 40] features -> [T, P] log-likelihoods (log-softmax minus the
    uniform log prior), the first and last frames replicated over the
    context, in `dtype`."""
    x = torch.cat([feats[:1].expand(left, -1), feats,
                   feats[-1:].expand(right, -1)]).to(dtype)
    for layer in layers:
        kind = layer["kind"]
        if kind == "splice":
            t = x.shape[0]
            rows = [x[torch.clamp(torch.arange(t, device=x.device) + o, 0,
                                  t - 1)] for o in layer["indices"]]
            x = torch.cat(rows, dim=1)
        elif kind == "narrow":
            if x.shape[0] > layer["left"] + layer["right"]:
                x = x[layer["left"]:x.shape[0] - layer["right"]]
        elif kind == "linear":
            x = x @ torch.as_tensor(layer["w"], device=x.device).to(dtype) \
                + torch.as_tensor(layer["b"], device=x.device).to(dtype)
        elif kind == "relu":
            x = torch.clamp(x, min=0)
        elif kind == "batchnorm":
            x = x * torch.as_tensor(layer["scale"], device=x.device).to(dtype) \
                + torch.as_tensor(layer["offset"], device=x.device).to(dtype)
        elif kind == "logsoftmax":
            x = torch.log_softmax(x, dim=-1)
        else:
            raise ValueError(f"unknown layer {kind}")
    return x + math.log(num_pdfs)


def am_logp(layers, waves: Sequence[np.ndarray], left: int, right: int,
            num_pdfs: int, device, precision: str = "float64"
            ) -> List[torch.Tensor]:
    """Each wave's [T, P] log-likelihoods on `device`: float64, or float32
    with the matmuls in TF32 (precision "tf32", the AM's control)."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        out = []
        with torch.no_grad():
            for w in waves:
                feats = fbank(torch.as_tensor(w, device=device), dtype)
                out.append(tdnn(layers, feats, left, right, num_pdfs, dtype))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# -- the delta LM -------------------------------------------------------------

class DeltaLm:
    """Big-LM G' cost minus the unigram vector, following backoff arcs
    (a state's epsilon arc) where a word has no arc of its own."""

    def __init__(self, lm):
        order = np.lexsort((lm.label, lm.src))
        self.src, self.label = lm.src[order], lm.label[order]
        self.dst = lm.dst[order]
        self.weight = lm.weight[order].astype(np.float64)
        self.key = self.src * (int(lm.label.max()) + 1) + self.label
        self.kmul = int(lm.label.max()) + 1
        self.final = lm.final.astype(np.float64)
        self.small = lm.small_lm.astype(np.float64)
        self.bos, self.eos, self.start = lm.bos_id, lm.eos_id, lm.start

    def _arc(self, state: int, label: int) -> Optional[int]:
        k = state * self.kmul + label
        i = int(np.searchsorted(self.key, k))
        return i if i < self.key.size and self.key[i] == k else None

    def walk(self, state: int, label: int) -> Optional[Tuple[int, float]]:
        cost = 0.0
        while True:
            i = self._arc(state, label)
            if i is not None:
                return int(self.dst[i]), cost + float(self.weight[i])
            bo = self._arc(state, 0)
            if bo is None:
                return None
            cost += float(self.weight[bo])
            state = int(self.dst[bo])

    def _final(self, state: int) -> float:
        cost = 0.0
        while not math.isfinite(self.final[state]):
            bo = self._arc(state, 0)
            if bo is None:
                return math.inf
            cost += float(self.weight[bo])
            state = int(self.dst[bo])
        return cost + float(self.final[state])

    def cost(self, words: Sequence[int], final: bool) -> float:
        """The sequence's delta cost; with `final`, </s> and the final
        weight too."""
        hit = self.walk(self.start, self.bos)
        state = self.start if hit is None else hit[0]
        total = 0.0
        for w in words:
            hit = self.walk(state, int(w))
            if hit is not None:
                state, c = hit
                total += c - float(self.small[w])
        if not final:
            return total
        hit = self.walk(state, self.eos)
        if hit is None:
            return math.inf
        return total + hit[1] + self._final(hit[0]) - float(self.small[self.eos])


# -- exact alignment ----------------------------------------------------------

def _csr(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable")
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=off[1:])
    return order, off


def _gather(states: np.ndarray, order: np.ndarray, off: np.ndarray
            ) -> np.ndarray:
    """Arc ids of every state in `states` by a CSR (order, off)."""
    lo, hi = off[states], off[states + 1]
    n = hi - lo
    if n.sum() == 0:
        return np.zeros(0, np.int64)
    base = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
    return order[base + np.arange(int(n.sum()))]


class Graph:
    """A graph's arcs indexed for the aligner."""

    def __init__(self, g):
        self.n = g.final.size
        self.start = int(g.start)
        self.src, self.dst = g.src.astype(np.int64), g.dst.astype(np.int64)
        self.olabel = g.olabel.astype(np.int64)
        self.ilabel = g.ilabel.astype(np.int64)
        self.weight = g.weight.astype(np.float64)
        self.final = g.final.astype(np.float64)
        self.pdf = np.where(self.ilabel > 0,
                            np.asarray(g.tid2pdf)[self.ilabel], -1)
        self.out = _csr(self.src, self.n)
        plain = self.olabel == 0
        self.back = _csr(np.where(plain, self.dst, self.n), self.n + 1)
        self.by_word = _csr(self.olabel, int(self.olabel.max()) + 1)
        self.depth = self._eps_depth()
        self.min_emit_weight = float(self.weight[self.pdf >= 0].min())
        self._co: Dict[object, np.ndarray] = {}

    def check_floor(self, lm=None) -> None:
        """Raise unless every path cost term but the emitting arcs and the
        acoustic one is >= 0 (what `judge.floor_excess` rests on): epsilon
        and final weights, and with a delta LM every G' weight and each
        word's unigram equal to its word arc's weight."""
        eps = self.pdf < 0
        ok = (self.weight[eps].min(initial=0) >= 0
              and np.nanmin(np.where(np.isfinite(self.final), self.final,
                                     0)) >= 0)
        if lm is not None:
            words = self.olabel > 0
            ok = ok and lm.weight.min() >= 0 and np.allclose(
                lm.small[self.olabel[words]], self.weight[words])
        if not ok:
            raise ValueError("a path cost term below 0: no cost floor")

    def _eps_depth(self) -> int:
        """Longest epsilon path (rounds of closure an exact frame needs)."""
        eps = self.ilabel == 0
        s, d = self.src[eps], self.dst[eps]
        level = np.zeros(self.n, np.int64)
        for depth in range(64):
            new = level.copy()
            np.maximum.at(new, d, level[s] + 1)
            if np.array_equal(new, level):
                return depth
            level = new
        raise ValueError("the graph has an epsilon cycle")

    def _bfs(self, seeds: np.ndarray, forward: bool,
             allowed: Optional[np.ndarray]) -> np.ndarray:
        """States reached from `seeds` over arcs with no output label
        (forward, or backward), within the `allowed` mask when given."""
        seen = np.zeros(self.n, bool)
        front = np.unique(seeds)
        if allowed is not None:
            front = front[allowed[front]]
        seen[front] = True
        while front.size:
            if forward:
                arcs = _gather(front, *self.out)
                arcs = arcs[self.olabel[arcs] == 0]
                nxt = self.dst[arcs]
            else:
                arcs = _gather(front, *self.back)
                nxt = self.src[arcs]
            nxt = np.unique(nxt)
            nxt = nxt[~seen[nxt]]
            if allowed is not None:
                nxt = nxt[allowed[nxt]]
            seen[nxt] = True
            front = nxt
        return seen

    def coreach(self, key) -> np.ndarray:
        """Mask of states that reach, without a word, the source of an arc
        labelled `key` (a word id) or a final state (key "final")."""
        if key not in self._co:
            if key == "final":
                seeds = np.flatnonzero(np.isfinite(self.final))
            else:
                seeds = self.src[_gather(np.array([key]), *self.by_word)]
            self._co[key] = self._bfs(seeds, False, None)
        return self._co[key]


@dataclass
class Job:
    """One alignment: utterance row `utt` (its frames in the logp table),
    and either a word sequence (None: the best path of all) ending in a
    final state or anywhere."""

    utt: int
    words: Optional[Sequence[int]]
    final: bool


def _product(g: Graph, job: Job):
    """(states, position, arcs, next position) of the job's product graph,
    or None where no path emits the words; states are graph states per
    position, arcs index the graph's arcs."""
    if job.words is None:
        return ([np.arange(g.n)], [np.arange(g.src.size)], [])
    words = [int(w) for w in job.words]
    n = len(words)
    entry = np.array([g.start])
    pos_states, local, cross = [], [], []
    for k in range(n + 1):
        if k < n:
            allowed = g.coreach(words[k])
        else:
            allowed = g.coreach("final") if job.final else None
        reach = g._bfs(entry, True, allowed)
        states = np.flatnonzero(reach)
        if states.size == 0:
            return None
        arcs = _gather(states, *g.out)
        keep = (g.olabel[arcs] == 0) & reach[g.dst[arcs]]
        local.append(arcs[keep])
        pos_states.append(states)
        if k < n:
            word_arcs = arcs[g.olabel[arcs] == words[k]]
            cross.append(word_arcs)
            entry = np.unique(g.dst[word_arcs])
            if entry.size == 0:
                return None
    return pos_states, local, cross


def align(g: Graph, jobs: Sequence[Job], logp: Sequence[torch.Tensor],
          am_scale: float, device, precision: str = "float64"
          ) -> np.ndarray:
    """Exact Viterbi cost of each job ([J] float64, inf where no path
    emits its words): graph weights plus am_scale * -logp over the
    utterance's frames (logp[job.utt], [T_u, P]), plus the final weight
    where the job ends final.  precision "bfloat16" rounds every cost to
    bfloat16 (the decoder's control)."""
    states_of, pos_of, starts = [], [], []
    arc_src, arc_dst, arc_id, arc_job = [], [], [], []
    end_w, state_job = [], []
    base = 0
    cost = np.full(len(jobs), np.inf)
    live_jobs = []
    for j, job in enumerate(jobs):
        prod = _product(g, job)
        if prod is None:
            continue
        live_jobs.append(j)
        pos_states, local, cross = prod
        offs = np.cumsum([0] + [s.size for s in pos_states])
        lookup = []
        for k, states in enumerate(pos_states):
            lookup.append(states)
            state_job.append(np.full(states.size, j))
            if k == len(pos_states) - 1:
                end_w.append(g.final[states] if job.final
                             else np.zeros(states.size))
            else:
                end_w.append(np.full(states.size, np.inf))

        def pid(k, s):
            return base + offs[k] + np.searchsorted(lookup[k], s)

        starts.append(pid(0, np.array([g.start]))[0])
        for k, arcs in enumerate(local):
            arc_src.append(pid(k, g.src[arcs]))
            arc_dst.append(pid(k, g.dst[arcs]))
            arc_id.append(arcs)
            arc_job.append(np.full(arcs.size, j))
        for k, arcs in enumerate(cross):
            arc_src.append(pid(k, g.src[arcs]))
            arc_dst.append(pid(k + 1, g.dst[arcs]))
            arc_id.append(arcs)
            arc_job.append(np.full(arcs.size, j))
        base += int(offs[-1])
    if not live_jobs:
        return cost

    rows = [lp.shape[0] for lp in logp]
    row_off = np.concatenate([[0], np.cumsum(rows)])
    p = logp[0].shape[1]
    ftype = torch.float64 if precision == "float64" else torch.float32

    def q(x):
        if precision == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    table = q(torch.cat([lp.to(ftype) for lp in logp]).reshape(-1))
    src = np.concatenate(arc_src)
    dst = np.concatenate(arc_dst)
    aid = np.concatenate(arc_id)
    ajob = np.concatenate(arc_job)
    utt = np.array([job.utt for job in jobs])
    t_job = np.array([rows[job.utt] for job in jobs])
    emit = g.pdf[aid] >= 0

    def dev(x, dtype=torch.int64):
        return torch.as_tensor(x, device=device).to(dtype)

    n_states = base
    es, ed = dev(src[emit]), dev(dst[emit])
    ew = q(dev(g.weight[aid[emit]], ftype))
    e_row = dev(row_off[utt[ajob[emit]]])
    e_pdf = dev(g.pdf[aid[emit]])
    e_last = dev(t_job[ajob[emit]] - 1)
    zs, zd = dev(src[~emit]), dev(dst[~emit])
    zw = q(dev(g.weight[aid[~emit]], ftype))
    s_t = dev(t_job[np.concatenate(state_job)])
    endw = dev(np.concatenate(end_w), ftype)
    sjob = dev(np.concatenate(state_job))
    scale = float(am_scale)

    def closure(tok):
        for _ in range(g.depth):
            c = q(tok[zs] + zw)
            tok = tok.scatter_reduce(0, zd, c, "amin", include_self=True)
        return tok

    with torch.no_grad():
        tok = torch.full((n_states,), math.inf, dtype=ftype, device=device)
        tok[dev(starts)] = 0.0
        tok = closure(tok)
        for t in range(int(t_job.max())):
            idx = (e_row + torch.minimum(e_last, torch.tensor(
                t, device=device))) * p + e_pdf
            c = q(q(tok[es] + ew) - q(scale * table[idx]))
            new = torch.full_like(tok, math.inf).scatter_reduce(
                0, ed, c, "amin", include_self=True)
            new = closure(new)
            tok = torch.where(t < s_t, new, tok)
        total = q(tok + endw)
        best = torch.full((len(jobs),), math.inf, dtype=ftype, device=device)
        best = best.scatter_reduce(0, sjob, total, "amin", include_self=True)
    out = best.double().cpu().numpy()
    out[[j for j in range(len(jobs)) if j not in set(live_jobs)]] = np.inf
    return out


# -- beam search --------------------------------------------------------------

HASH_MUL = 1_000_003
HASH_MASK = (1 << 61) - 1


def word_hash(words: Sequence[int]) -> int:
    """The rolling hash `beam_search` carries for a word sequence (int64
    arithmetic, wrapping)."""
    h = 0
    for w in words:
        h = ((h * HASH_MUL + int(w)) & ((1 << 64) - 1)) & HASH_MASK
    return h


def beam_search(g: Graph, logp: Sequence[torch.Tensor], frames: Sequence[int],
                am_scale: float, beam_size: int, beam: float, device,
                precision: str = "float32") -> Tuple[np.ndarray, ...]:
    """The decoder's pruned search, plainly: per frame every live token
    takes each emitting arc (cost + weight - am_scale * logp) and then the
    epsilon arcs that follow; candidates keep the least cost per state;
    each row keeps its `beam_size` cheapest (ties by state) within `beam`
    of its best.  Costs are float32 sums (bfloat16 for the control).
    Returns, per row after its frames, the best token's cost (no final
    weight) and `word_hash`, and the best of cost + final weight (inf
    where no token is final) and its hash."""
    rows = len(logp)
    p = logp[0].shape[1]
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32

    def t(x, dtype=torch.int64):
        return torch.as_tensor(x, device=device).to(dtype)

    order, off = g.out
    emit = g.pdf[order] >= 0
    e_order, z_order = order[emit], order[~emit]
    e_off = t(np.concatenate([[0], np.cumsum(np.bincount(
        g.src[e_order], minlength=g.n))]))
    z_off = t(np.concatenate([[0], np.cumsum(np.bincount(
        g.src[z_order], minlength=g.n))]))
    e_arc, z_arc = t(e_order), t(z_order)
    dst, olab = t(g.dst), t(g.olabel)
    w = t(g.weight, torch.float32)
    pdf = t(np.maximum(g.pdf, 0))
    table = torch.stack([torch.nn.functional.pad(
        x.to(device, torch.float32), (0, 0, 0, max(frames) - x.shape[0]))
        for x in logp])  # [R, T, P]
    last = t(frames)
    scale = float(np.float32(am_scale))

    def expand(row, state, cost, h, arc_off, arcs):
        n = arc_off[state + 1] - arc_off[state]
        first = torch.repeat_interleave(arc_off[state], n)
        start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        a = arcs[first + torch.arange(first.numel(), device=device) - start]
        r = torch.repeat_interleave(row, n)
        c = torch.repeat_interleave(cost, n).to(torch.float64) \
            + w[a].to(torch.float64)
        hh = torch.repeat_interleave(h, n)
        hh = torch.where(olab[a] > 0, (hh * HASH_MUL + olab[a]) & HASH_MASK,
                         hh)
        return r, dst[a], c, hh, a

    def closure(row, state, cost, h):
        parts = [(row, state, cost, h)]
        for _ in range(g.depth):
            r, s, c, hh, _ = expand(row, state, cost, h, z_off, z_arc)
            c = c.to(dt).to(torch.float32)
            parts.append((r, s, c, hh))
            row, state, cost, h = r, s, c, hh
        return [torch.cat(x) for x in zip(*parts)]

    def prune(row, state, cost, h):
        key = row * g.n + state
        o = torch.argsort(cost, stable=True)
        o = o[torch.argsort(key[o], stable=True)]
        k = key[o]
        first = torch.ones_like(k, dtype=torch.bool)
        first[1:] = k[1:] != k[:-1]
        o = o[first]
        row, state, cost, h = row[o], state[o], cost[o], h[o]
        o = torch.argsort(state, stable=True)
        o = o[torch.argsort(cost[o], stable=True)]
        o = o[torch.argsort(row[o], stable=True)]
        row, state, cost, h = row[o], state[o], cost[o], h[o]
        starts = torch.searchsorted(row, torch.arange(rows, device=device))
        rank = torch.arange(row.numel(), device=device) - starts[row]
        best = torch.full((rows,), math.inf, device=device).scatter_reduce(
            0, row, cost, "amin")
        keep = (rank < beam_size) & (cost <= best[row] + beam)
        return row[keep], state[keep], cost[keep], h[keep]

    with torch.no_grad():
        row = torch.arange(rows, device=device)
        tok = closure(row, torch.full_like(row, g.start),
                      torch.zeros(rows, device=device),
                      torch.zeros_like(row))
        tok = prune(*tok)
        for f in range(max(frames)):
            row, state, cost, h = tok
            on = last[row] > f
            r, s, c, hh, a = expand(row[on], state[on], cost[on], h[on],
                                    e_off, e_arc)
            lp = table[r, f, pdf[a]].to(torch.float64)
            c = (c.to(torch.float32).to(torch.float64) - scale * lp)
            c = c.to(dt).to(torch.float32)
            new = closure(r, s, c, hh)
            new = prune(*new)
            tok = [torch.cat([x[~on], y]) for x, y in zip(tok, new)]
        row, state, cost, h = tok
        out = []
        fin = t(g.final, torch.float64)[state]
        for total in (cost.double(), cost.double() + fin):
            best = torch.full((rows,), math.inf, dtype=torch.float64,
                              device=device).scatter_reduce(0, row, total,
                                                            "amin")
            idx = torch.arange(row.numel(), device=device)
            pick = torch.full((rows,), -1, dtype=torch.int64,
                              device=device).scatter_reduce(
                0, row, torch.where(total == best[row], idx, -1), "amax")
            out += [best.cpu().numpy(), h[pick.clamp(min=0)].cpu().numpy()]
    return tuple(out)
