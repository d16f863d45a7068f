"""Plain reference of Kaldi's Switchboard chain BLSTM (recipe
`egs/swbd/s5c/local/chain/run_blstm.sh` -> `tuning/run_blstm_6j.sh`; its
layers the `fast-lstmp-layer` of `steps/libs/nnet3/xconfig/lstm.py`,
Kaldi's `LstmNonlinearityComponent`; Povey et al., "Purely
sequence-trained neural networks for ASR based on lattice-free MMI",
Interspeech 2016) decoded in Kaldi's chunks
(`src/nnet3/nnet-am-decodable-simple.cc`), in plain `torch`.

It imports neither JAX nor anything of the port (its fbank and MFCC are
`tdnnf_reference`'s), so it also runs on a machine with a card (TF32 is
switched off around every call unless precision "tf32" asks for it).  It
decodes one utterance at a time and one chunk at a time, each BLSTM layer
a Python loop over its steps (the two directions side by side), as
Kaldi's `DecodableNnetSimple` does:

- features: `fbank` and `mfcc` (40 log-mel energies, the DCT, the
  lifter) of the whole utterance, T frames, S = ceil(T / f) output rows
  (f = `subsample`; output row s is frame f s);
- chunks: `frames_per_chunk` rounded up to a multiple of f, F frames, so
  F / f output rows a chunk; the chunk of output frames a .. b reads the
  input frames a - L - el .. b + R + er, where L, R are lda's splice
  context and el, er the extra contexts (`extra_left_context_initial` in
  place of el in an utterance's first chunk and
  `extra_right_context_final` in place of er in its last, where those are
  >= 0); frames outside the utterance are its edge frames repeated;
- lda(t) = W [mfcc(t + o) for o in lda.splice; ivector] + b, computed at
  the frames t = a + f k (any whole k) whose splice lies in the chunk's
  input: the nnet computes a quantity only where its inputs exist, and
  the LSTMs below read nothing else;
- a BLSTM layer on input x(t) at those frames: the forward LSTMP (delay
  -d) and the backward one (delay +d), out(t) = [fwd(t); bwd(t)]; each
  LSTMP (cell C, recurrent projection R, recurrence scale s, gates in the
  order i, f, g, o; e = -d forward, +d backward):
    a(t) = W_all [x(t); s r(t + e)] + b
    i = sig(a_i + w_ic s c(t + e)), f = sig(a_f + w_fc s c(t + e))
    c(t) = f s c(t + e) + i tanh(a_g), o = sig(a_o + w_oc c(t))
    m(t) = o tanh(c(t)), [r(t); p(t)] = W_rp m(t) + b_rp, the output;
  c and r are 0 where t + e is not a computed frame (nnet3's
  `IfDefined`): the forward recurrence starts from zero state at the
  chunk's first computed frame, the backward one at its last;
- output(t) = W blstm3(t) + b at the chunk's output frames a, a + f, ...,
  b only, no log-softmax, no prior (label delay 0).

Departures from the recipe: the i-vector is an input, not extracted;
dropout, the xent branch and the recurrence's gradient clipping
(training only) are absent; the mel bins span 20 Hz to 8 kHz (the
recipe's hires MFCC uses 20 Hz to 7,600 Hz); lda's splice is the whole
stack's context (the recipe's too), and label delays other than 0 are not
taken.

The model is a dict of arrays, weights stored [in, out]:
  lda {splice, w [len(splice) F + I, K], b},
  layers [{kind "blstmp", delay d > 0, forward {scale, rec_dim,
           w_all [D + R, 4 C], b, peephole [3, C] (w_ic, w_fc, w_oc),
           w_rp [C, R + P], b_rp}, backward {the same}}],
  output {delay 0, w, b}, num_ceps, lifter, subsample.
The chunk settings are a dict under Kaldi's names: frames_per_chunk,
extra_left_context, extra_right_context, extra_left_context_initial,
extra_right_context_final.
`precision`: "float64", "float32", "tf32" (float32 with TF32 matmuls on
a card) or "bfloat16" (float32 with every matmul's operands rounded to
bfloat16): the last two are the nearest precisions below float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tdnnf_reference import fbank, mfcc, num_frames  # noqa: F401


class _Net:
    """The model's tensors in one dtype on one device, and its matmul."""

    def __init__(self, model: Dict, precision: str, device):
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        self.bf16 = precision == "bfloat16"

        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v) for v in x]
            if isinstance(x, (np.ndarray, torch.Tensor)):
                return torch.as_tensor(x).to(device, self.dtype)
            return x

        self.m = conv(model)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).to(
                self.dtype)
        return x @ w

    def bmm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """[B, K] rows times [B, K, N] matrices -> [B, N]."""
        if self.bf16:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        return torch.bmm(x[:, None], w)[:, 0].to(self.dtype)


def chunks(frames: int, subsample: int, chunk: Dict
           ) -> List[Tuple[int, int, int, int]]:
    """Kaldi's chunks of an utterance of `frames` frames: (first output
    frame, last output frame, extra left context, extra right context),
    in frames."""
    f = subsample
    rows = -(-frames // f)
    per = -(-int(chunk["frames_per_chunk"]) // f)  # output rows a chunk
    out = []
    for s0 in range(0, rows, per):
        s1 = min(rows, s0 + per) - 1
        left = int(chunk["extra_left_context"])
        if s0 == 0 and int(chunk["extra_left_context_initial"]) >= 0:
            left = int(chunk["extra_left_context_initial"])
        right = int(chunk["extra_right_context"])
        if s1 == rows - 1 and int(chunk["extra_right_context_final"]) >= 0:
            right = int(chunk["extra_right_context_final"])
        out.append((f * s0, f * s1, left, right))
    return out


def _blstm(net: _Net, layer: Dict, x: torch.Tensor, k: int) -> torch.Tensor:
    """One BLSTM layer over x [n, D] (consecutive computed frames), its
    LSTMPs reading k rows back (forward) and k rows ahead (backward), each
    from zero state.  Step j computes row j of the forward LSTMP and row
    n - 1 - j of the backward one, the two directions side by side as a
    batch of two with their own weights; [n, 2 (R + P)], [fwd; bwd]."""
    sides = [layer["forward"], layer["backward"]]
    d = x.shape[-1]
    rec = int(sides[0]["rec_dim"])
    c_dim = sides[0]["peephole"].shape[1]
    assert all(int(p["rec_dim"]) == rec and p["peephole"].shape[1] == c_dim
               and p["w_rp"].shape == sides[0]["w_rp"].shape for p in sides)
    w_r = torch.stack([p["w_all"][d:] for p in sides])      # [2, R, 4C]
    w_rp = torch.stack([p["w_rp"] for p in sides])          # [2, C, R + P]
    b_rp = torch.stack([p["b_rp"] for p in sides])          # [2, R + P]
    w_ic, w_fc, w_oc = torch.stack([p["peephole"] for p in sides]).unbind(1)
    s = x.new_tensor([[float(p["scale"])] for p in sides])  # [2, 1]
    # The gates' input half; the backward direction's rows in reverse.
    a_x = torch.stack([net.mm(x, sides[0]["w_all"][:d]) + sides[0]["b"],
                       net.mm(x.flip(0), sides[1]["w_all"][:d])
                       + sides[1]["b"]])                    # [2, n, 4C]
    n = x.shape[0]
    cs: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for j in range(n):
        if j >= k:
            c_prev, r_prev = cs[j - k], outs[j - k][:, :rec]
        else:
            c_prev, r_prev = x.new_zeros(2, c_dim), x.new_zeros(2, rec)
        sc = s * c_prev
        a = a_x[:, j] + net.bmm(s * r_prev, w_r)
        ai, af, ag, ao = a.split(c_dim, dim=-1)
        i = torch.sigmoid(ai + w_ic * sc)
        f = torch.sigmoid(af + w_fc * sc)
        c = f * sc + i * torch.tanh(ag)
        o = torch.sigmoid(ao + w_oc * c)
        cs.append(c)
        outs.append(net.bmm(o * torch.tanh(c), w_rp) + b_rp)
    out = torch.stack(outs, dim=1)                          # [2, n, R + P]
    return torch.cat([out[0], out[1].flip(0)], dim=-1)


def _chunk(net: _Net, model: Dict, feats: torch.Tensor, iv: torch.Tensor,
           first: int, last: int, el: int, er: int) -> torch.Tensor:
    """The outputs at frames first, first + f, ..., last of one chunk."""
    m = net.m
    f = int(model["subsample"])
    splice = [int(o) for o in model["lda"]["splice"]]
    lo_in = first - (-min(splice)) - el
    hi_in = last + max(splice) + er
    # The chunk's input frames lo_in .. hi_in, the utterance's edge frames
    # repeated outside it.
    window = feats[torch.as_tensor(np.clip(np.arange(lo_in, hi_in + 1), 0,
                                           feats.shape[0] - 1),
                                   device=feats.device)]
    # The frames on the chunk's grid whose splice the window holds.
    at = [t for t in range(first - f * ((first - lo_in) // f), hi_in + 1, f)
          if t + min(splice) >= lo_in and t + max(splice) <= hi_in]
    rows = np.asarray(at) - lo_in
    x = torch.cat([window[torch.as_tensor(rows + o, device=feats.device)]
                   for o in splice]
                  + [iv[None].expand(len(at), -1)], dim=-1)
    h = net.mm(x, m["lda"]["w"]) + m["lda"]["b"]
    for layer in m["layers"]:
        assert int(layer["delay"]) % f == 0, "delay off the frame grid"
        h = _blstm(net, layer, h, int(layer["delay"]) // f)
    keep = [at.index(t) for t in range(first, last + 1, f)]
    return net.mm(h[keep], m["output"]["w"]) + m["output"]["b"]


def forward(model: Dict, logmels: Sequence[torch.Tensor], ivectors,
            chunk: Dict, precision: str = "float64") -> List[torch.Tensor]:
    """[T_u, 40] log-mel energies of each utterance and their i-vectors
    -> each utterance's [ceil(T_u / subsample), P] outputs."""
    assert int(model["output"]["delay"]) == 0, "label delay 0 only"
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        with torch.no_grad():
            net = _Net(model, precision, logmels[0].device)
            outs = []
            for u, logmel in enumerate(logmels):
                feats = mfcc(logmel.to(net.dtype), int(model["num_ceps"]),
                             float(model["lifter"]))
                iv = torch.as_tensor(np.asarray(ivectors[u])).to(
                    logmel.device, net.dtype)
                outs.append(torch.cat([
                    _chunk(net, model, feats, iv, *c) for c in chunks(
                        feats.shape[0], int(model["subsample"]), chunk)]))
            return outs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def context(model: Dict) -> Tuple[int, int]:
    """(left, right) frames of context the stack reads around an output
    frame: lda's splice (the recurrences read none)."""
    splice = model["lda"]["splice"]
    return -min(splice), max(splice)


def logp(model: Dict, waves: Sequence, ivectors, device, chunk: Dict,
         precision: str = "float64") -> List[torch.Tensor]:
    """Each wave's [ceil(T / subsample), P] outputs on `device`: fbank,
    MFCC and the network in one precision (float64 for "float64", else
    float32), one utterance and one chunk at a time."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    feats = [fbank(torch.as_tensor(np.asarray(w), device=device), dtype)
             for w in waves]
    return forward(model, feats, ivectors, chunk, precision)
