"""Plain reference of Kaldi's chain TDNN-LSTM (recipe
`egs/swbd/s5c/local/chain/run_tdnn_lstm.sh`, its LSTM layer the
`fast-lstmp-layer` of `steps/libs/nnet3/xconfig/lstm.py`, Kaldi's
`LstmNonlinearityComponent`; Peddinti, Wang, Povey and Khudanpur, "Low
latency acoustic modeling using temporal convolution and LSTMs", IEEE
Signal Processing Letters, 2018) at inference, in plain `torch`.

It imports neither JAX nor anything of the port (its fbank and MFCC are
`tdnnf_reference`'s), so it also runs on a machine with a card (TF32 is
switched off around every call unless precision "tf32" asks for it).  It
follows the equations literally, on a batch of utterances, each with its
own length T_u, whose outputs are the frames 0, f, 2 f, ... < T_u
(f = `subsample`):

- features: `tdnnf_reference.fbank` and `.mfcc` (40 log-mel energies, the
  DCT, the lifter), the first and last frames replicated at the edges;
- lda(t) = W [mfcc(t + o) for o in lda.splice; ivector] + b;
- a TDNN layer: BN(ReLU(W [h(t + o) for o in offsets] + b));
- an LSTMP layer (cell C, recurrent projection R, delay d < 0, recurrence
  scale s; gates in the order i, f, g, o):
    a(t) = W_all [x(t); s r(t + d)] + b
    i = sig(a_i + w_ic s c(t + d)), f = sig(a_f + w_fc s c(t + d))
    c(t) = f s c(t + d) + i tanh(a_g), o = sig(a_o + w_oc c(t))
    m(t) = o tanh(c(t)), [r(t); p(t)] = W_rp m(t) + b_rp, the output;
- output(t) = W lstm(t - output.delay) + b, no log-softmax, no prior.

Every layer is computed at exactly the frames its successors read, found
from the outputs backwards: a layer read only at every f-th frame is
computed only there.  Each recurrence is stepped frame by frame of its
layer from zero state (c = r = 0) at the first frame its layer computes,
for the whole batch at once (up to the longest utterance's frames; an
utterance's own outputs read nothing past its own).  BN is a batchnorm at
test time as a per-dimension scale and offset.

Departures from Kaldi: decoding is looped, not chunked: each recurrence
runs from zero state at the utterance's first computed frame to its end,
as `nnet3-latgen-faster-looped` and `online2-wav-nnet3-latgen-faster` run
it with `extra-left-context-initial` 0, where the recipe's offline decode
(`frames-per-chunk` 140, `extra-left-context` 50) restarts the state every
chunk; the i-vector is an input, not extracted; dropout and the xent
branch (training only) are absent; the mel bins span 20 Hz to 8 kHz (the
recipe's hires MFCC uses 20 Hz to 7,600 Hz).

The model is a dict of arrays, weights stored [in, out]:
  lda {splice, w [len(splice) F + I, K], b},
  layers [{kind "tdnn", offsets, w, b, scale, offset} or
          {kind "lstmp", delay, scale, rec_dim, w_all [D + R, 4 C], b,
           peephole [3, C] (w_ic, w_fc, w_oc), w_rp [C, R + P], b_rp}],
  output {delay, w, b}, num_ceps, lifter, subsample.
`precision`: "float64", "float32", "tf32" (float32 with TF32 matmuls on
a card) or "bfloat16" (float32 with every matmul's operands rounded to
bfloat16): the last two are the nearest precisions below float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tdnnf_reference import fbank, mfcc, num_frames  # noqa: F401

Grid = Tuple[int, int, int]  # (first frame, step, count)


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


def _frames(g: Grid) -> np.ndarray:
    return g[0] + g[1] * np.arange(g[2])


def _input_grid(out: Grid, offsets: Sequence[int]) -> Grid:
    """The frames a layer with these offsets reads to compute `out`: on
    the output's step where the offsets differ by multiples of it, else
    every frame of the span."""
    first, last = out[0] + min(offsets), out[0] + out[1] * (out[2] - 1) \
        + max(offsets)
    step = out[1] if all((o - offsets[0]) % out[1] == 0 for o in offsets) \
        else 1
    return first, step, (last - first) // step + 1


def _read(h: torch.Tensor, grid: Grid, frames: np.ndarray) -> torch.Tensor:
    """Rows of h [U, n, D] (on `grid`) at the given frames."""
    idx = (frames - grid[0]) // grid[1]
    assert ((frames - grid[0]) % grid[1] == 0).all() and idx.min() >= 0 \
        and idx.max() < grid[2]
    return h[:, torch.as_tensor(idx, device=h.device)]


def grids(model: Dict, rows: int) -> List[Grid]:
    """The frames each layer is computed at, for `rows` output rows: [lda,
    layer 0, layer 1, ..., output]."""
    g = (0, int(model["subsample"]), rows)
    out = [g]
    g = _input_grid(g, [-int(model["output"]["delay"])])
    for layer in reversed(model["layers"]):
        out.append(g)
        if layer["kind"] == "tdnn":
            g = _input_grid(g, layer["offsets"])
    out.append(g)
    return out[::-1]


def forward(model: Dict, logmels: Sequence[torch.Tensor], ivectors,
            precision: str = "float64") -> List[torch.Tensor]:
    """[T_u, 40] log-mel energies of each utterance and their i-vectors
    -> each utterance's [ceil(T_u / subsample), P] outputs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        with torch.no_grad():
            return _forward(model, logmels, ivectors, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _forward(model, logmels, ivectors, precision):
    device = logmels[0].device
    net = _Net(model, precision, device)
    m = net.m
    f = int(model["subsample"])
    lengths = [x.shape[0] for x in logmels]
    rows = [-(-t // f) for t in lengths]
    plan = grids(model, max(rows))
    # lda reads the MFCC at its splice, the edges replicated per utterance.
    lda = plan[0]
    feat_grid = _input_grid(lda, model["lda"]["splice"])
    need = _frames(feat_grid)
    feats = torch.stack([
        mfcc(x.to(net.dtype), int(model["num_ceps"]), float(model["lifter"]))[
            torch.as_tensor(np.clip(need, 0, t - 1), device=device)]
        for x, t in zip(logmels, lengths)])
    iv = torch.as_tensor(np.asarray(ivectors)).to(device, net.dtype)
    at = _frames(lda)
    x = torch.cat([_read(feats, feat_grid, at + o)
                   for o in model["lda"]["splice"]]
                  + [iv[:, None].expand(-1, at.size, -1)], dim=-1)
    h = net.mm(x, m["lda"]["w"]) + m["lda"]["b"]
    grid = lda
    for layer, out_grid in zip(m["layers"], plan[1:-1]):
        at = _frames(out_grid)
        if layer["kind"] == "tdnn":
            x = torch.cat([_read(h, grid, at + o) for o in layer["offsets"]],
                          dim=-1)
            h = torch.clamp(net.mm(x, layer["w"]) + layer["b"], min=0) \
                * layer["scale"] + layer["offset"]
        else:
            h = _lstmp(net, layer, _read(h, grid, at), out_grid)
        grid = out_grid
    out = m["output"]
    at = _frames(plan[-1]) - int(model["output"]["delay"])
    y = net.mm(_read(h, grid, at), out["w"]) + out["b"]
    return [y[u, :n] for u, n in enumerate(rows)]


def _lstmp(net: _Net, layer: Dict, x: torch.Tensor, grid: Grid
           ) -> torch.Tensor:
    """The LSTMP layer over x [U, n, D] at the frames of `grid`, stepped
    frame by frame from zero state."""
    back = -int(layer["delay"])
    assert back % grid[1] == 0, "the recurrence reads frames not computed"
    back //= grid[1]
    s = float(layer["scale"])
    d = x.shape[-1]
    w_x, w_r = layer["w_all"][:d], layer["w_all"][d:]
    c_dim = layer["peephole"].shape[1]
    rec = int(layer["rec_dim"])
    w_ic, w_fc, w_oc = layer["peephole"]
    a_x = net.mm(x, w_x) + layer["b"]
    zero_c = x.new_zeros((x.shape[0], c_dim))
    zero_r = x.new_zeros((x.shape[0], rec))
    cs: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for j in range(x.shape[1]):
        c_prev = cs[j - back] if j >= back else zero_c
        r_prev = outs[j - back][:, :rec] if j >= back else zero_r
        a = a_x[:, j] + net.mm(s * r_prev, w_r)
        ai, af, ag, ao = a.split(c_dim, dim=-1)
        i = torch.sigmoid(ai + w_ic * (s * c_prev))
        f = torch.sigmoid(af + w_fc * (s * c_prev))
        c = f * (s * c_prev) + i * torch.tanh(ag)
        o = torch.sigmoid(ao + w_oc * c)
        cs.append(c)
        outs.append(net.mm(o * torch.tanh(c), layer["w_rp"]) + layer["b_rp"])
    return torch.stack(outs, dim=1)


def context(model: Dict) -> Tuple[int, int]:
    """(left, right) frames of context the stack reads around an
    utterance's frames: lda's splice, each TDNN layer's offsets and the
    output delay (which moves d frames of right context to the left)."""
    offsets = [model["lda"]["splice"]] + [
        x["offsets"] for x in model["layers"] if x["kind"] == "tdnn"]
    delay = int(model["output"]["delay"])
    return (sum(-min(o) for o in offsets) + delay,
            sum(max(o) for o in offsets) - delay)


def logp(model: Dict, waves: Sequence, ivectors, device,
         precision: str = "float64") -> List[torch.Tensor]:
    """Each wave's [ceil(T / subsample), P] outputs on `device`: fbank,
    MFCC and the network in one precision (float64 for "float64", else
    float32), the utterances in one batch."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    feats = [fbank(torch.as_tensor(np.asarray(w), device=device), dtype)
             for w in waves]
    return forward(model, feats, ivectors, precision)
