"""Plain reference of Kaldi's LibriSpeech chain TDNN-F (recipe
`egs/librispeech/s5/local/chain/tuning/run_tdnn_1d.sh`; the factored layer
of Povey et al., "Semi-Orthogonal Low-Rank Matrix Factorization for Deep
Neural Networks", Interspeech 2018) at inference, in plain `torch`.

It imports neither JAX nor anything of the port, so it also runs on a
machine with a card (TF32 is switched off around every call unless
precision "tf32" asks for it).  It follows the equations literally, at
every 10 ms input frame t of an utterance of T frames:

- features: Kaldi-style log-mel energies (`fbank`: 25 ms / 10 ms frames,
  DC removal, pre-emphasis 0.97, Hamming window, 512-point power spectrum,
  40 triangular mel bins, floor, log), then MFCC (`mfcc`): DCT-II of the
  40 log energies (row 0 scaled by sqrt(1/40), the others by sqrt(2/40)),
  the first `num_ceps` kept, coefficient i times 1 + Q/2 sin(pi i / Q);
- the first and last frames replicated over the context (40 each side);
- lda(t) = W [mfcc(t-1); mfcc(t); mfcc(t+1); ivector] + b;
- tdnn1 = BN(ReLU(affine(lda)));
- tdnnf k, stride s, input h: l(t) = W_l [h(t-s); h(t)] (no bias),
  a(t) = W_a [l(t); l(t+s)] + b, out(t) = BN(ReLU(a(t))) + bypass h(t);
  stride 0 takes the single row t on each side;
- prefinal-l = linear (no bias); prefinal-chain = BN(linear (no bias) of
  BN(ReLU(affine))); output = affine, no log-softmax, no prior;
- every layer computed at every frame its successors read, then every
  `subsample`-th output row taken: rows t = 0, f, 2f, ... < T.

BN is a batchnorm at test time as a per-dimension scale and offset.
Departures from Kaldi: the mel bins span 20 Hz to 8 kHz (the recipe's
hires MFCC uses 20 Hz to 7,600 Hz); the i-vector is an input, not
extracted; dropout and the xent branch (training only) are absent.

The model is a dict of arrays, weights stored [in, out]:
  lda {w [3 F + I, 3 F + I], b}, tdnn1 {w, b, scale, offset},
  tdnnf [{stride, w_l [k D, B], w_a [k B, D], b, scale, offset}, ...],
  bypass, prefinal_l {w [D, S]},
  prefinal_chain {w1 [S, D], b1, scale1, offset1, w2 [D, S], scale2,
  offset2}, output {w [S, P], b}, num_ceps, lifter, subsample.
`precision`: "float64", "float32", "tf32" (float32 with TF32 matmuls on
a card) or "bfloat16" (float32 with every matmul's operands rounded to
bfloat16): the last two are the nearest precisions below float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

FLT_EPSILON = 1.1920929e-07


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
        left, centre, right = (lo + b * step, lo + (b + 1) * step,
                               lo + (b + 2) * step)
        rise = (bin_mel - left) / (centre - left)
        fall = (right - bin_mel) / (right - centre)
        inside = (bin_mel > left) & (bin_mel < right)
        bank[:half, b] = np.where(inside, np.where(bin_mel <= centre, rise,
                                                   fall), 0.0)
    return bank


def num_frames(samples: int) -> int:
    return 0 if samples < 400 else 1 + (samples - 400) // 160


def fbank(wave: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """[S] samples -> [T, 40] log-mel energies, computed in `dtype`."""
    t = num_frames(wave.shape[0])
    x = wave.to(dtype).unfold(0, 400, 160)[:t]
    x = x - x.mean(dim=1, keepdim=True)
    x = torch.cat([x[:, :1] * (1 - 0.97), x[:, 1:] - 0.97 * x[:, :-1]], 1)
    n = torch.arange(400, dtype=torch.float64, device=wave.device)
    x = x * (0.54 - 0.46 * torch.cos(2 * math.pi * n / 399)).to(dtype)
    power = torch.fft.rfft(x, n=512).abs() ** 2
    bank = torch.as_tensor(mel_bank(), dtype=dtype, device=wave.device)
    return torch.log(torch.clamp(power @ bank, min=FLT_EPSILON))


def mfcc(logmel: torch.Tensor, num_ceps: int, lifter: float) -> torch.Tensor:
    """[T, N] log-mel energies -> [T, num_ceps] MFCC, term by term."""
    t, n = logmel.shape
    out = []
    for k in range(num_ceps):
        scale = math.sqrt((1.0 if k == 0 else 2.0) / n)
        basis = torch.tensor([scale * math.cos(math.pi / n * (j + 0.5) * k)
                              for j in range(n)], dtype=logmel.dtype,
                             device=logmel.device)
        c = logmel @ basis
        if lifter:
            c = c * (1.0 + 0.5 * lifter * math.sin(math.pi * k / lifter))
        out.append(c)
    return torch.stack(out, dim=1)


class _Net:
    """The model's tensors in one dtype on one device, and its matmul."""

    def __init__(self, model: Dict, precision: str, device):
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        self.bf16 = precision == "bfloat16"
        self.device = device

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


def _tdnnf(net: _Net, h: torch.Tensor, layer: Dict, bypass: float
           ) -> torch.Tensor:
    """Rows [a, b) of h -> rows [a + s, b - s) of the block's output."""
    s = int(layer["stride"])
    n = h.shape[0]
    if s == 0:
        lin = net.mm(h, layer["w_l"])
        a = net.mm(lin, layer["w_a"]) + layer["b"]
        return torch.clamp(a, min=0) * layer["scale"] + layer["offset"] \
            + bypass * h
    # l(t) for t in [a + s, b): [h(t - s); h(t)]
    lin = net.mm(torch.cat([h[:n - s], h[s:]], dim=1), layer["w_l"])
    # a(t) for t in [a + s, b - s): [l(t); l(t + s)]
    m = lin.shape[0]
    a = net.mm(torch.cat([lin[:m - s], lin[s:]], dim=1), layer["w_a"]) \
        + layer["b"]
    return torch.clamp(a, min=0) * layer["scale"] + layer["offset"] \
        + bypass * h[s:n - s]


def context(model: Dict) -> int:
    """Frames of context on each side: lda's 1 and each block's stride."""
    return 1 + sum(int(x["stride"]) for x in model["tdnnf"])


def forward(model: Dict, logmel: torch.Tensor, ivector,
            precision: str = "float64") -> torch.Tensor:
    """[T, 40] log-mel energies of one utterance and its i-vector ->
    [ceil(T / subsample), P] outputs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        with torch.no_grad():
            return _forward(model, logmel, ivector, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _forward(model, logmel, ivector, precision):
    net = _Net(model, precision, logmel.device)
    m = net.m
    t = logmel.shape[0]
    c = context(model)
    feats = mfcc(logmel.to(net.dtype), int(model["num_ceps"]),
                 float(model["lifter"]))
    # Frames -c .. T + c - 1, the edges replicated.
    idx = torch.clamp(torch.arange(-c, t + c, device=logmel.device), 0,
                      t - 1)
    x = feats[idx]
    iv = torch.as_tensor(ivector).to(logmel.device, net.dtype)
    n = x.shape[0]
    # lda(t) for t in [-c + 1, T + c - 1)
    spliced = torch.cat([x[:n - 2], x[1:n - 1], x[2:],
                         iv[None].expand(n - 2, -1)], dim=1)
    h = net.mm(spliced, m["lda"]["w"]) + m["lda"]["b"]
    tdnn1 = m["tdnn1"]
    h = torch.clamp(net.mm(h, tdnn1["w"]) + tdnn1["b"], min=0) \
        * tdnn1["scale"] + tdnn1["offset"]
    for layer in m["tdnnf"]:
        h = _tdnnf(net, h, layer, float(model["bypass"]))
    # h holds frames 0 .. T - 1 now, every one of them.
    h = net.mm(h, m["prefinal_l"]["w"])
    p = m["prefinal_chain"]
    h = torch.clamp(net.mm(h, p["w1"]) + p["b1"], min=0) * p["scale1"] \
        + p["offset1"]
    h = net.mm(h, p["w2"]) * p["scale2"] + p["offset2"]
    out = net.mm(h, m["output"]["w"]) + m["output"]["b"]
    return out[::int(model["subsample"])]


def logp(model: Dict, waves: Sequence, ivectors, device,
         precision: str = "float64") -> List[torch.Tensor]:
    """Each wave's [ceil(T / subsample), P] outputs on `device`: fbank,
    MFCC and the network in one precision (float64 for "float64", else
    float32)."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    out = []
    for w, iv in zip(waves, ivectors):
        feats = fbank(torch.as_tensor(np.asarray(w), device=device), dtype)
        out.append(forward(model, feats, iv, precision))
    return out

