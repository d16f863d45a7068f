"""nnet3-style layer stack as a PyTorch module (port of
catears_tpu/am/nnet.py).

Same layer grammar as the JAX version (Linear with `w` stored [in, out],
ReLU, Normalize, Softmax, LogSoftmax, Splice with edge clamping, BatchNorm
as precomputed scale/offset, Narrow).  The module runs on [T, D] or on a
batch [B, T, D]: splice and narrow act on the time axis (-2), so a batch of
equally padded utterances gives each utterance exactly its own result.

Beside it, the factored TDNN of Kaldi's chain models (TDNN-F), which the
JAX version does not have: a bias-free spliced linear, the tdnnf block
(linear over offsets (-s, 0) to a bottleneck, affine over (0, s), ReLU,
batchnorm, plus `bypass` times the block's input), a subsample layer
where the frame rate drops, and an i-vector appended to every row.  These
consume their context (no edge clamping: the caller pads the input by the
model's context).  Time offsets and strides are in input frames; after a
subsample layer of factor f the stack runs on every f-th row, so a stride
of s frames is s / f rows there (`layer_rates`).  Every linear counts the
FLOPs it enqueues on `am_flops` (utils/log.py).

The chain TDNN-LSTM adds three kinds: a spliced affine (the spliced
linear with a bias), Kaldi's projected LSTM with peepholes (`lstmp`: its
gates' input half one batched matmul over the rows, its recurrence of
delay d frames, |d| / rate rows, am/lstm.py) and an output delay (`delay`
d: out(t) = in(t - d), which moves no row: it only shifts the frames the
rows stand for, so the stack's context is d more on the left and d less
on the right).  A spliced layer directly before a subsample layer is
computed at the kept rows only.  A recurrence starts from zero state at
the first row its layer computes and, told the output rows the valid
outputs have (`Nnet.run(..., out_rows=)`), steps only to the last row
those read (`Nnet.steps`); the rows after it are zeros.  Tracing, each
recurrence is spanned as `am.recurrence` (layer, steps, batch; CUDA
events on a card) and counts `lstm_steps` (the sequential steps run) and
`lstm_steps_needed` (those the valid outputs read).

The chain BLSTM adds one kind, `blstmp` (NN02 kind 17): a forward LSTMP
(recurrence from row t - d) and a backward one (from row t + d) on one
input, their outputs appended ([forward; backward], the xconfig's
`Append`).  The backward one is the forward recurrence over each batch
row's rows reversed within its own length (`reverse_rows`: told each
row's rows, `Nnet.run(..., lengths=)`, so that each backward chain
starts at its row's last row and never in the batch's padding).  A stack
with one is evaluated in Kaldi's chunks (am/chunks.py, am/model.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from catears_tpu_torch.am.lstm import lstm_recurrence
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.binfmt import NnetSpec
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.errors import CorruptionError

# Static layer definition: tuple of ("kind", *static_args) entries.
NnetDef = Tuple[Tuple[Any, ...], ...]


def build_nnet(spec: NnetSpec) -> Tuple[NnetDef, List[Dict[str, np.ndarray]]]:
    """Split an NN02 spec into a static layer structure + numpy parameters."""
    layer_defs: List[Tuple[Any, ...]] = []
    params: List[Dict[str, np.ndarray]] = []
    for layer in spec.layers:
        if layer.kind == binfmt.LAYER_LINEAR:
            layer_defs.append(("linear",))
            params.append({"w": np.asarray(layer.weight, np.float32),
                           "b": np.asarray(layer.bias, np.float32)})
        elif layer.kind == binfmt.LAYER_RELU:
            layer_defs.append(("relu",))
            params.append({})
        elif layer.kind == binfmt.LAYER_NORMALIZE:
            layer_defs.append(("normalize",))
            params.append({})
        elif layer.kind == binfmt.LAYER_SOFTMAX:
            layer_defs.append(("softmax",))
            params.append({})
        elif layer.kind == binfmt.LAYER_LOGSOFTMAX:
            layer_defs.append(("logsoftmax",))
            params.append({})
        elif layer.kind == binfmt.LAYER_SPLICE:
            layer_defs.append(("splice", tuple(layer.indices)))
            params.append({})
        elif layer.kind == binfmt.LAYER_BATCHNORM:
            layer_defs.append(("batchnorm",))
            params.append({"scale": np.asarray(layer.scale, np.float32),
                           "offset": np.asarray(layer.offset, np.float32)})
        elif layer.kind == binfmt.LAYER_NARROW:
            layer_defs.append(("narrow", layer.narrow_left,
                               layer.narrow_right))
            params.append({})
        elif layer.kind == binfmt.LAYER_SPLICED_LINEAR:
            layer_defs.append(("spliced_linear", tuple(layer.offsets)))
            params.append({"w": np.asarray(layer.weight, np.float32)})
        elif layer.kind == binfmt.LAYER_SPLICED_AFFINE:
            layer_defs.append(("spliced_affine", tuple(layer.offsets)))
            params.append({"w": np.asarray(layer.weight, np.float32),
                           "b": np.asarray(layer.bias, np.float32)})
        elif layer.kind == binfmt.LAYER_LSTMP:
            layer_defs.append(("lstmp", int(layer.delay),
                               float(np.float32(layer.rec_scale)),
                               int(layer.rec_dim)))
            params.append(_lstmp_params(layer))
        elif layer.kind == binfmt.LAYER_BLSTMP:
            back = layer.backward
            layer_defs.append((
                "blstmp", -int(layer.delay),
                float(np.float32(layer.rec_scale)), int(layer.rec_dim),
                float(np.float32(back.rec_scale)), int(back.rec_dim)))
            params.append({f"{side}_{k}": v for side, part in
                           (("fw", layer), ("bw", back))
                           for k, v in _lstmp_params(part).items()})
        elif layer.kind == binfmt.LAYER_DELAY:
            layer_defs.append(("delay", int(layer.delay)))
            params.append({})
        elif layer.kind == binfmt.LAYER_TDNNF:
            layer_defs.append(("tdnnf", layer.stride,
                               float(np.float32(layer.bypass))))
            params.append({"w_l": np.asarray(layer.linear, np.float32),
                           "w_a": np.asarray(layer.affine, np.float32),
                           "b": np.asarray(layer.bias, np.float32),
                           "scale": np.asarray(layer.scale, np.float32),
                           "offset": np.asarray(layer.offset, np.float32)})
        elif layer.kind == binfmt.LAYER_SUBSAMPLE:
            layer_defs.append(("subsample", layer.factor))
            params.append({})
        elif layer.kind == binfmt.LAYER_IVECTOR:
            layer_defs.append(("ivector", layer.dim))
            params.append({})
        else:
            raise CorruptionError(f"unknown layer kind {layer.kind}")
    layer_rates(tuple(layer_defs))  # refuses a plan it cannot run
    return tuple(layer_defs), params


def _lstmp_params(layer) -> Dict[str, np.ndarray]:
    w = np.asarray(layer.weight, np.float32)
    rec = int(layer.rec_dim)
    return {"w_x": w[:-rec], "w_r": w[-rec:],
            "b": np.asarray(layer.bias, np.float32),
            "peephole": np.asarray(layer.peephole, np.float32),
            "w_rp": np.asarray(layer.projection, np.float32),
            "b_rp": np.asarray(layer.projection_bias, np.float32)}


TDNN_KINDS = ("spliced_linear", "tdnnf", "subsample", "ivector",
              "spliced_affine", "lstmp", "delay", "blstmp")
SPLICED = ("spliced_linear", "spliced_affine")
RECURRENT = ("lstmp", "blstmp")


def layer_rates(nnet_def: NnetDef) -> Tuple[int, ...]:
    """The frame rate each layer runs at, in input frames a row: the
    product of the subsample factors before it.  Raises CorruptionError
    where a stride or offset after a subsample is not a whole number of
    rows, or where a splice or narrow (which count rows) follows one."""
    rates, rate = [], 1
    for layer in nnet_def:
        rates.append(rate)
        kind = layer[0]
        steps = ()
        if kind in SPLICED:
            steps = layer[1]
        elif kind in ("tdnnf",) + RECURRENT:
            steps = (layer[1],)
        elif kind in ("splice", "narrow") and rate > 1:
            raise CorruptionError(f"a {kind} layer after a subsample layer")
        if any(o % rate for o in steps):
            raise CorruptionError(
                f"{kind} layer: offsets {steps} at {rate} frames a row")
        if kind == "subsample":
            rate *= layer[1]
    return tuple(rates)


def frame_subsampling(nnet_def: NnetDef) -> int:
    """Input frames per output row: the product of the subsample
    factors."""
    factor = 1
    for layer in nnet_def:
        if layer[0] == "subsample":
            factor *= layer[1]
    return factor


def ivector_dim(nnet_def: NnetDef) -> int:
    """Width of the i-vector the stack appends (0: it takes none)."""
    dims = {layer[1] for layer in nnet_def if layer[0] == "ivector"}
    if len(dims) > 1:
        raise CorruptionError(f"i-vector layers of widths {sorted(dims)}")
    return dims.pop() if dims else 0


def context_frames(nnet_def: NnetDef) -> Tuple[int, int]:
    """(left, right) input frames of context the stack consumes: narrow
    rows (at the input rate), spliced linears' offsets, tdnnf strides and
    output delays (in frames; a recurrence consumes none)."""
    left = right = 0
    for layer in nnet_def:
        kind = layer[0]
        if kind == "narrow":
            left += layer[1]
            right += layer[2]
        elif kind in SPLICED:
            left += max(0, -min(layer[1]))
            right += max(0, max(layer[1]))
        elif kind == "tdnnf":
            left += layer[1]
            right += layer[1]
        elif kind == "delay":
            left += layer[1]
            right -= layer[1]
    return left, right


def fold_feature_map(nnet_def: NnetDef, params, fmap: np.ndarray):
    """`params` with a linear feature map [40, F] (an MFCC's DCT and
    lifter, frontend/mfcc.py) folded into the first linear, which reads
    spliced F-wide feature rows (and any i-vector after them): the folded
    stack takes the 40-wide rows the map is applied to.  The product is
    formed in float64.  Raises CorruptionError where anything but splice,
    narrow or ivector layers precede that linear."""
    fmap = np.asarray(fmap, np.float64)
    blocks = 1
    for i, layer in enumerate(nnet_def):
        kind = layer[0]
        if kind == "splice":
            blocks *= len(layer[1])
        elif kind in ("narrow", "ivector"):
            continue
        elif kind == "linear":
            w = np.asarray(params[i]["w"], np.float64)
            f = fmap.shape[1]
            if w.shape[0] < blocks * f:
                raise CorruptionError(
                    f"feature map: linear {i} reads {w.shape[0]} inputs, "
                    f"fewer than {blocks} x {f}")
            feats = w[:blocks * f].reshape(blocks, f, -1)
            folded = np.concatenate(
                [np.einsum("nf,bfo->bno", fmap, feats).reshape(
                    blocks * fmap.shape[0], -1), w[blocks * f:]])
            out = list(params)
            out[i] = dict(params[i], w=folded.astype(np.float32))
            return out
        else:
            break
    raise CorruptionError("feature map: no linear reads the spliced "
                          "features first")


def splice(x: torch.Tensor, indices: Sequence[int]) -> torch.Tensor:
    """[..., T, D] -> [..., T, len(indices)*D]: context concat, edges
    clamped."""
    t, d = x.shape[-2], x.shape[-1]
    offs = torch.as_tensor(indices, dtype=torch.int64, device=x.device)
    idx = torch.clamp(torch.arange(t, device=x.device)[:, None]
                      + offs[None, :], 0, t - 1)
    return x[..., idx, :].reshape(*x.shape[:-2], t, len(indices) * d)


def narrow(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Drop `left` head rows and `right` tail rows (no-op if too few rows)."""
    t = x.shape[-2]
    if t <= left + right:
        return x
    return x[..., left:t - right, :]


def normalize_rms(x: torch.Tensor) -> torch.Tensor:
    """Scale each row so its root-mean-square is 1 (NormalizeLayer)."""
    d = x.shape[-1]
    squared_sum = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.sqrt(d / squared_sum)


def apply_layer(kind: str, layer: Tuple[Any, ...], x: torch.Tensor,
                p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every layer kind except `linear` (shared by the float and int8
    stacks)."""
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "normalize":
        return normalize_rms(x)
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    if kind == "logsoftmax":
        return torch.log_softmax(x, dim=-1)
    if kind == "splice":
        return splice(x, layer[1])
    if kind == "batchnorm":
        return x * p["scale"] + p["offset"]
    if kind == "narrow":
        return narrow(x, layer[1], layer[2])
    raise ValueError(f"unknown layer kind {kind}")


def _rows(x: torch.Tensor, lo: int, n: int, step: int = 1) -> torch.Tensor:
    return x[..., lo:lo + step * (n - 1) + 1:step, :]


def spliced_linear(x: torch.Tensor, w: torch.Tensor,
                   offsets: Sequence[int], step: int = 1) -> torch.Tensor:
    """[..., N, D] -> [..., N - left - right, O]: out[i] is the sum over
    offsets o_j of x[i + left + o_j] @ w's j-th [D, O] block, with no
    bias; offsets in rows.  `step` f > 1 computes only out[0], out[f],
    out[2 f], ... (for a subsample layer after it)."""
    d = x.shape[-1]
    lo = max(0, -min(offsets))
    n = x.shape[-2] - lo - max(0, max(offsets))
    if n <= 0:
        raise ValueError(f"spliced linear: {x.shape[-2]} rows for offsets "
                         f"{tuple(offsets)}")
    n = -(-n // step)
    y = None
    for j, o in enumerate(offsets):
        part = torch.matmul(_rows(x, lo + o, n, step), w[j * d:(j + 1) * d])
        y = part if y is None else y + part
    _count_flops(y, 2 * len(offsets) * d)
    return y


def tdnnf(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int,
          bypass: float) -> torch.Tensor:
    """The TDNN-F block over [..., N, D] at a stride of `stride` rows:
    l(t) = W_l [h(t-s); h(t)], a(t) = W_a [l(t); l(t+s)] + b,
    out(t) = BN(ReLU(a(t))) + bypass * h(t); N - 2s rows (s = 0: one row
    each side)."""
    offsets = (-stride, 0) if stride else (0,)
    neck = spliced_linear(x, p["w_l"], offsets)
    a = spliced_linear(neck, p["w_a"], (0, stride) if stride else (0,))
    a = a + p["b"]
    return (torch.clamp(a, min=0.0) * p["scale"] + p["offset"]
            + bypass * _rows(x, stride, a.shape[-2]))


def append_ivector(x: torch.Tensor, ivector: torch.Tensor) -> torch.Tensor:
    """[..., N, D] rows and an [..., dim] i-vector -> [..., N, D + dim]."""
    iv = ivector.to(x.dtype)[..., None, :].expand(
        *x.shape[:-1], ivector.shape[-1])
    return torch.cat([x, iv], dim=-1)


def _count_flops(y: torch.Tensor, per_output: int) -> None:
    """Adds 2 x multiply-adds (`per_output` FLOPs an output value) to
    the `am_flops` counter."""
    log.count("am_flops", float(y.numel()) * per_output)


def lstmp(x: torch.Tensor, p: Dict[str, torch.Tensor], delay: int,
          scale: float, steps: int, index: int = -1,
          direction: str = "forward") -> torch.Tensor:
    """The projected LSTM over [..., N, D] rows with a recurrence of
    `delay` rows (>= 1): the gates' input half x W_x + b of the first
    `steps` rows in one matmul, then the recurrence (am/lstm.py), each of
    the `delay` interleaved chains of rows from zero state; [..., N,
    R + P], the rows from `steps` on zeros.  `direction` only labels the
    span: a backward recurrence is a forward one over reversed rows
    (`reverse_rows`)."""
    n = x.shape[-2]
    steps = max(0, min(steps, n))
    lead = x.shape[:-2]
    gx = torch.matmul(x[..., :steps, :].reshape(lead.numel(), steps,
                                                x.shape[-1]),
                      p["w_x"]) + p["b"]
    _count_flops(gx, 2 * x.shape[-1])
    b, g4 = gx.shape[0], gx.shape[-1]
    chain = -(-steps // delay)
    if delay > 1:  # row j is step j // delay of chain j % delay
        gx = torch.nn.functional.pad(gx, (0, 0, 0, chain * delay - steps))
        gx = gx.view(b, chain, delay, g4).transpose(1, 2).reshape(
            b * delay, chain, g4)
    with log.span("am.recurrence", device=x.device.type == "cuda",
                  layer=index, steps=chain, batch=gx.shape[0],
                  direction=direction):
        out = lstm_recurrence(gx.contiguous(), p["w_r"], p["peephole"],
                              p["w_rp"], p["b_rp"], scale)
    log.count("lstm_steps", chain)
    log.count("am_flops", 2.0 * gx.shape[0] * chain
              * (p["w_r"].numel() + p["w_rp"].numel()))
    oc = out.shape[-1]
    if delay > 1:
        out = out.view(b, delay, chain, oc).transpose(1, 2).reshape(
            b, chain * delay, oc)[:, :steps]
    out = torch.nn.functional.pad(out, (0, 0, 0, n - steps))
    return out.reshape(*lead, n, oc)


def reverse_rows(x: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N, D] with each batch row's first lengths[b] rows reversed and
    the rows after them (its padding) left in place (None: all N rows
    reversed); its own inverse."""
    if lengths is None:
        return torch.flip(x, dims=(-2,))
    n = x.shape[-2]
    j = torch.arange(n, device=x.device)
    last = lengths.to(x.device)[:, None] - 1
    idx = torch.where(j[None, :] <= last, last - j[None, :], j[None, :])
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def blstmp(x: torch.Tensor, p: Dict[str, torch.Tensor],
           layer: Tuple[Any, ...], delay: int, index: int = -1,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bidirectional LSTMP layer over [B, N, D] rows: the forward
    LSTMP (recurrence from row t - delay) and the backward one (from row
    t + delay), each from zero state, the backward chains starting at
    each batch row's last row (`lengths[b] - 1`; None: row N - 1), never
    in its padding; [B, N, R + P + R' + P'], [forward; backward]."""
    n = x.shape[-2]
    fw = lstmp(x, _side(p, "fw"), delay, layer[2], n, index)
    bw = lstmp(reverse_rows(x, lengths), _side(p, "bw"), delay, layer[4], n,
               index, "backward")
    return torch.cat([fw, reverse_rows(bw, lengths)], dim=-1)


def _side(p: Dict[str, torch.Tensor], side: str) -> Dict[str, torch.Tensor]:
    return {k[len(side) + 1:]: v for k, v in p.items()
            if k.startswith(side + "_")}


def tdnn_layer(layer: Tuple[Any, ...], x: torch.Tensor,
               p: Dict[str, torch.Tensor], rate: int,
               ivector: Optional[torch.Tensor], step: int = 1
               ) -> torch.Tensor:
    """One of TDNN_KINDS but `lstmp` at `rate` input frames a row
    (`step`: a spliced layer's, as `spliced_linear`'s)."""
    kind = layer[0]
    if kind in SPLICED:
        y = spliced_linear(x, p["w"], [o // rate for o in layer[1]], step)
        return y + p["b"] if kind == "spliced_affine" else y
    if kind == "delay":
        return x
    if kind == "tdnnf":
        return tdnnf(x, p, layer[1] // rate, layer[2])
    if kind == "subsample":
        return x[..., ::layer[1], :]
    if kind == "ivector":
        if ivector is None or ivector.shape[-1] != layer[1]:
            raise ValueError(f"the stack appends a {layer[1]}-wide "
                             f"i-vector; got "
                             f"{None if ivector is None else tuple(ivector.shape)}")
        return append_ivector(x, ivector)
    raise ValueError(f"unknown layer kind {kind}")


def output_dim(nnet_def: NnetDef, params, input_dim: int) -> int:
    """Static output dimension of the stack."""
    d = input_dim
    for layer, p in zip(nnet_def, params):
        kind = layer[0]
        if kind in ("linear",) + SPLICED:
            d = p["w"].shape[1]
        elif kind == "lstmp":
            d = p["w_rp"].shape[1]
        elif kind == "blstmp":
            d = p["fw_w_rp"].shape[1] + p["bw_w_rp"].shape[1]
        elif kind == "splice":
            d = d * len(layer[1])
        elif kind == "ivector":
            d += layer[1]
    return d


def rows_consumed(nnet_def: NnetDef) -> Tuple[int, int]:
    """Total (left, right) rows consumed by Narrow layers."""
    left = right = 0
    for layer in nnet_def:
        if layer[0] == "narrow":
            left += layer[1]
            right += layer[2]
    return left, right


def nnet_forward(nnet_def: NnetDef, params, x) -> torch.Tensor:
    """Run the layer stack on [..., T, D] features (the JAX functional
    form): `params` as build_nnet gives them, numpy or torch; each is read
    as float32 on x's device for this call and kept nowhere.  Equal to
    `Nnet(nnet_def, params)(x)`."""
    x = torch.as_tensor(x, dtype=torch.float32)
    for layer, p in zip(nnet_def, params):
        p = {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
             for k, v in p.items()}
        if layer[0] == "linear":
            x = torch.matmul(x, p["w"]) + p["b"]
        else:
            x = apply_layer(layer[0], layer, x, p)
    return x


class Nnet(nn.Module):
    """The float layer stack; parameters keep the JAX layout (`w` is
    [in, out])."""

    def __init__(self, nnet_def: NnetDef,
                 params: List[Dict[str, np.ndarray]]):
        super().__init__()
        self.nnet_def = tuple(nnet_def)
        self.rates = layer_rates(self.nnet_def)
        self.factor = frame_subsampling(self.nnet_def)
        # Subsample layers whose spliced predecessor computes only the
        # rows they keep (and which then pass their input on).
        self.fused = {i for i, layer in enumerate(self.nnet_def)
                      if layer[0] == "subsample" and i
                      and self.nnet_def[i - 1][0] in SPLICED}
        # The context of the layers after each layer, left + right frames.
        self.after = [sum(context_frames(self.nnet_def[i + 1:]))
                      for i in range(len(self.nnet_def))]
        self.layer_params = nn.ModuleList()
        for p in params:
            holder = nn.Module()
            for name, value in p.items():
                holder.register_buffer(
                    name, torch.tensor(np.asarray(value, np.float32)))
            self.layer_params.append(holder)

    def params(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.layer_params[i].named_buffers())

    def steps(self, i: int, out_rows: int) -> int:
        """Rows of layer i's output that valid outputs read, where they
        have `out_rows` rows: its first row stands for the first output
        row's frame less the left context of the layers after it, and the
        last one read for the last output row's frame plus their right
        context."""
        if out_rows <= 0:
            return 0
        return (self.factor * (out_rows - 1) + self.after[i]) \
            // self.rates[i] + 1

    def forward_layer(self, i: int, x: torch.Tensor,
                      ivector: Optional[torch.Tensor] = None,
                      out_rows: Optional[int] = None,
                      lengths: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Layer i alone (`ivector`: the [..., dim] i-vector an ivector
        layer appends; `out_rows`: the output rows valid outputs have,
        where a forward-only recurrence stops; None: at the last row;
        `lengths`: [B] each batch row's rows at a bidirectional layer's
        rate, where its backward chains start; None: all rows)."""
        layer, p = self.nnet_def[i], self.params(i)
        kind = layer[0]
        if kind == "linear":
            y = torch.matmul(x, p["w"]) + p["b"]
            _count_flops(y, 2 * x.shape[-1])
            return y
        if i in self.fused:
            return x
        if kind == "lstmp":
            delay = -layer[1] // self.rates[i]
            steps = x.shape[-2]
            if out_rows is not None:
                steps = self.steps(i, out_rows)
                log.count("lstm_steps_needed", -(-steps // delay))
            return lstmp(x, p, delay, layer[2], steps, i)
        if kind == "blstmp":
            delay = layer[1] // self.rates[i]
            log.count("lstm_steps_needed", 2 * -(-x.shape[-2] // delay))
            return blstmp(x, p, layer, delay, i, lengths)
        if kind in TDNN_KINDS:
            return tdnn_layer(layer, x, p, self.rates[i], ivector,
                              self.factor if i + 1 in self.fused else 1)
        return apply_layer(kind, layer, x, p)

    def run(self, lo: int, hi: int, x: torch.Tensor,
            ivector: Optional[torch.Tensor] = None,
            out_rows: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layers lo..hi-1."""
        for i in range(lo, hi):
            x = self.forward_layer(i, x, ivector, out_rows, lengths)
        return x

    def forward(self, x: torch.Tensor,
                ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run(0, len(self.nnet_def), x, ivector)


def from_jax_params(nnet_def: NnetDef, params) -> Nnet:
    """The port's module from the JAX build's parameters (numpy arrays or
    anything np.asarray takes), with identical values."""
    return Nnet(nnet_def, [{k: np.asarray(v, np.float32) for k, v in p.items()}
                           for p in params])
