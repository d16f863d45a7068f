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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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


TDNN_KINDS = ("spliced_linear", "tdnnf", "subsample", "ivector")


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
        if kind == "spliced_linear":
            steps = layer[1]
        elif kind == "tdnnf":
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
    rows (at the input rate), spliced linears' offsets and tdnnf strides
    (in frames)."""
    left = right = 0
    for layer in nnet_def:
        kind = layer[0]
        if kind == "narrow":
            left += layer[1]
            right += layer[2]
        elif kind == "spliced_linear":
            left += max(0, -min(layer[1]))
            right += max(0, max(layer[1]))
        elif kind == "tdnnf":
            left += layer[1]
            right += layer[1]
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


def _rows(x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    return x[..., lo:lo + n, :]


def spliced_linear(x: torch.Tensor, w: torch.Tensor,
                   offsets: Sequence[int]) -> torch.Tensor:
    """[..., N, D] -> [..., N - left - right, O]: out[i] is the sum over
    offsets o_j of x[i + left + o_j] @ w's j-th [D, O] block, with no
    bias; offsets in rows."""
    d = x.shape[-1]
    lo = max(0, -min(offsets))
    n = x.shape[-2] - lo - max(0, max(offsets))
    if n <= 0:
        raise ValueError(f"spliced linear: {x.shape[-2]} rows for offsets "
                         f"{tuple(offsets)}")
    y = None
    for j, o in enumerate(offsets):
        part = torch.matmul(_rows(x, lo + o, n), w[j * d:(j + 1) * d])
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


def tdnn_layer(layer: Tuple[Any, ...], x: torch.Tensor,
               p: Dict[str, torch.Tensor], rate: int,
               ivector: Optional[torch.Tensor]) -> torch.Tensor:
    """One of TDNN_KINDS at `rate` input frames a row."""
    kind = layer[0]
    if kind == "spliced_linear":
        return spliced_linear(x, p["w"], [o // rate for o in layer[1]])
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
        if kind in ("linear", "spliced_linear"):
            d = p["w"].shape[1]
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
        self.layer_params = nn.ModuleList()
        for p in params:
            holder = nn.Module()
            for name, value in p.items():
                holder.register_buffer(
                    name, torch.tensor(np.asarray(value, np.float32)))
            self.layer_params.append(holder)

    def params(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.layer_params[i].named_buffers())

    def forward_layer(self, i: int, x: torch.Tensor,
                      ivector: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Layer i alone (`ivector`: the [..., dim] i-vector an ivector
        layer appends)."""
        layer, p = self.nnet_def[i], self.params(i)
        if layer[0] == "linear":
            y = torch.matmul(x, p["w"]) + p["b"]
            _count_flops(y, 2 * x.shape[-1])
            return y
        if layer[0] in TDNN_KINDS:
            return tdnn_layer(layer, x, p, self.rates[i], ivector)
        return apply_layer(layer[0], layer, x, p)

    def run(self, lo: int, hi: int, x: torch.Tensor,
            ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layers lo..hi-1."""
        for i in range(lo, hi):
            x = self.forward_layer(i, x, ivector)
        return x

    def forward(self, x: torch.Tensor,
                ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run(0, len(self.nnet_def), x, ivector)


def from_jax_params(nnet_def: NnetDef, params) -> Nnet:
    """The port's module from the JAX build's parameters (numpy arrays or
    anything np.asarray takes), with identical values."""
    return Nnet(nnet_def, [{k: np.asarray(v, np.float32) for k, v in p.items()}
                           for p in params])
