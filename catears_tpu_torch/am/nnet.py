"""nnet3-style layer stack as a PyTorch module (port of
catears_tpu/am/nnet.py).

Same layer grammar as the JAX version (Linear with `w` stored [in, out],
ReLU, Normalize, Softmax, LogSoftmax, Splice with edge clamping, BatchNorm
as precomputed scale/offset, Narrow).  The module runs on [T, D] or on a
batch [B, T, D]: splice and narrow act on the time axis (-2), so a batch of
equally padded utterances gives each utterance exactly its own result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.binfmt import NnetSpec
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
        else:
            raise CorruptionError(f"unknown layer kind {layer.kind}")
    return tuple(layer_defs), params


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


class Nnet(nn.Module):
    """The float layer stack; parameters keep the JAX layout (`w` is
    [in, out])."""

    def __init__(self, nnet_def: NnetDef,
                 params: List[Dict[str, np.ndarray]]):
        super().__init__()
        self.nnet_def = tuple(nnet_def)
        self.layer_params = nn.ModuleList()
        for p in params:
            holder = nn.Module()
            for name, value in p.items():
                holder.register_buffer(
                    name, torch.tensor(np.asarray(value, np.float32)))
            self.layer_params.append(holder)

    def params(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.layer_params[i].named_buffers())

    def forward_layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i alone."""
        layer, p = self.nnet_def[i], self.params(i)
        if layer[0] == "linear":
            return torch.matmul(x, p["w"]) + p["b"]
        return apply_layer(layer[0], layer, x, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.nnet_def)):
            x = self.forward_layer(i, x)
        return x


def from_jax_params(nnet_def: NnetDef, params) -> Nnet:
    """The port's module from the JAX build's parameters (numpy arrays or
    anything np.asarray takes), with identical values."""
    return Nnet(nnet_def, [{k: np.asarray(v, np.float32) for k, v in p.items()}
                           for p in params])
