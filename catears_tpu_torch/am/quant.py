"""Int8 quantized acoustic-model path (port of catears_tpu/am/quant.py).

Same quantization semantics as the JAX version: per-tensor affine min/max
quantization to uint8 with scale = (max-min)/255 and zero_point =
round(-min/scale), values stored shifted to int8 (v - 128), and the
zero-point cross terms applied as rank-1 corrections in a float32 epilogue:

  (a - zpA)(b - zpB) = a'b' + cB*rowsum(a') + cA*colsum(b') + K*cA*cB
  with a' = a-128, b' = b-128, cA = 128-zpA, cB = 128-zpB.

Batched: an activation tensor [B, M, K] is quantized per utterance (min and
max over each utterance's own [M, K] rows), exactly what the JAX batch path
computes under vmap; a weight matrix [K, N] gets one scale.  The int8 dot
a'b' is `matmul_s8`, whose CUDA tensors run the hand-written Hopper kernel
in csrc/matmul_s8.cu.

Activations quantize dynamically (per-call min/max) by default.
`calibrate_ranges` records each linear's input range from float passes;
the layer then quantizes with that static range (`rng`, one scale for the
whole batch, out-of-range values saturate) or, guarded (`grng`), with the
range widened per utterance to its own min/max.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from catears_tpu_torch.am.nnet import Nnet, NnetDef, apply_layer


class QuantizedTensor(NamedTuple):
    values: torch.Tensor  # int8, stored as (uint8 value - 128)
    scale: torch.Tensor  # f32, one per matrix (leading dims of the input)
    zero_point: torch.Tensor  # i32, uint8 domain, same shape as scale


def quantize(x: torch.Tensor) -> QuantizedTensor:
    """Min/max affine quantization over the last two dims (one matrix)."""
    mn = torch.amin(x, dim=(-2, -1))
    mx = torch.amax(x, dim=(-2, -1))
    scale = (mx - mn) / 255.0
    # Degenerate constant input: a scale that represents it exactly.
    flat_scale = torch.where(mn == 0, torch.ones_like(mn),
                             torch.abs(mn) / 128.0)
    scale = torch.where(scale <= 0, flat_scale, scale)
    zero_point = torch.round(-mn / scale).to(torch.int32)
    q = torch.clamp(torch.round(x / scale[..., None, None])
                    + zero_point[..., None, None], 0, 255)
    return QuantizedTensor((q - 128).to(torch.int8), scale.float(),
                           zero_point)


def quantize_static(x: torch.Tensor, mn: torch.Tensor,
                    mx: torch.Tensor) -> QuantizedTensor:
    """Affine quantization with a given float32 range (per matrix: mn and mx
    have the shape of x's leading dims, or are scalars).

    The scale and zero point come from float32 tensors, as JAX computes
    them under jit: a scale rounded from float64 could differ by an ulp
    and flip rounded values.
    """
    mn = mn.to(torch.float32)
    mx = mx.to(torch.float32)
    flat_scale = torch.where(mn == 0, torch.ones_like(mn),
                             torch.abs(mn) / 128.0)
    scale = torch.where(mx - mn <= 0, flat_scale, (mx - mn) / 255.0)
    zero_point = torch.round(-mn / scale).to(torch.int32)
    q = torch.clamp(torch.round(x / scale[..., None, None])
                    + zero_point[..., None, None], 0, 255)
    return QuantizedTensor((q - 128).to(torch.int8), scale, zero_point)


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"matmul_s8 takes int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != 2:
        raise ValueError(f"matmul_s8 takes [B, M, K] or [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[-1] != b.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def matmul_s8_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, M, K] or [M, K] int8 @ [K, N] int8 -> int32, exact.

    CPU: an int32 torch.matmul.  CUDA (torch.matmul has no integer path
    there): float64, exact because |sum a'b'| <= 128^2 * K stays far below
    2^53; float32 would not be (128^2 * 3072 > 2^24).
    """
    _check_operands(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def matmul_s8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, K] or [M, K] int8 @ [K, N] int8 -> int32 (exact).

    CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernel (one launch for the whole batch) or raise.  `matmul_s8.launches`
    counts kernel launches.
    """
    _check_operands(a, b)
    if a.device.type == "cpu":
        return matmul_s8_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_s8: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_s8: operands must be contiguous")
    squeeze = a.dim() == 2
    a3 = a[None] if squeeze else a
    batch, m, _ = a3.shape
    n = b.shape[1]
    if batch > 65535:
        raise ValueError(f"matmul_s8: batch {batch} exceeds the grid limit")
    if batch * m * n == 0:
        out = torch.empty((batch, m, n), dtype=torch.int32, device=a.device)
    else:
        from catears_tpu_torch.kernels import load_kernels

        out = load_kernels().matmul_s8(a3, b)
        matmul_s8.launches += 1
    return out[0] if squeeze else out


matmul_s8.launches = 0


def qmatmul(aq: QuantizedTensor, bq: QuantizedTensor,
            colsum_b: torch.Tensor = None) -> torch.Tensor:
    """Quantized matmul with the f32 dequant epilogue.

    aq: [..., M, K] activations with per-matrix scale/zero point (shape
    [...]); bq: one [K, N] weight matrix.  colsum_b: optional precomputed
    f32 column sums of bq.values.
    """
    a, b = aq.values, bq.values
    k = a.shape[-1]
    dot = matmul_s8(a, b).to(torch.float32)
    ca = (128 - aq.zero_point).to(torch.float32)[..., None, None]
    cb = (128 - bq.zero_point).to(torch.float32)
    rowsum_a = torch.sum(a.to(torch.int32), dim=-1).to(torch.float32)
    if colsum_b is None:
        colsum_b = torch.sum(b.to(torch.int32), dim=0).to(torch.float32)
    acc = (dot + cb * rowsum_a[..., None] + ca * colsum_b
           + k * ca * cb)
    return aq.scale[..., None, None] * bq.scale * acc


class QuantNnet(nn.Module):
    """The int8 layer stack: per linear, the quantized weight (`wq` values
    [in, out] int8, scale, zero point), its f32 column sums, the f32 bias
    and, once calibrated, the f32 input range `rng` or `grng` ([lo, hi]);
    other layers keep their float parameters."""

    def __init__(self, nnet_def: NnetDef, qparams: List[Dict]):
        super().__init__()
        self.nnet_def = tuple(nnet_def)
        self.layer_params = nn.ModuleList()
        for p in qparams:
            holder = nn.Module()
            for name, value in p.items():
                if name == "wq":
                    holder.register_buffer("wq_values", value.values)
                    holder.register_buffer("wq_scale", value.scale)
                    holder.register_buffer("wq_zero_point", value.zero_point)
                else:
                    holder.register_buffer(name, value)
            self.layer_params.append(holder)

    def params(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.layer_params[i].named_buffers())

    def set_range(self, i: int, key: str, lo: float, hi: float) -> None:
        """Attach a calibrated input range to linear i under `key` ("rng"
        or "grng"), replacing either one already there."""
        holder = self.layer_params[i]
        for old in ("rng", "grng"):
            if old in holder._buffers:
                del holder._buffers[old]
        holder.register_buffer(key, torch.tensor(
            [lo, hi], dtype=torch.float32, device=holder.wq_values.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nnet_forward_quant(self, x)


def quantize_params(nnet_def: NnetDef, params) -> QuantNnet:
    """Pre-quantize every linear layer's weights (bias stays f32).

    params: per-layer dicts of float tensors or numpy arrays.
    """
    out = []
    for layer, p in zip(nnet_def, params):
        p = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
             for k, v in p.items()}
        if layer[0] == "linear":
            wq = quantize(p["w"])
            colsum = torch.sum(wq.values.to(torch.int32),
                               dim=0).to(torch.float32)
            out.append({"wq": wq, "b": p["b"], "colsum": colsum})
        else:
            out.append(p)
    return QuantNnet(nnet_def, out)


def from_jax_qparams(nnet_def: NnetDef, qparams) -> QuantNnet:
    """The port's int8 stack from the JAX `quantize_params` output: carries
    wq.values, scale, zero_point, colsum, the bias and a calibrated range
    (`rng` or `grng`, rounded to float32 as JAX uses it) across."""
    out = []
    for layer, p in zip(nnet_def, qparams):
        if layer[0] == "linear":
            wq = p["wq"]
            q = {
                "wq": QuantizedTensor(
                    torch.tensor(np.asarray(wq.values)),
                    torch.tensor(np.asarray(wq.scale, np.float32)),
                    torch.tensor(np.asarray(wq.zero_point, np.int32))),
                "b": torch.tensor(np.asarray(p["b"], np.float32)),
                "colsum": torch.tensor(np.asarray(p["colsum"], np.float32))}
            for key in ("rng", "grng"):
                if key in p:
                    q[key] = torch.tensor(np.asarray(p[key], np.float32))
            out.append(q)
        else:
            out.append({k: torch.tensor(np.asarray(v, np.float32))
                        for k, v in p.items()})
    return QuantNnet(nnet_def, out)


def calibrate_ranges(nnet_def: NnetDef, float_nnet: Nnet, qnet: QuantNnet,
                     xs, margin: float = 0.05, guard: bool = False) -> None:
    """Record each linear's input (min, max) from float forward passes.

    Runs the float stack layer by layer on representative features (one
    [T, D] tensor or a list of per-utterance ones; the range is the running
    min/max over all of them), widens it by `margin` of its span and
    attaches it to the linear in `qnet`: under "grng" with guard=True (the
    range then widens per call to cover its input), else "rng" (static,
    out-of-range inputs saturate).  The arithmetic is the JAX function's:
    float32 extremes, then Python floats.
    """
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    ranges: List[Optional[Tuple[float, float]]] = [None] * len(nnet_def)
    with torch.no_grad():
        for x in xs:
            for i, layer in enumerate(nnet_def):
                if layer[0] == "linear":
                    mn, mx = float(torch.min(x)), float(torch.max(x))
                    if ranges[i] is None:
                        ranges[i] = (mn, mx)
                    else:
                        ranges[i] = (min(ranges[i][0], mn),
                                     max(ranges[i][1], mx))
                x = float_nnet.forward_layer(i, x)
    key = "grng" if guard else "rng"
    for i, r in enumerate(ranges):
        if r is not None:
            pad = margin * max(r[1] - r[0], 1e-6)
            qnet.set_range(i, key, r[0] - pad, r[1] + pad)


def calibration_coverage(nnet_def: NnetDef, float_nnet: Nnet,
                         qnet: QuantNnet, xs) -> List[float]:
    """Fraction of activations inside each calibrated linear's range, from
    float passes over held-out features (one tensor or a list)."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    inside = [0] * len(nnet_def)
    total = [0] * len(nnet_def)
    with torch.no_grad():
        for x in xs:
            for i, layer in enumerate(nnet_def):
                p = qnet.params(i)
                rng = p.get("rng", p.get("grng"))
                if layer[0] == "linear" and rng is not None:
                    inside[i] += int(torch.sum((x >= rng[0]) & (x <= rng[1])))
                    total[i] += x.numel()
                x = float_nnet.forward_layer(i, x)
    return [inside[i] / total[i] for i in range(len(nnet_def)) if total[i]]


def _quantize_input(x: torch.Tensor, p: Dict[str, torch.Tensor]):
    """The activation quantization of one linear: guarded static ("grng":
    the range widened to each matrix's own min/max, as JAX computes it per
    utterance under vmap), static ("rng": one range for the whole batch),
    or dynamic."""
    if "grng" in p:
        lo, hi = p["grng"][0], p["grng"][1]
        return quantize_static(
            x, torch.minimum(torch.amin(x, dim=(-2, -1)), lo),
            torch.maximum(torch.amax(x, dim=(-2, -1)), hi))
    if "rng" in p:
        return quantize_static(x, p["rng"][0], p["rng"][1])
    return quantize(x)


def nnet_forward_quant(qnet: QuantNnet, x: torch.Tensor) -> torch.Tensor:
    """Layer stack with int8 linears; each linear's activations quantize
    per matrix (per utterance for a [B, T, D] batch) by its calibrated
    range when it has one, else dynamically."""
    for i, layer in enumerate(qnet.nnet_def):
        p = qnet.params(i)
        if layer[0] == "linear":
            xq = _quantize_input(x, p)
            wq = QuantizedTensor(p["wq_values"], p["wq_scale"],
                                 p["wq_zero_point"])
            x = qmatmul(xq, wq, colsum_b=p["colsum"]) + p["b"]
        else:
            x = apply_layer(layer[0], layer, x, p)
    return x
