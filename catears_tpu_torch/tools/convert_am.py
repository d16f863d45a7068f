"""Convert a Kaldi nnet3 text acoustic model to the NN02 binary format.
(The port's copy of catears_tpu/tools/convert_am.py.)

Functional parity with reference tool/convert_am.py: parses the text AM
dumped by Kaldi's `nnet3-am-copy --binary=false`, converts

  component-node graph   -> layer order; `Append(Offset(x,-1), x, ...)`
                            descriptors become Splice+Narrow layer pairs and
                            accumulate left/right context
  NaturalGradientAffineComponent -> Linear (W stored transposed: [in, out])
  RectifiedLinearComponent       -> ReLU
  BatchNormComponent             -> precomputed scale/offset
                                    (scale = (var+eps)^-0.5 * target_rms,
                                     offset = -mean * scale)
  LogSoftmaxComponent            -> LogSoftmax
  <Priors>                       -> VEC0 prior file

and writes `<out>.nnet` (NN02) + `<out>.prior` (VEC0).

Usage: python -m catears_tpu_torch.tools.convert_am <text-nnet3-am> <out-prefix>
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

import numpy as np

from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.binfmt import LayerSpec, NnetSpec
from catears_tpu_torch.utils.errors import CorruptionError

_COMPONENT_NODE = re.compile(
    r"^component-node name=(\S+) component=(\S+) input=(.*)$")
_APPEND = re.compile(r"^Append\((.*)\)$")
_OFFSET = re.compile(r"^Offset\(([\w.\-]+),\s*(-?\d+)\)$")


def _split_args(text: str) -> List[str]:
    """Split a comma-separated argument list respecting parentheses."""
    args, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        args.append("".join(cur).strip())
    return args


def parse_topology(desc: str):
    """component-node lines -> (ordered layer names, splice specs, context)."""
    order: List[str] = []
    extra: Dict[str, LayerSpec] = {}
    prev_name = "input"
    left = right = 0
    for raw in desc.splitlines():
        line = raw.strip()
        if not line:
            continue
        node_type = line.split()[0]
        if node_type not in ("component-node", "input-node", "output-node"):
            raise CorruptionError(f"unexpected node line: {line}")
        if node_type != "component-node":
            continue
        m = _COMPONENT_NODE.match(line)
        if not m:
            raise CorruptionError(f"cannot parse component-node: {line}")
        comp = m.group(2)
        layer_input = m.group(3).strip()
        m_append = _APPEND.match(layer_input)
        if m_append is not None:
            indices = []
            for field in _split_args(m_append.group(1)):
                m_off = _OFFSET.match(field)
                if m_off:
                    if m_off.group(1) != prev_name:
                        raise CorruptionError(
                            f"Offset references {m_off.group(1)}, expected "
                            f"{prev_name}: {line}")
                    indices.append(int(m_off.group(2)))
                else:
                    if field != prev_name:
                        raise CorruptionError(
                            f"Append arg {field!r}, expected {prev_name!r}")
                    indices.append(0)
            nl = -min(min(indices), 0)
            nr = max(max(indices), 0)
            left += nl
            right += nr
            extra[comp + "__splice"] = LayerSpec(binfmt.LAYER_SPLICE,
                                                 indices=tuple(indices))
            extra[comp + "__narrow"] = LayerSpec(binfmt.LAYER_NARROW,
                                                 narrow_left=nl,
                                                 narrow_right=nr)
            order.extend([comp + "__splice", comp + "__narrow"])
        elif layer_input != prev_name:
            raise CorruptionError(
                f"component input {layer_input!r}, expected {prev_name!r}")
        order.append(comp)
        prev_name = comp
    return order, extra, (left, right)


_TOKEN = re.compile(r"<(\S+?)>")


def _find_token(text: str, name: str, start: int = 0) -> int:
    pos = text.find(f"<{name}>", start)
    if pos < 0:
        raise CorruptionError(f"unable to find token <{name}>")
    return pos


def _read_matrix_after(text: str, token: str, start: int) -> Tuple[np.ndarray, int]:
    pos = _find_token(text, token, start) + len(token) + 2
    open_b = text.index("[", pos)
    close_b = text.index("]", open_b)
    rows = [r for r in text[open_b + 1:close_b].strip().splitlines()
            if r.strip()]
    mat = np.array([[float(v) for v in r.split()] for r in rows], np.float64)
    return mat, close_b + 1


def _read_float_after(text: str, token: str, start: int) -> Tuple[float, int]:
    pos = _find_token(text, token, start) + len(token) + 2
    m = re.match(r"\s*([-\d.eE+]+)", text[pos:])
    if not m:
        raise CorruptionError(f"cannot read float after <{token}>")
    return float(m.group(1)), pos + m.end()


def parse_components(text: str) -> Dict[str, LayerSpec]:
    """The <ComponentName> ... blocks after <NumComponents>."""
    comps: Dict[str, LayerSpec] = {}
    pos = 0
    while True:
        pos = text.find("<ComponentName>", pos)
        if pos < 0:
            break
        m = re.match(r"<ComponentName>\s+(\S+)\s+<(\S+?)>",
                     text[pos:], re.DOTALL)
        if not m:
            raise CorruptionError("cannot parse <ComponentName> block")
        name, tag = m.group(1), m.group(2)
        end_tag = f"</{tag}>"
        end = text.find(end_tag, pos)
        if end < 0:
            raise CorruptionError(f"unterminated <{tag}>")
        body = text[pos:end]
        if tag == "NaturalGradientAffineComponent" or tag == "AffineComponent":
            w, p2 = _read_matrix_after(body, "LinearParams", 0)
            b, _ = _read_matrix_after(body, "BiasParams", p2)
            # Kaldi stores W as [out, in]; NN02 stores [in, out]
            comps[name] = LayerSpec(binfmt.LAYER_LINEAR,
                                    weight=w.T.astype(np.float32),
                                    bias=b.reshape(-1).astype(np.float32))
        elif tag == "RectifiedLinearComponent":
            comps[name] = LayerSpec(binfmt.LAYER_RELU)
        elif tag == "BatchNormComponent":
            eps, p2 = _read_float_after(body, "Epsilon", 0)
            rms, p2 = _read_float_after(body, "TargetRms", p2)
            mean, p2 = _read_matrix_after(body, "StatsMean", p2)
            var, _ = _read_matrix_after(body, "StatsVar", p2)
            scale = np.power(var.reshape(-1) + eps, -0.5) * rms
            offset = -mean.reshape(-1) * scale
            comps[name] = LayerSpec(binfmt.LAYER_BATCHNORM,
                                    scale=scale.astype(np.float32),
                                    offset=offset.astype(np.float32))
        elif tag == "LogSoftmaxComponent":
            comps[name] = LayerSpec(binfmt.LAYER_LOGSOFTMAX)
        elif tag == "SoftmaxComponent":
            comps[name] = LayerSpec(binfmt.LAYER_SOFTMAX)
        elif tag == "NormalizeComponent":
            comps[name] = LayerSpec(binfmt.LAYER_NORMALIZE)
        else:
            raise CorruptionError(f"unexpected component type: {tag}")
        pos = end + len(end_tag)
    return comps


def convert(model_text: str) -> Tuple[NnetSpec, np.ndarray]:
    n3_start = _find_token(model_text, "Nnet3")
    n3_end = model_text.find("</Nnet3>")
    if n3_end < 0:
        raise CorruptionError("unable to find </Nnet3>")
    nnet3 = model_text[n3_start + len("<Nnet3>"):n3_end]
    nc = _find_token(nnet3, "NumComponents")
    order, extra, (left, right) = parse_topology(nnet3[:nc])
    comps = parse_components(nnet3[nc:])
    comps.update(extra)

    layers = []
    for name in order:
        if name not in comps:
            raise CorruptionError(f"layer not found: {name}")
        layers.append(comps[name])
    spec = NnetSpec(left_context=left, right_context=right, layers=layers)

    prior, _ = _read_matrix_after(model_text, "Priors",
                                  _find_token(model_text, "Priors"))
    return spec, prior.reshape(-1).astype(np.float32)


def verify_dims(spec: NnetSpec) -> None:
    """Check the dim chain through linear/splice layers."""
    dim = None
    for i, layer in enumerate(spec.layers):
        if layer.kind == binfmt.LAYER_LINEAR:
            if dim is not None and dim != layer.weight.shape[0]:
                raise CorruptionError(
                    f"layer {i}: input dim {layer.weight.shape[0]} expected, "
                    f"got {dim}")
            dim = layer.weight.shape[1]
        elif layer.kind == binfmt.LAYER_SPLICE and dim is not None:
            dim = dim * len(layer.indices)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(f"Usage: python -m catears_tpu_torch.tools.convert_am "
              f"<text-nnet3-am> <out-prefix>")
        return 1
    with open(argv[0], encoding="utf-8") as fd:
        spec, prior = convert(fd.read())
    verify_dims(spec)
    with open(argv[1] + ".nnet", "wb") as fd:
        binfmt.write_nnet(fd, spec)
    with open(argv[1] + ".prior", "wb") as fd:
        binfmt.write_vec0(fd, prior)
    print(f"wrote {argv[1]}.nnet (left={spec.left_context}, "
          f"right={spec.right_context}, {len(spec.layers)} layers) "
          f"and {argv[1]}.prior ({prior.size} pdfs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
