"""Shared pieces of the TDNN-LSTM tests (tests/test_torch_tdnn_lstm.py on
the CPU): a seeded random chain TDNN-LSTM in `tdnn_lstm_reference`'s
layout, its NN02 layers, and a chain model directory the Recognizer and
the CLI read.  Imports no JAX."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

import tdnn_lstm_reference as ref
from _tdnnf_parity import chain_graph
from catears_tpu_torch.io import binfmt

FEAT = 40
# The layers of the tests' two plans, (kind, offsets or delay), and their
# output delays.  "sub": the LSTMs recur at the subsampled rate, the
# second TDNN computing only the subsampled rows (context (11, 1)); "full":
# the first LSTM recurs at every frame, three interleaved chains of rows
# (context (5, 1)); "recipe": run_tdnn_lstm.sh's layers (context (21, 11)).
PLANS = {
    "sub": ((("tdnn", (0,)), ("tdnn", (-1, 0, 1)), ("lstmp", -3),
             ("tdnn", (-3, 0, 3)), ("lstmp", -3)), 5),
    "full": ((("tdnn", (0,)), ("lstmp", -3), ("tdnn", (-1, 0, 1)),
              ("lstmp", -3)), 2),
    "recipe": ((("tdnn", (0,)), ("tdnn", (-1, 0, 1)), ("tdnn", (-1, 0, 1)),
                ("lstmp", -3), ("tdnn", (-3, 0, 3)), ("tdnn", (-3, 0, 3)),
                ("lstmp", -3), ("tdnn", (-3, 0, 3)), ("tdnn", (-3, 0, 3)),
                ("lstmp", -3)), 5),
}


def make_model(rng: np.random.RandomState, plan: str = "sub",
               dim: int = 32, cell: int = 32, rec: int = 8, nonrec: int = 8,
               scale: float = 0.85, pdfs: int = 48, ivector_dim: int = 10,
               subsample: int = 3) -> Dict:
    """A chain TDNN-LSTM with seeded weights (randn / sqrt(fan in),
    biases 0.1 randn, batchnorm scale 1 + 0.1 U and offset 0.05 randn,
    peepholes 0.5 randn)."""
    def w(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def v(n, s):
        return (rng.randn(n) * s).astype(np.float32)

    lda = 5 * FEAT + ivector_dim
    m = {"lda": {"splice": [-2, -1, 0, 1, 2], "w": w(lda, lda),
                 "b": v(lda, 0.1)},
         "layers": [], "num_ceps": FEAT, "lifter": 22.0,
         "subsample": subsample}
    d = lda
    layers, output_delay = PLANS[plan]
    for kind, arg in layers:
        if kind == "tdnn":
            m["layers"].append({
                "kind": "tdnn", "offsets": list(arg),
                "w": w(len(arg) * d, dim), "b": v(dim, 0.1),
                "scale": (1.0 + 0.1 * rng.rand(dim)).astype(np.float32),
                "offset": v(dim, 0.05)})
            d = dim
        else:
            m["layers"].append({
                "kind": "lstmp", "delay": arg, "scale": scale,
                "rec_dim": rec, "w_all": w(d + rec, 4 * cell),
                "b": v(4 * cell, 0.1), "peephole": v(3 * cell, 0.5).reshape(
                    3, cell), "w_rp": w(cell, rec + nonrec),
                "b_rp": v(rec + nonrec, 0.1)})
            d = rec + nonrec
    m["output"] = {"delay": output_delay, "w": w(d, pdfs),
                   "b": v(pdfs, 0.1)}
    return m


def nnet_spec(m: Dict) -> binfmt.NnetSpec:
    """The model as NN02 layers: splice and narrow, the i-vector, lda;
    each TDNN layer a linear (offsets (0,)) or a spliced affine, ReLU and
    batchnorm; each LSTMP layer; the output delay and the output affine.
    The subsample layer goes before the first layer computed only at
    every f-th frame (the reference's plan), or right after its spliced
    affine where that layer reads the frames between."""
    spec = binfmt.LayerSpec
    f = int(m["subsample"])
    splice = tuple(m["lda"]["splice"])
    layers = [spec(binfmt.LAYER_SPLICE, indices=splice),
              spec(binfmt.LAYER_NARROW, narrow_left=-min(splice),
                   narrow_right=max(splice)),
              spec(binfmt.LAYER_IVECTOR,
                   dim=m["lda"]["w"].shape[0] - len(splice) * m["num_ceps"]),
              spec(binfmt.LAYER_LINEAR, weight=m["lda"]["w"],
                   bias=m["lda"]["b"])]
    plan = ref.grids(m, 4)[1:-1]
    first = next((i for i, g in enumerate(plan) if g[1] == f), None) \
        if f > 1 else None
    for i, x in enumerate(m["layers"]):
        sub = spec(binfmt.LAYER_SUBSAMPLE, factor=f)
        fused = i == first and x["kind"] == "tdnn" \
            and any(o % f for o in x["offsets"])
        if i == first and not fused:
            layers.append(sub)
        if x["kind"] == "lstmp":
            layers.append(spec(
                binfmt.LAYER_LSTMP, delay=x["delay"], rec_scale=x["scale"],
                rec_dim=x["rec_dim"], weight=x["w_all"], bias=x["b"],
                peephole=x["peephole"], projection=x["w_rp"],
                projection_bias=x["b_rp"]))
            continue
        if tuple(x["offsets"]) == (0,):
            layers.append(spec(binfmt.LAYER_LINEAR, weight=x["w"],
                               bias=x["b"]))
        else:
            layers.append(spec(binfmt.LAYER_SPLICED_AFFINE,
                               offsets=tuple(x["offsets"]), weight=x["w"],
                               bias=x["b"]))
        if fused:
            layers.append(sub)
        layers += [spec(binfmt.LAYER_RELU),
                   spec(binfmt.LAYER_BATCHNORM, scale=x["scale"],
                        offset=x["offset"])]
    layers += [spec(binfmt.LAYER_DELAY, delay=int(m["output"]["delay"])),
               spec(binfmt.LAYER_LINEAR, weight=m["output"]["w"],
                    bias=m["output"]["b"])]
    left, right = ref.context(m)
    return binfmt.NnetSpec(left, right, layers)


def write_lstm_model(out: str, rng: np.random.RandomState,
                     plan: str = "sub", extra: str = "",
                     **kw) -> Tuple[str, Dict, int]:
    """A chain TDNN-LSTM model directory (pk::fst_0 graph in chain
    topology, NN02 nnet, tid2pdf, words, a config with am_scale 1.0 and
    MFCC features, no prior); (config path, model, i-vector width)."""
    os.makedirs(out, exist_ok=True)
    fst, tid2pdf, num_pdfs, _ = chain_graph(rng)
    model = make_model(rng, plan, pdfs=num_pdfs, **kw)
    spec = nnet_spec(model)
    with open(os.path.join(out, "graph.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, fst.to_raw())
    with open(os.path.join(out, "am.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, spec)
    with open(os.path.join(out, "am.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, tid2pdf)
    with open(os.path.join(out, "words.txt"), "w") as fd:
        fd.write("<eps> 0\n")
        fd.writelines(f"w{i} {i}\n" for i in range(1, 41))
        fd.write("<s> 41\n</s> 42\n")
    dim = spec.layers[2].dim
    conf = os.path.join(out, "lstm.conf")
    with open(conf, "w") as fd:
        fd.write(f"fst = graph.fst\nnnet = am.nnet\ntid2pdf = am.tid2pdf\n"
                 f"symbol_table = words.txt\nleft_context = "
                 f"{spec.left_context}\nright_context = "
                 f"{spec.right_context}\nchunk_size = 20\nnum_pdfs = "
                 f"{num_pdfs}\nam_scale = 1.0\nfeature_type = mfcc\n"
                 f"beam_size = 256\nexpand_size = 4096\n" + extra)
    return conf, model, dim
