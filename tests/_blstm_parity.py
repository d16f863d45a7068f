"""Shared pieces of the chain BLSTM tests (tests/test_torch_blstm.py on
the CPU, the card tests): a seeded random chain BLSTM in
`blstm_reference`'s layout, its NN02 layers, and a chain model directory
the Recognizer and the CLI read.  Imports no JAX."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

import blstm_reference as ref
from _tdnnf_parity import chain_graph
from catears_tpu_torch.io import binfmt

FEAT = 40
# Small chunks for the CPU: 30 frames (10 output rows at subsampling 3),
# 12 frames (4 rows) of extra context, none at the utterance's edges.
CHUNK = {"frames_per_chunk": 30, "extra_left_context": 12,
         "extra_right_context": 12, "extra_left_context_initial": 0,
         "extra_right_context_final": 0}
# The recipe's decode settings (run_blstm_6j.sh's decode stage).
RECIPE_CHUNK = {"frames_per_chunk": 150, "extra_left_context": 50,
                "extra_right_context": 50, "extra_left_context_initial": 0,
                "extra_right_context_final": 0}


def _lstmp(rng, d: int, cell: int, rec: int, nonrec: int,
           scale: float) -> Dict:
    def w(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    return {"scale": scale, "rec_dim": rec, "w_all": w(d + rec, 4 * cell),
            "b": (0.1 * rng.randn(4 * cell)).astype(np.float32),
            "peephole": (0.5 * rng.randn(3, cell)).astype(np.float32),
            "w_rp": w(cell, rec + nonrec),
            "b_rp": (0.1 * rng.randn(rec + nonrec)).astype(np.float32)}


def make_model(rng: np.random.RandomState, layers: int = 2, cell: int = 16,
               rec: int = 8, nonrec: int = 8, scale: float = 0.85,
               pdfs: int = 48, ivector_dim: int = 10, subsample: int = 3,
               delay: int = 3) -> Dict:
    """A chain BLSTM with seeded weights (randn / sqrt(fan in), biases
    0.1 randn, peepholes 0.5 randn): lda over MFCC -2..2 and the
    i-vector, `layers` BLSTM layers, the output affine."""
    lda = 5 * FEAT + ivector_dim
    m = {"lda": {"splice": [-2, -1, 0, 1, 2],
                 "w": (rng.randn(lda, lda) / np.sqrt(lda)).astype(
                     np.float32),
                 "b": (0.1 * rng.randn(lda)).astype(np.float32)},
         "layers": [], "num_ceps": FEAT, "lifter": 22.0,
         "subsample": subsample}
    d = lda
    for _ in range(layers):
        m["layers"].append({
            "kind": "blstmp", "delay": delay,
            "forward": _lstmp(rng, d, cell, rec, nonrec, scale),
            "backward": _lstmp(rng, d, cell, rec, nonrec, scale)})
        d = 2 * (rec + nonrec)
    m["output"] = {"delay": 0,
                   "w": (rng.randn(d, pdfs) / np.sqrt(d)).astype(np.float32),
                   "b": (0.1 * rng.randn(pdfs)).astype(np.float32)}
    return m


def _lstmp_spec(kind: int, delay: int, p: Dict) -> binfmt.LayerSpec:
    return binfmt.LayerSpec(
        kind, delay=delay, rec_scale=float(p["scale"]),
        rec_dim=int(p["rec_dim"]), weight=p["w_all"], bias=p["b"],
        peephole=p["peephole"], projection=p["w_rp"],
        projection_bias=p["b_rp"])


def nnet_spec(m: Dict) -> binfmt.NnetSpec:
    """The model as NN02 layers: splice and narrow, the i-vector, lda, the
    subsample layer (the BLSTMs recur at the output rate), each BLSTM
    layer (kind 17), the output affine."""
    spec = binfmt.LayerSpec
    splice = tuple(m["lda"]["splice"])
    layers = [spec(binfmt.LAYER_SPLICE, indices=splice),
              spec(binfmt.LAYER_NARROW, narrow_left=-min(splice),
                   narrow_right=max(splice)),
              spec(binfmt.LAYER_IVECTOR,
                   dim=m["lda"]["w"].shape[0] - len(splice) * m["num_ceps"]),
              spec(binfmt.LAYER_LINEAR, weight=m["lda"]["w"],
                   bias=m["lda"]["b"]),
              spec(binfmt.LAYER_SUBSAMPLE, factor=int(m["subsample"]))]
    for x in m["layers"]:
        layer = _lstmp_spec(binfmt.LAYER_BLSTMP, -int(x["delay"]),
                            x["forward"])
        layer.backward = _lstmp_spec(binfmt.LAYER_LSTMP, int(x["delay"]),
                                     x["backward"])
        layers.append(layer)
    layers.append(spec(binfmt.LAYER_LINEAR, weight=m["output"]["w"],
                       bias=m["output"]["b"]))
    left, right = ref.context(m)
    return binfmt.NnetSpec(left, right, layers)


def chunk_conf(chunk: Dict) -> str:
    """The chunk settings as configuration lines."""
    return "".join(f"{k} = {v}\n" for k, v in chunk.items())


def write_blstm_model(out: str, rng: np.random.RandomState,
                      chunk: Dict = CHUNK, extra: str = "",
                      **kw) -> Tuple[str, Dict, int]:
    """A chain BLSTM model directory (pk::fst_0 graph in chain topology,
    NN02 nnet, tid2pdf, words, a config with am_scale 1.0, MFCC features,
    no prior and the chunk settings; chunk None: none); (config path,
    model, i-vector width)."""
    os.makedirs(out, exist_ok=True)
    fst, tid2pdf, num_pdfs, _ = chain_graph(rng)
    model = make_model(rng, pdfs=num_pdfs, **kw)
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
    conf = os.path.join(out, "blstm.conf")
    with open(conf, "w") as fd:
        fd.write(f"fst = graph.fst\nnnet = am.nnet\ntid2pdf = am.tid2pdf\n"
                 f"symbol_table = words.txt\nleft_context = "
                 f"{spec.left_context}\nright_context = "
                 f"{spec.right_context}\nchunk_size = 20\nnum_pdfs = "
                 f"{num_pdfs}\nam_scale = 1.0\nfeature_type = mfcc\n"
                 f"beam_size = 256\nexpand_size = 4096\n"
                 + (chunk_conf(chunk) if chunk else "") + extra)
    return conf, model, dim
