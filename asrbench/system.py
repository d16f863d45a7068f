"""The system under test: the benchmark's inputs handed to the PyTorch
port (`catears_tpu_torch`) through its public constructors.  Nothing else
of the harness imports the program, and the reference never does."""

from __future__ import annotations

import os
from typing import List

import numpy as np


def flat_fst(g):
    from catears_tpu_torch.graph.fst import FlatFst

    return FlatFst.from_arrays(g.start, g.final, g.src, g.dst, g.ilabel,
                               g.olabel, g.weight)


def delta_lm(big):
    from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst, LmFst
    from catears_tpu_torch.io.symbols import SymbolTable

    base = FlatFst.from_arrays(big.start, big.final, big.src, big.dst,
                               big.label, big.label, big.weight)
    table = SymbolTable()
    table.bos_id, table.eos_id = big.bos_id, big.eos_id
    return DeltaLmFst(big.small_lm, LmFst(**base.__dict__), table)


def nnet_spec(layers: List[dict], left: int, right: int):
    from catears_tpu_torch.io import binfmt

    kinds = {"splice": binfmt.LAYER_SPLICE, "narrow": binfmt.LAYER_NARROW,
             "linear": binfmt.LAYER_LINEAR, "relu": binfmt.LAYER_RELU,
             "batchnorm": binfmt.LAYER_BATCHNORM,
             "logsoftmax": binfmt.LAYER_LOGSOFTMAX}
    specs = []
    for x in layers:
        spec = binfmt.LayerSpec(kinds[x["kind"]])
        if x["kind"] == "splice":
            spec.indices = tuple(x["indices"])
        elif x["kind"] == "narrow":
            spec.narrow_left, spec.narrow_right = x["left"], x["right"]
        elif x["kind"] == "linear":
            spec.weight, spec.bias = x["w"], x["b"]
        elif x["kind"] == "batchnorm":
            spec.scale, spec.offset = x["scale"], x["offset"]
        specs.append(spec)
    return binfmt.NnetSpec(left_context=left, right_context=right,
                           layers=specs)


def acoustic_model(layers: List[dict], left: int, right: int, num_pdfs: int,
                   tid2pdf: np.ndarray, device):
    """The float AM over a uniform prior (the program's AcousticModel)."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet

    nnet_def, params = build_nnet(nnet_spec(layers, left, right))
    prior = np.full(num_pdfs, 1.0 / num_pdfs, np.float32)
    return AcousticModel(nnet_def, params, np.log(prior), tid2pdf, left,
                         right, chunk_size=50, num_pdfs=num_pdfs,
                         device=device)


def beam_config(dc: dict):
    from catears_tpu_torch.decode.beam import BeamConfig

    return BeamConfig(beam_size=dc["beam_size"],
                      expand_size=dc["expand_size"],
                      eps_expand_size=dc["eps_expand_size"],
                      lm_expand_size=dc.get("lm_expand_size", 0),
                      max_eps_iters=dc["max_eps_iters"], beam=dc["beam"],
                      am_scale=dc["am_scale"])


def batch_decoder(g, dc: dict, dlm, device):
    """BatchDecoder over the raw graph: the program prepares and builds
    its own decode graph from it."""
    from catears_tpu_torch.decode.decoder import BatchDecoder

    return BatchDecoder(flat_fst(g), g.tid2pdf, am_scale=dc["am_scale"],
                        delta_lm=dlm, config=beam_config(dc),
                        chunk_frames=dc["chunk_frames"],
                        arc_group=dc["arc_group"],
                        csr_group=dc["csr_group"], device=device)


def batched_logp(am, waves):
    from catears_tpu_torch.runtime.batch import batched_logp as fn

    return fn(am, waves)


def write_model_dir(out: str, g, layers: List[dict], left: int, right: int,
                    dc: dict) -> str:
    """A model directory the program's Recognizer reads (pk::fst_0 graph,
    NN02 nnet, VEC0 prior and tid2pdf, words, config); returns the config
    path."""
    from catears_tpu_torch.io import binfmt

    os.makedirs(out, exist_ok=True)
    fst = flat_fst(g)
    with open(os.path.join(out, "graph.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, fst.to_raw())
    with open(os.path.join(out, "am.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, nnet_spec(layers, left, right))
    with open(os.path.join(out, "am.prior"), "wb") as fd:
        binfmt.write_vec0(fd, np.full(g.num_pdfs, 1.0 / g.num_pdfs,
                                      np.float32))
    with open(os.path.join(out, "am.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, np.asarray(g.tid2pdf, np.int32))
    with open(os.path.join(out, "words.txt"), "w") as fd:
        fd.write("<eps> 0\n")
        fd.writelines(f"word{i} {i}\n" for i in range(1, g.num_words + 1))
        fd.write(f"<s> {g.num_words + 1}\n</s> {g.num_words + 2}\n")
    conf = os.path.join(out, "model.conf")
    keys = {"fst": "graph.fst", "nnet": "am.nnet", "prior": "am.prior",
            "tid2pdf": "am.tid2pdf", "symbol_table": "words.txt",
            "left_context": left, "right_context": right,
            "chunk_size": 20, "num_pdfs": g.num_pdfs,
            "arc_group": dc["arc_group"], "csr_group": dc["csr_group"],
            "beam_size": dc["beam_size"], "expand_size": dc["expand_size"],
            "eps_expand_size": dc["eps_expand_size"],
            "max_eps_iters": dc["max_eps_iters"], "beam": dc["beam"]}
    with open(conf, "w") as fd:
        fd.writelines(f"{k} = {v}\n" for k, v in keys.items())
    return conf


def recognizer(conf: str, device):
    from catears_tpu_torch.runtime.recognizer import AM_SCALE, Recognizer

    return Recognizer(conf, device=device), AM_SCALE


def decode_layer():
    """(init_beam_batch, decode_chunk): the decoder frame loop's entry,
    for the traced run's count of the work per frame."""
    from catears_tpu_torch.decode.beam import decode_chunk, init_beam_batch

    return init_beam_batch, decode_chunk
