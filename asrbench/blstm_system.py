"""The BLSTM cell's system under test: the model handed to the PyTorch
port through its public constructors (as `lstm_system.py` hands it the
TDNN-LSTM), with the configuration's chunk settings; the port's spans and
counters are `chain_system`'s.  Nothing else of the cell imports the
program."""

from __future__ import annotations

from typing import Dict

import numpy as np


def require_program() -> None:
    """Exit at once, before any set-up, where the program cannot run a
    BLSTM (no bidirectional LSTMP layer kind in its NN02 reader)."""
    from catears_tpu_torch.io import binfmt

    if not hasattr(binfmt, "LAYER_BLSTMP"):
        raise SystemExit("asrbench: this checkout's program has no "
                         "bidirectional LSTMP layers (io.binfmt.LAYER_BLSTMP):"
                         " it cannot run a BLSTM")


def nnet_spec(model: Dict, left: int, right: int):
    """The model dict (`blstm_ref`'s layout) as NN02 layers: splice and
    narrow, the i-vector, lda, the subsample layer (the BLSTMs recur at
    the output rate), each BLSTM layer (kind 17: the forward LSTMP's
    parameters, its backward one's), the output affine."""
    from catears_tpu_torch.io import binfmt

    def a(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float32)

    def lstmp(kind, delay, p):
        return binfmt.LayerSpec(
            kind, delay=delay, rec_scale=float(p["scale"]),
            rec_dim=int(p["rec_dim"]), weight=a(p["w_all"]), bias=a(p["b"]),
            peephole=a(p["peephole"]), projection=a(p["w_rp"]),
            projection_bias=a(p["b_rp"]))

    spec = binfmt.LayerSpec
    splice = tuple(model["lda"]["splice"])
    layers = [spec(binfmt.LAYER_SPLICE, indices=splice),
              spec(binfmt.LAYER_NARROW, narrow_left=-min(splice),
                   narrow_right=max(splice)),
              spec(binfmt.LAYER_IVECTOR, dim=a(model["lda"]["w"]).shape[0]
                   - len(splice) * int(model["num_ceps"])),
              spec(binfmt.LAYER_LINEAR, weight=a(model["lda"]["w"]),
                   bias=a(model["lda"]["b"])),
              spec(binfmt.LAYER_SUBSAMPLE, factor=int(model["subsample"]))]
    for x in model["layers"]:
        d = int(x["delay"])
        layer = lstmp(binfmt.LAYER_BLSTMP, -d, x["forward"])
        layer.backward = lstmp(binfmt.LAYER_LSTMP, d, x["backward"])
        layers.append(layer)
    layers.append(spec(binfmt.LAYER_LINEAR, weight=a(model["output"]["w"]),
                       bias=a(model["output"]["b"])))
    return binfmt.NnetSpec(left_context=left, right_context=right,
                           layers=layers)


def acoustic_model(model: Dict, am_cfg: Dict, chunk: Dict, num_pdfs: int,
                   tid2pdf: np.ndarray, device):
    """The program's AcousticModel of the BLSTM: no prior, MFCC input
    (folded into lda), evaluated in the configuration's chunks (`chunk`,
    Kaldi's option names); the nnet states the subsampling factor and the
    i-vector width."""
    from catears_tpu_torch.am.chunks import ChunkOptions
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet

    left, right = am_cfg["context"]
    nnet_def, params = build_nnet(nnet_spec(model, left, right))
    return AcousticModel(
        nnet_def, params, None, tid2pdf, left, right, chunk_size=50,
        num_pdfs=num_pdfs, device=device, feature_type="mfcc",
        chunking=ChunkOptions(**chunk))
