"""The TDNN-LSTM cell's system under test: the model handed to the PyTorch
port through its public constructors (as `chain_system.py` hands it the
TDNN-F); the port's spans and counters are `chain_system`'s.  Nothing
else of the cell imports the program."""

from __future__ import annotations

from typing import Dict

import numpy as np

from asrbench import lstm_ref


def require_program() -> None:
    """Exit at once, before any set-up, where the program cannot run a
    TDNN-LSTM (no LSTMP layer kind in its NN02 reader)."""
    from catears_tpu_torch.io import binfmt

    if not hasattr(binfmt, "LAYER_LSTMP"):
        raise SystemExit("asrbench: this checkout's program has no LSTMP "
                         "layers (io.binfmt.LAYER_LSTMP): it cannot run a "
                         "TDNN-LSTM")


def nnet_spec(model: Dict, left: int, right: int):
    """The model dict (`lstm_ref`'s layout) as NN02 layers: splice and
    narrow, the i-vector, lda; each TDNN layer a linear (offsets (0,)) or
    a spliced affine, ReLU and batchnorm; each LSTMP layer; the output
    delay and the output affine.  The subsample layer goes right after the
    spliced affine of the first layer computed only at every f-th frame
    (`lstm_ref.grids`) where that layer reads the frames between, else
    before it."""
    from catears_tpu_torch.io import binfmt

    def a(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float32)

    spec = binfmt.LayerSpec
    f = int(model["subsample"])
    splice = tuple(model["lda"]["splice"])
    layers = [spec(binfmt.LAYER_SPLICE, indices=splice),
              spec(binfmt.LAYER_NARROW, narrow_left=-min(splice),
                   narrow_right=max(splice)),
              spec(binfmt.LAYER_IVECTOR, dim=a(model["lda"]["w"]).shape[0]
                   - len(splice) * int(model["num_ceps"])),
              spec(binfmt.LAYER_LINEAR, weight=a(model["lda"]["w"]),
                   bias=a(model["lda"]["b"]))]
    plan = lstm_ref.grids(model, 4)[1:-1]
    first = next((i for i, g in enumerate(plan) if g[1] == f), None) \
        if f > 1 else None
    for i, x in enumerate(model["layers"]):
        sub = spec(binfmt.LAYER_SUBSAMPLE, factor=f)
        fused = i == first and x["kind"] == "tdnn" \
            and any(o % f for o in x["offsets"])
        if i == first and not fused:
            layers.append(sub)
        if x["kind"] == "lstmp":
            layers.append(spec(
                binfmt.LAYER_LSTMP, delay=int(x["delay"]),
                rec_scale=float(x["scale"]), rec_dim=int(x["rec_dim"]),
                weight=a(x["w_all"]), bias=a(x["b"]),
                peephole=a(x["peephole"]), projection=a(x["w_rp"]),
                projection_bias=a(x["b_rp"])))
            continue
        if tuple(x["offsets"]) == (0,):
            layers.append(spec(binfmt.LAYER_LINEAR, weight=a(x["w"]),
                               bias=a(x["b"])))
        else:
            layers.append(spec(binfmt.LAYER_SPLICED_AFFINE,
                               offsets=tuple(x["offsets"]), weight=a(x["w"]),
                               bias=a(x["b"])))
        if fused:
            layers.append(sub)
        layers += [spec(binfmt.LAYER_RELU),
                   spec(binfmt.LAYER_BATCHNORM, scale=a(x["scale"]),
                        offset=a(x["offset"]))]
    layers += [spec(binfmt.LAYER_DELAY, delay=int(model["output"]["delay"])),
               spec(binfmt.LAYER_LINEAR, weight=a(model["output"]["w"]),
                    bias=a(model["output"]["b"]))]
    return binfmt.NnetSpec(left_context=left, right_context=right,
                           layers=layers)


def acoustic_model(model: Dict, am_cfg: Dict, num_pdfs: int,
                   tid2pdf: np.ndarray, device):
    """The program's AcousticModel of the TDNN-LSTM: no prior, MFCC input
    (folded into lda); the nnet states the subsampling factor and the
    i-vector width."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet

    left, right = am_cfg["context"]
    nnet_def, params = build_nnet(nnet_spec(model, left, right))
    return AcousticModel(
        nnet_def, params, None, tid2pdf, left, right, chunk_size=50,
        num_pdfs=num_pdfs, device=device, feature_type="mfcc")
