"""The chain cell's system under test: the TDNN-F model handed to the
PyTorch port through its public constructors (as `system.py` hands it the
TDNN), and the port's spans and counters, which the chain kind reads in
its traced runs.  Nothing else of the chain cell imports the program."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def require_program() -> None:
    """Exit at once, before any set-up, where the program cannot run a
    chain model (no TDNN-F layer kinds in its NN02 reader)."""
    from catears_tpu_torch.io import binfmt

    if not hasattr(binfmt, "LAYER_TDNNF"):
        raise SystemExit("asrbench: this checkout's program has no TDNN-F "
                         "layers (io.binfmt.LAYER_TDNNF): it cannot run a "
                         "chain model")


def nnet_spec(model: Dict, left: int, right: int):
    """The model dict (`chain_ref`'s layout) as NN02 layers: splice
    (-1, 0, 1) and narrow, the i-vector appended, lda, tdnn1, the blocks
    with a subsample layer before the first whose stride the factor
    divides (stride 0 included), prefinal-l, prefinal-chain, output."""
    from catears_tpu_torch.io import binfmt

    def a(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float32)

    spec = binfmt.LayerSpec
    factor = int(model["subsample"])
    feat = 3 * int(model["num_ceps"])
    layers = [spec(binfmt.LAYER_SPLICE, indices=(-1, 0, 1)),
              spec(binfmt.LAYER_NARROW, narrow_left=1, narrow_right=1),
              spec(binfmt.LAYER_IVECTOR,
                   dim=a(model["lda"]["w"]).shape[0] - feat),
              spec(binfmt.LAYER_LINEAR, weight=a(model["lda"]["w"]),
                   bias=a(model["lda"]["b"]))]
    t = model["tdnn1"]
    layers += [spec(binfmt.LAYER_LINEAR, weight=a(t["w"]), bias=a(t["b"])),
               spec(binfmt.LAYER_RELU),
               spec(binfmt.LAYER_BATCHNORM, scale=a(t["scale"]),
                    offset=a(t["offset"]))]
    sub = factor == 1
    for x in model["tdnnf"]:
        if not sub and int(x["stride"]) % factor == 0:
            layers.append(spec(binfmt.LAYER_SUBSAMPLE, factor=factor))
            sub = True
        layers.append(spec(binfmt.LAYER_TDNNF, stride=int(x["stride"]),
                           bypass=float(model["bypass"]),
                           linear=a(x["w_l"]), affine=a(x["w_a"]),
                           bias=a(x["b"]), scale=a(x["scale"]),
                           offset=a(x["offset"])))
    p = model["prefinal_chain"]
    layers += [spec(binfmt.LAYER_SPLICED_LINEAR, offsets=(0,),
                    weight=a(model["prefinal_l"]["w"])),
               spec(binfmt.LAYER_LINEAR, weight=a(p["w1"]), bias=a(p["b1"])),
               spec(binfmt.LAYER_RELU),
               spec(binfmt.LAYER_BATCHNORM, scale=a(p["scale1"]),
                    offset=a(p["offset1"])),
               spec(binfmt.LAYER_SPLICED_LINEAR, offsets=(0,),
                    weight=a(p["w2"])),
               spec(binfmt.LAYER_BATCHNORM, scale=a(p["scale2"]),
                    offset=a(p["offset2"])),
               spec(binfmt.LAYER_LINEAR, weight=a(model["output"]["w"]),
                    bias=a(model["output"]["b"]))]
    return binfmt.NnetSpec(left_context=left, right_context=right,
                           layers=layers)


def acoustic_model(model: Dict, am_cfg: Dict, num_pdfs: int,
                   tid2pdf: np.ndarray, device):
    """The program's AcousticModel of the chain model: no prior, MFCC
    input (the program folds its DCT and lifter into lda); the nnet
    states the subsampling factor and the i-vector width."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet

    left, right = am_cfg["context"]
    nnet_def, params = build_nnet(nnet_spec(model, left, right))
    return AcousticModel(
        nnet_def, params, None, tid2pdf, left, right, chunk_size=50,
        num_pdfs=num_pdfs, device=device, feature_type="mfcc")


def batched_logp(am, waves, ivectors):
    from catears_tpu_torch.runtime.batch import batched_logp as fn

    return fn(am, waves, ivectors)


def start_tracing() -> None:
    from catears_tpu_torch.utils import log

    log.start_tracing()


def stop_tracing() -> List:
    """Stops the program's tracing; its spans, device times resolved."""
    from catears_tpu_torch.utils import log

    log.stop_tracing()
    return log.spans()


def counters() -> Dict[str, float]:
    from catears_tpu_torch.utils import log

    return log.metrics()
