"""The TDNN-LSTM cell's weights, made from the seed (beside `chain_gen.py`,
whose graph, traffic and feature statistics the cell shares).

`tdnnlstm_device` draws the chain TDNN-LSTM at the configuration's widths
on the card in one normal and one uniform call, as `chain_gen.tdnnf_device`
draws the TDNN-F, with the same distributions: weights randn / sqrt(fan
in) (a peephole, a diagonal weight, has a fan in of 1), biases 0.1 randn
(the forget gate's too, as drawn), batchnorm scale 1 + 0.1 U and offset
0.05 randn; lda that draw applied to the features standardized by
`chain_gen.feature_stats`.  Each LSTMP layer's recurrence scale is
1 - |delay| / decay_time (Kaldi's xconfig sets the forward scale of the
layer's BackpropTruncationComponent so).  Returns the model dict
`lstm_ref` reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def layer_shapes(am: Dict, num_pdfs: int) -> List[Tuple]:
    """Each layer's (name, kind, [in, out] of its matrices): lda, the
    TDNN and LSTMP layers in order, output."""
    feat = len(am["lda_splice"]) * am["num_ceps"] + am["ivector_dim"]
    cell, rec = am["cell_dim"], am["recurrent_projection_dim"]
    proj = rec + am["non_recurrent_projection_dim"]
    out = [("lda", "lda", [(feat, feat)])]
    d = feat
    for x in am["layers"]:
        if x["kind"] == "tdnn":
            out.append((x["name"], "tdnn",
                        [(len(x["offsets"]) * d, am["tdnn_dim"])]))
            d = am["tdnn_dim"]
        else:
            out.append((x["name"], "lstmp",
                        [(d + rec, 4 * cell), (cell, proj)]))
            d = proj
    out.append(("output", "output", [(d, num_pdfs)]))
    return out


def recurrence_scale(am: Dict) -> float:
    return 1.0 - abs(am["lstm_delay"]) / am["decay_time"]


def tdnnlstm_device(g: torch.Generator, device, am: Dict, num_pdfs: int,
                    stats: Tuple[np.ndarray, np.ndarray]) -> Dict:
    """The TDNN-LSTM's model dict (`lstm_ref`'s layout, float32 tensors on
    `device`), drawn in one normal and one uniform call; lda reads the
    spliced MFCC standardized by `stats` (`chain_gen.feature_stats`; the
    i-vector, standard normal, as it is)."""
    shapes = layer_shapes(am, num_pdfs)
    cell = am["cell_dim"]
    n_normal = n_uniform = 0
    for _, kind, mats in shapes:
        n_normal += sum(i * o + o for i, o in mats)
        if kind == "tdnn":
            n_normal += mats[0][1]
            n_uniform += mats[0][1]
        elif kind == "lstmp":
            n_normal += 3 * cell
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    pos = [0, 0]

    def take(n, u=False):
        pos[u] += n
        src = uniform if u else normal
        return src[pos[u] - n:pos[u]]

    def weight(shape):
        return take(shape[0] * shape[1]).view(*shape) / math.sqrt(shape[0])

    splice = am["lda_splice"]
    mean, dev = (np.concatenate([np.tile(x, len(splice)),
                                 np.full(am["ivector_dim"], y)])
                 for x, y in zip(stats, (0.0, 1.0)))
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    dev = torch.as_tensor(dev, dtype=torch.float32, device=device)
    (_, _, [lda]), *body, (_, _, [out]) = shapes
    w = weight(lda) / dev[:, None]
    model = {"lda": {"splice": list(splice), "w": w,
                     "b": 0.1 * take(lda[1]) - mean @ w}, "layers": []}
    scale = recurrence_scale(am)
    for x, (_, kind, mats) in zip(am["layers"], body):
        if kind == "tdnn":
            n = mats[0][1]
            model["layers"].append(dict(
                kind="tdnn", offsets=list(x["offsets"]), w=weight(mats[0]),
                b=0.1 * take(n), scale=1.0 + 0.1 * take(n, True),
                offset=0.05 * take(n)))
        else:
            (w_all, w_rp) = mats
            model["layers"].append(dict(
                kind="lstmp", delay=am["lstm_delay"], scale=scale,
                rec_dim=am["recurrent_projection_dim"],
                w_all=weight(w_all), b=0.1 * take(w_all[1]),
                peephole=take(3 * cell).view(3, cell), w_rp=weight(w_rp),
                b_rp=0.1 * take(w_rp[1])))
    model["output"] = {"delay": am["label_delay"], "w": weight(out),
                       "b": 0.1 * take(out[1])}
    model.update(num_ceps=am["num_ceps"], lifter=am["cepstral_lifter"],
                 subsample=am["frame_subsampling_factor"])
    assert pos == [n_normal, n_uniform]
    return model
