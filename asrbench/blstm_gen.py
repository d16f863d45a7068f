"""The BLSTM cell's weights, made from the seed (beside `chain_gen.py`,
whose graph, traffic and feature statistics the cell shares, and
`lstm_gen.py`, whose draw it follows).

`blstm_device` draws the chain BLSTM at the configuration's widths on
the card in one normal call, with `lstm_gen`'s distributions: weights
randn / sqrt(fan in) (a peephole, a diagonal weight, has a fan in of 1),
biases 0.1 randn (the forget gate's too, as drawn); lda that draw
applied to the features standardized by `chain_gen.feature_stats`.  Both
directions of a layer have the recurrence scale 1 - |delay| / decay_time
(Kaldi's xconfig sets the forward scale of each LSTMP's
BackpropTruncationComponent so).  Returns the model dict `blstm_ref`
reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def layer_shapes(am: Dict, num_pdfs: int) -> List[Tuple]:
    """Each layer's (name, kind, [in, out] of its matrices): lda, each
    BLSTM layer (the forward LSTMP's W_all and projection, then the
    backward one's), output."""
    feat = len(am["lda_splice"]) * am["num_ceps"] + am["ivector_dim"]
    cell, rec = am["cell_dim"], am["recurrent_projection_dim"]
    proj = rec + am["non_recurrent_projection_dim"]
    out = [("lda", "lda", [(feat, feat)])]
    d = feat
    for x in am["layers"]:
        out.append((x["name"], "blstmp", [(d + rec, 4 * cell), (cell, proj)]
                    * 2))
        d = 2 * proj
    out.append(("output", "output", [(d, num_pdfs)]))
    return out


def recurrence_scale(am: Dict) -> float:
    return 1.0 - abs(am["lstm_delay"]) / am["decay_time"]


def blstm_device(g: torch.Generator, device, am: Dict, num_pdfs: int,
                 stats: Tuple[np.ndarray, np.ndarray]) -> Dict:
    """The BLSTM's model dict (`blstm_ref`'s layout, float32 tensors on
    `device`), drawn in one normal call; lda reads the spliced MFCC
    standardized by `stats` (`chain_gen.feature_stats`; the i-vector,
    standard normal, as it is)."""
    shapes = layer_shapes(am, num_pdfs)
    cell = am["cell_dim"]
    n_normal = 0
    for _, kind, mats in shapes:
        n_normal += sum(i * o + o for i, o in mats)
        if kind == "blstmp":
            n_normal += 2 * 3 * cell
    normal = torch.randn(n_normal, generator=g, device=device)
    pos = [0]

    def take(n):
        pos[0] += n
        return normal[pos[0] - n:pos[0]]

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

    def lstmp(w_all, w_rp):
        return dict(scale=scale, rec_dim=am["recurrent_projection_dim"],
                    w_all=weight(w_all), b=0.1 * take(w_all[1]),
                    peephole=take(3 * cell).view(3, cell), w_rp=weight(w_rp),
                    b_rp=0.1 * take(w_rp[1]))

    for _, _, (w_all, w_rp, _, _) in body:
        model["layers"].append(dict(kind="blstmp",
                                    delay=abs(am["lstm_delay"]),
                                    forward=lstmp(w_all, w_rp),
                                    backward=lstmp(w_all, w_rp)))
    model["output"] = {"delay": am["label_delay"], "w": weight(out),
                       "b": 0.1 * take(out[1])}
    model.update(num_ceps=am["num_ceps"], lifter=am["cepstral_lifter"],
                 subsample=am["frame_subsampling_factor"])
    assert pos == [n_normal]
    return model
