"""Acoustic model: nnet + log-prior + transition->pdf map, with streaming
(port of catears_tpu/am/model.py).

Output is the nnet's log-softmax minus the log-prior (pseudo
log-likelihood).  `forward_padded` takes context-padded features, [L + T + R,
40] for one utterance or [B, L + T + R, 40] for a padded batch, and returns
[T, P] / [B, T, P].  `forward` is the JAX package's whole-utterance host
path (numpy in and out, edges replicated) and `AMStream` its chunked
streaming wrapper.  Both pad the rows to the JAX package's bucketed counts
with the replicated last frame: with `quantized = true` the pad takes part
in each layer's min/max, so another row count would give other int8
log-probs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from catears_tpu_torch.am.nnet import NnetDef, Nnet, build_nnet
from catears_tpu_torch.am.quant import calibrate_ranges, quantize_params
from catears_tpu_torch.frontend.fbank import bucket
from catears_tpu_torch.io.binfmt import read_nnet_file, read_vec0_file
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.utils.device import Device, resolve_device

FEAT_DIM = 40


class AcousticModel(nn.Module):
    def __init__(self, nnet_def: NnetDef, params, log_prior: np.ndarray,
                 tid2pdf: np.ndarray, left_context: int, right_context: int,
                 chunk_size: int, num_pdfs: int, quantized: bool = False,
                 device: Device = "cuda"):
        """params: per-layer dicts of numpy float arrays (build_nnet);
        quantized=True quantizes every linear's weights to int8 here and
        keeps the float stack too, for `calibrate`.  The model lives on
        `device` (the card unless the CPU is asked for)."""
        device = resolve_device(device)
        super().__init__()
        self.nnet_def = nnet_def
        self.quantized = quantized
        self.float_nnet = Nnet(nnet_def, params)
        self.nnet = (quantize_params(nnet_def, params) if quantized
                     else self.float_nnet)
        self.register_buffer("log_prior", torch.as_tensor(
            np.asarray(log_prior, np.float32)))
        self.tid2pdf = np.asarray(tid2pdf, np.int32)
        self.left_context = left_context
        self.right_context = right_context
        self.chunk_size = chunk_size
        self.num_pdfs = num_pdfs
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.log_prior.device

    @classmethod
    def read(cls, conf: Configuration,
             device: Device = "cuda") -> "AcousticModel":
        device = resolve_device(device)
        spec = read_nnet_file(conf.get_path("nnet"))
        nnet_def, params = build_nnet(spec)
        prior = read_vec0_file(conf.get_path("prior"))
        log_prior = np.log(prior)
        left = conf.get_int("left_context")
        right = conf.get_int("right_context")
        chunk = conf.get_int("chunk_size")
        num_pdfs = conf.get_int("num_pdfs")
        tid2pdf = read_vec0_file(conf.get_path("tid2pdf"), np.int32)
        quantized = conf.get_string("quantized", "false").lower() in (
            "true", "1", "yes")
        return cls(nnet_def, params, log_prior, tid2pdf, left, right, chunk,
                   num_pdfs, quantized=quantized, device=device)

    def calibrate(self, padded_feats, margin: float = 0.05,
                  guard: bool = False) -> None:
        """Calibrate the int8 activation ranges on representative
        features: [L + T + R, 40] context-padded fbank rows, or a list of
        them.  Afterwards every linear quantizes with a static range
        (guard=True: widened to any input that exceeds it; see
        quant.calibrate_ranges).  No-op on the float AM."""
        if not self.quantized:
            return
        if not isinstance(padded_feats, (list, tuple)):
            padded_feats = [padded_feats]
        calibrate_ranges(self.nnet_def, self.float_nnet, self.nnet,
                         [torch.as_tensor(x, dtype=torch.float32,
                                          device=self.device)
                          for x in padded_feats],
                         margin=margin, guard=guard)

    def forward_padded(self, feats: torch.Tensor) -> torch.Tensor:
        """Context-padded features -> log-likelihoods (see module doc)."""
        return self.nnet(feats) - self.log_prior

    def _padded_numpy(self, padded: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = self.forward_padded(torch.as_tensor(
                np.asarray(padded, np.float32)).to(self.device))
        return out.cpu().numpy()

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """[T, 40] -> [T, P] (numpy): replicate-pad the edges, pad the rows
        to the bucketed count with the last frame, run the nnet once."""
        t = feats.shape[0]
        if t == 0:
            return np.zeros((0, self.num_pdfs), np.float32)
        padded = np.concatenate([
            self.pad_context(feats),
            np.repeat(feats[-1:], bucket(t) - t, axis=0)])
        return self._padded_numpy(padded)[:t]

    def pad_context(self, feats: np.ndarray) -> np.ndarray:
        return np.concatenate([
            np.repeat(feats[:1], self.left_context, axis=0),
            feats,
            np.repeat(feats[-1:], self.right_context, axis=0),
        ])


class AMStream:
    """Streaming chunked inference with the reference's padding: the first
    frame replicated left_context times at the start, the last frame
    right_context times at the end of the stream."""

    def __init__(self, am: AcousticModel):
        self.am = am
        self._buffer: Optional[np.ndarray] = None  # [n, 40]
        self._started = False

    def process(self, feats: np.ndarray) -> np.ndarray:
        """Append frames; emit chunk_size log-prob rows per full window."""
        am = self.am
        if feats.shape[0] == 0:
            return np.zeros((0, am.num_pdfs), np.float32)
        if not self._started:
            self._buffer = np.repeat(feats[:1], am.left_context, axis=0)
            self._started = True
        self._buffer = np.concatenate([self._buffer, feats])

        outputs: List[np.ndarray] = []
        window = am.left_context + am.right_context + am.chunk_size
        while self._buffer.shape[0] >= window:
            outputs.append(am._padded_numpy(self._buffer[:window]))
            self._buffer = self._buffer[am.chunk_size:]
        if not outputs:
            return np.zeros((0, am.num_pdfs), np.float32)
        return np.concatenate(outputs)

    def end_of_stream(self) -> np.ndarray:
        """Pad the right context with the last frame and flush."""
        am = self.am
        if self._buffer is None or self._buffer.shape[0] == 0:
            return np.zeros((0, am.num_pdfs), np.float32)
        if (self._buffer.shape[0] + am.right_context
                <= am.left_context + am.right_context):
            return np.zeros((0, am.num_pdfs), np.float32)
        t = self._buffer.shape[0] - am.left_context  # valid output rows
        buf = np.concatenate([
            self._buffer,
            np.repeat(self._buffer[-1:], am.right_context + bucket(t) - t,
                      axis=0),
        ])
        out = am._padded_numpy(buf)
        self._buffer = np.zeros((0, FEAT_DIM), np.float32)
        return out[:t]
