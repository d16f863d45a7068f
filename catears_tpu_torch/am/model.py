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

A chain model (Kaldi's TDNN-F, am/nnet.py) differs in four ways.  Its
nnet states two of them: the frame subsampling factor f
(`frame_subsampling_factor`: its stack keeps every f-th row from its
subsample layer on, so `forward_padded` gives ceil(T / f) rows, row u for
input frame f u) and the i-vector it appends per utterance (`ivector_dim`;
`forward_padded(feats, ivectors)`).  Its configuration states the other
two: no prior (outputs are log-likelihoods as they stand: `prior` may be
left out), and MFCC input (`feature_type = mfcc`: the chain recipes'
hires MFCC, whose DCT and lifter are folded into the first affine here,
so the stack takes fbank rows).
Tracing, `forward_padded` spans the stack up to its subsample layer as
`am.full_rate` and the rest as `am.subsampled` (CUDA-event spans on a
card), and counts `am_rows_full_rate` and `am_rows_subsampled`, the
[B x T] rows each part put out (a stack with no subsample layer is all
full rate); the linears count `am_flops`.  Live streaming runs only
models of one row per 10 ms frame with no i-vector
(`require_streamable`).

The chain TDNN-LSTM (am/nnet.py's `lstmp`, `spliced_affine` and `delay`
kinds) is such a model too.  `forward_padded(..., frames=)` tells it the
longest utterance's valid frames, so that each recurrence steps only to
the last row a valid output reads, not to the padded length.  Its
subsampled part starts at the spliced affine that computes only the
subsample layer's rows.

The chain BLSTM (a `blstmp` layer, NN02 kind 17) cannot run looped: its
configuration gives Kaldi's chunk settings (`frames_per_chunk`,
`extra_left_context`, `extra_right_context`, `extra_left_context_initial`,
`extra_right_context_final`; am/chunks.py), without which it is refused,
and `forward_padded(..., lengths=)`, told each utterance's frames
(`batched_logp` passes them), cuts every utterance into its chunks,
gathers all chunk windows' inputs in one gather, runs the stack over the
windows, the layers after the last recurrence (the output affine) at the
kept rows only, and scatters those into [B, rows_max, P].  A chunked
stack consumes its context and subsamples before its first recurrence.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from catears_tpu_torch.am.chunks import ChunkOptions, plan_chunks
from catears_tpu_torch.am.nnet import (RECURRENT, TDNN_KINDS, NnetDef, Nnet,
                                       build_nnet, context_frames,
                                       fold_feature_map, frame_subsampling,
                                       ivector_dim)
from catears_tpu_torch.am.quant import calibrate_ranges, quantize_params
from catears_tpu_torch.frontend.fbank import bucket
from catears_tpu_torch.frontend.mfcc import mfcc_matrix
from catears_tpu_torch.io.binfmt import read_nnet_file, read_vec0_file
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import (CorruptionError,
                                            NotImplementedError_)

FEAT_DIM = 40


class AcousticModel(nn.Module):
    def __init__(self, nnet_def: NnetDef, params,
                 log_prior: Optional[np.ndarray], tid2pdf: np.ndarray,
                 left_context: int, right_context: int, chunk_size: int,
                 num_pdfs: int, quantized: bool = False,
                 device: Device = "cuda", feature_type: str = "fbank",
                 chunking: Optional[ChunkOptions] = None):
        """params: per-layer dicts of numpy float arrays (build_nnet);
        quantized=True quantizes every linear's weights to int8 here and
        keeps the float stack too, for `calibrate`.  The model lives on
        `device` (the card unless the CPU is asked for).  log_prior None:
        a chain model's, outputs taken as they are.  A stack of TDNN-F
        layers must consume exactly the given context.  feature_type
        "mfcc": frontend.mfcc's map is folded into the first linear
        (am.nnet.fold_feature_map).  chunking: Kaldi's chunk settings
        (am/chunks.py), which a stack with a backward recurrence needs and
        no other takes."""
        device = resolve_device(device)
        super().__init__()
        if feature_type not in ("fbank", "mfcc"):
            raise CorruptionError(
                f"feature_type {feature_type!r}: fbank or mfcc")
        tdnnf_stack = any(layer[0] in TDNN_KINDS for layer in nnet_def)
        if tdnnf_stack and context_frames(nnet_def) != (left_context,
                                                         right_context):
            raise CorruptionError(
                f"context ({left_context}, {right_context}); the nnet "
                f"consumes {context_frames(nnet_def)}")
        if quantized and tdnnf_stack:
            raise NotImplementedError_(
                "quantized = true takes the plain TDNN layer kinds only")
        self.chunking = chunking
        self._tail = chunked_tail(nnet_def, chunking)
        if feature_type == "mfcc":
            params = fold_feature_map(nnet_def, params, mfcc_matrix())
        self.nnet_def = nnet_def
        self.quantized = quantized
        self.float_nnet = Nnet(nnet_def, params)
        self.nnet = (quantize_params(nnet_def, params) if quantized
                     else self.float_nnet)
        self.has_prior = log_prior is not None
        self.register_buffer("log_prior", torch.as_tensor(
            np.asarray(log_prior, np.float32) if self.has_prior
            else np.zeros(num_pdfs, np.float32)))
        self.tid2pdf = np.asarray(tid2pdf, np.int32)
        self.left_context = left_context
        self.right_context = right_context
        self.chunk_size = chunk_size
        self.num_pdfs = num_pdfs
        self.frame_subsampling_factor = frame_subsampling(nnet_def)
        self.ivector_dim = ivector_dim(nnet_def)
        # The stack's full-rate part: the layers before its first
        # subsample layer (all of them without one), or before the spliced
        # layer that computes only the subsample layer's rows.
        self._split = next((i for i, layer in enumerate(nnet_def)
                            if layer[0] == "subsample"), len(nnet_def))
        if self._split in self.float_nnet.fused:
            self._split -= 1
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
        log_prior = (np.log(read_vec0_file(conf.get_path("prior")))
                     if conf.has("prior") else None)
        left = conf.get_int("left_context")
        right = conf.get_int("right_context")
        chunk = conf.get_int("chunk_size")
        num_pdfs = conf.get_int("num_pdfs")
        tid2pdf = read_vec0_file(conf.get_path("tid2pdf"), np.int32)
        quantized = conf.get_string("quantized", "false").lower() in (
            "true", "1", "yes")
        return cls(nnet_def, params, log_prior, tid2pdf, left, right, chunk,
                   num_pdfs, quantized=quantized, device=device,
                   feature_type=conf.get_string("feature_type",
                                                "fbank").lower(),
                   chunking=ChunkOptions.from_config(conf))

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

    def require_streamable(self, what: str) -> None:
        """Raise NotImplementedError_ unless the model gives one row per
        10 ms frame, takes no i-vector and runs looped (what live
        streaming runs)."""
        if self.chunking is not None:
            raise NotImplementedError_(
                f"{what} runs a model looped; this one has a backward "
                f"recurrence, evaluated in chunks: decode it on the batch "
                f"path (--batch)")
        if self.frame_subsampling_factor != 1 or self.ivector_dim:
            raise NotImplementedError_(
                f"{what} decodes one row per 10 ms frame with no i-vector; "
                f"this model has frame_subsampling_factor "
                f"{self.frame_subsampling_factor} and ivector_dim "
                f"{self.ivector_dim}: decode it on the batch path (--batch)")

    def output_rows(self, frames: int) -> int:
        """Rows the model gives for `frames` input frames."""
        return -(-frames // self.frame_subsampling_factor)

    def forward_padded(self, feats: torch.Tensor,
                       ivectors: Optional[torch.Tensor] = None,
                       frames: Optional[int] = None,
                       lengths: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
        """Context-padded features (and, for a model that takes them, the
        [B, dim] or [dim] i-vectors) -> log-likelihoods (see module
        doc).  `frames`: the longest utterance's valid frames (None: the
        padded rows are all valid); `lengths`: each utterance's, which a
        chunked model reads (None: `frames` for every one)."""
        if self.quantized:
            return self.nnet(feats) - self.log_prior
        if self.ivector_dim and ivectors is None:
            raise ValueError(f"the model takes a {self.ivector_dim}-wide "
                             f"i-vector per utterance; none given")
        if self.chunking is not None:
            return self._forward_chunked(feats, ivectors, frames, lengths)
        n = len(self.nnet_def)
        cuda = feats.device.type == "cuda"
        rows = None if frames is None else self.output_rows(frames)
        with log.span("am.full_rate", device=cuda):
            x = self.nnet.run(0, self._split, feats, ivectors, rows)
        log.count("am_rows_full_rate", x.shape[:-1].numel())
        if self._split < n:
            with log.span("am.subsampled", device=cuda):
                x = self.nnet.run(self._split, n, x, ivectors, rows)
            log.count("am_rows_subsampled", x.shape[:-1].numel())
        return x - self.log_prior if self.has_prior else x

    def _forward_chunked(self, feats: torch.Tensor,
                         ivectors: Optional[torch.Tensor],
                         frames: Optional[int],
                         lengths: Optional[Sequence[int]]) -> torch.Tensor:
        """forward_padded in Kaldi's chunks (am/chunks.py)."""
        one = feats.dim() == 2
        if one:
            feats = feats[None]
            ivectors = None if ivectors is None else ivectors.reshape(1, -1)
        b, padded_len, dim = feats.shape
        if lengths is None:
            valid = padded_len - self.left_context - self.right_context
            lengths = [valid if frames is None else frames] * b
        if len(lengths) != b:
            raise ValueError(f"{len(lengths)} lengths for {b} utterances")
        rows = [self.output_rows(t) for t in lengths]
        plan = plan_chunks(rows, self.chunking, self.frame_subsampling_factor)
        cuda = feats.device.type == "cuda"
        n, width = plan.chunks, plan.width
        attrs = dict(chunks=n, window=width, batch=b)
        with log.span("am.chunks", device=cuda, part="gather", **attrs):
            index = plan.upload(lengths, self.left_context,
                                self.right_context, padded_len, feats.device)
            x = feats.reshape(-1, dim)[index.rows_in]
            iv = None if ivectors is None else ivectors[index.utt]
        log.count("am_chunks", n)
        log.count("am_chunk_rows", n * width)
        log.count("am_chunk_rows_needed", int(plan.rows.sum()))
        with log.span("am.full_rate", device=cuda):
            x = self.nnet.run(0, self._split, x, iv)
        log.count("am_rows_full_rate", x.shape[:-1].numel())
        with log.span("am.subsampled", device=cuda):
            x = self.nnet.run(self._split, self._tail, x, iv,
                              lengths=index.rows)
            x = x.reshape(-1, x.shape[-1])[index.src]
            x = self.nnet.run(self._tail, len(self.nnet_def), x)
        log.count("am_rows_subsampled", x.shape[0])
        with log.span("am.chunks", device=cuda, part="scatter", **attrs):
            out = x.new_zeros((b * plan.rows_max, x.shape[-1]))
            out.index_copy_(0, index.dst, x)
        out = out.view(b, plan.rows_max, -1)
        if self.has_prior:
            out = out - self.log_prior
        return out[0] if one else out

    def _padded_numpy(self, padded: np.ndarray,
                      ivector: Optional[np.ndarray] = None,
                      frames: Optional[int] = None) -> np.ndarray:
        with torch.no_grad():
            iv = (None if ivector is None else torch.as_tensor(
                np.asarray(ivector, np.float32)).to(self.device))
            out = self.forward_padded(torch.as_tensor(
                np.asarray(padded, np.float32)).to(self.device), iv, frames)
        return out.cpu().numpy()

    def forward(self, feats: np.ndarray,
                ivector: Optional[np.ndarray] = None) -> np.ndarray:
        """[T, 40] (and the utterance's i-vector) -> [ceil(T / f), P]
        (numpy): replicate-pad the edges, pad the rows to the bucketed
        count with the last frame, run the nnet once."""
        t = feats.shape[0]
        if t == 0:
            return np.zeros((0, self.num_pdfs), np.float32)
        padded = np.concatenate([
            self.pad_context(feats),
            np.repeat(feats[-1:], bucket(t) - t, axis=0)])
        return self._padded_numpy(padded, ivector, t)[:self.output_rows(t)]

    def pad_context(self, feats: np.ndarray) -> np.ndarray:
        return np.concatenate([
            np.repeat(feats[:1], self.left_context, axis=0),
            feats,
            np.repeat(feats[-1:], self.right_context, axis=0),
        ])


def chunked_tail(nnet_def: NnetDef,
                 chunking: Optional[ChunkOptions]) -> Optional[int]:
    """The index after a chunked stack's last recurrent layer (the layers
    from it on run on the kept rows only); None for a stack run looped.
    Raises CorruptionError where a stack with a backward recurrence has
    no chunk settings, where a stack without one has them, and where a
    chunked stack consumes context or subsamples at or after its first
    recurrence, or ends in layers that do not act row by row (the
    planner's window holds each row's input only at the stack's input)."""
    kinds = [layer[0] for layer in nnet_def]
    if "blstmp" not in kinds:
        if chunking is not None:
            raise CorruptionError(
                "frames_per_chunk: only a model with a backward recurrence "
                "(NN02 kind 17) is evaluated in chunks; this one runs looped")
        return None
    if chunking is None:
        raise CorruptionError(
            "the nnet has a backward recurrence (NN02 kind 17, blstmp), "
            "which is evaluated in Kaldi's chunks: the configuration needs "
            "frames_per_chunk (and extra_left_context, extra_right_context, "
            "extra_left_context_initial, extra_right_context_final)")
    first = min(i for i, k in enumerate(kinds) if k in RECURRENT)
    last = max(i for i, k in enumerate(kinds) if k in RECURRENT)
    rowwise = ("linear", "relu", "normalize", "softmax", "logsoftmax",
               "batchnorm")
    bad = [k for k in kinds[first:] if k not in RECURRENT + rowwise]
    if bad:
        raise CorruptionError(
            f"a chunked stack takes only recurrences and row-wise layers "
            f"from its first recurrence on; found {', '.join(bad)}")
    return last + 1


class AMStream:
    """Streaming chunked inference with the reference's padding: the first
    frame replicated left_context times at the start, the last frame
    right_context times at the end of the stream."""

    def __init__(self, am: AcousticModel):
        am.require_streamable("AMStream")
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
