"""Fused low-latency streaming sessions: one device step per frame chunk
(port of catears_tpu/runtime/streaming.py).  BatchStreamingSession holds N
live streams; StreamingSession, one utterance, is a view of a one-stream
BatchStreamingSession.

The componentized path (FbankStream -> AMStream -> Decoder) pulls every
stage's output to the host.  Here fbank + (online CMVN) + context concat +
TDNN forward + beam search for a fixed F-frame chunk run on tensors that
stay on the session's device, carrying the AM context window, the CMVN
ring and the beam there:

  step(samples_window, ctx, cmvn ring, beam) -> (ctx', ring', beam', trace)

The host sends the chunk's sample window in and pulls the traces in one
transfer when a hypothesis is asked for (`_materialize`).  With `quantized
= true` the AM's linears run the int8 kernel (`am.quant.qmatmul`) on the
card, one launch per linear per chunk step; the B streams of a
BatchStreamingSession ride one launch, each stream quantized by its own
window's min/max (the JAX vmap's semantics).

Semantics are those of the JAX sessions: the first chunk takes F + R
frames with the first frame replicated L times on the left, steady chunks
carry the [L+R, 40] context, the AM emits R frames late, and end-of-stream
and shorter-than-one-chunk utterances flush through the exact host path.
Online CMVN runs on the device as a 600-frame float32 ring whose window
sum is recomputed from the ring every chunk (no drift on a long stream);
the end-of-stream tail continues it on the host in float64, as in JAX.

Deviations from the JAX package (ROADMAP queue 3): BatchStreamingSession's
end-of-stream tail extends only the finishing stream's host trace, by its
valid frames (JAX appends identity rows to every stream), and
`process_batch` raises on a chunk list of the wrong length.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.decode.beam import (BeamConfig, BeamState,
                                           FrameTrace, decode_chunk,
                                           init_beam_batch)
from catears_tpu_torch.decode.hyp import (HostTrace, IncrementalBacktracker,
                                          best_path)
from catears_tpu_torch.decode.oracle import Hypothesis
from catears_tpu_torch.frontend.cmvn import (CMVN_GLOBAL_FRAMES, CMVN_WINDOW,
                                             FEAT_DIM)
from catears_tpu_torch.frontend.fbank import (FRAME_LENGTH, FRAME_SHIFT,
                                              fbank_from_wave, num_frames)
from catears_tpu_torch.graph.device import DeviceFst, DeviceLm
from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.errors import BeamCapacityError

F32, I32 = torch.float32, torch.int32


def _device_cmvn_chunk(gsum, gcount, rings, counts, feats):
    """Online CMVN over one chunk of B streams with carried device rings.

    rings [B, 600, 40] hold each stream's last <= 600 raw frames (zeros
    before they exist, so they drop out of the sums); counts [B] are the
    frames seen.  The window sum is the full ring reduce (fresh each chunk)
    plus prefix sums of the incoming minus outgoing frames: the JAX
    function's arithmetic, in float32.  Returns (normalized feats, rings',
    counts').
    """
    b, f, d = feats.shape
    steps = torch.arange(f, dtype=I32, device=feats.device)
    idx = (counts[:, None] + steps[None, :]) % CMVN_WINDOW  # [B, F]
    gather_idx = idx.long()[..., None].expand(b, f, d)
    outgoing = torch.gather(rings, 1, gather_idx)  # leaving the window
    base = torch.sum(rings, dim=1, keepdim=True)
    win = base + torch.cumsum(feats, 1) - torch.cumsum(outgoing, 1)
    seen = torch.clamp(counts[:, None] + 1 + steps[None, :],
                       max=CMVN_WINDOW).to(F32)
    from_global = torch.clamp(CMVN_WINDOW - seen,
                              max=float(CMVN_GLOBAL_FRAMES))
    scalar = (from_global / gcount)[..., None]
    mean = (win + scalar * gsum) / (seen[..., None] + scalar * gcount)
    rings = rings.scatter(1, gather_idx, feats)
    return feats - mean, rings, counts + f


def _host_cmvn_tail(cm, u: int, feats: np.ndarray) -> np.ndarray:
    """Continue stream u's CMVN on the host, in float64, from its carried
    ring in `cm` (gsum, gcount, rings, counts)."""
    gsum, gcount, rings, counts = cm
    gsum = gsum.cpu().numpy().astype(np.float64)
    gcount, count = float(gcount), int(counts[u])
    ring = rings[u].cpu().numpy().astype(np.float64)
    out = np.empty(feats.shape, np.float32)
    base = ring.sum(axis=0)
    for i, row in enumerate(feats.astype(np.float64)):
        j = (count + i) % CMVN_WINDOW
        base = base - ring[j] + row
        ring[j] = row
        c = min(count + i + 1, CMVN_WINDOW)
        fg = min(CMVN_WINDOW - c, CMVN_GLOBAL_FRAMES)
        scalar = fg / gcount
        mean = (base + scalar * gsum) / (c + scalar * gcount)
        out[i] = row - mean
    return out


def _cmvn_state(cmvn_stats: Optional[np.ndarray], batch: int,
                device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(gsum [40], gcount, rings [B, 600, 40], counts [B]) as the JAX
    batch session initializes them; [B, 1, 40] rings and a unit count
    without CMVN."""
    if cmvn_stats is not None:
        stats = np.asarray(cmvn_stats, np.float64)
        gsum = torch.tensor(stats[:FEAT_DIM], dtype=F32)
        gcount = torch.tensor(stats[FEAT_DIM], dtype=F32)
        rows = CMVN_WINDOW
    else:
        gsum = torch.zeros(FEAT_DIM, dtype=F32)
        gcount = torch.tensor(1.0, dtype=F32)
        rows = 1
    ring = torch.zeros((batch, rows, FEAT_DIM), dtype=F32)
    count = torch.zeros(batch, dtype=I32)
    return tuple(x.to(device) for x in (gsum, gcount, ring, count))


def _window_frames(samples: np.ndarray, consumed: int,
                   n_frames: int) -> np.ndarray:
    start = consumed * FRAME_SHIFT
    return samples[start:start + FRAME_LENGTH + FRAME_SHIFT * (n_frames - 1)]


def _pull_traces(traces: List[FrameTrace]) -> Tuple[np.ndarray, np.ndarray]:
    """The chunks' (prev_slot, words), concatenated on the device and
    brought to the host in one transfer each."""
    prev = torch.cat([t.prev_slot for t in traces]).cpu().numpy()
    words = torch.cat([t.words for t in traces]).cpu().numpy()
    return prev, words


class _FusedStep:
    """BatchStreamingSession's fused chunk step over [B] streams."""

    def __init__(self, am: AcousticModel, cfg: BeamConfig, dfst: DeviceFst,
                 dlm: Optional[DeviceLm], cmvn: bool):
        am.require_streamable("live streaming")
        self.am, self.cfg, self.dfst, self.dlm = am, cfg, dfst, dlm
        self.cmvn = cmvn
        self.device = dfst.device

    def __call__(self, samples: np.ndarray, n_frames: int,
                 ctx: Optional[torch.Tensor], cm, beam,
                 active: torch.Tensor):
        """samples [B, S] (host) -> (new ctx [B, L+R, 40], cm', beam',
        trace [F, B, ...]); ctx None is the first chunk (left replicate
        padding).  Streams with active False decode identity frames and
        keep their CMVN ring; the caller keeps their ctx."""
        with torch.no_grad():
            with log.span("tick.features"):
                wave = torch.from_numpy(samples).to(self.device)
                feats = fbank_from_wave(wave, n_frames)  # [B, n_frames, 40]
                if self.cmvn:
                    gsum, gcount, rings, counts = cm
                    feats, new_rings, new_counts = _device_cmvn_chunk(
                        gsum, gcount, rings, counts, feats)
                    cm = (gsum, gcount,
                          torch.where(active[:, None, None], new_rings,
                                      rings),
                          torch.where(active, new_counts, counts))
                if ctx is None:
                    left = feats[:, :1].expand(-1, self.am.left_context, -1)
                    window = torch.cat([left, feats], dim=1)
                else:
                    window = torch.cat([ctx, feats], dim=1)
                logp = self.am.forward_padded(window)  # [B, F, P]
            with log.span("tick.decode", frames=logp.shape[1]):
                valid = active[None, :].expand(logp.shape[1], -1)
                beam, trace = decode_chunk(self.cfg, self.dfst, beam,
                                           logp.transpose(0, 1), valid,
                                           self.dlm)
        ctx_len = self.am.left_context + self.am.right_context
        return window[:, -ctx_len:], cm, beam, trace

    def _fbank(self, samples: np.ndarray, n_frames: int,
               cmvn_tail) -> np.ndarray:
        with torch.no_grad():
            feats = fbank_from_wave(torch.from_numpy(samples).to(
                self.device), n_frames).cpu().numpy()
        return cmvn_tail(feats) if self.cmvn else feats

    def tail_logp(self, samples: np.ndarray, consumed: int,
                  ctx: Optional[torch.Tensor], cmvn_tail) -> np.ndarray:
        """One stream's end-of-stream log-probs by the exact host path.

        Without a chunk step (ctx None): the whole utterance through the
        bucketed `AcousticModel.forward`.  Else the frames after the last
        step behind the carried [L+R, 40] context, the last frame
        replicated R times: the AM emits the t_extra + R held-back rows.
        `cmvn_tail` continues the stream's CMVN on the host.
        """
        total = num_frames(samples.shape[0])
        if ctx is None:
            if total == 0:
                return np.zeros((0, self.am.num_pdfs), np.float32)
            return self.am.forward(self._fbank(samples, total, cmvn_tail))
        window = ctx.cpu().numpy()
        if total > consumed:
            window = np.concatenate([window, self._fbank(
                samples[consumed * FRAME_SHIFT:], total - consumed,
                cmvn_tail)])
        window = np.concatenate(
            [window, np.repeat(window[-1:], self.am.right_context, axis=0)])
        return self.am._padded_numpy(window)

    def decode_host(self, beam, logp: np.ndarray, stream: int,
                    batch: int, chunk: int):
        """Decode [n, P] log-probs for one stream of `batch` in chunk-frame
        steps under a frame_valid mask; yields (beam', trace, n_valid)."""
        n = logp.shape[0]
        n_pad = -(-n // chunk) * chunk
        lp = np.zeros((n_pad, batch, logp.shape[1]), np.float32)
        lp[:n, stream] = logp
        valid = np.zeros((n_pad, batch), bool)
        valid[:n, stream] = True
        for off in range(0, n_pad, chunk):
            with torch.no_grad():
                beam, trace = decode_chunk(
                    self.cfg, self.dfst, beam,
                    torch.from_numpy(lp[off:off + chunk]).to(self.device),
                    torch.from_numpy(valid[off:off + chunk]).to(self.device),
                    self.dlm)
            yield beam, trace, int(valid[off:off + chunk, stream].sum())


class BatchStreamingSession:
    """N concurrent live streams decoded by ONE fused step per chunk.

    Per-stream sample buffers on the host, a shared [B]-batched fbank + AM
    + decode chunk step on the device, and per-stream partial hypotheses
    via per-stream incremental trackers.  Streams may receive audio at
    different rates: each drain round steps exactly the streams that have
    a full chunk buffered (the others decode identity frames under
    frame_valid = 0 and keep their AM context and CMVN ring), so one slow
    stream never stalls the batch.  end_of_stream flushes a stream's tail
    through the exact host AM path with only that stream valid.
    """

    def __init__(self, am: AcousticModel, fst: FlatFst,
                 delta_lm: Optional[DeltaLmFst], cfg: BeamConfig,
                 dfst: DeviceFst, dlm: Optional[DeviceLm],
                 n_streams: int, chunk_frames: int = 20,
                 cmvn_stats: Optional[np.ndarray] = None):
        self.am = am
        self.fst = fst
        self.delta_lm = delta_lm
        self.cfg = cfg
        self.dfst = dfst
        self.dlm = dlm
        self.has_lm = dlm is not None
        self.b = n_streams
        self.f = chunk_frames
        self.l = am.left_context
        self.r = am.right_context
        self.cmvn = cmvn_stats is not None
        self._step = _FusedStep(am, cfg, dfst, dlm, self.cmvn)
        self._cm = _cmvn_state(cmvn_stats, n_streams, dfst.device)
        self._samples = [np.zeros(0, np.float32) for _ in range(n_streams)]
        self._consumed = [0] * n_streams  # feats consumed by fused steps
        self._started = [False] * n_streams
        self._flushed = [False] * n_streams
        self._ctx = torch.zeros((n_streams, self.l + self.r, FEAT_DIM),
                                dtype=F32, device=dfst.device)
        beam, init_trace = init_beam_batch(cfg, n_streams, dfst, dlm)
        self.beam = beam
        prev0 = init_trace.prev_slot.cpu().numpy()
        words0 = init_trace.words.cpu().numpy()
        self._host_traces: List[List[HostTrace]] = [
            [HostTrace(prev0[u], words0[u])] for u in range(n_streams)]
        # (stacked [F, B, ...] trace, frames to take, the one stream they
        # belong to or None for every stream)
        self._dev_traces: List[Tuple[FrameTrace, int, Optional[int]]] = []
        self.num_frames_decoded = [0] * n_streams
        self._trackers = [IncrementalBacktracker()
                          for _ in range(n_streams)]

    # -- internals ---------------------------------------------------------

    def _avail(self, u: int) -> int:
        return num_frames(self._samples[u].shape[0])

    def _need(self, u: int) -> int:
        return self.f + (self.r if not self._started[u] else 0)

    def _ready(self, u: int) -> bool:
        return (not self._flushed[u]
                and self._avail(u) >= self._consumed[u] + self._need(u))

    def _step_group(self, group: List[int], first: bool) -> None:
        n_frames = self.f + (self.r if first else 0)
        s_len = FRAME_LENGTH + FRAME_SHIFT * (n_frames - 1)
        samples = np.zeros((self.b, s_len), np.float32)
        active = np.zeros(self.b, bool)
        for u in group:
            samples[u] = _window_frames(self._samples[u], self._consumed[u],
                                        n_frames)
            active[u] = True
        act = torch.from_numpy(active).to(self.dfst.device)
        ctx_new, self._cm, self.beam, trace = self._step(
            samples, n_frames, None if first else self._ctx, self._cm,
            self.beam, act)
        self._ctx = torch.where(act[:, None, None], ctx_new, self._ctx)
        self._dev_traces.append((trace, self.f, None))
        for u in group:
            self._consumed[u] += n_frames
            self._started[u] = True
            self.num_frames_decoded[u] += self.f
        log.count("frames_decoded", self.f * len(group))

    def _drain(self) -> None:
        while True:
            firsts = [u for u in range(self.b)
                      if self._ready(u) and not self._started[u]]
            if firsts:
                self._step_group(firsts, first=True)
            steadies = [u for u in range(self.b)
                        if self._ready(u) and self._started[u]]
            if steadies:
                self._step_group(steadies, first=False)
            if not firsts and not steadies:
                return

    def process(self, u: int, samples: np.ndarray) -> None:
        """Feed float samples to stream u; steps every ready stream."""
        if self._flushed[u]:
            return
        if samples.size:
            self._samples[u] = np.concatenate(
                [self._samples[u], samples.astype(np.float32)])
        self._drain()

    def process_batch(self, chunks) -> None:
        """Feed one chunk per stream (None or empty to skip one), then step
        (spanned as `tick.step`; the fused steps' parts as `tick.features`,
        fbank + CMVN + AM, and `tick.decode`).

        Appends every stream's samples before draining, so simultaneous
        arrivals decode as one fused [B] group step (B separate process()
        calls would drain after each append and serialize the same audio
        into B batch-1 steps).  Per-stream results are identical either
        way.  `chunks` must hold one entry per stream.
        """
        if len(chunks) != self.b:
            raise ValueError(f"process_batch takes one chunk per stream "
                             f"({self.b}), got {len(chunks)}")
        with log.span("tick.step"):
            for u, s in enumerate(chunks):
                if s is None or self._flushed[u]:
                    continue
                s = np.asarray(s, np.float32).ravel()
                if s.size:
                    self._samples[u] = np.concatenate([self._samples[u], s])
            self._drain()

    def end_of_stream(self, u: int) -> None:
        """Flush stream u's tail through the exact host AM path."""
        if self._flushed[u]:
            return
        self._drain()
        self._flushed[u] = True
        self._decode_host(u, self._step.tail_logp(
            self._samples[u], self._consumed[u],
            self._ctx[u] if self._started[u] else None,
            lambda feats: _host_cmvn_tail(self._cm, u, feats)))

    def _decode_host(self, u: int, logp: np.ndarray) -> None:
        if logp.shape[0] == 0:
            return
        for self.beam, trace, n_valid in self._step.decode_host(
                self.beam, logp, u, self.b, self.f):
            # Only stream u's valid frames: the other streams' rows (and
            # u's padded ones) are identity frames.
            self._dev_traces.append((trace, n_valid, u))
            self.num_frames_decoded[u] += n_valid
            log.count("frames_decoded", n_valid)

    def _materialize(self) -> None:
        if not self._dev_traces:
            return
        with log.span("partials.copy"):
            prev, words = _pull_traces([t for t, _, _ in self._dev_traces])
        off = 0
        for trace, n_valid, only in self._dev_traces:
            for u in (range(self.b) if only is None else (only,)):
                self._host_traces[u].extend(
                    HostTrace(prev[off + i, u], words[off + i, u])
                    for i in range(n_valid))
            off += trace.prev_slot.shape[0]
        self._dev_traces = []

    def overflowed(self, u: int) -> bool:
        return bool(self.beam.overflow[u])

    def best_path(self, u: int, end_of_stream: bool) -> Hypothesis:
        if self.overflowed(u):
            raise BeamCapacityError(
                f"arc expansion overflowed capacity for stream {u} "
                f"(expand_size={self.cfg.expand_size})")
        self._materialize()
        states, lms, costs = (x[u].cpu().numpy() for x in (
            self.beam.states, self.beam.lm, self.beam.costs))
        return best_path(self._host_traces[u], states, lms, costs, self.fst,
                         self.delta_lm, end_of_stream=end_of_stream,
                         tracker=self._trackers[u])

    def partials(self) -> List[Hypothesis]:
        """Every stream's partial hypothesis from one pull of the beam and
        one of the pending traces, then per-stream incremental host walks
        (B best_path() calls give the same hypotheses with B pulls).  As in
        the JAX package, a stream already flushed gets its non-final
        (end_of_stream=False) hypothesis too.  Spanned as `tick.partials`,
        its device-to-host copies as `partials.copy`."""
        with log.span("tick.partials"):
            with log.span("partials.copy"):
                ovf, states, lms, costs = (x.cpu().numpy() for x in (
                    self.beam.overflow, self.beam.states, self.beam.lm,
                    self.beam.costs))
            if ovf.any():
                raise BeamCapacityError(
                    f"arc expansion overflowed capacity for streams "
                    f"{np.nonzero(ovf)[0].tolist()} "
                    f"(expand_size={self.cfg.expand_size})")
            self._materialize()
            return [
                best_path(self._host_traces[u], states[u], lms[u], costs[u],
                          self.fst, self.delta_lm, end_of_stream=False,
                          tracker=self._trackers[u])
                for u in range(self.b)
            ]


class StreamingSession:
    """Device-resident streaming decode for one utterance: a view of a
    one-stream BatchStreamingSession, whose stream 0 it is."""

    def __init__(self, am: AcousticModel, fst: FlatFst,
                 delta_lm: Optional[DeltaLmFst], cfg: BeamConfig,
                 dfst: DeviceFst, dlm: Optional[DeviceLm],
                 chunk_frames: int = 20,
                 cmvn_stats: Optional[np.ndarray] = None):
        self._batch = BatchStreamingSession(
            am, fst, delta_lm, cfg, dfst, dlm, 1, chunk_frames=chunk_frames,
            cmvn_stats=cmvn_stats)

    @property
    def beam(self) -> BeamState:
        return self._batch.beam

    @property
    def num_frames_decoded(self) -> int:
        return self._batch.num_frames_decoded[0]

    @property
    def overflowed(self) -> bool:
        """True if any frame's arc expansion truncated (result suspect)."""
        return self._batch.overflowed(0)

    def process(self, samples: np.ndarray) -> None:
        self._batch.process(0, samples)

    def end_of_stream(self) -> None:
        """Flush the remaining feats through the host AM path (exact
        padding)."""
        self._batch.end_of_stream(0)

    def best_path(self, end_of_stream: bool) -> Hypothesis:
        return self._batch.best_path(0, end_of_stream)

    def get_state(self) -> dict:
        """The session as plain numpy structures (picklable; the JAX
        Utterance's "session" keys and dtypes): ctx None before the first
        chunk step, the CMVN ring [rows, 40] and a scalar count."""
        b = self._batch
        b._materialize()
        gsum, gcount, rings, counts = b._cm
        return {
            "samples": b._samples[0].copy(),
            "consumed_frames": b._consumed[0],
            "ctx": b._ctx[0].cpu().numpy() if b._started[0] else None,
            "beam": tuple(x.cpu().numpy() for x in b.beam),
            "cm": tuple(x.cpu().numpy()
                        for x in (gsum, gcount, rings[0], counts[0])),
            "traces": [(t.prev_slot.copy(), t.words.copy())
                       for t in b._host_traces[0]],
            "num_frames_decoded": b.num_frames_decoded[0],
            "flushed": b._flushed[0],
        }

    def set_state(self, state: dict) -> None:
        """Restore a `get_state` snapshot."""
        b = self._batch

        def to_dev(x):
            return torch.as_tensor(np.asarray(x)).to(b.dfst.device)

        b._samples = [state["samples"].copy()]
        b._consumed = [state["consumed_frames"]]
        b._started = [state["ctx"] is not None]
        b._ctx = (torch.zeros_like(b._ctx) if state["ctx"] is None
                  else to_dev(state["ctx"])[None])
        b.beam = BeamState(*(to_dev(x) for x in state["beam"]))
        if "cm" in state:
            gsum, gcount, ring, count = (to_dev(x) for x in state["cm"])
            b._cm = (gsum, gcount, ring[None], count[None])
        b._host_traces = [[HostTrace(p, w) for p, w in state["traces"]]]
        b._dev_traces = []
        b.num_frames_decoded = [state["num_frames_decoded"]]
        b._flushed = [state["flushed"]]
        # The tracker memo indexes the restored trace list.
        b._trackers = [IncrementalBacktracker()]
