"""Decoder runtime around the beam search (port of
catears_tpu/decode/decoder.py).

`Decoder` is the single-utterance streaming decoder (the reference Decoder
lifecycle: initialize / process / end_of_stream / best_path, with
get_state / set_state), buffering log-prob rows into fixed chunks decoded
under a frame_valid mask; `autosize` sizes a deployment's capacities from
one generous decode.  `BatchDecoder` is the batch path: optional delta-LM
rescoring, the overflow regrow-and-retry and the device backtrace with the
host's final-weight pick (or the host backtrace), `decode_batch` its
one-shot form; on a card its frame loop replays one CUDA graph per chunk
(`_ChunkRunner`).  Both set up through `build_decode_graph`, and both
decode every mode of `prepare_decode_graph`:
eps-free and closed graphs with the transformed graph (epsilon depth
capped at 1), raw ones (or any graph when close_eps=False) with the
original graph and its own epsilon depth, as the JAX decoders do.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from catears_tpu_torch.decode.beam import (
    BeamConfig,
    BeamState,
    FrameTrace,
    backtrace_device,
    decode_chunk,
    emit_lanes,
    expand_emitting,
    init_beam_batch,
    select_beam,
)
from catears_tpu_torch.decode.hyp import (
    HostTrace,
    IncrementalBacktracker,
    assemble_words_batch,
    best_path,
    pick_final,
)
from catears_tpu_torch.decode.oracle import Hypothesis
from catears_tpu_torch.graph.device import (DeviceFst, DeviceLm,
                                            expansion_bounds, lm_propagate,
                                            lm_propagate_capped)
from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst
from catears_tpu_torch.graph.transform import prepare_decode_graph
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import BeamCapacityError


def safe_config(fst: FlatFst, arc_group: int, base: BeamConfig,
                has_lm: bool = False, csr_group: int = None,
                lm_dup_factor: int = 4) -> BeamConfig:
    """Raise base's expansion capacities to the graph's worst case.

    LM off, the bound is exact and the decoder can never truncate.  With a
    delta-LM the beam dedups on (state, lm) pairs, so the true worst case
    is K tokens on the highest-fanout state; the capacities allow
    `lm_dup_factor` beam copies per HCLG state instead (capped at that
    worst case), and the overflow flag catches a genuine overshoot.
    """
    eb, epsb = expansion_bounds(fst, arc_group, base.beam_size,
                                distinct_states=True, csr_group=csr_group)
    if has_lm:
        eb_w, epsb_w = expansion_bounds(fst, arc_group, base.beam_size,
                                        distinct_states=False,
                                        csr_group=csr_group)
        eb = min(eb_w, lm_dup_factor * eb)
        epsb = min(epsb_w, lm_dup_factor * epsb)
    return dataclasses.replace(
        base,
        expand_size=max(base.expand_size, eb, arc_group),
        eps_expand_size=max(base.eps_expand_size, epsb, arc_group))


def _round_up(v: int, quantum: int) -> int:
    return -(-v // quantum) * quantum


def _device_lm(delta_lm: Optional[DeltaLmFst],
               device: torch.device) -> Optional[DeviceLm]:
    if delta_lm is None:
        return None
    with log.span("setup.device_lm"):
        return DeviceLm.build(delta_lm, device=device)


def _decode_graph(fst: FlatFst, close_eps: bool):
    """(decode graph, eps_depth_cap, olabel2), the JAX decoders' choice:
    with close_eps, prepare_decode_graph's graph at depth 1 unless its mode
    is 'raw'; otherwise the original graph at its own epsilon depth."""
    if close_eps:
        g2, olab2, mode = prepare_decode_graph(fst)
        if mode != "raw":
            return g2, 1, olab2
    return fst, None, None


def _with_am_scale(config: BeamConfig, am_scale: float) -> BeamConfig:
    if config.am_scale != am_scale:
        config = dataclasses.replace(config, am_scale=am_scale)
    return config


def build_decode_graph(fst: FlatFst, tid2pdf: np.ndarray, am_scale: float,
                       delta_lm: Optional[DeltaLmFst],
                       config: Optional[BeamConfig], arc_group: int,
                       close_eps: bool, csr_group: Optional[int],
                       device: Device):
    """(config, DeviceFst, DeviceLm or None, auto_capacity): the decoders'
    set-up on `device` (the card unless the CPU is asked for), spanned as
    setup.decode_graph, setup.device_fst and setup.device_lm.  The tables
    are built from the graph `_decode_graph` picks; config None is sized
    by safe_config from that graph (auto_capacity True: LM off it cannot
    truncate), an explicit one takes `am_scale`."""
    device = resolve_device(device)
    with log.span("setup.decode_graph"):
        dec_fst, cap, olab2 = _decode_graph(fst, close_eps)
    auto_capacity = config is None
    if auto_capacity:
        config = safe_config(dec_fst, arc_group, BeamConfig(am_scale=am_scale),
                             delta_lm is not None, csr_group=csr_group)
    with log.span("setup.device_fst"):
        dfst = DeviceFst.build(
            dec_fst, tid2pdf, group=arc_group, eps_depth_cap=cap,
            csr_group=csr_group, olabel2=olab2, device=device)
    return (_with_am_scale(config, am_scale), dfst,
            _device_lm(delta_lm, dfst.device), auto_capacity)


def autosize(fst: FlatFst, tid2pdf: np.ndarray, logp: np.ndarray,
             am_scale: float = 0.1,
             delta_lm: Optional[DeltaLmFst] = None,
             base: Optional[BeamConfig] = None,
             margin: float = 1.25,
             arc_group: int = 4,
             csr_group: int = None,
             device: Device = "cuda") -> BeamConfig:
    """One-call deployment geometry from a representative decode.

    Runs `logp` ([T, P] or [B, T, P] log-prob frames) through a decode
    with generous capacities (safe_config bounds, uncapped delta-LM walk),
    reads the capacity high-water telemetry and returns a tight BeamConfig
    with `margin` headroom.  Genuine overshoot at decode time is still
    caught by the overflow flag (BeamCapacityError).  select_compact is
    left 0, as in JAX.
    """
    base = _with_am_scale(base or BeamConfig(am_scale=am_scale), am_scale)
    sizing = dataclasses.replace(
        safe_config(fst, arc_group, base, delta_lm is not None,
                    csr_group=csr_group, lm_dup_factor=8),
        lm_expand_size=0, select_compact=0)
    lp = np.asarray(logp, np.float32)
    if lp.ndim == 2:
        lp = lp[None]
    hw = np.zeros(5, np.int64)
    for row in lp:
        dec = Decoder(fst, tid2pdf, am_scale=am_scale, delta_lm=delta_lm,
                      config=sizing, arc_group=arc_group,
                      csr_group=csr_group, device=device)
        dec.process(row)
        dec.end_of_stream()
        dec.check_capacity()
        hw = np.maximum(hw, dec.capacity_high_water)
    g = csr_group or arc_group
    return dataclasses.replace(
        base,
        expand_size=max(_round_up(int(hw[0] * margin), 512), g),
        eps_expand_size=max(_round_up(int(hw[1] * margin), 512), g)
        if hw[1] else base.eps_expand_size,
        lm_expand_size=(_round_up(int(hw[2] * margin), 128)
                        if delta_lm is not None and hw[2] else 0),
    )


def _traces_to_host(trace: FrameTrace, num_valid: int,
                    utt: int) -> List[HostTrace]:
    """Slice a stacked [C, B, ...] FrameTrace to per-frame host traces."""
    prev = trace.prev_slot[:, utt].cpu().numpy()
    words = trace.words[:, utt].cpu().numpy()
    return [HostTrace(prev[f], words[f]) for f in range(num_valid)]


class Decoder:
    """Single-utterance streaming decoder (reference Decoder parity API)."""

    def __init__(self, fst: FlatFst, tid2pdf: np.ndarray,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 20,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 dfst: Optional[DeviceFst] = None,
                 dlm: Optional[DeviceLm] = None,
                 device: Device = "cuda"):
        """config=None sizes the capacities by safe_config (LM off they
        cannot truncate); an explicit config relies on the overflow flag.
        A prebuilt `dfst` is adopted with its `dlm` (built from `delta_lm`
        when None), and its device used, and needs an explicit config;
        else `build_decode_graph` builds them on `device`."""
        if dfst is None:
            config, dfst, dlm, _ = build_decode_graph(
                fst, tid2pdf, am_scale, delta_lm, config, arc_group,
                close_eps, csr_group, device)
        else:
            # The runtime caches one device graph per Recognizer, so
            # repeated utterances skip the transform and build.
            assert config is not None, \
                "prebuilt dfst requires an explicit BeamConfig"
            config = _with_am_scale(config, am_scale)
            if dlm is None:
                dlm = _device_lm(delta_lm, dfst.device)
        self.cfg, self.dfst, self.dlm = config, dfst, dlm
        self.fst = fst
        self.delta_lm = delta_lm
        self.has_lm = delta_lm is not None
        self.chunk_frames = chunk_frames
        self.initialize()

    @property
    def device(self) -> torch.device:
        return self.dfst.device

    def initialize(self) -> None:
        beam, trace = init_beam_batch(self.cfg, 1, self.dfst, self.dlm)
        self.beam = beam
        self.traces: List[HostTrace] = [
            HostTrace(trace.prev_slot[0].cpu().numpy(),
                      trace.words[0].cpu().numpy())
        ]
        self._pending: List[np.ndarray] = []
        self.num_frames_decoded = 0
        self.is_end_of_stream = False
        # Partial-hypothesis refreshes walk only the frames since the
        # last call (see hyp.IncrementalBacktracker).
        self._tracker = IncrementalBacktracker()

    def process(self, logp: np.ndarray) -> None:
        """Queue [n, P] log-prob rows; decodes in chunk_frames batches."""
        for row in np.asarray(logp, np.float32):
            self._pending.append(row)
        self._flush(force=False)

    def end_of_stream(self) -> None:
        self._flush(force=True)
        self.is_end_of_stream = True

    def _flush(self, force: bool) -> None:
        c = self.chunk_frames
        while self._pending and (len(self._pending) >= c or force):
            n = min(len(self._pending), c)
            rows = self._pending[:n]
            self._pending = self._pending[n:]
            p = rows[0].shape[0]
            logp = np.zeros((c, 1, p), np.float32)
            logp[:n, 0] = rows
            valid = np.zeros((c, 1), bool)
            valid[:n] = True
            self.beam, trace = decode_chunk(
                self.cfg, self.dfst, self.beam,
                torch.from_numpy(logp).to(self.device),
                torch.from_numpy(valid).to(self.device), self.dlm)
            self.traces.extend(_traces_to_host(trace, n, 0))
            self.num_frames_decoded += n
            log.count("frames_decoded", n)

    @property
    def overflowed(self) -> bool:
        """True if any frame's arc expansion truncated (result suspect)."""
        return bool(self.beam.overflow[0])

    @property
    def capacity_high_water(self) -> tuple:
        """(emit_overflow, eps, lm_walk, select_compact, cold_emit) slots
        the decode actually needed.

        Run a representative decode with generous capacities, then size
        BeamConfig.expand_size / eps_expand_size / lm_expand_size /
        select_compact / cold_expand_size to these marks (plus margin).
        Slot 3 is reported even with select_compact=0; slot 4 counts the
        cold tokens only when the hot/cold split runs.
        """
        return tuple(int(x) for x in self.beam.hiwater[0].cpu().numpy())

    def check_capacity(self) -> None:
        if self.overflowed:
            raise BeamCapacityError(
                f"arc expansion overflowed capacity (expand_size="
                f"{self.cfg.expand_size}, eps_expand_size="
                f"{self.cfg.eps_expand_size}) after "
                f"{self.num_frames_decoded} frames",
                hiwater=self.capacity_high_water)

    def best_path(self) -> Hypothesis:
        self.check_capacity()
        states = self.beam.states[0].cpu().numpy()
        lms = self.beam.lm[0].cpu().numpy()
        costs = self.beam.costs[0].cpu().numpy()
        return best_path(self.traces, states, lms, costs, self.fst,
                         self.delta_lm,
                         end_of_stream=self.is_end_of_stream,
                         tracker=self._tracker)

    # -- session checkpoint/resume -----------------------------------------

    def get_state(self) -> dict:
        """Snapshot the decode session as plain numpy arrays (the JAX
        Decoder's keys and dtypes)."""
        return {
            "beam": tuple(x.cpu().numpy() for x in self.beam),
            "traces": [(t.prev_slot.copy(), t.words.copy())
                       for t in self.traces],
            "pending": [r.copy() for r in self._pending],
            "num_frames_decoded": self.num_frames_decoded,
            "is_end_of_stream": self.is_end_of_stream,
        }

    def set_state(self, state: dict) -> None:
        self.beam = BeamState(*(torch.as_tensor(np.asarray(x)).to(
            self.device) for x in state["beam"]))
        self.traces = [HostTrace(p, w) for p, w in state["traces"]]
        # The tracker memo indexes the restored trace list, not the old one.
        self._tracker = IncrementalBacktracker()
        self._pending = [r.copy() for r in state["pending"]]
        self.num_frames_decoded = state["num_frames_decoded"]
        self.is_end_of_stream = state["is_end_of_stream"]


def _regrow_config(config: BeamConfig, hiwater,
                   margin: float = 1.5) -> BeamConfig:
    """New geometry from measured demand: each capacity grows to its
    high-water mark x margin (the mark is a lower bound on the true demand
    once truncation happened); the retry never compacts the selection."""
    emit, eps, lm, _sel, cold = (int(x) for x in hiwater)

    def grow(cur, need):
        return max(cur, _round_up(int(need * margin), 512))

    return dataclasses.replace(
        config, expand_size=grow(config.expand_size, emit),
        eps_expand_size=grow(config.eps_expand_size, eps),
        lm_expand_size=(grow(config.lm_expand_size, lm)
                        if config.lm_expand_size > 0 and lm
                        else config.lm_expand_size),
        cold_expand_size=(grow(config.cold_expand_size, cold)
                          if config.cold_expand_size > 0 and cold
                          else config.cold_expand_size),
        select_compact=0)


class BatchDecoder:
    """Reusable batched decoder: device graph built ONCE, decode many.

    decode() takes numpy or torch log-probs [B, T, P]; a tensor already on
    the decoder's device (straight from the batched AM) never visits the
    host.  Traces stay on the device and the backtrace runs there; only the
    final beam and the [B, T, W] word array come back.  With `delta_lm`
    the decode is rescored by that G' (its DeviceLm built once, here).

    The frames run chunk_frames at a time, the last chunk padded with
    invalid (identity) frames, through a `_ChunkRunner`: on a card one
    CUDA graph, captured by the first decode of its shape and replayed
    once a chunk (counters `frame_graph_captures`, `frame_graph_replays`);
    on the CPU the same steps eagerly.  The decoder keeps a runner per
    (batch size, chunk_frames, log-prob width) at its own config and one
    at the last regrown config (see `_runner`); `drop_graphs` frees them.
    One decode at a time: the runners' buffers are shared by its decodes.
    """

    def __init__(self, fst: FlatFst, tid2pdf: np.ndarray,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 50,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 dfst: Optional[DeviceFst] = None,
                 device: Device = "cuda"):
        """config=None sizes the capacities by safe_config (LM off they
        cannot truncate); an explicit config relies on the overflow
        retry, with its am_scale replaced by `am_scale`.  The tables are
        built by `build_decode_graph` on `device`; a prebuilt `dfst` is
        adopted instead, on its own device, and `fst` must then be the
        graph it was built from (its final weights drive the host
        backtrace, and a None config is sized from it)."""
        self.fst = fst
        self.delta_lm = delta_lm
        self.chunk_frames = chunk_frames
        if dfst is None:
            config, dfst, dlm, self.auto_capacity = build_decode_graph(
                fst, tid2pdf, am_scale, delta_lm, config, arc_group,
                close_eps, csr_group, device)
        else:
            self.auto_capacity = config is None
            if config is None:
                config = safe_config(fst, arc_group,
                                     BeamConfig(am_scale=am_scale),
                                     delta_lm is not None,
                                     csr_group=csr_group)
            config = _with_am_scale(config, am_scale)
            dlm = _device_lm(delta_lm, dfst.device)
        self.cfg, self.dfst, self.dlm = config, dfst, dlm
        self._runners: Dict[tuple, _ChunkRunner] = {}
        self._pool = None  # the runners' CUDA graph memory pool

    def drop_graphs(self) -> None:
        """Frees the frame loop's chunk runners, on a card their CUDA
        graphs and buffers; the next decode of each shape captures
        again."""
        self._runners.clear()

    def _runner(self, config: BeamConfig, beam: BeamState,
                num_pdfs: int) -> "_ChunkRunner":
        """The chunk runner of a decode of `beam`'s batch at `config`,
        reset to start from `beam`.  Runners are kept per (batch size,
        chunk_frames, log-prob width) and whether `config` is the
        decoder's own: a retry at another regrown config replaces the
        regrown runner before it, so a decoder holds at most two a shape.
        On a card their graphs share one memory pool (one decode runs at
        a time, and each runner keeps its own buffers and trace)."""
        key = (beam.states.shape[0], self.chunk_frames, num_pdfs,
               config == self.cfg)
        if key not in self._runners or self._runners[key].cfg != config:
            self._runners.pop(key, None)  # its graph's memory is reused
            if self.dfst.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._runners[key] = _ChunkRunner(
                config, self.dfst, self.dlm, beam, self.chunk_frames,
                num_pdfs, self._pool)
        runner = self._runners[key]
        runner.reset(beam)
        return runner

    def decode(self, logp, lengths: Optional[Sequence[int]] = None,
               device_backtrace: bool = True,
               retry_on_overflow: bool = True,
               retry_margin: float = 1.5,
               final_fallback: bool = False) -> List[Hypothesis]:
        """Decode a [B, T, P] log-prob batch; one Hypothesis per row.

        An overflow of an explicit config's capacities regrows the geometry
        from the decode's high-water telemetry (x retry_margin) and decodes
        the batch ONCE more; only a second overflow raises
        BeamCapacityError.  device_backtrace=False pulls every frame's
        trace and backtraces each utterance on the host (end-of-stream
        best path, no fallback).  final_fallback=True makes the device
        backtrace take the cheapest token when no final state is
        reachable.
        """
        if self.auto_capacity:
            retry_on_overflow = False  # safe_config bounds cannot truncate
        args = (self.fst, self.dfst, self.dlm, self.delta_lm, logp, lengths)
        with log.span("decode"):
            try:
                return _decode_batch_once(*args, self.cfg, self.chunk_frames,
                                          device_backtrace, final_fallback,
                                          self._runner)
            except BeamCapacityError as err:
                if not retry_on_overflow or err.hiwater is None:
                    raise
                regrown = _regrow_config(self.cfg, err.hiwater, retry_margin)
                log.count("overflow_retries", 1)
                print(f"# catears: capacity overflow (hiwater={err.hiwater});"
                      f" regrowing geometry to expand={regrown.expand_size} "
                      f"eps={regrown.eps_expand_size} "
                      f"lm={regrown.lm_expand_size} and retrying once",
                      file=sys.stderr)
                with log.span("decode.retry", hiwater=list(err.hiwater)):
                    return _decode_batch_once(*args, regrown,
                                              self.chunk_frames,
                                              device_backtrace,
                                              final_fallback, self._runner)


def decode_batch(fst: FlatFst, tid2pdf: np.ndarray, logp,
                 lengths: Optional[Sequence[int]] = None,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 50,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 device_backtrace: bool = True,
                 retry_on_overflow: bool = True,
                 retry_margin: float = 1.5,
                 device: Device = "cuda") -> List[Hypothesis]:
    """One-shot decode of a [B, T, P] batch (see BatchDecoder)."""
    return BatchDecoder(fst, tid2pdf, am_scale=am_scale, delta_lm=delta_lm,
                        config=config, chunk_frames=chunk_frames,
                        arc_group=arc_group, close_eps=close_eps,
                        csr_group=csr_group, device=device).decode(
        logp, lengths, device_backtrace=device_backtrace,
        retry_on_overflow=retry_on_overflow, retry_margin=retry_margin)


def _decode_batch_once(fst: FlatFst, dfst: DeviceFst,
                       dlm: Optional[DeviceLm],
                       delta_lm: Optional[DeltaLmFst], logp,
                       lengths: Optional[Sequence[int]],
                       config: BeamConfig, chunk_frames: int,
                       device_backtrace: bool, final_fallback: bool,
                       runner_for: Callable[[BeamConfig, BeamState, int],
                                            "_ChunkRunner"]
                       ) -> List[Hypothesis]:
    """One decode of the batch at `config`'s capacities, spanned (inside
    the caller's `decode` span) as decode.init, one decode.frames per
    chunk (with CUDA events on a card: the chunk's device time),
    decode.read (the host waits for the frame loop there),
    decode.backtrace and decode.hyps; while tracing, the read also takes
    the beam's hiwater for the `decode` span.  The frames run through the
    chunk runner `runner_for(config, initial beam, log-prob width)` gives,
    `chunk_frames` steps at a time.  The host waits for the card twice
    (counter `decode_host_syncs`): for the read and for the backtrace's
    words; its uploads do not wait."""
    dev = dfst.device
    c = chunk_frames
    with log.span("decode.init"):
        # Uploads from the host's (pageable) memory are staged at once,
        # so they need not wait for the card.
        logp = torch.as_tensor(logp, dtype=torch.float32).to(
            dev, non_blocking=True)
        b, t, p = logp.shape
        lengths = list(lengths) if lengths is not None else [t] * b
        beam, init_trace = init_beam_batch(config, b, dfst, dlm)
        len_arr = np.asarray(lengths)
        log.count("frames_decoded", int(len_arr.sum()))
        log.annotate("decode", batch=b, frames=int(len_arr.sum()), steps=t)
        # Whole chunks: the last is padded with invalid (identity) frames,
        # as the JAX decoder pads it, so one graph serves every length.
        valid = torch.from_numpy(np.arange(-(-t // c) * c)[:, None]
                                 < len_arr[None, :]).to(dev,
                                                        non_blocking=True)
        runner = runner_for(config, beam, p)
    logp_t = logp.transpose(0, 1)
    traces = None
    for off in range(0, t, c):
        n = min(c, t - off)
        # The selection's rows a chunk steps (B x chunk, its padding too)
        # and those whose frame is valid, the rows that do work there.
        log.count("frame_rows_stepped", b * c)
        log.count("frame_rows_valid", int(np.clip(len_arr - off, 0, c).sum()))
        with log.span("decode.frames", device=dev.type == "cuda", frames=n,
                      graph=runner.graph is not None):
            trace = runner.run(logp_t[off:off + n], valid[off:off + c])
            if traces is None:
                traces = _trace_buffer(init_trace, trace, t)
            traces.prev_slot[1 + off:1 + off + n].copy_(trace.prev_slot[:n])
            traces.words[1 + off:1 + off + n].copy_(trace.words[:n])
    if traces is None:  # no frame: the init trace alone
        traces = FrameTrace(init_trace.prev_slot[None],
                            init_trace.words[None])
    beam = runner.beam

    with log.span("decode.read"):
        overflow, hiwater, states, lms, costs = _to_host(
            runner.host, overflow=beam.overflow, hiwater=beam.hiwater,
            states=beam.states, lm=beam.lm, costs=beam.costs)
        if log.tracing():
            log.annotate("decode", hiwater=hiwater.max(axis=0).tolist(),
                         lanes=(emit_lanes(config, dfst)
                                if dfst.eps_removed else None))
        if overflow.any():
            bad = np.flatnonzero(overflow).tolist()
            raise BeamCapacityError(
                f"arc expansion overflowed capacity (expand_size="
                f"{config.expand_size}, eps_expand_size="
                f"{config.eps_expand_size}) for utterances {bad}",
                hiwater=tuple(int(x) for x in hiwater.max(axis=0)))
    if not device_backtrace:
        with log.span("decode.backtrace"):
            # Every frame's trace: buffers of this decode's alone.
            prev, word = _to_host({}, prev_slot=traces.prev_slot,
                                  words=traces.words)
            return [
                best_path([HostTrace(prev[f, u], word[f, u])
                           for f in range(lengths[u] + 1)],
                          states[u], lms[u], costs[u], fst, delta_lm,
                          end_of_stream=True)
                for u in range(b)
            ]
    with log.span("decode.backtrace"):
        frame_words, totals, empty = _device_backtrace(
            dfst, delta_lm, states, lms, costs, traces, final_fallback,
            runner.host)
    with log.span("decode.hyps"):
        # Utterance u's rows: the init trace and its frames; the invalid
        # frames past them carry no words.
        words = assemble_words_batch(frame_words, len_arr + 1)
        return [Hypothesis([], 0.0) if e else Hypothesis(w, total)
                for w, total, e in zip(words, totals.tolist(),
                                       empty.tolist())]


def _trace_buffer(init: FrameTrace, chunk: FrameTrace, t: int) -> FrameTrace:
    """The decode's own [1 + T, B, ...] trace, shaped like the chunk's,
    with `init` in frame 0.  In eps-free mode a graph with no epsilon arcs
    has a 1-wide init trace beside 2-wide frame traces (the JAX decoder
    fails to concatenate them); in the other modes the widths are equal.
    Words are zero-padded, so widening with zeros changes nothing."""
    prev = chunk.prev_slot.new_empty((1 + t,) + chunk.prev_slot.shape[1:])
    words = chunk.words.new_empty((1 + t,) + chunk.words.shape[1:])
    prev[0].copy_(init.prev_slot)
    words[0].zero_()
    words[0, ..., :init.words.shape[-1]].copy_(init.words)
    return FrameTrace(prev, words)


# The kernel wrappers a frame step launches through, each counting its
# launches on `.launches`; a graph's replay adds the launches it holds.
_FRAME_KERNELS = (expand_emitting, select_beam, lm_propagate_capped,
                  lm_propagate)


class _ChunkRunner:
    """`chunk` frame steps of a B-row batch over static buffers: the beam
    (carried from chunk to chunk), a [chunk, B, P] log-prob chunk and a
    [chunk, B] valid mask.  On a card the steps are one CUDA graph,
    captured once here and replayed per chunk; on the CPU they run
    eagerly over the same buffers.  The body is `decode_chunk` as every
    other caller runs it, followed by copies of its output beam into the
    static beam, so replays chain with no host work between them.  `pool`
    is the CUDA graph memory pool the capture allocates its temporaries
    and trace from (None: a private one).  `host` holds the pinned host
    buffers its decodes read the card into (`_to_host`)."""

    def __init__(self, cfg: BeamConfig, dfst: DeviceFst,
                 dlm: Optional[DeviceLm], beam: BeamState, chunk: int,
                 num_pdfs: int, pool=None):
        dev = dfst.device
        b = beam.states.shape[0]
        self.cfg, self.dfst, self.dlm = cfg, dfst, dlm
        self.beam = BeamState(*(x.clone() for x in beam))
        self.logp = torch.zeros((chunk, b, num_pdfs), dtype=torch.float32,
                                device=dev)
        self.valid = torch.zeros((chunk, b), dtype=torch.bool, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.trace: Optional[FrameTrace] = None
        self.launches = ()  # each of _FRAME_KERNELS' launches in a replay
        self.host: Dict[str, torch.Tensor] = {}
        if dev.type == "cuda":
            self._capture(pool)

    def _body(self) -> FrameTrace:
        beam, trace = decode_chunk(self.cfg, self.dfst, self.beam, self.logp,
                                   self.valid, self.dlm)
        for dst, src in zip(self.beam, beam):
            dst.copy_(src)
        return trace

    def _capture(self, pool) -> None:
        """One eager chunk on a side stream first (every kernel library
        loaded, the launch attributes set; the frames are invalid, so the
        beam stays valid), then the capture, its temporaries in `pool`.
        The capture launches nothing: the calls it made to each kernel
        wrapper are taken off its `.launches` and added at each replay."""
        dev = self.dfst.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = [k.launches for k in _FRAME_KERNELS]
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.trace = self._body()
        self.launches = tuple(k.launches - n
                              for k, n in zip(_FRAME_KERNELS, before))
        for k, n in zip(_FRAME_KERNELS, before):
            k.launches = n
        self.graph = graph
        log.count("frame_graph_captures")

    def reset(self, beam: BeamState) -> None:
        """Start a decode from `beam` (init_beam_batch's)."""
        for dst, src in zip(self.beam, beam):
            dst.copy_(src)

    def run(self, logp: torch.Tensor, valid: torch.Tensor) -> FrameTrace:
        """The next chunk: `logp` [n <= chunk, B, P] (the rows past n are
        zeroed) and `valid` [chunk, B].  Returns the chunk's [chunk, B,
        ...] trace, which the next run overwrites."""
        n = logp.shape[0]
        self.logp[:n].copy_(logp)
        if n < self.logp.shape[0]:
            self.logp[n:].zero_()
        self.valid.copy_(valid)
        if self.graph is None:
            return self._body()
        self.graph.replay()
        for k, n in zip(_FRAME_KERNELS, self.launches):
            k.launches += n
        log.count("frame_graph_replays")
        return self.trace


def _to_host(bufs: Dict[str, torch.Tensor],
             **tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors' values as numpy arrays after ONE wait for the card
    (counter `decode_host_syncs`, counted on the CPU too): on a card each
    is copied without blocking into the pinned buffer `bufs` keeps under
    its name (made, or doubled, to fit), then the host waits once for the
    copies; CPU tensors are read where they are.  The arrays are views of
    those buffers, which the next read of the name overwrites."""
    out, card = [], None
    for name, x in tensors.items():
        if x.device.type != "cuda":
            out.append(x.numpy())
            continue
        n = x.numel()
        buf = bufs.get(name)
        if buf is None or buf.numel() < n:
            grown = 2 * buf.numel() if buf is not None else 0
            buf = bufs[name] = torch.empty(max(n, grown), dtype=x.dtype,
                                           pin_memory=True)
        view = buf[:n].view(x.shape)
        view.copy_(x, non_blocking=True)
        out.append(view.numpy())
        card = x.device
    if card is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(card))
        done.synchronize()
    log.count("decode_host_syncs")
    return out


def _device_backtrace(dfst: DeviceFst, delta_lm: Optional[DeltaLmFst],
                      states: np.ndarray, lms: np.ndarray,
                      costs: np.ndarray, traces: FrameTrace,
                      final_fallback: bool,
                      host: Dict[str, torch.Tensor]):
    """(frame words [B, T, W], total cost [B] float64, no final token [B]
    bool) of the decode's [T, B, ...] traces: the host's exact final-weight
    pick (the graph's final weights from their host copy; a delta-LM final
    needs the backoff walk), then ONE backtrace on the device for the
    whole batch, its words read with one wait into `host`'s pinned
    buffers."""
    slots, totals, empty = pick_final(states, lms, costs, dfst.final_host,
                                      delta_lm, fallback=final_fallback)
    best = torch.from_numpy(slots).to(dfst.device, non_blocking=True)
    (frame_words,) = _to_host(host, words=backtrace_device(traces, best))
    return frame_words, totals, empty
