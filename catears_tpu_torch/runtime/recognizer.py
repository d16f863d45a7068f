"""Recognizer / Utterance runtime (port of
catears_tpu/runtime/recognizer.py; the reference's ce_stt lifecycle).

  Recognizer(config)        loads the HCLG (`fst`), the acoustic model
                            (`nnet`, `prior`, `tid2pdf`, contexts,
                            `quantized`), the symbol table, an optional
                            delta-LM (`large_lm` G' with its `original_lm`
                            unigram vector), optional online CMVN stats
                            (`cmvn_stats`) and the decoder geometry
                            (`beam_size`, `expand_size`, `eps_expand_size`,
                            `lm_expand_size`, `select_compact`,
                            `max_eps_iters`, `beam`, `arc_group`,
                            `csr_group`), or takes `beam_config=`;
                            `am_scale` (default AM_SCALE, 0.1; a chain
                            model's is 1.0), and the AM's `feature_type`
                            (am/model.py)
  create_utterance(format)  one live stream: bytes -> samples -> fbank ->
                            (CMVN) -> AM -> decoder, a partial hypothesis
                            refreshed every 20 decoded frames
  create_stream_batch(n)    n live streams in one fused step per chunk
                            (both refuse a subsampled or i-vector model)
  decode_wav_file(r, path)  one wav streamed through an Utterance (the CLI)

`device` places the acoustic model, the fbank and the decode graph: the
card unless the CPU is asked for.  The graph decodes in whichever mode
graph.transform.prepare_decode_graph gives it (eps-free, closed or raw),
as in JAX.
"""

from __future__ import annotations

from typing import Optional

from catears_tpu_torch.am.model import AcousticModel, AMStream
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.decode.decoder import Decoder, build_decode_graph
from catears_tpu_torch.frontend.cmvn import CMVNStream
from catears_tpu_torch.frontend.fbank import Fbank, FbankStream
from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu_torch.io.binfmt import read_vec0_file
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.io.symbols import SymbolTable
from catears_tpu_torch.io.wav import WaveFormat, WaveReader, read_pcm_header
from catears_tpu_torch.runtime.streaming import (BatchStreamingSession,
                                                 StreamingSession)
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import CorruptionError

AM_SCALE = 0.1  # default acoustic scale (`am_scale`), as in the JAX runtime
PARTIAL_HYP_INTERVAL = 20  # frames between partial hypotheses


class Recognizer:
    def __init__(self, config_path: str,
                 beam_config: Optional[BeamConfig] = None,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        conf = Configuration.read(config_path)
        self.conf = conf
        self.fst = FlatFst.read(conf.get_path("fst"))
        self.am = AcousticModel.read(conf, device=self.device)
        self.am_scale = conf.get_float("am_scale", AM_SCALE)
        self.symbol_table = SymbolTable.read(conf.get_path("symbol_table"))
        self.delta_lm = self._read_delta_lm(conf)
        self.cmvn_stats = None
        if conf.has("cmvn_stats"):
            self.cmvn_stats = read_vec0_file(conf.get_path("cmvn_stats"))
        self.fbank = Fbank(device=self.device)
        if beam_config is None:
            # Decoder geometry from the config (the keys tools.tune
            # prints); unset keys keep the defaults.
            geo = {}
            for key in ("beam_size", "expand_size", "eps_expand_size",
                        "lm_expand_size", "select_compact",
                        "max_eps_iters"):
                if conf.has(key):
                    geo[key] = conf.get_int(key)
            if conf.has("beam"):
                geo["beam"] = conf.get_float("beam")
            beam_config = BeamConfig(am_scale=self.am_scale, **geo)
        self.beam_config = beam_config
        self.arc_group = conf.get_int("arc_group", 4)
        self.csr_group = conf.get_int("csr_group", 0) or None

    def _read_delta_lm(self, conf: Configuration) -> Optional[DeltaLmFst]:
        large_lm_file = conf.get_path("large_lm", "")
        if not large_lm_file:
            return None
        original_lm_file = conf.get_path("original_lm", "")
        if not original_lm_file:
            raise CorruptionError(
                f"unable to find key 'original_lm' in {conf.filename}")
        small_lm = read_vec0_file(original_lm_file)
        lm = LmFst.read_lm(large_lm_file)
        return DeltaLmFst(small_lm, lm, self.symbol_table)

    def create_utterance(self, fmt: WaveFormat) -> "Utterance":
        return Utterance(self, fmt)

    def create_stream_batch(self, n_streams: int) -> BatchStreamingSession:
        """N concurrent live streams in one fused device step per chunk."""
        cfg, dfst, dlm = self._decode_graph()
        return BatchStreamingSession(
            self.am, self.fst, self.delta_lm, cfg, dfst, dlm, n_streams,
            chunk_frames=PARTIAL_HYP_INTERVAL, cmvn_stats=self.cmvn_stats)

    def _decode_graph(self):
        """Cached (BeamConfig, DeviceFst, DeviceLm): the device graph is
        built once per Recognizer, not once per utterance."""
        cached = getattr(self, "_graph_cache", None)
        if cached is None:
            cached = build_decode_graph(
                self.fst, self.am.tid2pdf, self.am_scale, self.delta_lm,
                self.beam_config, arc_group=self.arc_group, close_eps=True,
                csr_group=self.csr_group, device=self.device)[:3]
            self._graph_cache = cached
        return cached


class Utterance:
    """One streaming decode session.

    Two execution paths with identical semantics:
      - fused (default): fbank + (CMVN) + AM + decode in one device step
        per 20-frame chunk (runtime/streaming.py); online CMVN runs on the
        device as a carried 600-frame ring
      - componentized: FbankStream -> CMVNStream -> AMStream -> Decoder,
        used when fused=False
    """

    def __init__(self, recognizer: Recognizer, fmt: WaveFormat,
                 fused: bool = True):
        self.recognizer = recognizer
        self.wave_reader = WaveReader()
        self.wave_reader.set_format(fmt)
        self.cmvn_stream = None
        cfg, dfst, dlm = recognizer._decode_graph()
        self.decoder = self.session = None
        if fused:
            self.session = StreamingSession(
                recognizer.am, recognizer.fst, recognizer.delta_lm, cfg,
                dfst, dlm, chunk_frames=PARTIAL_HYP_INTERVAL,
                cmvn_stats=recognizer.cmvn_stats)
        else:
            self.decoder = Decoder(
                recognizer.fst, recognizer.am.tid2pdf,
                am_scale=recognizer.am_scale,
                delta_lm=recognizer.delta_lm, config=cfg,
                chunk_frames=PARTIAL_HYP_INTERVAL, dfst=dfst, dlm=dlm)
            if recognizer.cmvn_stats is not None:
                self.cmvn_stream = CMVNStream(recognizer.cmvn_stats)
            self.fbank_stream = FbankStream(recognizer.fbank)
            self.am_stream = AMStream(recognizer.am)
        self.hyp = ""
        self.loglikelihood_per_frame = 0.0
        self._last_partial_at = 0

    def process(self, data: bytes) -> int:
        """Feed raw PCM bytes; returns the number of samples consumed."""
        samples = self.wave_reader.process(data)
        if samples.size == 0:
            return 0
        log.count("audio_seconds", samples.size / 16000.0)
        if self.session is not None:
            with log.timed("process"):
                self.session.process(samples)
            decoded = self.session.num_frames_decoded
            if decoded - self._last_partial_at >= PARTIAL_HYP_INTERVAL:
                self._store_hyp(end_of_stream=False)
                self._last_partial_at = decoded
            return int(samples.size)
        with log.timed("frontend"):
            feats = self.fbank_stream.process(samples)
            if self.cmvn_stream is not None and feats.shape[0]:
                feats = self.cmvn_stream.process(feats)
        with log.timed("am"):
            logp = self.am_stream.process(feats)
        if logp.shape[0]:
            with log.timed("decode"):
                self.decoder.process(logp)
            decoded = self.decoder.num_frames_decoded
            if decoded - self._last_partial_at >= PARTIAL_HYP_INTERVAL:
                self._store_hyp(end_of_stream=False)
                self._last_partial_at = decoded
        return int(samples.size)

    def end_of_stream(self) -> None:
        if self.session is not None:
            self.session.end_of_stream()
            self._store_hyp(end_of_stream=True)
            return
        logp = self.am_stream.end_of_stream()
        if logp.shape[0]:
            self.decoder.process(logp)
        self.decoder.end_of_stream()
        self._store_hyp(end_of_stream=True)

    # -- session checkpoint/resume ----------------------------------------
    # The whole session snapshots to plain numpy structures (picklable;
    # the JAX Utterance's keys), restorable into a fresh Utterance.

    def get_state(self) -> dict:
        state = {
            "wave_buffer": bytes(self.wave_reader._buffer),
            "cmvn_history": (self.cmvn_stream._history.copy()
                             if self.cmvn_stream is not None else None),
            "hyp": self.hyp,
            "llh_per_frame": self.loglikelihood_per_frame,
            "last_partial_at": self._last_partial_at,
        }
        if self.session is not None:
            state["session"] = self.session.get_state()
        else:
            state["fbank_buffer"] = self.fbank_stream._buffer.copy()
            state["am_buffer"] = (None if self.am_stream._buffer is None
                                  else self.am_stream._buffer.copy())
            state["am_started"] = self.am_stream._started
            state["decoder"] = self.decoder.get_state()
        return state

    def set_state(self, state: dict) -> None:
        self.wave_reader._buffer = bytearray(state["wave_buffer"])
        if self.cmvn_stream is not None and state["cmvn_history"] is not None:
            self.cmvn_stream._history = state["cmvn_history"].copy()
        if self.session is not None:
            self.session.set_state(state["session"])
        else:
            self.fbank_stream._buffer = state["fbank_buffer"].copy()
            self.am_stream._buffer = (None if state["am_buffer"] is None
                                      else state["am_buffer"].copy())
            self.am_stream._started = state["am_started"]
            self.decoder.set_state(state["decoder"])
        self.hyp = state["hyp"]
        self.loglikelihood_per_frame = state["llh_per_frame"]
        self._last_partial_at = state["last_partial_at"]

    def _store_hyp(self, end_of_stream: bool) -> None:
        if self.session is not None:
            hyp = self.session.best_path(end_of_stream)
            frames = max(self.session.num_frames_decoded, 1)
        else:
            self.decoder.is_end_of_stream = end_of_stream
            hyp = self.decoder.best_path()
            frames = max(self.decoder.num_frames_decoded, 1)
        table = self.recognizer.symbol_table
        self.hyp = " ".join(table.get(w) for w in hyp.words)
        self.loglikelihood_per_frame = hyp.weight / frames


def decode_wav_file(recognizer: Recognizer, path: str,
                    chunk_bytes: int = 1024) -> str:
    """Decode one wav file streamed in fixed-size chunks (CLI parity)."""
    with open(path, "rb") as fd:
        fmt = read_pcm_header(fd)
        utt = recognizer.create_utterance(fmt)
        while True:
            chunk = fd.read(chunk_bytes)
            if not chunk:
                break
            utt.process(chunk)
    utt.end_of_stream()
    return utt.hyp
