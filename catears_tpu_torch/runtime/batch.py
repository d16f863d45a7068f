"""Batched (offline) decoding of .scp utterance lists (port of
catears_tpu/runtime/batch.py).

Utterances are read by the native threaded loader (`utils/native.py`;
Python, file by file, where it cannot be built), the whole batch runs fbank
+ AM on the recognizer's device, and the beam search consumes the [B, T, P]
log-probs there.  Ragged batches stay exact per utterance:
waves are padded to one bucketed length (base 4096 samples), features are
context-padded per utterance with a clipped index gather (edge frames
replicated), and the int8 AM quantizes each utterance's own padded rows,
as the JAX batch path does under vmap.  With online CMVN (`cmvn_stats`)
each utterance goes through the host frontend instead (fbank, the float64
OnlineCMVN, the bucketed whole-utterance AM), as in the JAX batch path: the
sliding window is sequential per utterance.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from catears_tpu_torch.decode.decoder import BatchDecoder
from catears_tpu_torch.frontend.cmvn import OnlineCMVN
from catears_tpu_torch.frontend.fbank import (NUM_BINS, bucket,
                                              fbank_from_wave, num_frames)
from catears_tpu_torch.io.wav import read_16k_pcm, read_scp
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.utils import log, native


def load_waves(paths: List[str]) -> List[np.ndarray]:
    """Native threaded batch load, falling back to Python per-file reads."""
    batch = native.load_wav_batch(paths) if native.available() else None
    if batch is not None:
        return batch
    return [read_16k_pcm(p) for p in paths]


def _batched_logp(am, t_max: int, waves: torch.Tensor,
                  frame_counts: torch.Tensor) -> torch.Tensor:
    """[B, S] padded waves + [B] frame counts -> [B, t_max, P].

    Padded row j of utterance u reads feats[clip(j - left, 0, t_u - 1)],
    so output frame i < t_u sees the edge-replicated window whatever the
    batch padding.
    """
    left, right = am.left_context, am.right_context
    feats = fbank_from_wave(waves, t_max)  # [B, t_max, 40]
    j = torch.arange(t_max + left + right, device=waves.device) - left
    idx = torch.minimum(torch.clamp(j[None, :], min=0),
                        (frame_counts - 1)[:, None])
    idx = torch.remainder(idx, t_max)  # t_u == 0 reads the last row, as JAX
    padded = torch.gather(feats, 1, idx[..., None].expand(-1, -1, NUM_BINS))
    return am.forward_padded(padded)


def batched_logp(am, waves: List[np.ndarray]) -> Tuple[torch.Tensor,
                                                       List[int]]:
    """Ragged waves -> ([B, T_max, P] log-probs on am.device, lengths)."""
    lengths = [num_frames(w.shape[0]) for w in waves]
    t_max = max(max(lengths), 1)
    s_max = bucket(max(w.shape[0] for w in waves), base=4096)
    t_bucket = num_frames(s_max)
    padded = np.zeros((len(waves), s_max), np.float32)
    for i, w in enumerate(waves):
        padded[i, :w.shape[0]] = w
    dev = am.device
    with torch.no_grad():
        logp = _batched_logp(am, t_bucket, torch.from_numpy(padded).to(dev),
                             torch.as_tensor(lengths, dtype=torch.int64,
                                             device=dev))
    return logp[:, :t_max], lengths


def get_batch_decoder(recognizer: Recognizer) -> BatchDecoder:
    """Cached BatchDecoder for a Recognizer (device graph built once)."""
    cached = getattr(recognizer, "_batch_decoder", None)
    if cached is None:
        cached = BatchDecoder(
            recognizer.fst, recognizer.am.tid2pdf,
            config=recognizer.beam_config, arc_group=recognizer.arc_group,
            csr_group=recognizer.csr_group, device=recognizer.device,
            delta_lm=recognizer.delta_lm)
        recognizer._batch_decoder = cached
    return cached


def decode_scp(recognizer: Recognizer, scp_path: str,
               batch_size: int = 16) -> List[Tuple[str, str]]:
    """Decode every `name path` entry; returns (name, hyp) pairs in order."""
    entries = read_scp(scp_path)
    results: List[Tuple[str, str]] = []
    cmvn = (OnlineCMVN(recognizer.cmvn_stats)
            if recognizer.cmvn_stats is not None else None)
    table = recognizer.symbol_table
    dec = get_batch_decoder(recognizer)
    audio_s = 0.0
    for lo in range(0, len(entries), batch_size):
        chunk = entries[lo:lo + batch_size]
        waves = load_waves([path for _, path in chunk])
        audio_s += sum(w.shape[0] for w in waves) / 16000.0
        if cmvn is None:
            logp, lengths = batched_logp(recognizer.am, waves)
        else:
            logps = [recognizer.am.forward(cmvn.apply(
                recognizer.fbank.compute(wave))) for wave in waves]
            lengths = [lp.shape[0] for lp in logps]
            logp = np.zeros((len(chunk), max(max(lengths), 1),
                             logps[0].shape[1]), np.float32)
            for i, lp in enumerate(logps):
                logp[i, :lp.shape[0]] = lp
        hyps = dec.decode(logp, lengths)
        for (name, _), hyp in zip(chunk, hyps):
            results.append((name, " ".join(table.get(w) for w in hyp.words)))
    log.count("audio_seconds", audio_s)
    return results
