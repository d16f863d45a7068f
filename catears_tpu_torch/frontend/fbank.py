"""Log-mel filterbank frontend (port of catears_tpu/frontend/fbank.py).

Same Kaldi-parity chain: 16 kHz, 25 ms frames / 10 ms shift, DC removal,
pre-emphasis 0.97, Hamming window, zero-pad 400 -> 512, power spectrum,
40 triangular mel bins over FFT bins [0, 256), floor at FLT_EPSILON, log.
The real DFT and the mel bank are two float32 `torch.matmul`s (TF32 is off
package-wide), exactly as the JAX version computes them outside any kernel.
`Fbank.compute` pads a wave to the JAX package's bucketed frame count (each
frame is independent, so the pad changes no valid row; both packages run
the same shapes), and `FbankStream` carries leftover samples between calls.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from catears_tpu_torch.utils.device import Device, resolve_device

SAMPLE_RATE = 16000
FRAME_SHIFT = 160  # 10 ms
FRAME_LENGTH = 400  # 25 ms
PADDED_LENGTH = 512
NUM_BINS = 40
LOW_FREQ = 20.0
HIGH_FREQ = SAMPLE_RATE / 2
PREEMPH_COEFF = 0.97
FLT_EPSILON = np.float32(1.1920929e-07)
NUM_FFT_BINS = PADDED_LENGTH // 2  # mel bins cover [0, 256) like Kaldi


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def num_frames(num_samples: int) -> int:
    """snip-edges frame count."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


@functools.lru_cache(maxsize=None)
def _constants() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hamming[400], dft[400, 2*257], mel[257, 40]) as float32 numpy."""
    n = np.arange(FRAME_LENGTH, dtype=np.float64)
    hamming = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (FRAME_LENGTH - 1))
    # Real DFT of the zero-padded 512-sample frame, restricted to the 400
    # nonzero inputs: X[k] = sum_n x[n] exp(-2πi k n / 512).
    k = np.arange(NUM_FFT_BINS + 1, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(n, k) / PADDED_LENGTH
    dft = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    # Kaldi triangular mel bins: weight nonzero only strictly inside
    # (left_mel, right_mel).
    fft_bin_width = SAMPLE_RATE / PADDED_LENGTH
    mel_low = mel_scale(LOW_FREQ)
    mel_high = mel_scale(HIGH_FREQ)
    mel_delta = (mel_high - mel_low) / (NUM_BINS + 1)
    bin_mels = mel_scale(fft_bin_width * np.arange(NUM_FFT_BINS))
    mel = np.zeros((NUM_FFT_BINS + 1, NUM_BINS), np.float64)
    for b in range(NUM_BINS):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        w = np.where(bin_mels <= center, up, down)
        inside = (bin_mels > left) & (bin_mels < right)
        mel[:NUM_FFT_BINS, b] = np.where(inside, w, 0.0)
    return (hamming.astype(np.float32), dft.astype(np.float32),
            mel.astype(np.float32))


def frame_signal(wave: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[..., S] -> [..., T, 400] frame gather; indices clamped for tails."""
    idx = (torch.arange(n_frames, device=wave.device)[:, None] * FRAME_SHIFT
           + torch.arange(FRAME_LENGTH, device=wave.device)[None, :])
    idx = torch.clamp(idx, max=wave.shape[-1] - 1)
    return wave[..., idx]


def fbank_from_frames(frames: torch.Tensor) -> torch.Tensor:
    """[..., T, 400] raw sample frames -> [..., T, 40] log-mel features."""
    hamming, dft, mel = (torch.from_numpy(c).to(frames.device)
                         for c in _constants())
    x = frames - torch.mean(frames, dim=-1, keepdim=True)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x = (x - PREEMPH_COEFF * prev) * hamming
    spec = torch.matmul(x, dft)
    re, im = torch.split(spec, NUM_FFT_BINS + 1, dim=-1)
    power = re * re + im * im
    energies = torch.matmul(power, mel)
    return torch.log(torch.clamp(energies, min=float(FLT_EPSILON)))


def fbank_from_wave(wave: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[..., S] -> [..., n_frames, 40]."""
    return fbank_from_frames(frame_signal(wave, n_frames))


def bucket(n: int, base: int = 16) -> int:
    """A frame, row or sample count rounded up as the JAX package rounds it
    for its jit cache: `base`, then powers of two."""
    if n <= base:
        return base
    return 1 << (n - 1).bit_length()


class Fbank:
    """Host-facing extractor: numpy samples in, numpy features out, the
    work on `device` (the card unless the CPU is asked for)."""

    def __init__(self, device: Device = "cuda"):
        self.device = resolve_device(device)

    def compute(self, wave: np.ndarray) -> np.ndarray:
        """[S] float32 samples -> [T, 40] float32 features (numpy)."""
        t = num_frames(wave.shape[0])
        if t == 0:
            return np.zeros((0, NUM_BINS), np.float32)
        t_pad = bucket(t)
        s_pad = (t_pad - 1) * FRAME_SHIFT + FRAME_LENGTH
        padded = np.zeros(s_pad, np.float32)
        padded[:wave.shape[0]] = wave
        with torch.no_grad():
            feats = fbank_from_wave(torch.from_numpy(padded).to(self.device),
                                    t_pad)
        return feats[:t].cpu().numpy()


class FbankStream:
    """Streaming wrapper: carries leftover samples between process() calls.

    Each call emits every complete frame in the accumulated buffer and then
    drops FRAME_SHIFT * n_frames samples, keeping the 240-sample overlap for
    the next call.
    """

    def __init__(self, fbank: Optional[Fbank] = None):
        self._fbank = fbank or Fbank()
        self._buffer = np.zeros(0, np.float32)

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size:
            self._buffer = np.concatenate([self._buffer,
                                           samples.astype(np.float32)])
        t = num_frames(self._buffer.shape[0])
        if t == 0:
            return np.zeros((0, NUM_BINS), np.float32)
        feats = self._fbank.compute(self._buffer)
        self._buffer = self._buffer[FRAME_SHIFT * t:]
        return feats
