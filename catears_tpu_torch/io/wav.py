"""RIFF/WAVE parsing and streaming PCM byte -> float conversion.

Parity with reference src/pcm_reader.{h,cc}: strict canonical-header
validation (PCM only, subchunk1_size == 16, bytes_rate / block_align checks),
mono 16 kHz with 8/16/32-bit samples, raw integer amplitudes (no [-1,1]
normalization — Kaldi convention), and a streaming reader that carries
partial-sample bytes between calls.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, List, Tuple

import numpy as np

from catears_tpu_torch.utils.errors import CorruptionError, RuntimeError_

WAV_HEADER_SIZE = 44


@dataclass
class WaveFormat:
    num_channels: int
    sample_rate: int
    bits_per_sample: int


def read_pcm_header(fd: BinaryIO) -> WaveFormat:
    """Parse a canonical 44-byte RIFF/WAVE header with reference's checks."""

    def expect(tag: bytes):
        got = fd.read(len(tag))
        if got != tag:
            raise CorruptionError(f"expected {tag!r}, found {got!r}")

    def read_exact(n: int) -> bytes:
        data = fd.read(n)
        if len(data) != n:
            raise CorruptionError(
                f"truncated wav header: wanted {n} bytes, got {len(data)}")
        return data

    def read_i32() -> int:
        return struct.unpack("<i", read_exact(4))[0]

    def read_i16() -> int:
        return struct.unpack("<h", read_exact(2))[0]

    expect(b"RIFF")
    read_i32()  # chunk size (unchecked, as in the reference)
    expect(b"WAVE")
    expect(b"fmt ")
    subchunk1_size = read_i32()
    if subchunk1_size != 16:
        raise CorruptionError(
            f"subchunk1_size == 16 expected, but {subchunk1_size} found")
    audio_format = read_i16()
    if audio_format != 1:
        raise CorruptionError(
            f"audio_format == 1 expected, but {audio_format} found")
    num_channels = read_i16()
    sample_rate = read_i32()
    bytes_rate = read_i32()
    block_align = read_i16()
    bits_per_sample = read_i16()
    # Reference validates bytes_rate/block_align against bits_per_sample only
    # (mono assumption), reference src/pcm_reader.cc:87-101.
    if bytes_rate != sample_rate * bits_per_sample // 8:
        raise CorruptionError(
            f"bytes_rate == {sample_rate * bits_per_sample // 8} expected, "
            f"but {bytes_rate} found")
    if block_align != bits_per_sample // 8:
        raise CorruptionError(
            f"block_align == {bits_per_sample // 8} expected, "
            f"but {block_align} found")
    expect(b"data")
    read_i32()  # subchunk2 size (reference reads but ignores it)
    return WaveFormat(num_channels, sample_rate, bits_per_sample)


_SAMPLE_DTYPES = {8: np.int8, 16: np.dtype("<i2"), 32: np.dtype("<i4")}


class WaveReader:
    """Streaming bytes -> float32 sample conversion with partial-sample carry."""

    def __init__(self):
        self._format: WaveFormat = None
        self._buffer = bytearray()

    def set_format(self, fmt: WaveFormat) -> None:
        if fmt.num_channels != 1:
            raise CorruptionError(f"num_channels = {fmt.num_channels} not supported")
        if fmt.sample_rate != 16000:
            raise CorruptionError(f"sample_rate = {fmt.sample_rate} not supported")
        if fmt.bits_per_sample not in (8, 16, 32):
            raise CorruptionError(
                f"bits_per_sample == 8, 16 or 32 expected, "
                f"but {fmt.bits_per_sample} found")
        self._format = fmt

    @property
    def ready(self) -> bool:
        return self._format is not None

    def process(self, data: bytes) -> np.ndarray:
        """Consume bytes, return complete samples as float32 (raw amplitude)."""
        if data is None:
            raise RuntimeError_("buffer is None")
        if len(data) <= 0:
            raise RuntimeError_(f"unexpected size: {len(data)}")
        if not self.ready:
            raise RuntimeError_("WaveReader is not ready")
        self._buffer.extend(data)
        bytes_per_sample = self._format.bits_per_sample // 8
        num_samples = len(self._buffer) // bytes_per_sample
        used = num_samples * bytes_per_sample
        chunk = bytes(self._buffer[:used])
        del self._buffer[:used]
        dtype = _SAMPLE_DTYPES[self._format.bits_per_sample]
        return np.frombuffer(chunk, dtype=dtype).astype(np.float32)


def read_16k_pcm(path: str) -> np.ndarray:
    """One-shot: parse header and convert the whole payload (to EOF)."""
    with open(path, "rb") as fd:
        fmt = read_pcm_header(fd)
        reader = WaveReader()
        reader.set_format(fmt)
        data = fd.read()
    return reader.process(data)


def read_scp(path: str) -> List[Tuple[str, str]]:
    """Parse an .scp list: `name path` per line (reference src/main.cc:55-77)."""
    entries = []
    with open(path, "r", encoding="utf-8") as fd:
        for raw in fd:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise CorruptionError(f"unexpected scp line: {line}")
            entries.append((fields[0], fields[1]))
    return entries
