"""Standard OpenFST ConstFst<StdArc> binary reader.

This preserves the reference's deployment contract: HCLG graphs produced by
Kaldi's mkgraph.sh + fstconvert are loaded directly, exactly as the reference
does via `fst::ConstFst<fst::StdArc>::Read` (reference src/ce_stt.cc:124).

Layout (little-endian; vendored OpenFST 1.6 era, reference
src/openfst/lib/fst.cc:58-96, src/openfst/include/fst/const-fst.h:102-240):

  i32 magic = 2125659606
  string fsttype ("const")        # strings are i32 length + bytes
  string arctype ("standard")
  i32 version                     # 2 = unaligned, 1 = legacy aligned
  i32 flags                       # 1 HAS_ISYMBOLS, 2 HAS_OSYMBOLS, 4 IS_ALIGNED
  u64 properties
  i64 start, i64 numstates, i64 numarcs
  [embedded symbol tables if flagged]
  [align to 16 if aligned]
  numstates x ConstState { f32 final_weight; u32 pos, narcs, nieps, noeps }
  [align to 16 if aligned]
  numarcs x StdArc { i32 ilabel, olabel; f32 weight; i32 nextstate }
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from catears_tpu_torch.utils.errors import CorruptionError

FST_MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996
HAS_ISYMBOLS = 0x1
HAS_OSYMBOLS = 0x2
IS_ALIGNED = 0x4
ALIGNMENT = 16

_STATE_DTYPE = np.dtype([("final", "<f4"), ("pos", "<u4"), ("narcs", "<u4"),
                         ("nieps", "<u4"), ("noeps", "<u4")])
_ARC_DTYPE = np.dtype([("ilabel", "<i4"), ("olabel", "<i4"),
                       ("weight", "<f4"), ("nextstate", "<i4")])


@dataclass
class ConstFst:
    """A loaded ConstFst: dense per-state arc spans, OpenFST arc order kept."""

    start: int
    final: np.ndarray  # f32 [S]  (+inf == Weight::Zero() == non-final)
    arc_pos: np.ndarray  # u64 [S] first arc index
    arc_count: np.ndarray  # u32 [S]
    arc_ilabel: np.ndarray  # i32 [A]
    arc_olabel: np.ndarray  # i32 [A]
    arc_weight: np.ndarray  # f32 [A]
    arc_next: np.ndarray  # i32 [A]

    @property
    def num_states(self) -> int:
        return self.final.size

    @property
    def num_arcs(self) -> int:
        return self.arc_ilabel.size


def _read_exact(fd: BinaryIO, n: int) -> bytes:
    data = fd.read(n)
    if len(data) != n:
        raise CorruptionError(
            f"unexpected EOF in ConstFst: wanted {n} bytes, got {len(data)}")
    return data


def _unpack(fd: BinaryIO, fmt: str):
    return struct.unpack(fmt, _read_exact(fd, struct.calcsize(fmt)))


def _read_string(fd: BinaryIO) -> str:
    (n,) = _unpack(fd, "<i")
    if n < 0 or n > 1 << 20:
        raise CorruptionError(f"bad string length in FST header: {n}")
    return _read_exact(fd, n).decode("utf-8", errors="replace")


def _skip_symbol_table(fd: BinaryIO) -> None:
    (magic,) = _unpack(fd, "<i")
    if magic != SYMBOL_TABLE_MAGIC:
        raise CorruptionError(f"bad symbol table magic: {magic}")
    _read_string(fd)  # name
    _unpack(fd, "<q")  # available key
    (size,) = _unpack(fd, "<q")
    if size < 0:
        raise CorruptionError(f"bad symbol table size: {size}")
    for _ in range(size):
        _read_string(fd)
        _read_exact(fd, 8)  # key


def _align(fd: BinaryIO) -> None:
    pos = fd.tell()
    pad = (-pos) % ALIGNMENT
    if pad:
        fd.read(pad)


def read_const_fst(fd: BinaryIO) -> ConstFst:
    (magic,) = _unpack(fd, "<i")
    if magic != FST_MAGIC:
        raise CorruptionError(f"bad FST magic number: {magic}")
    fsttype = _read_string(fd)
    arctype = _read_string(fd)
    if fsttype != "const":
        raise CorruptionError(
            f"fst type 'const' expected, found '{fsttype}' "
            "(convert with: fstconvert --fst_type=const)")
    if arctype != "standard":
        raise CorruptionError(f"arc type 'standard' expected, found '{arctype}'")
    (version,) = _unpack(fd, "<i")
    (flags,) = _unpack(fd, "<i")
    _unpack(fd, "<Q")  # properties
    (start,) = _unpack(fd, "<q")
    (num_states,) = _unpack(fd, "<q")
    (num_arcs,) = _unpack(fd, "<q")
    if num_states < 0 or num_arcs < 0:
        raise CorruptionError(
            f"bad ConstFst sizes: {num_states} states, {num_arcs} arcs")
    if flags & HAS_ISYMBOLS:
        _skip_symbol_table(fd)
    if flags & HAS_OSYMBOLS:
        _skip_symbol_table(fd)
    aligned = (version == 1) or (flags & IS_ALIGNED)
    if aligned:
        _align(fd)
    states = np.frombuffer(fd.read(num_states * _STATE_DTYPE.itemsize),
                           dtype=_STATE_DTYPE)
    if states.size != num_states:
        raise CorruptionError("truncated ConstFst state table")
    if aligned:
        _align(fd)
    arcs = np.frombuffer(fd.read(num_arcs * _ARC_DTYPE.itemsize),
                         dtype=_ARC_DTYPE)
    if arcs.size != num_arcs:
        raise CorruptionError("truncated ConstFst arc table")
    return ConstFst(
        start=start,
        final=states["final"].astype(np.float32),
        arc_pos=states["pos"].astype(np.int64),
        arc_count=states["narcs"].astype(np.int32),
        arc_ilabel=arcs["ilabel"].astype(np.int32),
        arc_olabel=arcs["olabel"].astype(np.int32),
        arc_weight=arcs["weight"].astype(np.float32),
        arc_next=arcs["nextstate"].astype(np.int32),
    )


def read_const_fst_file(path: str) -> ConstFst:
    with open(path, "rb") as fd:
        return read_const_fst(fd)
