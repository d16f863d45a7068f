"""Readers/writers for the pocketkaldi binary artifact formats.

Wire contract (must stay byte-compatible with the reference so the same model
files work in both frameworks):

  VEC0       "VEC0" + i32 section_size(dim*itemsize+4) + i32 dim + raw LE data
             (reference src/vector.cc:268-300)
  MAT0       "MAT0" + i32 8 + i32 rows + i32 cols + rows x VEC0
             (reference src/matrix.cc:160-191, tool/convert_am.py write_matrix)
  NN02       "NN02" + i32 left_ctx + i32 right_ctx + i32 n_layers +
             per layer: "LAY0" + i32 type + payload
             (reference src/nnet.cc:221-293, src/nnet.h:11-30); types 0-9
             are the reference's, 10-13 this package's factored TDNN
             (Kaldi's chain TDNN-F), which the reference does not read:
               10 spliced linear   i32 n + n x i32 offsets + MAT0 weight
                                   [n*in, out], no bias
               11 tdnnf block      i32 stride + f32 bypass + MAT0 linear
                                   + MAT0 affine + VEC0 bias + VEC0
                                   batchnorm scale + VEC0 offset
               12 subsample        i32 factor
               13 i-vector append  i32 dim
             and 14-16 its chain TDNN-LSTM's (Kaldi's fast-lstmp-layer):
               14 LSTMP            i32 delay (frames, < 0) + f32
                                   recurrence scale + i32 recurrent
                                   projection width R + MAT0 W_all
                                   [in + R, 4 C] (gates i, f, g, o; the
                                   input rows first) + VEC0 bias [4 C] +
                                   MAT0 peepholes [3, C] (w_ic, w_fc,
                                   w_oc) + MAT0 projection [C, R + P] +
                                   VEC0 projection bias [R + P]
               15 spliced affine   kind 10's payload + VEC0 bias [out]
               16 delay            i32 frames d: out(t) = in(t - d)
             and 17 its chain BLSTM's (two fast-lstmp-layers, delays -d
             and +d, on one input, their outputs appended):
               17 BLSTMP           i32 d (frames, > 0) + the forward
                                   LSTMP's payload after its delay (f32
                                   scale + i32 R + MAT0 W_all + VEC0 bias
                                   + MAT0 peepholes + MAT0 projection +
                                   VEC0 projection bias, as kind 14) +
                                   the backward LSTMP's, the same; the
                                   output is [forward; backward]
  pk::fst_0  32-byte name + i32 section_size + i32 n_states + i32 n_arcs +
             i32 start + f32 final[n_states] + i32 first_arc_idx[n_states] +
             n_arcs x (i32 next, i32 ilabel, i32 olabel, f32 weight), arcs
             sorted by (state, ilabel)
             (reference src/fst.cc:51-111, tool/convert_fstfmt.py)

All multi-byte values are little-endian.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Tuple

import numpy as np

from catears_tpu_torch.utils.errors import CorruptionError

# Layer type ids in the NN02 format (reference src/nnet.h:21-30).
LAYER_LINEAR = 0
LAYER_RELU = 1
LAYER_NORMALIZE = 2
LAYER_SOFTMAX = 3
LAYER_SPLICE = 6
LAYER_BATCHNORM = 7
LAYER_LOGSOFTMAX = 8
LAYER_NARROW = 9
# The factored TDNN's kinds (this package's; see the module docstring).
LAYER_SPLICED_LINEAR = 10
LAYER_TDNNF = 11
LAYER_SUBSAMPLE = 12
LAYER_IVECTOR = 13
# The chain TDNN-LSTM's kinds (this package's; see the module docstring).
LAYER_LSTMP = 14
LAYER_SPLICED_AFFINE = 15
LAYER_DELAY = 16
# The chain BLSTM's kind (this package's; see the module docstring).
LAYER_BLSTMP = 17

PKFST_SECTION = b"pk::fst_0"


def _read_exact(fd: BinaryIO, n: int) -> bytes:
    data = fd.read(n)
    if len(data) != n:
        raise CorruptionError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
    return data


def _expect(fd: BinaryIO, token: bytes) -> None:
    data = _read_exact(fd, len(token))
    if data != token:
        raise CorruptionError(f"expected {token!r}, found {data!r}")


def _read_i32(fd: BinaryIO) -> int:
    return struct.unpack("<i", _read_exact(fd, 4))[0]


def read_vec0(fd: BinaryIO, dtype=np.float32) -> np.ndarray:
    """Read one VEC0 section."""
    dtype = np.dtype(dtype)
    _expect(fd, b"VEC0")
    section_size = _read_i32(fd)
    dim = _read_i32(fd)
    if dim * dtype.itemsize + 4 != section_size:
        raise CorruptionError(
            f"VEC0: section_size {dim}*{dtype.itemsize}+4 expected, "
            f"found {section_size}")
    data = _read_exact(fd, dim * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype.newbyteorder("<")).astype(dtype)


def write_vec0(fd: BinaryIO, vec: np.ndarray) -> None:
    vec = np.ascontiguousarray(vec)
    fd.write(b"VEC0")
    fd.write(struct.pack("<i", vec.size * vec.dtype.itemsize + 4))
    fd.write(struct.pack("<i", vec.size))
    fd.write(vec.astype(vec.dtype.newbyteorder("<")).tobytes())


def read_mat0(fd: BinaryIO, dtype=np.float32) -> np.ndarray:
    """Read one MAT0 section (rows stored as VEC0 sections)."""
    _expect(fd, b"MAT0")
    _read_i32(fd)  # section_size: always 8 in the writer; not validated upstream
    rows = _read_i32(fd)
    cols = _read_i32(fd)
    mat = np.empty((rows, cols), dtype=dtype)
    for r in range(rows):
        row = read_vec0(fd, dtype)
        if row.size != cols:
            raise CorruptionError(
                f"MAT0: row {r} has {row.size} values, expected {cols}")
        mat[r] = row
    return mat


def write_mat0(fd: BinaryIO, mat: np.ndarray) -> None:
    mat = np.asarray(mat)
    fd.write(b"MAT0")
    fd.write(struct.pack("<i", 8))
    fd.write(struct.pack("<i", mat.shape[0]))
    fd.write(struct.pack("<i", mat.shape[1]))
    for r in range(mat.shape[0]):
        write_vec0(fd, mat[r])


@dataclass
class LayerSpec:
    """One layer parsed from an NN02 file."""

    kind: int
    # kind-dependent payload:
    weight: np.ndarray = None  # linear: [in_dim, out_dim] (file stores W^T)
    bias: np.ndarray = None  # linear
    scale: np.ndarray = None  # batchnorm
    offset: np.ndarray = None  # batchnorm
    indices: Tuple[int, ...] = ()  # splice
    narrow_left: int = 0  # narrow
    narrow_right: int = 0  # narrow
    offsets: Tuple[int, ...] = ()  # spliced linear: time offsets
    stride: int = 0  # tdnnf: time stride in input frames
    bypass: float = 0.0  # tdnnf: scale of the block's input added back
    linear: np.ndarray = None  # tdnnf: [k*dim, bottleneck], no bias
    affine: np.ndarray = None  # tdnnf: [k*bottleneck, dim], bias `bias`
    factor: int = 0  # subsample
    dim: int = 0  # i-vector append
    delay: int = 0  # lstmp: recurrence offset; delay: output delay (frames)
    rec_scale: float = 1.0  # lstmp: scale of c(t + delay), r(t + delay)
    rec_dim: int = 0  # lstmp: recurrent projection width R
    peephole: np.ndarray = None  # lstmp: [3, C] (w_ic, w_fc, w_oc)
    projection: np.ndarray = None  # lstmp: [C, R + P]
    projection_bias: np.ndarray = None  # lstmp: [R + P]
    backward: "LayerSpec" = None  # blstmp: the backward LSTMP (delay > 0)


@dataclass
class NnetSpec:
    left_context: int
    right_context: int
    layers: List[LayerSpec] = field(default_factory=list)


def _read_lstmp(fd: BinaryIO, kind: int, delay: int) -> LayerSpec:
    """An LSTMP payload after its delay (kinds 14 and 17)."""
    scale = struct.unpack("<f", _read_exact(fd, 4))[0]
    rec = _read_i32(fd)
    w, b = read_mat0(fd), read_vec0(fd)
    peep, proj, proj_b = read_mat0(fd), read_mat0(fd), read_vec0(fd)
    cells = proj.shape[0]
    if not 0 < rec <= proj.shape[1] \
            or w.shape[0] <= rec or w.shape[1] != 4 * cells \
            or b.size != 4 * cells or peep.shape != (3, cells) \
            or proj_b.size != proj.shape[1]:
        raise CorruptionError(
            f"lstmp layer: delay {delay}, recurrent width {rec}, "
            f"W_all {w.shape}, bias {b.size}, peepholes "
            f"{peep.shape}, projection {proj.shape}, its bias "
            f"{proj_b.size}")
    return LayerSpec(kind, delay=delay, rec_scale=scale, rec_dim=rec,
                     weight=w, bias=b, peephole=peep, projection=proj,
                     projection_bias=proj_b)


def _write_lstmp(fd: BinaryIO, layer: LayerSpec) -> None:
    """An LSTMP payload after its delay (kinds 14 and 17)."""
    fd.write(struct.pack("<f", layer.rec_scale))
    fd.write(struct.pack("<i", layer.rec_dim))
    write_mat0(fd, np.asarray(layer.weight, np.float32))
    write_vec0(fd, np.asarray(layer.bias, np.float32))
    write_mat0(fd, np.asarray(layer.peephole, np.float32))
    write_mat0(fd, np.asarray(layer.projection, np.float32))
    write_vec0(fd, np.asarray(layer.projection_bias, np.float32))


def read_nnet(fd: BinaryIO) -> NnetSpec:
    """Read an NN02 nnet file into layer specs."""
    _expect(fd, b"NN02")
    left = _read_i32(fd)
    right = _read_i32(fd)
    n_layers = _read_i32(fd)
    spec = NnetSpec(left, right)
    for _ in range(n_layers):
        _expect(fd, b"LAY0")
        kind = _read_i32(fd)
        if kind == LAYER_LINEAR:
            w = read_mat0(fd)
            b = read_vec0(fd)
            if b.size != w.shape[1]:
                raise CorruptionError(
                    f"linear layer: bias dim {b.size} != out dim {w.shape[1]}")
            spec.layers.append(LayerSpec(kind, weight=w, bias=b))
        elif kind == LAYER_SPLICE:
            n = _read_i32(fd)
            if n < 0:
                raise CorruptionError("splice layer: negative index count")
            idx = tuple(_read_i32(fd) for _ in range(n))
            spec.layers.append(LayerSpec(kind, indices=idx))
        elif kind == LAYER_BATCHNORM:
            scale = read_vec0(fd)
            offset = read_vec0(fd)
            spec.layers.append(LayerSpec(kind, scale=scale, offset=offset))
        elif kind == LAYER_NARROW:
            nl = _read_i32(fd)
            nr = _read_i32(fd)
            spec.layers.append(LayerSpec(kind, narrow_left=nl, narrow_right=nr))
        elif kind in (LAYER_RELU, LAYER_NORMALIZE, LAYER_SOFTMAX,
                      LAYER_LOGSOFTMAX):
            spec.layers.append(LayerSpec(kind))
        elif kind in (LAYER_SPLICED_LINEAR, LAYER_SPLICED_AFFINE):
            n = _read_i32(fd)
            if n <= 0:
                raise CorruptionError("spliced linear: no time offset")
            offsets = tuple(_read_i32(fd) for _ in range(n))
            w = read_mat0(fd)
            if w.shape[0] % n:
                raise CorruptionError(
                    f"spliced linear: {w.shape[0]} input rows for {n} "
                    f"offsets")
            b = None
            if kind == LAYER_SPLICED_AFFINE:
                b = read_vec0(fd)
                if b.size != w.shape[1]:
                    raise CorruptionError(
                        f"spliced affine: bias dim {b.size} != out dim "
                        f"{w.shape[1]}")
            spec.layers.append(LayerSpec(kind, offsets=offsets, weight=w,
                                         bias=b))
        elif kind == LAYER_LSTMP:
            delay = _read_i32(fd)
            if delay >= 0:
                raise CorruptionError(f"lstmp layer: delay {delay}")
            spec.layers.append(_read_lstmp(fd, kind, delay))
        elif kind == LAYER_BLSTMP:
            delay = _read_i32(fd)
            if delay <= 0:
                raise CorruptionError(f"blstmp layer: delay {delay}")
            layer = _read_lstmp(fd, kind, -delay)
            layer.backward = _read_lstmp(fd, LAYER_LSTMP, delay)
            if layer.weight.shape[0] - layer.rec_dim != \
                    layer.backward.weight.shape[0] - layer.backward.rec_dim:
                raise CorruptionError(
                    f"blstmp layer: input widths "
                    f"{layer.weight.shape[0] - layer.rec_dim} and "
                    f"{layer.backward.weight.shape[0] - layer.backward.rec_dim}")
            spec.layers.append(layer)
        elif kind == LAYER_DELAY:
            spec.layers.append(LayerSpec(kind, delay=_read_i32(fd)))
        elif kind == LAYER_TDNNF:
            stride = _read_i32(fd)
            bypass = struct.unpack("<f", _read_exact(fd, 4))[0]
            lin, aff = read_mat0(fd), read_mat0(fd)
            b, scale, offset = read_vec0(fd), read_vec0(fd), read_vec0(fd)
            k = 2 if stride else 1
            dim, neck = aff.shape[1], lin.shape[1]
            if stride < 0 or lin.shape[0] != k * dim \
                    or aff.shape[0] != k * neck \
                    or not b.size == scale.size == offset.size == dim:
                raise CorruptionError(
                    f"tdnnf layer: stride {stride}, linear {lin.shape}, "
                    f"affine {aff.shape}, vectors {b.size}/{scale.size}/"
                    f"{offset.size}")
            spec.layers.append(LayerSpec(
                kind, stride=stride, bypass=bypass, linear=lin, affine=aff,
                bias=b, scale=scale, offset=offset))
        elif kind == LAYER_SUBSAMPLE:
            factor = _read_i32(fd)
            if factor < 1:
                raise CorruptionError(f"subsample layer: factor {factor}")
            spec.layers.append(LayerSpec(kind, factor=factor))
        elif kind == LAYER_IVECTOR:
            dim = _read_i32(fd)
            if dim < 1:
                raise CorruptionError(f"i-vector layer: dim {dim}")
            spec.layers.append(LayerSpec(kind, dim=dim))
        else:
            raise CorruptionError(f"unexpected layer type: {kind}")
    return spec


def write_nnet(fd: BinaryIO, spec: NnetSpec) -> None:
    fd.write(b"NN02")
    fd.write(struct.pack("<i", spec.left_context))
    fd.write(struct.pack("<i", spec.right_context))
    fd.write(struct.pack("<i", len(spec.layers)))
    for layer in spec.layers:
        fd.write(b"LAY0")
        fd.write(struct.pack("<i", layer.kind))
        if layer.kind == LAYER_LINEAR:
            write_mat0(fd, np.asarray(layer.weight, np.float32))
            write_vec0(fd, np.asarray(layer.bias, np.float32))
        elif layer.kind == LAYER_SPLICE:
            fd.write(struct.pack("<i", len(layer.indices)))
            for i in layer.indices:
                fd.write(struct.pack("<i", i))
        elif layer.kind == LAYER_BATCHNORM:
            write_vec0(fd, np.asarray(layer.scale, np.float32))
            write_vec0(fd, np.asarray(layer.offset, np.float32))
        elif layer.kind == LAYER_NARROW:
            fd.write(struct.pack("<i", layer.narrow_left))
            fd.write(struct.pack("<i", layer.narrow_right))
        elif layer.kind in (LAYER_SPLICED_LINEAR, LAYER_SPLICED_AFFINE):
            fd.write(struct.pack("<i", len(layer.offsets)))
            for o in layer.offsets:
                fd.write(struct.pack("<i", o))
            write_mat0(fd, np.asarray(layer.weight, np.float32))
            if layer.kind == LAYER_SPLICED_AFFINE:
                write_vec0(fd, np.asarray(layer.bias, np.float32))
        elif layer.kind == LAYER_LSTMP:
            fd.write(struct.pack("<i", layer.delay))
            _write_lstmp(fd, layer)
        elif layer.kind == LAYER_BLSTMP:
            fd.write(struct.pack("<i", -layer.delay))
            _write_lstmp(fd, layer)
            _write_lstmp(fd, layer.backward)
        elif layer.kind == LAYER_DELAY:
            fd.write(struct.pack("<i", layer.delay))
        elif layer.kind == LAYER_TDNNF:
            fd.write(struct.pack("<i", layer.stride))
            fd.write(struct.pack("<f", layer.bypass))
            write_mat0(fd, np.asarray(layer.linear, np.float32))
            write_mat0(fd, np.asarray(layer.affine, np.float32))
            for v in (layer.bias, layer.scale, layer.offset):
                write_vec0(fd, np.asarray(v, np.float32))
        elif layer.kind == LAYER_SUBSAMPLE:
            fd.write(struct.pack("<i", layer.factor))
        elif layer.kind == LAYER_IVECTOR:
            fd.write(struct.pack("<i", layer.dim))


@dataclass
class RawFst:
    """A pk::fst_0 file as flat arrays (arcs sorted by (state, ilabel))."""

    start: int
    final: np.ndarray  # f32 [S], +inf for non-final states
    first_arc: np.ndarray  # i32 [S], first arc index per state or -1
    arc_next: np.ndarray  # i32 [A]
    arc_ilabel: np.ndarray  # i32 [A]
    arc_olabel: np.ndarray  # i32 [A]
    arc_weight: np.ndarray  # f32 [A]

    @property
    def num_states(self) -> int:
        return self.final.size

    @property
    def num_arcs(self) -> int:
        return self.arc_next.size


def read_pkfst(fd: BinaryIO) -> RawFst:
    name = _read_exact(fd, 32)
    if name.rstrip(b"\0") != PKFST_SECTION:
        raise CorruptionError(f"bad pk::fst_0 section name: {name!r}")
    section_size = _read_i32(fd)
    n_states = _read_i32(fd)
    n_arcs = _read_i32(fd)
    start = _read_i32(fd)
    expected = 12 + 8 * n_states + 16 * n_arcs
    if expected != section_size:
        raise CorruptionError(
            f"pk::fst_0 section_size {expected} expected, found {section_size}")
    final = np.frombuffer(_read_exact(fd, 4 * n_states), "<f4").astype(np.float32)
    first_arc = np.frombuffer(_read_exact(fd, 4 * n_states), "<i4").astype(np.int32)
    arcs = np.frombuffer(_read_exact(fd, 16 * n_arcs),
                         dtype=[("next", "<i4"), ("ilabel", "<i4"),
                                ("olabel", "<i4"), ("weight", "<f4")])
    return RawFst(
        start=start,
        final=final,
        first_arc=first_arc,
        arc_next=arcs["next"].astype(np.int32),
        arc_ilabel=arcs["ilabel"].astype(np.int32),
        arc_olabel=arcs["olabel"].astype(np.int32),
        arc_weight=arcs["weight"].astype(np.float32),
    )


def write_pkfst(fd: BinaryIO, fst: RawFst) -> None:
    n_states, n_arcs = fst.num_states, fst.num_arcs
    fd.write(PKFST_SECTION.ljust(32, b"\0"))
    fd.write(struct.pack("<i", 12 + 8 * n_states + 16 * n_arcs))
    fd.write(struct.pack("<i", n_states))
    fd.write(struct.pack("<i", n_arcs))
    fd.write(struct.pack("<i", fst.start))
    fd.write(np.asarray(fst.final, "<f4").tobytes())
    fd.write(np.asarray(fst.first_arc, "<i4").tobytes())
    arcs = np.empty(n_arcs, dtype=[("next", "<i4"), ("ilabel", "<i4"),
                                   ("olabel", "<i4"), ("weight", "<f4")])
    arcs["next"] = fst.arc_next
    arcs["ilabel"] = fst.arc_ilabel
    arcs["olabel"] = fst.arc_olabel
    arcs["weight"] = fst.arc_weight
    fd.write(arcs.tobytes())


def read_vec0_file(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as fd:
        return read_vec0(fd, dtype)


def read_nnet_file(path: str) -> NnetSpec:
    with open(path, "rb") as fd:
        return read_nnet(fd)


def read_pkfst_file(path: str) -> RawFst:
    with open(path, "rb") as fd:
        return read_pkfst(fd)
