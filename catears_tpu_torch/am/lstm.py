"""The recurrence of Kaldi's projected LSTM with peepholes (the
fast-lstmp-layer of the chain TDNN-LSTM recipes; `LstmNonlinearityComponent`
+ the recurrent-projection affine), which the JAX package does not have.

`lstm_recurrence` steps one recurrence of delay one row over T rows,
given the input half of the gates already computed for every row (one
batched GEMM, am/nnet.py): with s the recurrence scale, c(-1) = r(-1) = 0,

    g(t) = gx(t) + (s r(t-1)) W_r                [B, 4C]: i, f, g, o
    i = sigmoid(g_i + w_ic * s c(t-1)),  f = sigmoid(g_f + w_fc * s c(t-1))
    c(t) = f * s c(t-1) + i * tanh(g_g)
    o = sigmoid(g_o + w_oc * c(t)),      m(t) = o * tanh(c(t))
    [r(t); p(t)] = m(t) W_rp + b_rp               [B, R + P], the output

CPU tensors take the plain version (`lstm_recurrence_ref`, a Python loop
of T steps); CUDA tensors launch the hand-written kernel
(csrc/lstm_recurrence.cu: the whole time loop in one cooperative launch
for up to 1,024 batch rows) or raise.  `lstm_recurrence.launches`
counts the launches, as does the `lstm_recurrence_launches` counter.
"""

from __future__ import annotations

import ctypes

import torch

from catears_tpu_torch.kernels import check_launch, kernel_library
from catears_tpu_torch.utils import log

F32 = torch.float32
# The kernel's geometry (csrc/lstm_recurrence.cu): a CTA of 256 threads
# owns 8 cells (32 gate columns) and, in the projection, its share of the
# R + P output columns, at most 8; its gates are taken 16 batch rows at a
# time (the narrow form, up to 16 rows) or 32 (the wide form), from
# s r(t-1) of up to 128 rows held at once; at most 1,024 batch rows a
# launch.
CELLS_PER_CTA = 8
NARROW = 16
MAX_PASS = 128
MAX_BATCH = 1024
MAX_COLS_PER_CTA = 8
SMEM_LIMIT = 232_448


def lstm_recurrence(gx: torch.Tensor, w_r: torch.Tensor,
                    peephole: torch.Tensor, w_rp: torch.Tensor,
                    b_rp: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, T, 4C] gate inputs (x W_x + b), W_r [R, 4C], peepholes [3, C],
    W_rp [C, R + P], b_rp [R + P], float32 -> [B, T, R + P] (module
    docstring).  The kernel's output is bit-equal from run to run (each
    sum is taken by fixed threads in a fixed order)."""
    b, t, g4 = gx.shape
    c = g4 // 4
    r, oc = w_r.shape[0], w_rp.shape[1]
    if (g4 != 4 * c or tuple(w_r.shape) != (r, g4)
            or tuple(peephole.shape) != (3, c)
            or tuple(w_rp.shape) != (c, oc) or tuple(b_rp.shape) != (oc,)
            or not 0 < r <= oc
            or any(x.dtype != F32 for x in (gx, w_r, peephole, w_rp, b_rp))
            or any(x.device != gx.device
                   for x in (w_r, peephole, w_rp, b_rp))):
        raise ValueError(
            f"lstm_recurrence: needs float32 gx [B, T, 4C], W_r [R, 4C], "
            f"peepholes [3, C], W_rp [C, R + P >= R], b_rp [R + P] on one "
            f"device; got {tuple(gx.shape)} {gx.dtype}, {tuple(w_r.shape)}, "
            f"{tuple(peephole.shape)}, {tuple(w_rp.shape)}, "
            f"{tuple(b_rp.shape)}")
    if gx.device.type == "cpu":
        return lstm_recurrence_ref(gx, w_r, peephole, w_rp, b_rp, scale)
    if gx.device.type != "cuda":
        raise ValueError(f"lstm_recurrence: unsupported device {gx.device}")
    ctas = c // CELLS_PER_CTA
    cols = -(-oc // max(ctas, 1))
    if c % CELLS_PER_CTA or c % 4 or r % 4 or oc % 4 \
            or cols > MAX_COLS_PER_CTA:
        raise ValueError(
            f"lstm_recurrence: the kernel takes C a multiple of "
            f"{CELLS_PER_CTA} and of 4, R and R + P multiples of 4 and at "
            f"most {MAX_COLS_PER_CTA} projection columns a CTA; got C {c}, "
            f"R {r}, R + P {oc}")
    smem = smem_bytes(r, c, cols, min(b, MAX_BATCH))
    if smem > SMEM_LIMIT:
        raise ValueError(f"lstm_recurrence: {smem} bytes of shared memory "
                         f"a CTA (R {r}, C {c}, {min(b, MAX_BATCH)} rows), "
                         f"above {SMEM_LIMIT}")
    out = torch.empty((b, t, oc), dtype=F32, device=gx.device)
    if not out.numel():
        return out
    gx, w_r, peephole, w_rp, b_rp = (x.contiguous() for x in
                                     (gx, w_r, peephole, w_rp, b_rp))
    lib = kernel_library("lstm_recurrence", _ARGTYPES)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, b, MAX_BATCH):
            n = min(MAX_BATCH, b - lo)
            # Scratch: m(t) [n, C] and the grid barrier's arrival count.
            m = torch.empty((n, c), dtype=F32, device=gx.device)
            bar = torch.zeros(1, dtype=torch.int32, device=gx.device)
            rc = lib.catears_lstm_recurrence(
                gx[lo:lo + n].data_ptr(), w_r.data_ptr(),
                peephole.data_ptr(), w_rp.data_ptr(), b_rp.data_ptr(),
                out[lo:lo + n].data_ptr(), m.data_ptr(), bar.data_ptr(), n,
                t, c, r, oc, ctypes.c_float(scale), stream)
            check_launch(lib, rc, "lstm_recurrence")
            lstm_recurrence.launches += 1
            log.count("lstm_recurrence_launches")
    return out


lstm_recurrence.launches = 0
_ARGTYPES = {"catears_lstm_recurrence": [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]}


def smem_bytes(r: int, c: int, cols: int, batch: int) -> int:
    """Dynamic shared memory of one CTA for a launch of `batch` rows: its
    W_r columns [R, 32], its W_rp columns [C, cols], s r(t-1) of the rows
    held at once [min(batch, 128) rounded up to the group, R], one group's
    gates [group, 32] (group 16 up to 16 rows, else 32) and the cells'
    state of every row [batch, 8] (csrc/lstm_recurrence.cu)."""
    group = NARROW if batch <= NARROW else 2 * NARROW
    held = -(-min(batch, MAX_PASS) // group) * group
    return 4 * (r * 4 * CELLS_PER_CTA + c * cols + held * r
                + group * 4 * CELLS_PER_CTA + batch * CELLS_PER_CTA)


def lstm_recurrence_ref(gx: torch.Tensor, w_r: torch.Tensor,
                        peephole: torch.Tensor, w_rp: torch.Tensor,
                        b_rp: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of lstm_recurrence: the module docstring's equations
    as a Python loop over the T rows (on any device)."""
    b, t, g4 = gx.shape
    c, r = g4 // 4, w_r.shape[0]
    rec = gx.new_zeros((b, r))
    cell = gx.new_zeros((b, c))
    out = gx.new_empty((b, t, w_rp.shape[1]))
    w_ic, w_fc, w_oc = peephole
    for step in range(t):
        g = gx[:, step] + (scale * rec) @ w_r
        sc = scale * cell
        i = torch.sigmoid(g[:, :c] + w_ic * sc)
        f = torch.sigmoid(g[:, c:2 * c] + w_fc * sc)
        cell = f * sc + i * torch.tanh(g[:, 2 * c:3 * c])
        o = torch.sigmoid(g[:, 3 * c:] + w_oc * cell)
        rp = (o * torch.tanh(cell)) @ w_rp + b_rp
        out[:, step] = rp
        rec = rp[:, :r]
    return out
