"""Device-mesh scale-out: data-parallel utterances + tensor-parallel AM (port
of catears_tpu/parallel/mesh.py).

A `Mesh` is a [dp, mp] grid of torch devices with the JAX axis names

  data   — utterance batch dimension (waves, beam state, traces)
  model  — acoustic-model weight sharding (column-parallel linears)

JAX annotates shardings and lets XLA partition; here the partitioning is
written out.  The batch splits into dp contiguous blocks (`P("data")`);
data block d runs on devices[d, 0], from its own host thread and, on a
card, its own CUDA streams, so the blocks' launches interleave instead of
queueing behind one another.  Every linear's columns (and a batchnorm's
entries) split into mp contiguous blocks (`P(None, "model")` /
`P("model")`), block j on devices[d, j]; each block is computed on its
device and the blocks are concatenated where a layer needs whole rows
(splice, narrow, normalize, the next linear).  Devices may repeat: a mesh
of n logical shards of one card (or of the CPU) stands in for XLA's
`--xla_force_host_platform_device_count`, and every table or weight block
is copied once per distinct device, not once per shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.am.nnet import apply_layer
from catears_tpu_torch.decode.beam import (BeamConfig, BeamState, FrameTrace,
                                           decode_chunk, init_beam_batch)
from catears_tpu_torch.frontend.fbank import fbank_from_wave
from catears_tpu_torch.graph.device import (LM_TABLES, TABLES, DeviceFst,
                                            DeviceLm)
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import CatEarsError

# Layers that act on each column alone, so column blocks pass through.
_COLUMNWISE = ("relu",)


def _canonical(device: Device) -> torch.device:
    """resolve_device, with a CUDA device's index made explicit (so that
    'cuda' and 'cuda:0' are one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """('data', 'model') grid: `devices` is a [dp, mp] object array of
    torch.device."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def logical_devices(n: int, device: Device = "cuda") -> List[torch.device]:
    """n logical devices for a mesh: the CPU n times, or the cards
    round-robin (each shard its own card when there are n)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """('data', 'model') mesh over the first num_devices devices.

    devices=None takes the cards cuda:0..n-1 (CatEarsError without one);
    `devices` names logical devices, repeats allowed ([cpu] * 8, or
    [cuda:0] * n for n shards of one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise CatEarsError("no CUDA device is available (pass devices= "
                               "to build a mesh of CPU devices)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    n = num_devices or len(devices)
    assert n % model_parallel == 0, (n, model_parallel)
    if n > len(devices):
        raise CatEarsError(f"a mesh of {n} devices: only {len(devices)} "
                           f"given")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n // model_parallel, model_parallel))


def _split_columns(value: torch.Tensor, mesh: Mesh, what: str,
                   copies: Dict) -> List[List[torch.Tensor]]:
    """[..., N] -> blocks[d][j]: column block j of mp, on devices[d, j]
    (one copy per distinct device)."""
    mp = mesh.devices.shape[1]
    if value.shape[-1] % mp:
        raise CatEarsError(f"{what}: {value.shape[-1]} columns do not split "
                           f"evenly over {mp} model devices")
    parts = torch.chunk(value, mp, dim=-1)
    out = []
    for row in mesh.devices:
        blocks = []
        for j, dev in enumerate(row):
            key = (what, j, dev)
            if key not in copies:
                copies[key] = parts[j].to(dev).contiguous()
            blocks.append(copies[key])
        out.append(blocks)
    return out


def shard_am_params(am: AcousticModel, mesh: Mesh):
    """Column-shard every linear layer of the AM's float stack over the
    'model' axis.

    Returns one dict per layer: a linear's `w` [in, out] and `b` [out], and
    a batchnorm's `scale` and `offset`, as blocks[d][j], the j-th of mp
    contiguous column blocks on devices[d, j] (JAX's P(None, 'model') /
    P('model')); other layers have no parameters.
    """
    copies: Dict = {}
    sharded = []
    for i, layer in enumerate(am.nnet_def):
        p = am.float_nnet.params(i)
        names = {"linear": ("w", "b"),
                 "batchnorm": ("scale", "offset")}.get(layer[0], ())
        sharded.append({name: _split_columns(p[name], mesh,
                                             f"layer {i} {name}", copies)
                        for name in names})
    return sharded


def _on_device(tables, names, device: torch.device):
    """A DeviceFst / DeviceLm with its tables on `device`."""
    return dataclasses.replace(tables, **{
        name: getattr(tables, name).to(device) for name in names})


def _gather(blocks: List[torch.Tensor], home: torch.device) -> torch.Tensor:
    return torch.cat([b.to(home) for b in blocks], dim=-1)


def column_parallel_forward(nnet_def, params, d: int,
                            x: torch.Tensor) -> torch.Tensor:
    """The layer stack on data row d's devices: x [..., T, D] on
    devices[d, 0], each linear (and batchnorm) block on its model device,
    the blocks concatenated on x's device where a layer needs whole
    rows."""
    home = x.device
    blocks = None  # x split by columns over the model devices, or None
    for layer, p in zip(nnet_def, params):
        kind = layer[0]
        if kind == "linear":
            if blocks is not None:
                x, blocks = _gather(blocks, home), None
            blocks = [torch.matmul(x.to(w.device), w) + b
                      for w, b in zip(p["w"][d], p["b"][d])]
        elif kind == "batchnorm":
            if blocks is None:
                widths = [s.shape[0] for s in p["scale"][d]]
                blocks = [c.to(s.device) for c, s in zip(
                    torch.split(x, widths, dim=-1), p["scale"][d])]
            blocks = [c * s + o for c, s, o in zip(
                blocks, p["scale"][d], p["offset"][d])]
        elif kind in _COLUMNWISE and blocks is not None:
            blocks = [apply_layer(kind, layer, c, {}) for c in blocks]
        else:
            if blocks is not None:
                x, blocks = _gather(blocks, home), None
            x = apply_layer(kind, layer, x, {})
    return x if blocks is None else _gather(blocks, home)


class ShardedPipeline:
    """Batched wave -> features -> AM -> beam-search step over a mesh.

    The AM runs its float stack (as JAX's pipeline runs `am.params`), the
    int8 one is not sharded."""

    def __init__(self, am: AcousticModel, dfst: DeviceFst,
                 dlm: Optional[DeviceLm], cfg: BeamConfig, mesh: Mesh):
        self.am = am
        self.cfg = cfg
        self.mesh = mesh
        self.params = shard_am_params(am, mesh)
        self.homes = [row[0] for row in mesh.devices]
        # The graph tables, G' and prior once per distinct device.
        self._tables = {}
        for dev in self.homes:
            if dev not in self._tables:
                self._tables[dev] = (
                    _on_device(dfst, TABLES, dev),
                    None if dlm is None else _on_device(dlm, LM_TABLES, dev),
                    am.log_prior.to(dev))
        self._streams = {}
        for row in mesh.devices:
            for dev in row:
                if dev.type == "cuda" and dev not in self._streams:
                    self._streams[dev] = torch.cuda.Stream(device=dev)

    @property
    def first_device(self) -> torch.device:
        return self.mesh.devices[0, 0]

    def _blocks(self, batch: int):
        dp = len(self.homes)
        if batch % dp:
            raise CatEarsError(f"a batch of {batch} does not split evenly "
                               f"over the mesh's {dp} data blocks")
        per = batch // dp
        return [(d, d * per, (d + 1) * per) for d in range(dp)]

    def _run(self, batch: int, work):
        """work(d, lo, hi) for every data block, each from its own thread
        on its own streams (which first wait for the caller's); returns
        the results in block order once every block's device work is
        done."""
        for dev, stream in self._streams.items():
            stream.wait_stream(torch.cuda.current_stream(dev))

        def one(d, lo, hi):
            with torch.no_grad(), contextlib.ExitStack() as scope:
                # Each distinct device's stream, the home device's last
                # (entering a stream's context makes its device current).
                row = [self._streams[dev] for dev in
                       dict.fromkeys(self.mesh.devices[d][::-1])
                       if dev in self._streams]
                for stream in row:
                    scope.enter_context(torch.cuda.stream(stream))
                out = work(d, lo, hi)
                for stream in row:
                    stream.synchronize()
                return out

        blocks = self._blocks(batch)
        with ThreadPoolExecutor(max_workers=len(blocks)) as pool:
            futures = [pool.submit(one, *blk) for blk in blocks]
            return [f.result() for f in futures]

    def _gather_rows(self, parts: List[torch.Tensor],
                     dim: int = 0) -> torch.Tensor:
        """Blocks in batch order, concatenated on the mesh's first
        device (a global array's value)."""
        out = torch.cat([p.to(self.first_device) for p in parts], dim=dim)
        for p in parts:
            if p.is_cuda:  # read by the caller's stream from here on
                p.record_stream(torch.cuda.current_stream(p.device))
        return out

    def _am_block(self, d: int, wave: torch.Tensor,
                  n_frames: int) -> torch.Tensor:
        am = self.am
        feats = fbank_from_wave(wave, n_frames)
        b = feats.shape[0]
        padded = torch.cat([feats[:, :1].expand(b, am.left_context, -1),
                            feats,
                            feats[:, -1:].expand(b, am.right_context, -1)],
                           dim=1)
        out = column_parallel_forward(am.nnet_def, self.params, d, padded)
        return out - self._tables[self.homes[d]][2]

    def am_step(self, wave, n_frames: int) -> torch.Tensor:
        """[B, S] padded wave -> [B, T, P] log-likelihoods (dp x tp)."""
        wave = torch.as_tensor(wave, dtype=torch.float32)

        def work(d, lo, hi):
            return self._am_block(d, wave[lo:hi].to(self.homes[d]),
                                  n_frames)

        return self._gather_rows(self._run(wave.shape[0], work))

    def full_step(self, wave, beam: BeamState, lengths=None, *,
                  n_frames: int):
        """One step: wave chunk in, updated beam + traces out.

        lengths ([B] int, optional) supports RAGGED batches: utterance b
        decodes only its first lengths[b] frames; the padded tail runs
        identity frames (frame_valid=0), exactly like decode_batch's
        host path.  None = every frame valid.  Returns (logp [B, T, P],
        beam', FrameTrace [T, B, ...]) on the mesh's first device.
        """
        wave = torch.as_tensor(wave, dtype=torch.float32)
        if lengths is not None:
            lengths = torch.as_tensor(lengths)

        def work(d, lo, hi):
            home = self.homes[d]
            dfst, dlm, _ = self._tables[home]
            logp = self._am_block(d, wave[lo:hi].to(home), n_frames)
            logp_t = logp.transpose(0, 1)  # [T, b, P]
            if lengths is None:
                valid = torch.ones(logp_t.shape[:2], dtype=torch.bool,
                                   device=home)
            else:
                valid = (torch.arange(n_frames, device=home)[:, None]
                         < lengths[lo:hi].to(home)[None, :])
            part = BeamState(*(x[lo:hi].to(home) for x in beam))
            part, traces = decode_chunk(self.cfg, dfst, part, logp_t, valid,
                                        dlm)
            return logp, part, traces

        outs = self._run(wave.shape[0], work)
        logp = self._gather_rows([o[0] for o in outs])
        beam = BeamState(*(self._gather_rows(list(f))
                           for f in zip(*(o[1] for o in outs))))
        traces = FrameTrace(*(self._gather_rows(list(f), dim=1)
                              for f in zip(*(o[2] for o in outs))))
        return logp, beam, traces

    def jit_full_step(self, n_frames: int):
        """full_step with n_frames bound (JAX jits it; here it is a plain
        callable)."""
        return functools.partial(self.full_step, n_frames=n_frames)

    def make_beam(self, batch: int) -> BeamState:
        dfst, dlm, _ = self._tables[self.first_device]
        beam, _ = init_beam_batch(self.cfg, batch, dfst, dlm)
        return beam
