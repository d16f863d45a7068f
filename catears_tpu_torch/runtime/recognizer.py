"""Recognizer config loading (port of the model-loading part of
catears_tpu/runtime/recognizer.py).

Reads the same config keys as the JAX Recognizer: the HCLG (`fst`), the
acoustic model (`nnet`, `prior`, `tid2pdf`, contexts, `quantized`), the
symbol table, the delta-LM (`large_lm` G' with its `original_lm` unigram
vector), and the decoder geometry keys (`beam_size`, `expand_size`,
`eps_expand_size`, `lm_expand_size`, `max_eps_iters`, `beam`,
`arc_group`, `csr_group`).  `device` places the acoustic model and the
decode graph: the card unless the CPU is asked for.  Inputs the port does not carry yet fail here with
NotImplementedError_: online CMVN (`cmvn_stats`) and `select_compact`.
The streaming Utterance API is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu_torch.io.binfmt import read_vec0_file
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.io.symbols import SymbolTable
from catears_tpu_torch.utils.device import Device, resolve_device
from catears_tpu_torch.utils.errors import (CorruptionError,
                                            NotImplementedError_)

AM_SCALE = 0.1  # acoustic scale, as in the JAX runtime


class Recognizer:
    def __init__(self, config_path: str, device: Device = "cuda"):
        self.device = resolve_device(device)
        conf = Configuration.read(config_path)
        self.conf = conf
        if conf.has("cmvn_stats"):
            raise NotImplementedError_(
                "online CMVN (cmvn_stats) is not yet ported to the PyTorch "
                "backend")
        if conf.get_int("select_compact", 0):
            raise NotImplementedError_(
                "select_compact is not ported to the PyTorch backend")
        self.fst = FlatFst.read(conf.get_path("fst"))
        self.am = AcousticModel.read(conf, device=self.device)
        self.symbol_table = SymbolTable.read(conf.get_path("symbol_table"))
        self.delta_lm = self._read_delta_lm(conf)
        # Decoder geometry from the config; unset keys keep the defaults.
        geo = {}
        for key in ("beam_size", "expand_size", "eps_expand_size",
                    "lm_expand_size", "max_eps_iters"):
            if conf.has(key):
                geo[key] = conf.get_int(key)
        if conf.has("beam"):
            geo["beam"] = conf.get_float("beam")
        self.beam_config = BeamConfig(am_scale=AM_SCALE, **geo)
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
