"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

from typing import Union

import torch

from catears_tpu_torch.utils.errors import CatEarsError

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """`device` as a torch.device.  A CUDA device without a card raises
    CatEarsError: an entry point never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CatEarsError("no CUDA device is available (use --device=cpu "
                           "to run on the CPU)")
    return dev
