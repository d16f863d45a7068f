"""Scale-out: device meshes, sharded pipelines, multi-process runtime (port
of catears_tpu/parallel/).

Lazy re-exports: importing this package touches no CUDA device, so that
`parallel.distributed.initialize` (torch.distributed's process group) can
run before anything picks a card.
"""

import importlib
from typing import Any

_EXPORTS = {
    "ShardedPipeline": "catears_tpu_torch.parallel.mesh",
    "make_mesh": "catears_tpu_torch.parallel.mesh",
    "shard_am_params": "catears_tpu_torch.parallel.mesh",
    "initialize": "catears_tpu_torch.parallel.distributed",
    "local_batch_slice": "catears_tpu_torch.parallel.distributed",
    "global_sum": "catears_tpu_torch.parallel.distributed",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str) -> Any:
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(mod), name)
