"""catears_tpu_torch — the catears speech-to-text pipeline on PyTorch/CUDA.

A port of `catears_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
JAX package stays beside it as the reference: every module here mirrors
its counterpart's layout and function names (`frontend/`, `am/`, `graph/`,
`decode/`, `runtime/`, `cli.py`), and the tests run both on the same numpy
inputs.  It imports nothing of `catears_tpu`: the host modules it needs
(`io/` config, binary formats, OpenFST reader, WAV, symbols;
`graph/fst.py` and `graph/transform.py`; the `tools/` toy and trie
generators, the token-error count and the Kaldi conversion recipe;
`utils/` errors and counters) are copies kept at the JAX package's module
paths, stripped to what the port calls.  WAV batches, ConstFst, long
backtraces and edit distances go through the native host library
(`utils/native.py`, built from `csrc/catears_native.cc` with the host C++
compiler on first use) and take their Python paths where it cannot be
built.

It carries the offline batched decode (`cli.py --batch`) and the live
stream (`Recognizer.create_utterance`, `create_stream_batch`, the CLI on a
.wav): fbank (+ online CMVN) -> TDNN acoustic model (float, or int8 with
`quantized = true`, its activation ranges dynamic or calibrated by
`AcousticModel.calibrate`) -> WFST beam search over a graph of any
epsilon mode (eps-free, closed or raw), LM off or rescored on the fly by a
delta-LM (`large_lm` + `original_lm`).  `tools/` converts a Kaldi model
(`convert_am`, `convert_fst`, `convert_misc`, `lm`, `arpa`, `mkgraph`).
The int8 GEMM (`am.quant.matmul_s8`) is a hand-written CUDA kernel for
sm_90a (`csrc/matmul_s8.cu`); everything else, the LM walk and the
epsilon closure included, is plain PyTorch.

Precision: importing this package turns TF32 off for CUDA matmuls and
cuDNN (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so the fbank's DFT and mel
products and the float AM run in full float32 as they do in the JAX
reference.  No module-level state picks the device: every entry point
(`Recognizer`, `BatchDecoder`, `AcousticModel`, `DeviceFst`, `DeviceLm`)
takes `device`, runs on the card by default and raises `CatEarsError`
without one (`utils/device.py`); the CPU runs only when asked for.

The root and each subpackage re-export the JAX package's public names at
the same paths (`from catears_tpu_torch.runtime import Recognizer`), all
but `catears_tpu.parallel`'s, which is not ported yet.  Importing them
touches no card and builds no kernel.  `python -m catears_tpu_torch.bench`
is the port's benchmark, with `bench.py`'s knobs and output.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from catears_tpu_torch.io.config import Configuration  # noqa: E402
from catears_tpu_torch.utils.errors import (  # noqa: E402
    CatEarsError,
    CorruptionError,
    IOError_,
    last_error,
)

__all__ = [
    "Configuration",
    "CatEarsError",
    "CorruptionError",
    "IOError_",
    "last_error",
    "__version__",
]
