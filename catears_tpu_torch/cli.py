"""Command-line batch decoder on PyTorch (port of catears_tpu/cli.py's scp
batch path).

Usage: python -m catears_tpu_torch.cli --batch[=N] [--device=cuda|cpu]
           <config-file> <list.scp>
  --batch[=N]  decode the scp's `name path` entries N at a time (default
               16) in one batched beam search; prints `name hyp` per line.
  --device     where the AM and the decoder run; default cuda.  A default
               run without a CUDA device fails; it never falls back to the
               CPU.

The config may name a delta-LM (`large_lm` + `original_lm`): the decode is
then rescored by it, as the JAX CLI's is.  Inputs the port does not carry
yet fail with a one-line `catears:` error: a .wav input or an scp without
--batch (the streaming Utterance path), `cmvn_stats`, and graphs whose
epsilon removal does not reach the eps-free mode.
"""

from __future__ import annotations

import sys

from catears_tpu_torch.utils.errors import CatEarsError, NotImplementedError_


def print_usage() -> None:
    print("Usage: catears-torch --batch[=N] [--device=cuda|cpu] "
          "<model-config> <list.scp>")
    sys.exit(1)


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    batch_size = 0
    device = "cuda"
    for arg in list(argv):
        if arg == "--batch":
            batch_size = 16
            argv.remove(arg)
        elif arg.startswith("--batch="):
            batch_size = int(arg.split("=", 1)[1])
            argv.remove(arg)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            argv.remove(arg)
    if len(argv) != 2 or device not in ("cuda", "cpu"):
        print_usage()
    config_file, input_file = argv
    try:
        return _run(config_file, input_file, batch_size, device)
    except (CatEarsError, OSError) as e:
        print(f"catears: {e}", file=sys.stderr)
        return 1


def _run(config_file: str, input_file: str, batch_size: int,
         device: str) -> int:
    if input_file.endswith(".wav") or batch_size <= 0:
        raise NotImplementedError_(
            "single-utterance streaming decode is not yet ported to the "
            "PyTorch backend; pass an scp with --batch")
    from catears_tpu_torch.runtime.batch import decode_scp
    from catears_tpu_torch.runtime.recognizer import Recognizer

    recognizer = Recognizer(config_file, device=device)
    for name, hyp in decode_scp(recognizer, input_file,
                                batch_size=batch_size):
        print(f"{name} {hyp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
