"""Command-line decoder on PyTorch (port of catears_tpu/cli.py).

Usage: python -m catears_tpu_torch.cli [--batch[=N]] [--device=cuda|cpu]
           [--ivectors=FILE] <config-file> <input-file>
  *.wav        decode this file through the streaming Utterance path (fused
               chunk steps), print the hypothesis.
  *.scp        decode `name path` entries one by one the same way, print
               `name hyp` per line.
  --batch[=N]  decode the scp's entries N at a time (default 16) in one
               batched beam search instead.
  --device     where the fbank, the AM and the decoder run; default cuda.
               A default run without a CUDA device fails; it never falls
               back to the CPU.
  --ivectors   each utterance's i-vector, for a model whose nnet takes
               them: a Kaldi text archive, `name [ v1 ... ]` a line
               (`copy-vector ark,t`).  Such a model, and any whose nnet
               subsamples the frames (a chain model), decodes on the
               --batch path only.

The config may name a delta-LM (`large_lm` + `original_lm`) and online CMVN
stats (`cmvn_stats`), on either path, and a graph of any epsilon mode, as
the JAX CLI's may, and every decoder geometry key the JAX Recognizer
reads, `select_compact` included, and `am_scale` (default 0.1).
"""

from __future__ import annotations

import sys

from catears_tpu_torch.utils.errors import CatEarsError


def print_usage() -> None:
    print("Usage: catears-torch [--batch[=N]] [--device=cuda|cpu] "
          "[--ivectors=FILE] <model-config> <input-file>")
    print("  Input-file:")
    print("    *.wav: decode this file.")
    print("    *.scp: decode audios listed in it.")
    sys.exit(1)


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    batch_size = 0
    device = "cuda"
    ivectors = None
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
        elif arg.startswith("--ivectors="):
            ivectors = arg.split("=", 1)[1]
            argv.remove(arg)
    if len(argv) != 2 or device not in ("cuda", "cpu"):
        print_usage()
    config_file, input_file = argv
    if len(input_file) < 4:
        print_usage()
    try:
        return _run(config_file, input_file, batch_size, device, ivectors)
    except (CatEarsError, OSError) as e:
        print(f"catears: {e}", file=sys.stderr)
        return 1


def _run(config_file: str, input_file: str, batch_size: int,
         device: str, ivectors: str = None) -> int:
    from catears_tpu_torch.io.wav import read_scp
    from catears_tpu_torch.runtime.recognizer import (Recognizer,
                                                      decode_wav_file)

    recognizer = Recognizer(config_file, device=device)
    if input_file.endswith(".wav"):
        print(decode_wav_file(recognizer, input_file))
    elif batch_size > 0:
        from catears_tpu_torch.runtime.batch import decode_scp, read_ivectors
        ivs = read_ivectors(ivectors) if ivectors else None
        for name, hyp in decode_scp(recognizer, input_file,
                                    batch_size=batch_size, ivectors=ivs):
            print(f"{name} {hyp}")
    else:
        for name, wav_path in read_scp(input_file):
            print(f"{name} {decode_wav_file(recognizer, wav_path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
