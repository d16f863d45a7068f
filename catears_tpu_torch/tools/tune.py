"""One-call deployment geometry tuner (port of catears_tpu/tools/tune.py).

Decodes representative audio with generous capacities, reads the decoder's
capacity high-water telemetry (decode.decoder.autosize) and prints tight
decoder config keys, read back by runtime.Recognizer; genuine overshoot at
decode time still raises BeamCapacityError rather than being silently
wrong.

Usage:
  python -m catears_tpu_torch.tools.tune [--device=cuda|cpu] <model-config>
                                         <wav|scp> [--margin=M]
                                         [--beam-size=K]

Prints `key = value` lines to append to the model config.  --device
(default cuda) is where the frontend, the AM and the sizing decodes run.
"""

from __future__ import annotations

import dataclasses
import sys


def _usage() -> int:
    print("Usage: python -m catears_tpu_torch.tools.tune [--device=cuda|cpu]"
          " <model-config> <wav|scp> [--margin=M] [--beam-size=K]",
          file=sys.stderr)
    return 1


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    margin = 1.25
    beam_size = None
    device = "cuda"
    for arg in list(argv):
        if arg.startswith("--margin="):
            margin = float(arg.split("=", 1)[1])
            argv.remove(arg)
        elif arg.startswith("--beam-size="):
            beam_size = int(arg.split("=", 1)[1])
            argv.remove(arg)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            argv.remove(arg)
    if len(argv) != 2 or device not in ("cuda", "cpu"):
        return _usage()
    config_file, input_file = argv

    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.decode.decoder import autosize
    from catears_tpu_torch.frontend.cmvn import CMVNStream
    from catears_tpu_torch.io.wav import read_16k_pcm, read_scp
    from catears_tpu_torch.runtime.recognizer import Recognizer
    from catears_tpu_torch.utils.errors import CatEarsError

    try:
        rec = Recognizer(config_file, device=device)
        paths = ([p for _, p in read_scp(input_file)]
                 if input_file.endswith(".scp") else [input_file])
        logps = []
        for path in paths:
            feats = rec.fbank.compute(read_16k_pcm(path))
            if rec.cmvn_stats is not None:
                feats = CMVNStream(rec.cmvn_stats).process(feats)
            logps.append(rec.am.forward(rec.am.pad_context(feats)))
        base = BeamConfig(am_scale=rec.am_scale)
        if beam_size is not None:
            base = dataclasses.replace(base, beam_size=beam_size)
        # Per-utterance sizing (ragged lengths); the deployment geometry
        # covers the max demand across utterances.
        cfgs = [autosize(rec.fst, rec.am.tid2pdf, lp, am_scale=rec.am_scale,
                         delta_lm=rec.delta_lm, base=base, margin=margin,
                         arc_group=rec.arc_group, csr_group=rec.csr_group,
                         device=rec.device)
                for lp in logps]
        cfg = dataclasses.replace(
            base,
            expand_size=max(c.expand_size for c in cfgs),
            eps_expand_size=max(c.eps_expand_size for c in cfgs),
            lm_expand_size=max(c.lm_expand_size for c in cfgs))
    except (CatEarsError, OSError) as e:
        print(f"catears: {e}", file=sys.stderr)
        return 1

    print(f"# measured on {len(paths)} utterance(s), margin {margin}")
    print(f"beam_size = {cfg.beam_size}")
    print(f"expand_size = {cfg.expand_size}")
    print(f"eps_expand_size = {cfg.eps_expand_size}")
    if rec.delta_lm is not None and cfg.lm_expand_size:
        print(f"lm_expand_size = {cfg.lm_expand_size}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
