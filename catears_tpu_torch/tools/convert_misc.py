"""Small artifact converters: transition map and CMVN stats.
(The port's copy of catears_tpu/tools/convert_misc.py.)

Parity with reference tool/convert_trans.py (tid->pdf text map -> int32 VEC0,
index 0 unused) and tool/convert_cmvn_stats.py (Kaldi global CMVN stats text
matrix of 82 values -> 41-float VEC0 sum-stats).
"""

from __future__ import annotations

import re
import sys

import numpy as np

from catears_tpu_torch.io.binfmt import write_vec0

_NUM = re.compile(r"^[-+]?[0-9]+(\.[0-9]+)?(e[-+]?[0-9]+)?$")


def convert_trans(in_path: str, out_path: str) -> int:
    """id2pdf text (num_pdfs, num_transitions, then `tid pdf` lines)."""
    with open(in_path, encoding="utf-8") as fd:
        lines = [ln.strip() for ln in fd]
    num_pdfs = int(lines[0])
    num_transitions = int(lines[1])
    mapping = np.zeros(num_transitions + 1, np.int32)
    for line in lines[2:]:
        if not line:
            continue
        tid, pdf = line.split()
        mapping[int(tid)] = int(pdf)
    with open(out_path, "wb") as fd:
        write_vec0(fd, mapping)
    return num_pdfs


def convert_cmvn_stats(in_path: str, out_path: str) -> None:
    """Kaldi text stats matrix (2 x 41 = 82 values) -> 41-float VEC0."""
    with open(in_path, encoding="utf-8") as fd:
        tokens = " ".join(fd).split()
    values = [float(t) for t in tokens if _NUM.match(t)]
    if len(values) != 82:
        raise ValueError(f"82 values expected, but {len(values)} found")
    stats = np.asarray(values[:41], np.float32)
    with open(out_path, "wb") as fd:
        write_vec0(fd, stats)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3 or argv[0] not in ("trans", "cmvn"):
        print("Usage: python -m catears_tpu_torch.tools.convert_misc "
              "{trans|cmvn} <in> <out>")
        return 1
    if argv[0] == "trans":
        num_pdfs = convert_trans(argv[1], argv[2])
        print(f"num_pdfs = {num_pdfs}")
    else:
        convert_cmvn_stats(argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
