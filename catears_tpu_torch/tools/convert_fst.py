"""Convert an OpenFST ConstFst binary to the pk::fst_0 flat format.
(The port's copy of catears_tpu/tools/convert_fst.py.)

Parity with reference tool/convert_fstfmt.py (which used pywrapfst): arcs
are sorted by (state, ilabel) — the invariant the flat binary search and the
LmFst backoff convention (`first arc of a span = epsilon backoff`) rely on.

Note the runtime loads BOTH formats directly (FlatFst.read sniffs the
magic), so conversion is optional — useful for shipping the smaller flat
format to match the reference's deployment artifacts.

Usage: python -m catears_tpu_torch.tools.convert_fst <openfst-binfile> <out> [text]
"""

from __future__ import annotations

import sys

import numpy as np

from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.io.binfmt import RawFst, write_pkfst


def flat_to_raw(fst: FlatFst) -> RawFst:
    first_arc = np.full(fst.num_states, -1, np.int32)
    nonempty = fst.offsets[:-1] < fst.offsets[1:]
    first_arc[nonempty] = fst.offsets[:-1][nonempty]
    return RawFst(start=fst.start, final=fst.final, first_arc=first_arc,
                  arc_next=fst.arc_next, arc_ilabel=fst.arc_ilabel,
                  arc_olabel=fst.arc_olabel, arc_weight=fst.arc_weight)


def write_text(fd, fst: FlatFst) -> None:
    first_arc = flat_to_raw(fst).first_arc
    fd.write(f"state_number = {fst.num_states}\n")
    fd.write(f"arc_number = {fst.num_arcs}\n")
    fd.write(f"start_state = {fst.start}\n")
    fd.write("============ final =============\n")
    for i, f in enumerate(fst.final):
        fd.write(f"{i} -> {f}\n")
    fd.write("============ state_arcidx =============\n")
    for i, a in enumerate(first_arc):
        fd.write(f"{i} -> {a}\n")
    fd.write("============ arcs =============\n")
    for i in range(fst.num_arcs):
        fd.write(f"{i} -> next_state({fst.arc_next[i]}), "
                 f"input_label({fst.arc_ilabel[i]}), "
                 f"output_label({fst.arc_olabel[i]}), "
                 f"weight({fst.arc_weight[i]})\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3):
        print("Usage: python -m catears_tpu_torch.tools.convert_fst "
              "<openfst-binfile> <output> [text|binary]")
        return 1
    fst = FlatFst.read(argv[0])
    if len(argv) == 3 and argv[2] == "text":
        with open(argv[1], "w", encoding="utf-8") as fd:
            write_text(fd, fst)
    else:
        with open(argv[1], "wb") as fd:
            write_pkfst(fd, flat_to_raw(fst))
    print("Success")
    return 0


if __name__ == "__main__":
    sys.exit(main())
