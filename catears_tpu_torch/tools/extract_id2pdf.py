"""Extract the transition-id -> pdf-id map from a Kaldi model, no Kaldi
linkage required (the port's copy of scripts/extract_id2pdf.py, the first
step of the conversion recipe in docs/MODEL_CONVERSION.md).

The reference ships a Kaldi-linked C++ dumper (tool/extract_id2pdf.cc)
that prints

    num_pdfs
    num_transition_ids
    tid pdf          (for tid 0..num_transition_ids)

for tool/convert_trans.py to binarize.  This script produces the same text
from the TEXT form of the transition model, which any Kaldi install can
emit with:

    copy-transition-model --binary=false final.mdl final.txt.mdl

It reproduces TransitionModel's derived numbering (transition-states in
tuple order, transition-ids dense within each state's topology
transitions; hmm/transition-model.cc ComputeDerived) for both the classic
<Triples> (one pdf per HMM state) and the newer <Tuples> format
(forward-pdf + self-loop-pdf, chain models).

Usage: python -m catears_tpu_torch.tools.extract_id2pdf final.txt.mdl
       [> id2pdf.txt]
Feed the output to `python -m catears_tpu_torch.tools.convert_misc trans`,
or to `python -m catears_tpu_torch.tools.mkgraph --id2pdf`.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple


class _Tok:
    def __init__(self, text: str):
        self.toks = text.split()
        self.pos = 0

    def peek(self) -> str:
        return self.toks[self.pos] if self.pos < len(self.toks) else ""

    def next(self) -> str:
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok!r}, got {got!r} "
                             f"at token {self.pos}")

    def skip_until(self, tok: str) -> None:
        while self.peek() not in (tok, ""):
            self.pos += 1
        self.expect(tok)


def parse_topology(t: _Tok) -> Dict[int, List[List[int]]]:
    """phone -> per-HMM-state list of transition destination states."""
    topo: Dict[int, List[List[int]]] = {}
    t.expect("<Topology>")
    while t.peek() == "<TopologyEntry>":
        t.next()
        t.expect("<ForPhones>")
        phones = []
        while t.peek() != "</ForPhones>":
            phones.append(int(t.next()))
        t.next()  # </ForPhones>
        states: List[List[int]] = []
        while t.peek() == "<State>":
            t.next()
            int(t.next())  # state index (dense)
            # optional pdf-class declarations
            while t.peek() in ("<PdfClass>", "<ForwardPdfClass>",
                               "<SelfLoopPdfClass>"):
                t.next()
                t.next()
            trans: List[int] = []
            while t.peek() == "<Transition>":
                t.next()
                trans.append(int(t.next()))  # destination state
                t.next()  # probability
            t.expect("</State>")
            states.append(trans)
        t.expect("</TopologyEntry>")
        for p in phones:
            topo[p] = states
    t.expect("</Topology>")
    return topo


def parse_transition_model(text: str) -> Tuple[int, List[int]]:
    """(num_pdfs, tid2pdf list indexed by tid, [0] = 0)."""
    t = _Tok(text)
    t.skip_until("<TransitionModel>")
    topo = parse_topology(t)
    kind = t.next()
    if kind not in ("<Triples>", "<Tuples>"):
        raise ValueError(f"expected <Triples>/<Tuples>, got {kind!r}")
    n = int(t.next())
    tid2pdf = [0]
    num_pdfs = 0
    for _ in range(n):
        phone = int(t.next())
        hmm_state = int(t.next())
        fwd_pdf = int(t.next())
        self_pdf = int(t.next()) if kind == "<Tuples>" else fwd_pdf
        num_pdfs = max(num_pdfs, fwd_pdf + 1, self_pdf + 1)
        for dest in topo[phone][hmm_state]:
            tid2pdf.append(self_pdf if dest == hmm_state else fwd_pdf)
    t.expect("</Triples>" if kind == "<Triples>" else "</Tuples>")
    return num_pdfs, tid2pdf


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 1
    with open(argv[0], encoding="utf-8") as fd:
        num_pdfs, tid2pdf = parse_transition_model(fd.read())
    print(num_pdfs)
    print(len(tid2pdf) - 1)
    for tid, pdf in enumerate(tid2pdf):
        print(tid, pdf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
