"""Build a complete catears decode directory from Kaldi artifacts (the
port's copy of scripts/mkgraph.py; run it as
`python -m catears_tpu_torch.tools.mkgraph`).

Python equivalent of the reference's graph recipe (reference
tool/mkgraph_hcl.sh): everything downstream of Kaldi's own
graph compiler runs here with no Kaldi installation —

  1. prune the ARPA LM to order 1 (G for HCLG, and the subtraction LM),
  2. build the unigram cost vector (original_lm, VEC0),
  3. build the big-LM G' directly from the ARPA (pure-Python arpa2fst
     equivalent, catears_tpu_torch.tools.arpa) as pk::fst_0,
  4. convert/copy HCLG (OpenFST ConstFst -> pk::fst_0),
  5. binarize the tid->pdf map (from scripts/extract_id2pdf.py output),
  6. write the runtime config file.

The two steps that genuinely need Kaldi (composing HCLG itself, and the
nnet3 text dump for convert_am) are printed as exact commands when their
inputs are missing.  See docs/MODEL_CONVERSION.md for the full walkthrough.

Usage:
  python -m catears_tpu_torch.tools.mkgraph --out DIR --words words.txt
             --hclg HCLG.fst
             [--lm lm.arpa[.gz]]        # enables delta-LM rescoring
             [--id2pdf id2pdf.txt]      # from extract_id2pdf.py
             [--nnet f.nnet --prior f.prior --left-context N
              --right-context N --chunk-size N --num-pdfs N]
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys


def _open_text(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, encoding="utf-8", errors="replace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--words", required=True, help="Kaldi words.txt")
    ap.add_argument("--hclg", help="HCLG.fst from utils/mkgraph.sh")
    ap.add_argument("--lm", help="full ARPA LM (enables delta-LM)")
    ap.add_argument("--id2pdf", help="text map from extract_id2pdf.py")
    ap.add_argument("--nnet", help="NN02 file from tools/convert_am.py")
    ap.add_argument("--prior", help="VEC0 prior from tools/convert_am.py")
    ap.add_argument("--left-context", type=int, default=0)
    ap.add_argument("--right-context", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=50)
    ap.add_argument("--num-pdfs", type=int, default=0)
    args = ap.parse_args(argv)

    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.io import binfmt
    from catears_tpu_torch.tools import lm as lmtools
    from catears_tpu_torch.tools.arpa import arpa_to_fst
    from catears_tpu_torch.tools.convert_fst import flat_to_raw
    from catears_tpu_torch.tools.convert_misc import convert_trans

    os.makedirs(args.out, exist_ok=True)
    conf = {"symbol_table": "words.txt"}
    shutil.copyfile(args.words, os.path.join(args.out, "words.txt"))
    todo = []

    if args.hclg:
        # Accept OpenFST ConstFst or pk::fst_0; store as pk::fst_0.
        fst = FlatFst.read(args.hclg)
        with open(os.path.join(args.out, "hclg.fst"), "wb") as fd:
            binfmt.write_pkfst(fd, flat_to_raw(fst))
        conf["fst"] = "hclg.fst"
        print(f"hclg.fst: {fst.num_states} states, {fst.num_arcs} arcs")
    else:
        todo.append(
            "HCLG: with Kaldi —\n"
            "    gunzip -c lm.arpa.gz | python -m catears_tpu_torch.tools.lm "
            "prune | gzip > lm1.arpa.gz\n"
            "    utils/format_lm.sh data/lang lm1.arpa.gz lexicon.txt "
            "data/lang_test\n"
            "    utils/mkgraph.sh data/lang_test exp/<am-dir> graph\n"
            "  then re-run with --hclg graph/HCLG.fst")

    if args.lm:
        with _open_text(args.lm) as fd:
            pruned = lmtools.prune_to_unigram(fd)
        one_order = os.path.join(args.out, "lm.1order.arpa")
        with open(one_order, "w", encoding="utf-8") as fd:
            fd.write("\n".join(pruned) + "\n")
        costs = lmtools.read_unigram_costs(one_order)
        vocab = lmtools.read_vocab(os.path.join(args.out, "words.txt"))
        vec = lmtools.build_cost_vector(costs, vocab)
        with open(os.path.join(args.out, "original_lm.bin"), "wb") as fd:
            binfmt.write_vec0(fd, vec)
        gfst, _ = arpa_to_fst(args.lm, vocab=vocab)
        with open(os.path.join(args.out, "g.pfst"), "wb") as fd:
            binfmt.write_pkfst(fd, flat_to_raw(gfst))
        conf["large_lm"] = "g.pfst"
        conf["original_lm"] = "original_lm.bin"
        print(f"g.pfst: {gfst.num_states} states, {gfst.num_arcs} arcs; "
              f"original_lm.bin: {vec.size} entries")

    if args.id2pdf:
        num_pdfs = convert_trans(args.id2pdf,
                                 os.path.join(args.out, "tid2pdf.bin"))
        conf["tid2pdf"] = "tid2pdf.bin"
        if not args.num_pdfs:
            args.num_pdfs = num_pdfs
    else:
        todo.append(
            "tid2pdf: with Kaldi —\n"
            "    copy-transition-model --binary=false final.mdl final.txt.mdl\n"
            "    python scripts/extract_id2pdf.py final.txt.mdl > id2pdf.txt\n"
            "  then re-run with --id2pdf id2pdf.txt")

    for key, path in (("nnet", args.nnet), ("prior", args.prior)):
        if path:
            shutil.copyfile(path, os.path.join(args.out, f"am.{key}"))
            conf[key] = f"am.{key}"
    if not args.nnet:
        todo.append(
            "AM: with Kaldi —\n"
            "    nnet3-am-copy --binary=false --prepare-for-test=true "
            "final.mdl final.txt\n"
            "    python -m catears_tpu_torch.tools.convert_am final.txt "
            "am.nnet am.prior\n"
            "  then re-run with --nnet am.nnet --prior am.prior "
            "--left-context L --right-context R")

    conf.update(left_context=args.left_context,
                right_context=args.right_context,
                chunk_size=args.chunk_size)
    if args.num_pdfs:
        conf["num_pdfs"] = args.num_pdfs
    conf_path = os.path.join(args.out, "catears.conf")
    with open(conf_path, "w", encoding="utf-8") as fd:
        for k, v in conf.items():
            fd.write(f"{k} = {v}\n")
    print(f"wrote {conf_path}")
    if todo:
        print("\nremaining steps (need Kaldi):\n" + "\n".join(todo))
    return 0


if __name__ == "__main__":
    sys.exit(main())
