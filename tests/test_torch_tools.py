"""The port's copy of the Kaldi conversion recipe vs the JAX package's.

`catears_tpu_torch.tools.{convert_am, convert_fst, convert_misc, lm, arpa,
mkgraph}` must write byte-identical files to `catears_tpu.tools.*` and
`scripts/mkgraph.py` on tests/test_tools.py's inputs, and the port's
Recognizer on the port's decode directory must give the JAX transcript.
The scoring CLI (`tools.score`) prints the JAX CLI's bytes, and
`io.wav.iter_wav_chunks` and `io.openfst.write_const_fst` give JAX's bytes.
"""

import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import test_tools as jt
from _torch_parity import CPU
from catears_tpu.graph.fst import FlatFst
from catears_tpu.io import binfmt
from catears_tpu.tools import arpa as jarpa
from catears_tpu.tools import convert_am as jconvert_am
from catears_tpu.tools import convert_fst as jconvert_fst
from catears_tpu.tools import convert_misc as jconvert_misc
from catears_tpu.tools import lm as jlm
from catears_tpu_torch.graph.fst import FlatFst as PortFlatFst
from catears_tpu_torch.io import binfmt as tbinfmt
from catears_tpu_torch.tools import arpa as tarpa
from catears_tpu_torch.tools import convert_am as tconvert_am
from catears_tpu_torch.tools import convert_fst as tconvert_fst
from catears_tpu_torch.tools import convert_misc as tconvert_misc
from catears_tpu_torch.tools import lm as tlm
from catears_tpu_torch.tools import mkgraph as tmkgraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path) -> bytes:
    with open(path, "rb") as fd:
        return fd.read()


def test_convert_am_writes_the_same_files(tmp_path):
    src = tmp_path / "am.txt"
    src.write_text(jt.NNET3_TEXT)
    outs = [tmp_path / "jax", tmp_path / "port"]
    assert jconvert_am.main([str(src), str(outs[0])]) == 0
    assert tconvert_am.main([str(src), str(outs[1])]) == 0
    for ext in (".nnet", ".prior"):
        assert _bytes(str(outs[0]) + ext) == _bytes(str(outs[1]) + ext)
    spec = tbinfmt.read_nnet_file(str(outs[1]) + ".nnet")
    assert [layer.kind for layer in spec.layers] == [
        layer.kind for layer in jconvert_am.convert(jt.NNET3_TEXT)[0].layers]


@pytest.mark.parametrize("form", ["binary", "text"])
def test_convert_fst_g_pfst(tmp_path, data_dir, form):
    """G.pfst through convert_fst's main (flat_to_raw + write_pkfst, or
    the text dump) and through flat_to_raw directly."""
    g = os.path.join(data_dir, "G.pfst")
    outs = [str(tmp_path / "jax.out"), str(tmp_path / "port.out")]
    assert jconvert_fst.main([g, outs[0], form]) == 0
    assert tconvert_fst.main([g, outs[1], form]) == 0
    assert _bytes(outs[0]) == _bytes(outs[1])
    raws = [io.BytesIO(), io.BytesIO()]
    binfmt.write_pkfst(raws[0], jconvert_fst.flat_to_raw(FlatFst.read(g)))
    tbinfmt.write_pkfst(raws[1],
                        tconvert_fst.flat_to_raw(PortFlatFst.read(g)))
    assert raws[0].getvalue() == raws[1].getvalue()


def test_convert_misc_trans_and_cmvn(tmp_path):
    trans = tmp_path / "id2pdf.txt"
    trans.write_text("4\n6\n1 0\n2 0\n3 1\n4 2\n5 3\n6 3\n")
    stats = tmp_path / "stats.txt"
    stats.write_text(" [\n " + " ".join(str(float(i)) for i in range(82))
                     + " ]\n")
    for kind, src in (("trans", trans), ("cmvn", stats)):
        outs = [str(tmp_path / f"{kind}.jax"), str(tmp_path / f"{kind}.port")]
        assert jconvert_misc.main([kind, str(src), outs[0]]) == 0
        assert tconvert_misc.main([kind, str(src), outs[1]]) == 0
        assert _bytes(outs[0]) == _bytes(outs[1])
    assert tconvert_misc.convert_trans(str(trans), outs[1]) == 4


def test_lm_prune_and_convert_unigram(tmp_path, monkeypatch, capsys):
    """prune_to_unigram (also as main_prune on stdin), the unigram cost
    vector through main_convert_unigram, and fit_bigram_arpa."""
    lines = jt.ARPA.splitlines()
    assert tlm.prune_to_unigram(lines) == jlm.prune_to_unigram(lines)
    printed = []
    for module in (jlm, tlm):
        monkeypatch.setattr(sys, "stdin", io.StringIO(jt.ARPA))
        assert module.main_prune() == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(jt.ARPA)
    vocab = tmp_path / "words.txt"
    vocab.write_text("<eps> 0\nhello 1\nworld 2\n<s> 3\n</s> 4\n")
    outs = [str(tmp_path / "u.jax"), str(tmp_path / "u.port")]
    assert jlm.main_convert_unigram([str(arpa), str(vocab), outs[0]]) == 0
    assert tlm.main_convert_unigram([str(arpa), str(vocab), outs[1]]) == 0
    assert _bytes(outs[0]) == _bytes(outs[1])
    rng = np.random.RandomState(0)
    seqs = [[f"w{x}" for x in rng.randint(1, 9, rng.randint(2, 9))]
            for _ in range(50)]
    words = [f"w{i}" for i in range(1, 9)]
    assert tlm.fit_bigram_arpa(seqs, words) == jlm.fit_bigram_arpa(seqs,
                                                                   words)


@pytest.mark.parametrize("name", ["ARPA", "ARPA2", "ARPA3"])
def test_arpa_to_fst_writes_the_same_g(tmp_path, name):
    text = getattr(jt, name, None) or getattr(jt.TestArpaToFst, name)
    path = tmp_path / "lm.arpa"
    path.write_text(text)
    (jfst, jvocab), (tfst_, tvocab) = (jarpa.arpa_to_fst(str(path)),
                                       tarpa.arpa_to_fst(str(path)))
    assert jvocab == tvocab
    raws = [io.BytesIO(), io.BytesIO()]
    binfmt.write_pkfst(raws[0], jconvert_fst.flat_to_raw(jfst))
    tbinfmt.write_pkfst(raws[1], tconvert_fst.flat_to_raw(tfst_))
    assert raws[0].getvalue() == raws[1].getvalue()
    grams = tarpa.parse_arpa(text.splitlines())
    assert grams == jarpa.parse_arpa(text.splitlines())
    for sent in ([], list(tvocab)[-2:], list(tvocab)[-1:] * 3):
        sent = [w for w in sent if w not in ("<s>", "</s>")]
        assert tarpa.sentence_cost(grams, sent) == jarpa.sentence_cost(
            grams, sent)


def _kaldi_artifacts(src):
    """tests/test_tools.py::TestMkgraphRecipe's inputs: a toy model, its
    id2pdf text and a 5-word ARPA LM."""
    from catears_tpu.tools.toy import make_phone_loop_graph, write_toy_model

    write_toy_model(str(src), num_words=5, hidden=32, num_pdfs=24)
    graph = make_phone_loop_graph(np.random.RandomState(0), num_words=5,
                                  num_pdfs=24)
    with open(src / "id2pdf.txt", "w") as fd:
        fd.write(f"24\n{graph.num_transitions}\n")
        for tid, pdf in enumerate(graph.tid2pdf):
            fd.write(f"{tid} {pdf}\n")
    words = [f"word{i}" for i in range(1, 6)]
    lines = ["\\data\\", "ngram 1=7", "ngram 2=1", "", "\\1-grams:",
             "-99\t<s>\t-0.3", "-0.7\t</s>"]
    lines += [f"-0.8\t{w}\t-0.2" for w in words]
    lines += ["", "\\2-grams:", "-0.4\t<s> word1", "", "\\end\\"]
    (src / "lm.arpa").write_text("\n".join(lines) + "\n")


def test_mkgraph_decode_dir(tmp_path, data_dir, capsys):
    """The port's mkgraph writes the JAX script's decode directory file for
    file, and the port's Recognizer on it gives the JAX transcript."""
    from catears_tpu.decode.beam import BeamConfig
    from catears_tpu.runtime.recognizer import Recognizer, decode_wav_file
    from catears_tpu_torch.decode.beam import BeamConfig as PortBeamConfig
    from catears_tpu_torch.runtime.recognizer import Recognizer as PortRec
    from catears_tpu_torch.runtime.recognizer import \
        decode_wav_file as port_decode_wav_file

    src = tmp_path / "kaldi"
    _kaldi_artifacts(src)
    spec = importlib.util.spec_from_file_location(
        "jax_mkgraph", os.path.join(REPO, "scripts", "mkgraph.py"))
    jmkgraph = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmkgraph)
    outs = [tmp_path / "jax", tmp_path / "port"]
    for main, out in ((jmkgraph.main, outs[0]), (tmkgraph.main, outs[1])):
        assert main([
            "--out", str(out), "--words", str(src / "words.txt"),
            "--hclg", str(src / "toy.fst"), "--lm", str(src / "lm.arpa"),
            "--id2pdf", str(src / "id2pdf.txt"),
            "--nnet", str(src / "toy.nnet"), "--prior", str(src / "toy.prior"),
            "--left-context", "2", "--right-context", "2",
            "--chunk-size", "8"]) == 0
    capsys.readouterr()
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    assert {"catears.conf", "hclg.fst", "g.pfst", "original_lm.bin",
            "tid2pdf.bin", "am.nnet", "am.prior", "words.txt"} <= set(names)
    for name in names:
        assert _bytes(outs[0] / name) == _bytes(outs[1] / name), name

    geometry = dict(beam_size=128, expand_size=1024, eps_expand_size=512,
                    max_eps_iters=6, beam=1e9)
    wav = os.path.join(data_dir, "en-us-hello.wav")
    ref = decode_wav_file(Recognizer(str(outs[0] / "catears.conf"),
                                     beam_config=BeamConfig(**geometry)), wav)
    rec = PortRec(str(outs[1] / "catears.conf"),
                  beam_config=PortBeamConfig(**geometry), device=CPU)
    assert rec.delta_lm is not None
    assert port_decode_wav_file(rec, wav) == ref


# -- the scoring CLI, iter_wav_chunks and write_const_fst ------------------

SCORE_CASES = {
    "words": ("utt1 hello world\nutt2 the cat sat\n",
              "utt1 hello word\nutt2 the cat sat\n"),
    "missing": ("utt1 a b\nutt2 c\n", "utt1 a b\n"),
    "cjk": ("u1 你好 world\nu2 你好吗\n\nu3\n", "u1 你 world\nu2 你好吗 ok\n"),
    "empty_hyp": ("u1 a b c\n", "u1\n"),
}


@pytest.mark.parametrize("cer", [False, True], ids=["wer", "cer"])
@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_cli_stdout_equals_jax(tmp_path, capsys, case, cer):
    """`python -m catears_tpu_torch.tools.score [--cer] ref hyp` prints the
    JAX CLI's bytes; score() gives JAX's ScoreResult."""
    from catears_tpu.tools import score as jscore
    from catears_tpu_torch.tools import score as tscore

    ref, hyp = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    ref.write_text(SCORE_CASES[case][0], encoding="utf-8")
    hyp.write_text(SCORE_CASES[case][1], encoding="utf-8")
    argv = (["--cer"] if cer else []) + [str(ref), str(hyp)]
    printed = []
    for module in (jscore, tscore):
        assert module.main(list(argv)) == 0
        printed.append(capsys.readouterr().out.encode("utf-8"))
    assert printed[0] == printed[1]
    j, t = jscore.score(str(ref), str(hyp), cer), tscore.score(
        str(ref), str(hyp), cer)
    assert vars(j) == vars(t) and j.wer == t.wer


def test_score_cli_as_a_module(tmp_path):
    """The port's CLI through `python -m` in a fresh interpreter, and its
    usage error, against the JAX module's."""
    ref, hyp = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    ref.write_text(SCORE_CASES["cjk"][0], encoding="utf-8")
    hyp.write_text(SCORE_CASES["cjk"][1], encoding="utf-8")
    outs = []
    for pkg in ("catears_tpu", "catears_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.tools.score", "--cer", str(ref),
             str(hyp)], capture_output=True, cwd=REPO, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and outs[1].startswith(b"%CER ")
    from catears_tpu_torch.tools import score as tscore
    assert tscore.main([str(ref)]) == 1


def test_score_cases_of_test_tools():
    """tests/test_tools.py::TestScore on the port."""
    from catears_tpu_torch.tools import score as tscore

    err, s, d, i = tscore.edit_distance(list("kitten"), list("sitting"))
    assert err == 3 and s == 2 and i == 1
    assert tscore.char_tokenize("hello world") == ["hello", "world"]
    assert tscore.char_tokenize("你好 world") == ["你", "好", "world"]
    assert tscore.char_tokenize("你好吗") == ["你", "好", "吗"]
    assert tscore.token_errors(list("abc"), list("abd")) == 1


@pytest.mark.parametrize("chunk_bytes", [1, 1000, 1024, 1 << 20])
def test_iter_wav_chunks_equals_jax(data_dir, chunk_bytes):
    from catears_tpu.io.wav import iter_wav_chunks as jiter
    from catears_tpu_torch.io.wav import iter_wav_chunks as titer

    path = os.path.join(data_dir, "en-us-hello.wav")
    got = list(titer(path, chunk_bytes))
    assert got == list(jiter(path, chunk_bytes))
    assert all(len(c) == chunk_bytes for c in got[:-1])


@pytest.mark.parametrize("seed", [11, 12])
def test_write_const_fst_equals_jax(seed):
    """write_const_fst writes JAX's bytes, and both readers read them
    back."""
    from catears_tpu.io import openfst as jopenfst
    from catears_tpu_torch.io import openfst as topenfst

    rng = np.random.RandomState(seed)
    n_states, n_arcs = 13, 40
    state_of_arc = np.sort(rng.randint(0, n_states, n_arcs))
    counts = np.bincount(state_of_arc, minlength=n_states)
    pos = np.concatenate([[0], np.cumsum(counts)[:-1]])
    final = np.where(rng.rand(n_states) < 0.3,
                     rng.rand(n_states).astype(np.float32), np.inf)
    fields = dict(
        start=0, final=final.astype(np.float32),
        arc_pos=pos.astype(np.int64), arc_count=counts.astype(np.int32),
        arc_ilabel=rng.randint(0, 5, n_arcs).astype(np.int32),
        arc_olabel=rng.randint(0, 5, n_arcs).astype(np.int32),
        arc_weight=rng.rand(n_arcs).astype(np.float32),
        arc_next=rng.randint(0, n_states, n_arcs).astype(np.int32))
    bufs = [io.BytesIO(), io.BytesIO()]
    jopenfst.write_const_fst(bufs[0], jopenfst.ConstFst(**fields))
    topenfst.write_const_fst(bufs[1], topenfst.ConstFst(**fields))
    assert bufs[0].getvalue() == bufs[1].getvalue()
    bufs[1].seek(0)
    back = topenfst.read_const_fst(bufs[1])
    for name, value in fields.items():
        np.testing.assert_array_equal(getattr(back, name), value)


def _script_extract_id2pdf():
    spec = importlib.util.spec_from_file_location(
        "extract_id2pdf", os.path.join(REPO, "scripts", "extract_id2pdf.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# TestExtractId2Pdf's model text, and its <Tuples> form (forward and
# self-loop pdfs of a chain model).
TUPLES_MDL = jt.TestExtractId2Pdf.MDL.replace(
    "<Triples> 4\n1 0 0\n1 1 1\n2 0 2\n2 1 3\n</Triples>",
    "<Tuples> 4\n1 0 0 4\n1 1 1 1\n2 0 2 5\n2 1 3 3\n</Tuples>")


@pytest.mark.parametrize("text", [jt.TestExtractId2Pdf.MDL, TUPLES_MDL],
                         ids=["triples", "tuples"])
def test_extract_id2pdf_equals_the_script(tmp_path, capsys, text):
    """tools.extract_id2pdf (the recipe's first step, in the package)
    parses as scripts/extract_id2pdf.py does and prints its bytes, through
    main() and as a module."""
    from catears_tpu_torch.tools import extract_id2pdf as tool

    script = _script_extract_id2pdf()
    want = script.parse_transition_model(text)
    assert tool.parse_transition_model(text) == want
    if "<Triples>" in text:
        assert want == (4, [0, 0, 0, 1, 1, 2, 2, 3, 3])
    else:
        assert want == (6, [0, 4, 0, 1, 1, 5, 2, 3, 3])
    mdl = tmp_path / "final.txt.mdl"
    mdl.write_text(text)
    printed = []
    for main in (script.main, tool.main):
        assert main([str(mdl)]) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    proc = subprocess.run(
        [sys.executable, "-m", "catears_tpu_torch.tools.extract_id2pdf",
         str(mdl)], capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and proc.stdout == printed[0]
    assert tool.main([]) == 1
