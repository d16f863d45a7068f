"""The PyTorch port's batch CLI end to end vs the JAX CLI, on the CPU.

Transcripts must be identical, for the float and the int8 (`quantized =
true`) acoustic model, LM off and with delta-LM rescoring.  Also: the port
imports neither jax nor the JAX package, its entry points run on the card
unless asked for the CPU, graphs that keep their epsilon arcs (prepare_
decode_graph's 'raw' mode) decode as in JAX, and so does a config that
sets `select_compact`.
"""

import ast
import contextlib
import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CPU, write_raw_conf, write_scp
from catears_tpu.cli import main as jax_main
from catears_tpu.tools.biggraph import write_trie_model
from catears_tpu.tools.toy import write_toy_model
from catears_tpu_torch.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model(tmp_path_factory, data_dir):
    d = tmp_path_factory.mktemp("torch_slice")
    conf = write_toy_model(str(d), rng=np.random.RandomState(5),
                           num_words=20, hidden=64, num_pdfs=96)
    scp = write_scp(str(d / "list.scp"),
                    [os.path.join(data_dir, f"en-us-{w}.wav")
                     for w in ("hello", "cat")])
    return str(d), conf, scp


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _with_keys(d, conf, name, lines):
    path = os.path.join(d, name)
    with open(conf) as src, open(path, "w") as dst:
        dst.write(src.read() + "".join(f"{x}\n" for x in lines))
    return path


@pytest.mark.parametrize("quantized", [False, True])
def test_cli_transcripts_match_jax(model, quantized):
    d, conf, scp = model
    if quantized:
        conf = _with_keys(d, conf, "toyq.conf", ["quantized = true"])
    rc_j, ref, _ = _run(jax_main, ["--batch=2", conf, scp])
    rc_t, got, _ = _run(torch_main, ["--batch=2", "--device=cpu", conf, scp])
    assert rc_j == rc_t == 0
    assert got == ref
    assert len(got.splitlines()) == 2


@pytest.fixture(scope="module")
def lm_model(tmp_path_factory, data_dir):
    """A small trie model with a delta-LM G' (tests/test_streaming.py's
    write_trie_model(with_lm=True) shape) and a narrow beam."""
    d = tmp_path_factory.mktemp("torch_slice_lm")
    conf = write_trie_model(str(d), np.random.RandomState(4), num_words=80,
                            hidden=32, num_phones=25, bigram_states=20,
                            variants=2, with_lm=True)
    with open(conf, "a") as fd:
        fd.write("beam_size = 256\nexpand_size = 1024\n"
                 "eps_expand_size = 256\nlm_expand_size = 64\n")
    scp = write_scp(str(d / "list.scp"),
                    [os.path.join(data_dir, f"en-us-{w}.wav")
                     for w in ("hello", "cat", "hello")])
    return str(d), conf, scp


@pytest.fixture(scope="module")
def toy_lm_conf(model):
    """The toy model with an ARPA-shaped G' over its 20 words (<s> and
    </s> are 21 and 22 in both): its decodes end in final states, so the
    transcripts are not empty."""
    from catears_tpu.io import binfmt
    from catears_tpu.tools.biggraph import make_big_lm

    d, conf, _ = model
    big = make_big_lm(np.random.RandomState(3), num_words=20)
    with open(os.path.join(d, "toy_g.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, big.lm.to_raw())
    with open(os.path.join(d, "toy.unigram"), "wb") as fd:
        binfmt.write_vec0(fd, big.small_lm)
    return _with_keys(d, conf, "toylm.conf", ["large_lm = toy_g.fst",
                                              "original_lm = toy.unigram",
                                              "lm_expand_size = 16",
                                              "beam_size = 512"])


@pytest.mark.parametrize("which", ["trie", "toy"])
@pytest.mark.parametrize("quantized", [False, True])
def test_cli_transcripts_with_delta_lm_match_jax(lm_model, toy_lm_conf,
                                                 which, quantized):
    _, conf, scp = lm_model
    if which == "toy":
        conf = toy_lm_conf
    if quantized:
        conf = _with_keys(os.path.dirname(conf), conf, "lmq.conf",
                          ["quantized = true"])
    rc_j, ref, _ = _run(jax_main, ["--batch=2", conf, scp])
    rc_t, got, _ = _run(torch_main, ["--batch=2", "--device=cpu", conf, scp])
    assert rc_j == rc_t == 0
    assert got == ref
    assert len(got.splitlines()) == 3
    if which == "toy":
        assert all(len(line.split()) > 1 for line in got.splitlines())


def test_delta_lm_without_original_lm_fails_as_jax(lm_model):
    d, conf, scp = lm_model
    bad = os.path.join(d, "no_original_lm.conf")
    with open(conf) as src, open(bad, "w") as dst:
        dst.writelines(x for x in src if not x.startswith("original_lm"))
    rc_j, out_j, err_j = _run(jax_main, ["--batch=2", bad, scp])
    rc_t, out_t, err_t = _run(torch_main, ["--batch=2", "--device=cpu", bad,
                                           scp])
    _one_line_error(rc_t, out_t, err_t, "original_lm")
    assert (rc_j, out_j, err_j) == (rc_t, out_t, err_t)


# Files that must not import jax or the JAX package: every module of the
# port, the card's smoke run and the profile script.
PORT_SCRIPTS = ("chip_smoke.py", os.path.join("scripts", "torch_profile.py"))
REFUSED = ("jax", "jaxlib", "catears_tpu")


def test_port_never_imports_jax():
    """In a fresh interpreter whose import system refuses jax and
    catears_tpu (the bare names and every submodule), every module of the
    port imports, and so do the two scripts, as modules."""
    code = f"""
import importlib, importlib.util, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import catears_tpu_torch
for m in pkgutil.walk_packages(catears_tpu_torch.__path__,
                               "catears_tpu_torch."):
    importlib.import_module(m.name)
for path in {PORT_SCRIPTS!r}:
    name = path.split("/")[-1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    sys.modules[name] = module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
assert not [m for m in sys.modules if m.split(".")[0] in {REFUSED!r}]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _port_files():
    package = glob.glob(os.path.join(REPO, "catears_tpu_torch", "**", "*.py"),
                        recursive=True)
    return sorted([p for p in package if "_build" not in p.split(os.sep)]
                  + [os.path.join(REPO, p) for p in PORT_SCRIPTS])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_names_no_jax_package_in_imports(path):
    """No import statement of a port file names catears_tpu or jax."""
    with open(path) as fd:
        tree = ast.parse(fd.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in REFUSED, (
                f"{path}:{node.lineno} imports {name}")


def _entry_point_calls(conf):
    """Each public constructor of the port, called without `device`."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.decode.decoder import BatchDecoder, Decoder
    from catears_tpu_torch.frontend.fbank import Fbank
    from catears_tpu_torch.graph import device as tdevice
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.io.config import Configuration
    from catears_tpu_torch.runtime.recognizer import Recognizer
    from catears_tpu_torch.tools.biggraph import make_big_lm

    config = Configuration.read(conf)
    fst = FlatFst.read(config.get_path("fst"))
    tid2pdf = np.arange(fst.arc_ilabel.max() + 1, dtype=np.int32)
    delta = make_big_lm(np.random.RandomState(0), num_words=20).delta_lm()
    return {
        "Recognizer": lambda: Recognizer(conf),
        "BatchDecoder": lambda: BatchDecoder(fst, tid2pdf),
        "Decoder": lambda: Decoder(fst, tid2pdf),
        "Fbank": lambda: Fbank(),
        "AcousticModel": lambda: AcousticModel(
            (("relu",),), [{}], np.zeros(4), tid2pdf, 0, 0, 8, 4),
        "AcousticModel.read": lambda: AcousticModel.read(config),
        "DeviceFst.build": lambda: tdevice.DeviceFst.build(fst, tid2pdf),
        "DeviceFst.from_numpy": lambda: tdevice.DeviceFst.from_numpy(
            *tdevice.build_arrays(fst, tid2pdf)),
        "DeviceLm.build": lambda: tdevice.DeviceLm.build(delta),
        "DeviceLm.from_numpy": lambda: tdevice.DeviceLm.from_numpy(
            *tdevice.lm_arrays(delta)),
    }


ENTRY_POINTS = ("Recognizer", "BatchDecoder", "Decoder", "Fbank",
                "AcousticModel",
                "AcousticModel.read", "DeviceFst.build",
                "DeviceFst.from_numpy", "DeviceLm.build",
                "DeviceLm.from_numpy")


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(model, monkeypatch, entry):
    """Called without `device` where no card is present, every entry point
    raises the port's CatEarsError (the CLI's message), never running on
    the CPU instead."""
    from catears_tpu_torch.utils.errors import CatEarsError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CatEarsError, match="no CUDA device is available"):
        _entry_point_calls(model[1])[entry]()


def _one_line_error(rc, out, err, needle):
    assert rc == 1 and out == ""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("catears: ")
    assert needle in lines[0]


def test_unported_inputs_fail_cleanly(model, data_dir):
    """Inputs the port once refused now decode: a .wav, an scp without
    --batch (the streaming Utterance path), a `cmvn_stats` config with
    --batch, and a `select_compact` config (once a one-line error), whose
    transcripts equal JAX's with --batch and the plain config's on the
    .wav."""
    d, conf, scp = model
    conf = _with_keys(d, conf, "narrow.conf", ["beam_size = 256",
                                               "expand_size = 2048",
                                               "eps_expand_size = 1024"])
    wav = os.path.join(data_dir, "en-us-hello.wav")
    rc, out, _ = _run(torch_main, ["--device=cpu", conf, wav])
    assert rc == 0 and len(out.splitlines()) == 1
    plain_wav = out
    rc, out, _ = _run(torch_main, ["--device=cpu", conf, scp])
    assert rc == 0 and [x.split()[0] for x in out.splitlines()] == ["u0",
                                                                   "u1"]
    cmvn = _with_keys(d, conf, "cmvn.conf", [
        "cmvn_stats = " + os.path.join(data_dir, "cmvn_stats.bin")])
    rc, out, _ = _run(torch_main, ["--batch", "--device=cpu", cmvn, scp])
    assert rc == 0 and len(out.splitlines()) == 2
    compact = _with_keys(d, conf, "compact.conf", ["select_compact = 256"])
    rc_j, ref, _ = _run(jax_main, ["--batch=2", compact, scp])
    rc, out, _ = _run(torch_main, ["--batch=2", "--device=cpu", compact, scp])
    assert rc_j == rc == 0 and out == ref and len(out.splitlines()) == 2
    rc, out, _ = _run(torch_main, ["--device=cpu", compact, wav])
    assert rc == 0 and out == plain_wav


def test_default_device_needs_cuda(model):
    _, conf, scp = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    _one_line_error(*_run(torch_main, ["--batch=2", conf, scp]), "CUDA")


def test_graph_not_eps_free_is_rejected():
    """An epsilon path with two output labels keeps the graph out of
    prepare_decode_graph's eps-free and closed modes: the decoders take it
    raw, with the closure rounds in every frame, and give the words and
    costs of JAX's BatchDecoder and Decoder."""
    from catears_tpu.decode import decoder as jdecoder
    from catears_tpu.graph.fst import FlatFst as JaxFlatFst
    from catears_tpu_torch.decode.decoder import BatchDecoder, Decoder
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.graph.transform import prepare_decode_graph

    arcs = np.array([(0, 1, 0, 1, 0.5), (1, 2, 0, 2, 0.5), (0, 0, 1, 0, 1.0),
                     (2, 2, 2, 0, 1.0)])
    fst, jfst = (flat.from_arrays(
        start=0, final=np.zeros(3, np.float32),
        state_of_arc=arcs[:, 0].astype(np.int64),
        arc_next=arcs[:, 1].astype(np.int32),
        arc_ilabel=arcs[:, 2].astype(np.int32),
        arc_olabel=arcs[:, 3].astype(np.int32),
        arc_weight=arcs[:, 4].astype(np.float32))
        for flat in (FlatFst, JaxFlatFst))
    assert prepare_decode_graph(fst)[2] == "raw"
    tid2pdf = np.arange(3, dtype=np.int32)
    # pdf 2 likely: the best path crosses the two-word epsilon path
    logp = np.log(np.random.RandomState(0).dirichlet(
        [1.0, 1.0, 8.0], size=(2, 6))).astype(np.float32)
    ref = jdecoder.BatchDecoder(jfst, tid2pdf).decode(logp, [6, 4])
    got = BatchDecoder(fst, tid2pdf, device=CPU).decode(logp, [6, 4])
    assert [(h.words, h.weight) for h in got] == [
        (h.words, h.weight) for h in ref]
    assert got[0].words == [1, 2]
    jdec, tdec = jdecoder.Decoder(jfst, tid2pdf), Decoder(fst, tid2pdf,
                                                         device=CPU)
    for dec in (jdec, tdec):
        dec.process(logp[0])
        dec.end_of_stream()
    ref, got = jdec.best_path(), tdec.best_path()
    assert (got.words, got.weight) == (ref.words, ref.weight)


@pytest.fixture(scope="module")
def raw_conf(model):
    """The toy model whose graph carries one more epsilon path, unreachable,
    with two output labels (prepare_decode_graph's 'raw' mode)."""
    return write_raw_conf(model[1], "raw", ["beam_size = 256",
                                            "expand_size = 2048",
                                            "eps_expand_size = 1024"])


@pytest.fixture(scope="module")
def raw_lm_conf(toy_lm_conf):
    """The same raw graph under the toy G' (delta-LM rescoring)."""
    return write_raw_conf(toy_lm_conf, "rawlm", ["expand_size = 8192",
                                                 "eps_expand_size = 1024",
                                                 "lm_expand_size = 256"])


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("how", ["batch", "wav"])
def test_cli_on_a_raw_graph_matches_jax(model, data_dir, raw_conf,
                                        raw_lm_conf, how, lm):
    """The Recognizer on the raw toy graph, LM off and with the toy G',
    through the CLI's batch path and its .wav (streaming Utterance) path:
    JAX's transcripts."""
    _, _, scp = model
    conf = raw_lm_conf if lm else raw_conf
    if how == "batch":
        argv = ["--batch=2", conf, scp]
    else:
        argv = [conf, os.path.join(data_dir, "en-us-hello.wav")]
    rc_j, ref, _ = _run(jax_main, argv)
    rc_t, got, _ = _run(torch_main, ["--device=cpu"] + argv)
    assert rc_j == rc_t == 0
    assert got == ref
    assert len(got.splitlines()) == (2 if how == "batch" else 1)
    assert all(line.split() for line in got.splitlines())
