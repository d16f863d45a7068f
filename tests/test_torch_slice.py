"""The PyTorch port's batch CLI end to end vs the JAX CLI, on the CPU.

Transcripts must be identical, for the float and the int8 (`quantized =
true`) acoustic model, LM off and with delta-LM rescoring.  Also: the port
never imports jax, and inputs it does not carry yet fail with a one-line
`catears:` error.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import write_scp
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


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import catears_tpu_torch\n"
        "for m in pkgutil.walk_packages(catears_tpu_torch.__path__,\n"
        "                               'catears_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _one_line_error(rc, out, err, needle):
    assert rc == 1 and out == ""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("catears: ")
    assert needle in lines[0]


def test_unported_inputs_fail_cleanly(model, data_dir):
    d, conf, scp = model
    wav = os.path.join(data_dir, "en-us-hello.wav")
    _one_line_error(*_run(torch_main, ["--device=cpu", conf, wav]),
                    "not yet ported")
    _one_line_error(*_run(torch_main, ["--device=cpu", conf, scp]),
                    "not yet ported")
    cmvn = _with_keys(d, conf, "cmvn.conf", ["cmvn_stats = c.bin"])
    _one_line_error(*_run(torch_main, ["--batch", "--device=cpu", cmvn, scp]),
                    "cmvn_stats")


def test_default_device_needs_cuda(model):
    _, conf, scp = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    _one_line_error(*_run(torch_main, ["--batch=2", conf, scp]), "CUDA")


def test_graph_not_eps_free_is_rejected():
    """An epsilon path with two output labels keeps the graph out of
    prepare_decode_graph's eps-free mode, which the port's decoder does not
    carry yet."""
    from catears_tpu.graph.fst import FlatFst
    from catears_tpu.graph.transform import prepare_decode_graph
    from catears_tpu.utils.errors import NotImplementedError_
    from catears_tpu_torch.decode.decoder import BatchDecoder

    arcs = np.array([(0, 1, 0, 1, 0.5), (1, 2, 0, 2, 0.5), (0, 0, 1, 0, 1.0),
                     (2, 2, 2, 0, 1.0)])
    fst = FlatFst.from_arrays(
        start=0, final=np.zeros(3, np.float32),
        state_of_arc=arcs[:, 0].astype(np.int64),
        arc_next=arcs[:, 1].astype(np.int32),
        arc_ilabel=arcs[:, 2].astype(np.int32),
        arc_olabel=arcs[:, 3].astype(np.int32),
        arc_weight=arcs[:, 4].astype(np.float32))
    assert prepare_decode_graph(fst)[2] != "eps_free"
    with pytest.raises(NotImplementedError_, match="not yet ported"):
        BatchDecoder(fst, np.arange(3, dtype=np.int32))
