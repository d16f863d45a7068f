"""The port's public host API vs the JAX package's.

The root and every subpackage of `catears_tpu_torch` export the names its
counterpart in `catears_tpu` exports, at the same paths (EXCLUDED is
empty: `parallel` is ported).  Importing them touches no card and builds
no kernel.  The functions this
API added to the port are held to JAX's: `am.nnet.nnet_forward` (float32
within 1e-4, the float AM's tolerance; equal to the port's `Nnet` exactly)
and `decode.oracle.OracleDecoder` (words and weights equal: both are the
same Python arithmetic).
"""

import importlib
import os
import pkgutil
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import catears_tpu
from _torch_parity import CPU, random_fst
from catears_tpu.am import nnet as jnn
from catears_tpu.decode import oracle as joracle
from catears_tpu.graph import fst as jfst
from catears_tpu.tools.toy import make_toy_nnet as jmake_toy_nnet
from catears_tpu_torch.am import nnet as tnn
from catears_tpu_torch.decode import oracle as toracle
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.io import binfmt as tbinfmt
from catears_tpu_torch.io.symbols import SymbolTable as TSymbolTable
from catears_tpu_torch.tools.toy import make_toy_nnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Subpackages of catears_tpu whose names the port does not export yet.
EXCLUDED = ()
PACKAGES = ("", "am", "decode", "frontend", "graph", "io", "parallel",
            "runtime", "utils")


def _public(module):
    """Names a `from module import name` user sees: __all__ when the module
    has one, else every attribute without a leading underscore that is not
    a submodule."""
    if hasattr(module, "__all__"):
        return sorted(module.__all__)
    return sorted(name for name, value in vars(module).items()
                  if not name.startswith("_")
                  and not isinstance(value, types.ModuleType))


def _pair(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module(f"catears_tpu{suffix}"),
            importlib.import_module(f"catears_tpu_torch{suffix}"))


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "root")
def test_public_names_equal_jax(sub):
    jax_mod, port_mod = _pair(sub)
    assert _public(port_mod) == _public(jax_mod)
    assert hasattr(port_mod, "__all__") == hasattr(jax_mod, "__all__")
    for name in _public(jax_mod):
        assert getattr(port_mod, name) is not None, name


def test_every_jax_subpackage_is_checked_or_excluded():
    jax_subs = sorted(m.name for m in pkgutil.iter_modules(
        catears_tpu.__path__) if m.ispkg)
    assert jax_subs == sorted([p for p in PACKAGES if p] + list(EXCLUDED))
    for sub in EXCLUDED:
        assert importlib.util.find_spec(f"catears_tpu_torch.{sub}") is None


# The import forms README.md documents for the JAX package, and those that
# failed on the port before it re-exported the names.
IMPORTS = [
    "from catears_tpu_torch.runtime import Recognizer",
    "from catears_tpu_torch.runtime import Utterance, decode_wav_file",
    "from catears_tpu_torch import Configuration",
    "from catears_tpu_torch import CatEarsError, last_error",
    "from catears_tpu_torch.io import Configuration",
    "from catears_tpu_torch.decode import Decoder, decode_batch",
    "from catears_tpu_torch.decode import OracleDecoder, Hypothesis",
    "from catears_tpu_torch.io import iter_wav_chunks, write_const_fst",
    "from catears_tpu_torch.am import AcousticModel, nnet_forward",
    "from catears_tpu_torch.frontend import Fbank, OnlineCMVN",
    "from catears_tpu_torch.graph import FlatFst, DeltaLmFst, LmFst",
    "from catears_tpu_torch.parallel import ShardedPipeline, make_mesh",
    "from catears_tpu_torch.parallel import initialize, global_sum",
]


@pytest.mark.parametrize("statement", IMPORTS)
def test_import_form(statement):
    scope = {}
    exec(statement, scope)
    names = statement.split(" import ")[1].split(", ")
    jax_statement = statement.replace("catears_tpu_torch", "catears_tpu")
    jax_scope = {}
    exec(jax_statement, jax_scope)
    for name in names:
        assert type(scope[name]).__name__ == type(jax_scope[name]).__name__


def test_import_touches_no_card_and_builds_nothing():
    """Importing the root and every subpackage leaves CUDA uninitialized,
    no kernel library loaded and TF32 off."""
    code = (
        "import importlib, torch\n"
        f"for sub in {PACKAGES!r}:\n"
        "    importlib.import_module('catears_tpu_torch' + "
        "('.' + sub if sub else ''))\n"
        "import catears_tpu_torch.bench, catears_tpu_torch.kernels as k\n"
        "import catears_tpu_torch.parallel.mesh, catears_tpu_torch.graft_entry\n"
        "import catears_tpu_torch.tools.synth\n"
        "import catears_tpu_torch.utils.native as native\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert native._LIB is None and not native._TRIED\n"
        "assert k._libs is None and not k.BUILD_LOG\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("batched", [False, True])
def test_nnet_forward_matches_jax_and_nnet(batched):
    spec = make_toy_nnet(np.random.RandomState(3), hidden=32, num_pdfs=20,
                         num_tdnn_layers=3)
    jspec = jmake_toy_nnet(np.random.RandomState(3), hidden=32, num_pdfs=20,
                           num_tdnn_layers=3)
    nnet_def, params = tnn.build_nnet(spec)
    jdef, jparams = jnn.build_nnet(jspec)
    assert nnet_def == jdef
    x = np.random.RandomState(4).randn(2, 30, 40).astype(np.float32)
    ref = np.stack([np.asarray(jnn.nnet_forward(jdef, jparams,
                                                jnp.asarray(row)))
                    for row in x])
    inp = x if batched else x[0]
    got_np = tnn.nnet_forward(nnet_def, params, inp)
    got_t = tnn.nnet_forward(nnet_def, [
        {k: torch.from_numpy(v) for k, v in p.items()} for p in params],
        torch.from_numpy(inp))
    module = tnn.Nnet(nnet_def, params)(torch.from_numpy(inp))
    assert torch.equal(got_np, module) and torch.equal(got_t, module)
    want = ref if batched else ref[0]
    np.testing.assert_allclose(got_np.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layers", [1, 3])
def test_output_dim_and_rows_consumed_match_jax(layers):
    """am.nnet.output_dim and rows_consumed, on the port's build of a toy
    TDNN and on JAX's."""
    spec = make_toy_nnet(np.random.RandomState(6), hidden=24, num_pdfs=17,
                         num_tdnn_layers=layers)
    nnet_def, params = tnn.build_nnet(spec)
    jdef, jparams = jnn.build_nnet(jmake_toy_nnet(
        np.random.RandomState(6), hidden=24, num_pdfs=17,
        num_tdnn_layers=layers))
    assert tnn.output_dim(nnet_def, params, 40) == jnn.output_dim(
        jdef, jparams, 40) == 17
    assert tnn.rows_consumed(nnet_def) == jnn.rows_consumed(jdef) == (
        spec.left_context, spec.right_context)


def _oracles(seed, beam, with_lm, data_dir):
    rng = np.random.RandomState(seed)
    kw = dict(num_states=14, eps_prob=0.3)
    graphs = (random_fst(rng, flat=jfst.FlatFst, **kw),
              random_fst(np.random.RandomState(seed), flat=tfst.FlatFst,
                         **kw))
    deltas = (None, None)
    if with_lm:
        from catears_tpu.io.binfmt import read_vec0_file
        from catears_tpu.io.symbols import SymbolTable

        small = os.path.join(data_dir, "lm.1order.bin")
        g = os.path.join(data_dir, "G.pfst")
        words = os.path.join(data_dir, "lm.words.txt")
        deltas = (jfst.DeltaLmFst(read_vec0_file(small),
                                  jfst.LmFst.read_lm(g),
                                  SymbolTable.read(words)),
                  tfst.DeltaLmFst(tbinfmt.read_vec0_file(small),
                                  tfst.LmFst.read_lm(g),
                                  TSymbolTable.read(words)))
        graphs = tuple(_with_lm_words(f, d, np.random.RandomState(seed))
                       for f, d in zip(graphs, deltas))
    tid2pdf = np.arange(11, dtype=np.int32)
    return [mod.OracleDecoder(f, tid2pdf, beam=beam, beam_size=64,
                              delta_lm=d)
            for mod, f, d in zip((joracle, toracle), graphs, deltas)]


def _with_lm_words(fst, delta, rng):
    import dataclasses

    vocab = delta.small_lm.size
    words = rng.randint(3, min(vocab, 200), size=fst.arc_olabel.size)
    return dataclasses.replace(fst, arc_olabel=np.where(
        fst.arc_olabel > 0, words, 0).astype(np.int32))


def _hyp(h):
    return h.words, h.weight


@pytest.mark.parametrize("seed,beam,with_lm", [
    (0, 1e9, False), (1, 1e9, False), (2, 8.0, False), (3, 4.0, False),
    (4, 1e9, True), (5, 8.0, True)])
def test_oracle_decoder_matches_jax(seed, beam, with_lm, data_dir):
    jo, to = _oracles(seed, beam, with_lm, data_dir)
    assert to.one_pass_eps == jo.one_pass_eps
    logp = np.log(np.random.RandomState(50 + seed).dirichlet(
        np.ones(11), size=14)).astype(np.float32)
    for f, row in enumerate(logp):
        assert to.process(row) == jo.process(row)
        if f % 5 == 4:
            partial = [_hyp(o.best_path(end_of_stream=False))
                       for o in (jo, to)]
            assert partial[0] == partial[1]
    assert to.tokens == jo.tokens
    assert _hyp(to.best_path()) == _hyp(jo.best_path())


def test_oracle_decoder_matches_the_ports_device_decoder():
    """The port's oracle against the port's own Decoder on the CPU, as
    tests/test_decoder.py::run_both holds the JAX pair."""
    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.decode.decoder import Decoder

    cfg = BeamConfig(beam_size=128, expand_size=1024, eps_expand_size=512,
                     max_eps_iters=6, beam=1e9, am_scale=0.1)
    for seed in range(3):
        rng = np.random.RandomState(seed)
        fst = random_fst(rng)
        tid2pdf = np.arange(11, dtype=np.int32)
        logp = np.log(rng.dirichlet(np.ones(11), size=15)).astype(np.float32)
        oracle = toracle.OracleDecoder(fst, tid2pdf, beam=cfg.beam,
                                       beam_size=cfg.beam_size)
        for row in logp:
            oracle.process(row)
        dec = Decoder(fst, tid2pdf, config=cfg, chunk_frames=7, device=CPU)
        dec.process(logp)
        dec.end_of_stream()
        o, d = oracle.best_path(), dec.best_path()
        assert d.words == o.words, seed
        assert abs(d.weight - o.weight) < 1e-3
