"""The port's native host library (`catears_tpu_torch.utils.native`, built
from `catears_tpu_torch/csrc/catears_native.cc`) vs the Python paths.

JAX's four cases (tests/test_native.py) on the port's library, each entry
point exactly equal to the port's Python path and to the JAX package's;
`FlatFst.read` of a ConstFst and `runtime.batch.load_waves`, native
against Python, with equal arrays; the library builds into the package's
`_build/` and, where it cannot be built, every call returns None with the
compiler's output kept in BUILD_LOG.  Skips only without a C++ compiler.
"""

import io
import os
import shutil

import numpy as np
import pytest

from catears_tpu.decode.hyp import HostTrace as JHostTrace
from catears_tpu.decode.hyp import backtrace as jbacktrace
from catears_tpu.graph.fst import FlatFst as JaxFlatFst
from catears_tpu.io.openfst import read_const_fst_file as jread_const_fst
from catears_tpu.io.wav import read_16k_pcm as jread_16k_pcm
from catears_tpu.tools.score import edit_distance as jedit_distance
from catears_tpu_torch.decode import hyp as thyp
from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.io.openfst import ConstFst, write_const_fst
from catears_tpu_torch.io.wav import read_16k_pcm
from catears_tpu_torch.runtime import batch as tbatch
from catears_tpu_torch.tools import score as tscore
from catears_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(shutil.which("c++") is None
                                and shutil.which("g++") is None,
                                reason="no C++ compiler")

FST_ARRAYS = ("final", "offsets", "arc_ilabel", "arc_olabel", "arc_weight",
              "arc_next")


@pytest.fixture
def lib():
    lib = native.load()
    assert lib is not None, native.BUILD_LOG
    return lib


def _wavs(data_dir):
    return [os.path.join(data_dir, "en-us-hello.wav"),
            os.path.join(data_dir, "en-us-cat.wav"),
            os.path.join(data_dir, "en-us-hello.wav")]


def test_builds_into_the_package_build_dir(lib):
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libcatears_native-")
    assert native.BUILD_DIR.endswith(os.path.join("catears_tpu_torch",
                                                  "_build"))
    assert native.available()


class TestNativeWav:
    def test_batch_load_matches_python(self, lib, data_dir):
        paths = _wavs(data_dir)
        batch = native.load_wav_batch(paths, num_threads=2)
        assert batch is not None
        for path, wave in zip(paths, batch):
            np.testing.assert_array_equal(wave, read_16k_pcm(path))
            np.testing.assert_array_equal(wave, jread_16k_pcm(path))

    def test_load_waves_native_equals_python(self, lib, data_dir,
                                             monkeypatch):
        paths = _wavs(data_dir)
        got = tbatch.load_waves(paths)
        monkeypatch.setattr(native, "available", lambda: False)
        want = tbatch.load_waves(paths)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _const_fst_bytes(fst):
    counts = np.diff(fst.offsets).astype(np.int32)
    cf = ConstFst(start=fst.start, final=fst.final,
                  arc_pos=fst.offsets[:-1].astype(np.int64),
                  arc_count=counts, arc_ilabel=fst.arc_ilabel,
                  arc_olabel=fst.arc_olabel, arc_weight=fst.arc_weight,
                  arc_next=fst.arc_next)
    buf = io.BytesIO()
    write_const_fst(buf, cf)
    return buf.getvalue(), counts


class TestNativeConstFst:
    def test_parse_matches_python(self, lib, data_dir):
        fst = FlatFst.read(os.path.join(data_dir, "G.pfst"))
        data, counts = _const_fst_bytes(fst)
        parsed = native.parse_const_fst(data)
        assert parsed is not None
        start, final, pos, cnt, arcs = parsed
        assert start == fst.start
        np.testing.assert_array_equal(final, fst.final)
        np.testing.assert_array_equal(pos, fst.offsets[:-1])
        np.testing.assert_array_equal(cnt, counts)
        np.testing.assert_array_equal(arcs[:, 0], fst.arc_ilabel)
        np.testing.assert_array_equal(arcs[:, 1], fst.arc_olabel)
        np.testing.assert_array_equal(
            arcs[:, 2].view(np.float32), fst.arc_weight)
        np.testing.assert_array_equal(arcs[:, 3], fst.arc_next)

    def test_flatfst_read_native_equals_python(self, lib, data_dir,
                                               tmp_path, monkeypatch):
        fst = FlatFst.read(os.path.join(data_dir, "G.pfst"))
        path = tmp_path / "g.fst"
        path.write_bytes(_const_fst_bytes(fst)[0])
        got = FlatFst.read(str(path))
        jax_py = JaxFlatFst.from_const_fst(jread_const_fst(str(path)))
        monkeypatch.setattr(native, "available", lambda: False)
        want = FlatFst.read(str(path))
        assert got.start == want.start == jax_py.start
        for name in FST_ARRAYS:
            for other in (want, jax_py):
                a, b = getattr(got, name), getattr(other, name)
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def _traces(seed, t, k=8, w=3):
    rng = np.random.RandomState(seed)
    prev = rng.randint(0, k, (t, k)).astype(np.int32)
    prev[0] = -1  # root frame
    words = np.where(rng.rand(t, k, w) < 0.3,
                     rng.randint(1, 50, (t, k, w)), 0).astype(np.int32)
    return prev, words


class TestNativeBacktrace:
    @pytest.mark.parametrize("t", [12, 100])
    def test_matches_python(self, lib, monkeypatch, t):
        """t = 100 also takes the port's backtrace through the library (64
        traces or more); the port's Python walk is forced for the
        reference, and JAX's walk takes its own path."""
        prev, words = _traces(0, t)
        traces = [thyp.HostTrace(prev[f], words[f]) for f in range(t)]
        jtraces = [JHostTrace(prev[f], words[f]) for f in range(t)]
        nat = [native.backtrace(prev, words, s) for s in range(8)]
        via_port = [thyp.backtrace(traces, s) for s in range(8)]
        jax_walk = [jbacktrace(jtraces, s) for s in range(8)]
        monkeypatch.setattr(native, "available", lambda: False)
        py = [thyp.backtrace(traces, s) for s in range(8)]
        assert nat == py == via_port == jax_walk


class TestNativeEditDistance:
    def test_matches_python(self, lib, monkeypatch):
        rng = np.random.RandomState(1)
        pairs = [(list(rng.randint(0, 5, rng.randint(0, 15))),
                  list(rng.randint(0, 5, rng.randint(0, 15))))
                 for _ in range(20)]
        nat = [native.edit_distance(a, b) for a, b in pairs]
        strs = [([str(x) for x in a], [str(x) for x in b]) for a, b in pairs]
        via_port = [tscore.token_errors(a, b) for a, b in strs]
        monkeypatch.setattr(native, "available", lambda: False)
        py = [tscore.token_errors(a, b) for a, b in strs]
        jpy = [jedit_distance(a, b)[0] for a, b in strs]
        assert nat == via_port == py == jpy


def test_unbuildable_library_returns_none(monkeypatch, tmp_path, data_dir):
    """Without a compiler every entry point returns None, BUILD_LOG says
    why, and the callers take their Python paths."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "BUILD_LOG", "")
    monkeypatch.setattr(native, "lib_path",
                        lambda: str(tmp_path / "libcatears_native-x.so"))
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert native.load() is None and not native.available()
    assert "no C++ compiler" in native.BUILD_LOG
    paths = _wavs(data_dir)
    assert native.load_wav_batch(paths) is None
    assert native.edit_distance([1], [2]) is None
    assert native.backtrace(*_traces(0, 4), 0) is None
    assert native.parse_const_fst(b"") is None
    waves = tbatch.load_waves(paths)
    np.testing.assert_array_equal(waves[1], read_16k_pcm(paths[1]))
    assert tscore.token_errors(list("abc"), list("abd")) == 1


def test_compiler_errors_are_kept(monkeypatch, tmp_path):
    """A source the compiler rejects: load() gives None and BUILD_LOG
    holds the compiler's message."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "lib_path",
                        lambda: str(tmp_path / "build" / "libbad.so"))
    assert native.load() is None
    assert "exited" in native.BUILD_LOG and "bad.cc" in native.BUILD_LOG
