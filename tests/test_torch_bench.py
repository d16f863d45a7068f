"""The port's benchmark (`catears_tpu_torch.bench`) vs the repo's bench.py.

Tier-1, at toy scale (BENCH_WORDS 300, BENCH_BATCH 2, BENCH_SECONDS 1,
BENCH_HIDDEN 64), on the CPU (BENCH_DEVICE=cpu; JAX on the CPU too):
- `build_bench_setup` draws the random stream in bench.py's order, so the
  planted frames, true words, wave, tid2pdf, AM weights (float and int8),
  DeviceFst and DeviceLm tables equal bench.py's bit for bit;
- the AM forward of the headline equals bench.py's jitted one within the
  AM tests' tolerances (float 1e-4; int8 1% of the range);
- so does the setup under each knob of the decode variants
  (BENCH_REORDER=bfs|freq|hot with BENCH_HOT_ROWS and BENCH_COLD, and
  BENCH_SELECT_COMPACT): the renumbered graph, the calibration's visit
  counts, the DeviceFst tables (emit_hot included) and the BeamConfig;
- every mode's JSON line carries bench.py's keys and metric name, the
  headline's also under the variant knobs;
- a knob value without a counterpart raises, and so do a run without a
  card and a `scaling` run whose batch does not split over its 8 devices
  (the toy batch of 2), as one `catears: ...` line;
- `scaling` at BENCH_BATCH 8 on 8 logical CPU devices prints bench.py's
  `dp_sharding_efficiency_8dev` line.
Marked `slow`, at a reduced trie scale: the headline's per-utterance words,
WER, capacity high-water marks and hyp0_words equal bench.py's run, LM off
and on.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, DFST_META, DLM_META, assert_same,
                           range_error, to_np)
from catears_tpu_torch import bench as tbench
from catears_tpu_torch.graph.device import LM_TABLES, TABLES
from catears_tpu_torch.utils.errors import CatEarsError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"BENCH_WORDS": "300", "BENCH_BATCH": "2", "BENCH_SECONDS": "1",
       "BENCH_HIDDEN": "64", "BENCH_RUNS": "1", "BENCH_DEVICE": "cpu"}
# A narrower beam keeps the JSON-path decodes short on the CPU.
TOY_BEAM = {"BENCH_BEAM": "512", "BENCH_EXPAND": "8192"}
KNOBS = ("BENCH_MODE", "BENCH_LM", "BENCH_QUANT", "BENCH_GRAPH",
         "BENCH_STREAMS", "BENCH_REORDER", "BENCH_SELECT_COMPACT",
         "BENCH_COLD", "BENCH_HOT_ROWS", "BENCH_SKIP_LM", "BENCH_CALIBRATE",
         "BENCH_DEVICE", "BENCH_BEAM", "BENCH_EXPAND", "BENCH_LM_EXPAND")
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "wer",
                 "lm_on_xrt", "lm_on_ratio_off_over_on", "lm_on_wer"}
MODE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def toy_env(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for key, value in TOY.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


def _setups(env, seconds=1.0, **knobs):
    for key, value in knobs.items():
        env.setenv(key, value)
    jax_setup = _jax_bench().build_bench_setup(2, seconds)
    return jax_setup, tbench.build_bench_setup(2, seconds)


def _assert_am_equal(jam, tam):
    assert (tam.left_context, tam.right_context, tam.num_pdfs,
            tam.chunk_size, tam.quantized) == (
        jam.left_context, jam.right_context, jam.num_pdfs, jam.chunk_size,
        jam.quantized)
    assert tam.nnet_def == jam.nnet_def
    assert_same(jam.tid2pdf, tam.tid2pdf, "tid2pdf")
    assert_same(jam.log_prior, tam.log_prior, "log_prior")
    for i, p in enumerate(jam.float_params):
        tp = tam.float_nnet.params(i)
        assert sorted(tp) == sorted(p)
        for k, v in p.items():
            assert_same(v, tp[k], f"layer {i} {k}")
    if not jam.quantized:
        return
    for i, p in enumerate(jam.params):
        if "wq" not in p:
            continue
        tp = tam.nnet.params(i)
        assert_same(p["wq"].values, tp["wq_values"], f"layer {i} wq")
        assert_same(np.asarray(p["wq"].scale, np.float32).reshape(-1),
                    tp["wq_scale"].reshape(-1), f"layer {i} scale")
        assert_same(np.asarray(p["wq"].zero_point).reshape(-1),
                    tp["wq_zero_point"].reshape(-1), f"layer {i} zp")
        assert_same(p["colsum"], tp["colsum"], f"layer {i} colsum")
        assert_same(p["b"], tp["b"], f"layer {i} bias")


def _assert_tables_equal(jd, td, names, meta):
    for name in names:
        assert_same(getattr(jd, name), getattr(td, name), name)
    assert int(jd.start) == int(td.start)
    for name in meta:
        assert getattr(jd, name) == getattr(td, name), name


@pytest.mark.parametrize("knobs", [
    {}, {"BENCH_LM": "1"}, {"BENCH_QUANT": "1"},
    {"BENCH_GRAPH": "loop", "BENCH_PDFS": "64", "BENCH_WORDS": "40"}],
    ids=["trie", "trie-lm", "trie-int8", "loop"])
def test_setup_equals_bench_py(toy_env, knobs):
    toy_env.delenv("BENCH_PDFS", raising=False)
    (jam, jfst, jd, jl, jcfg, jwave, jplanted, jwords), \
        (tam, tfst, td, tl, tcfg, twave, tplanted, twords) = _setups(
            toy_env, **knobs)
    if knobs.get("BENCH_GRAPH") == "loop":
        assert jplanted is None and tplanted is None and twords is None
    else:
        assert_same(jplanted, tplanted, "planted")
        assert twords == jwords and sum(len(w) for w in twords) > 0
    assert_same(jwave, twave, "wave")
    assert twave.device == CPU
    _assert_am_equal(jam, tam)
    for name in ("start", "final", "offsets", "arc_next", "arc_ilabel",
                 "arc_olabel", "arc_weight"):
        assert_same(getattr(jfst, name), getattr(tfst, name), name)
    _assert_tables_equal(jd, td, TABLES, DFST_META)
    assert (jl is None) == (tl is None) == ("BENCH_LM" not in knobs)
    if jl is not None:
        _assert_tables_equal(jl, tl, LM_TABLES, DLM_META)
    for field in ("beam_size", "expand_size", "eps_expand_size",
                  "lm_expand_size", "max_eps_iters", "beam", "am_scale"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


# 1.02 s = 100 frames: bench.py's calibration decode scans 20-frame
# validity masks, so its frames (up to 300) must fill whole chunks.
VARIANT_SECONDS = 1.02
VARIANT_KNOBS = {
    "bfs": {"BENCH_REORDER": "bfs"},
    "freq": {"BENCH_REORDER": "freq"},
    "hot-500": {"BENCH_REORDER": "hot", "BENCH_HOT_ROWS": "500"},
    # The default 175,000 hot rows exceed the toy trie's states: all hot.
    "hot-default": {"BENCH_REORDER": "hot"},
    "hot-500-cold-64": {"BENCH_REORDER": "hot", "BENCH_HOT_ROWS": "500",
                        "BENCH_COLD": "64"},
    "select-compact": {"BENCH_SELECT_COMPACT": "512"},
    "cold-without-hot": {"BENCH_COLD": "64"},
    "loop-hot": {"BENCH_REORDER": "hot", "BENCH_GRAPH": "loop",
                 "BENCH_PDFS": "64", "BENCH_WORDS": "40"},
}


@pytest.mark.parametrize("case", list(VARIANT_KNOBS))
def test_variant_knob_setup_equals_bench_py(toy_env, case):
    """The decode-variant knobs, applied in bench.py's order: the same
    renumbered graph, tables and BeamConfig (the loop graph ignores
    BENCH_REORDER, as bench.py does)."""
    toy_env.delenv("BENCH_PDFS", raising=False)
    knobs = VARIANT_KNOBS[case]
    (_, jfst, jd, _, jcfg, _, jplanted, jwords), \
        (_, tfst, td, _, tcfg, _, tplanted, twords) = _setups(
            toy_env, VARIANT_SECONDS, **knobs)
    assert_same(jplanted, tplanted, "planted")
    assert twords == jwords
    for name in ("start", "final", "offsets", "arc_next", "arc_ilabel",
                 "arc_olabel", "arc_weight"):
        assert_same(getattr(jfst, name), getattr(tfst, name), name)
    _assert_tables_equal(jd, td, TABLES, DFST_META)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    hot = knobs.get("BENCH_REORDER") == "hot" and "BENCH_GRAPH" not in knobs
    assert (td.hot_rows > 0) == hot
    assert tcfg.cold_expand_size == int(knobs.get("BENCH_COLD",
                                                  1024 if hot else 0))
    assert tcfg.select_compact == int(knobs.get("BENCH_SELECT_COMPACT", 0))


def test_calibrate_counts_equals_bench_py(toy_env):
    """The calibration decode's per-state visit counts."""
    from catears_tpu.tools.biggraph import make_trie_graph, plant_logp
    from catears_tpu_torch.tools.biggraph import \
        make_trie_graph as port_trie_graph

    rng = np.random.RandomState(0)
    jg = make_trie_graph(rng, num_words=300)
    planted, _ = plant_logp(rng, jg, 2, 60)
    want = _jax_bench()._calibrate_counts(jg.fst, jg.tid2pdf, planted)
    tg = port_trie_graph(np.random.RandomState(0), num_words=300)
    got = tbench._calibrate_counts(tg.fst, tg.tid2pdf, planted, CPU)
    assert_same(want, got, "counts")
    assert (got > 0).sum() > 100


@pytest.mark.parametrize("quant", ["0", "1"], ids=["float", "int8"])
def test_am_forward_matches_bench_py(toy_env, quant):
    """The headline's AM forward (fbank, edge-replicated context, the AM
    over the batch) against bench.py's vmapped one."""
    import jax

    from catears_tpu.frontend.fbank import fbank_from_wave, num_frames

    (jam, *_, jwave, _, _), (tam, *_, twave, _, _) = _setups(
        toy_env, BENCH_QUANT=quant)
    t_frames = num_frames(jwave.shape[1])

    def one(w):
        feats = fbank_from_wave(w, t_frames)
        return jam.forward_padded(jnp.concatenate([
            jnp.repeat(feats[:1], jam.left_context, axis=0), feats,
            jnp.repeat(feats[-1:], jam.right_context, axis=0)]))

    ref = np.asarray(jax.jit(jax.vmap(one))(jwave))
    got = to_np(tbench.am_forward(tam, twave, t_frames))
    assert got.shape == ref.shape == (2, t_frames, tam.num_pdfs)
    if quant == "1":
        assert range_error(ref, got) < 0.01
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_first_argmin_picks_the_first_tie(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 4, (6, 33)).astype(np.float32)
    x[0] = np.inf
    x[1, 5:] = np.inf
    x[2, ::3] = -0.0
    x[2, 1::3] = 0.0
    got = tbench.first_argmin(torch.from_numpy(x)).numpy()
    assert got.tolist() == np.argmin(x, axis=1).tolist()
    assert got.tolist() == np.asarray(jnp.argmin(jnp.asarray(x),
                                                 axis=1)).tolist()


def _json_line(capsys):
    """The one JSON line on stdout; stderr must report every run's time,
    their median and the card."""
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1, out
    assert "run_s=[" in captured.err and "median_s=" in captured.err
    assert "card=cpu" in captured.err
    return json.loads(out[0])


def test_headline_json(toy_env, capsys):
    for key, value in TOY_BEAM.items():
        toy_env.setenv(key, value)
    assert tbench.run() == 0
    record = _json_line(capsys)
    assert set(record) == HEADLINE_KEYS
    assert record["metric"] == "audio_seconds_per_sec_per_chip"
    assert record["unit"] == "xRT" and record["value"] > 0
    assert record["wer"] <= 0.25 and record["lm_on_wer"] <= 0.25


def test_headline_json_with_variant_knobs(toy_env, capsys):
    """The headline on a hot_order graph with the hot/cold split and a
    compacted selection, LM off: the JSON keys and the planted WER."""
    for key, value in {**TOY_BEAM, "BENCH_REORDER": "hot",
                       "BENCH_HOT_ROWS": "500", "BENCH_COLD": "512",
                       "BENCH_SELECT_COMPACT": "4096",
                       "BENCH_SKIP_LM": "1"}.items():
        toy_env.setenv(key, value)
    assert tbench.run() == 0
    record = _json_line(capsys)
    assert set(record) == MODE_KEYS | {"wer"}
    assert record["metric"] == "audio_seconds_per_sec_per_chip"
    assert record["wer"] <= 0.25


@pytest.mark.parametrize("mode,knobs,metric,keys", [
    ("product", {}, "product_batch_audio_seconds_per_sec",
     MODE_KEYS | {"wer"}),
    ("am", {}, "am_forward_audio_seconds_per_sec_float", MODE_KEYS),
    ("am", {"BENCH_QUANT": "1"}, "am_forward_audio_seconds_per_sec_int8",
     MODE_KEYS),
    ("am", {"BENCH_QUANT": "1", "BENCH_CALIBRATE": "0"},
     "am_forward_audio_seconds_per_sec_int8", MODE_KEYS),
    ("streaming", {}, "streaming_audio_seconds_per_sec", MODE_KEYS),
    ("streaming", {"BENCH_STREAMS": "2"},
     "batched_streaming_audio_seconds_per_sec", MODE_KEYS),
    ("scaling", {"BENCH_BATCH": "8", "BENCH_SECONDS": "0.5",
                 "BENCH_BEAM": "128", "BENCH_EXPAND": "1024",
                 "BENCH_EPS_EXPAND": "256"},
     "dp_sharding_efficiency_8dev", MODE_KEYS),
], ids=["product", "am-float", "am-int8", "am-int8-dynamic", "streaming",
        "streaming-2", "scaling"])
def test_mode_json(toy_env, capsys, mode, knobs, metric, keys):
    toy_env.setenv("BENCH_MODE", mode)
    for key, value in {**TOY_BEAM, **knobs}.items():
        toy_env.setenv(key, value)
    assert tbench.run() == 0
    record = _json_line(capsys)
    assert set(record) == keys
    assert record["metric"] == metric and record["value"] > 0
    assert record.get("wer", 0.0) <= 0.25
    if mode == "scaling":
        assert record["unit"] == "ratio"
        assert "BENCH_GRAPH" not in os.environ  # its defaults end with it


@pytest.mark.parametrize("knob,value", [
    ("BENCH_REORDER", "random"), ("BENCH_MODE", "scaling"),
    ("BENCH_DEVICE", "tpu")])
def test_refused_knobs_raise(toy_env, capsys, knob, value):
    """A knob value without a counterpart raises (bench.py knows no
    BENCH_REORDER=random); so does `scaling` on the toy batch of 2, which
    8 devices cannot split."""
    toy_env.setenv(knob, value)
    with pytest.raises(CatEarsError) as err:
        tbench.run()
    assert "\n" not in str(err.value)
    assert not capsys.readouterr().out


def test_select_compact_zero_is_accepted(toy_env):
    toy_env.setenv("BENCH_SELECT_COMPACT", "0")
    tbench.check_knobs()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("mode", ["", "product", "streaming", "am",
                                  "scaling"])
def test_without_a_card_raises(toy_env, mode):
    toy_env.delenv("BENCH_DEVICE")
    toy_env.setenv("BENCH_MODE", mode)
    with pytest.raises(CatEarsError, match="no CUDA device"):
        tbench.run()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_a_card_is_one_line():
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    proc = subprocess.run([sys.executable, "-m", "catears_tpu_torch.bench"],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120, env=dict(env, PYTHONPATH=REPO))
    assert proc.returncode == 1 and not proc.stdout
    assert proc.stderr.startswith("catears: no CUDA device")
    assert len(proc.stderr.strip().splitlines()) == 1


# -- slow: the headline against bench.py's run at a reduced trie scale -----

REDUCED = {"BENCH_WORDS": "3000", "BENCH_BATCH": "3", "BENCH_SECONDS": "2",
           "BENCH_HIDDEN": "64", "BENCH_RUNS": "1"}
SUMMARY = re.compile(r"# \[(lm-off|lm-on)\] .*hyp0_words=(\d+), .*"
                     r"capacity_hiwater=\((.*)\), WER=")


def _summaries(stderr):
    """{tag: (hyp0_words, hiwater)} of a bench's `# [lm-...]` lines."""
    out = {}
    for m in SUMMARY.finditer(stderr):
        marks = tuple(int(x) for x in re.findall(r"(\d+)\)?(?:,|$)",
                                                 m.group(3)))
        out[m.group(1)] = (int(m.group(2)), marks)
    return out


JAX_DRIVER = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import catears_tpu.decode.hyp as hyp
seen = []
_assemble = hyp.assemble_words
def assemble(words):
    got = _assemble(words)
    seen.append([int(w) for w in got])
    return got
hyp.assemble_words = assemble
sys.path.insert(0, {repo!r})
import bench
bench.main()
print(json.dumps(seen))
"""


@pytest.mark.slow
def test_headline_words_equal_bench_py(tmp_path, monkeypatch, capsys):
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(REDUCED, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_CACHE_DIR=str(tmp_path / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c",
                           JAX_DRIVER.format(repo=REPO)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=1800, env=env)
    assert proc.returncode == 0, proc.stderr
    jax_record, jax_words = (json.loads(x) for x in
                             proc.stdout.strip().splitlines()[-2:])

    import catears_tpu_torch.decode.hyp as thyp

    seen = []
    assemble = thyp.assemble_words
    monkeypatch.setattr(thyp, "assemble_words",
                        lambda w: seen.append(assemble(w)) or seen[-1])
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for key, value in {**REDUCED, "BENCH_DEVICE": "cpu"}.items():
        monkeypatch.setenv(key, value)
    assert tbench.run() == 0
    captured = capsys.readouterr()
    record = json.loads(captured.out.strip().splitlines()[-1])
    assert seen == jax_words and len(seen) == 2 * int(REDUCED["BENCH_BATCH"])
    assert sum(len(w) for w in seen) > 0
    for key in ("wer", "lm_on_wer"):
        assert record[key] == jax_record[key], key
    assert _summaries(captured.err) == _summaries(proc.stderr)
    assert set(_summaries(captured.err)) == {"lm-off", "lm-on"}
