"""The chain cell's pieces on the CPU: the chain-topology graph generator
(one state a phone, its two pdf classes, 7,000 pdfs at the
configuration's phones and variants), the planted targets, the planned
FLOP count against a hand count of the TDNN-F's equations, the
benchmark's reference copy against tests/tdnnf_reference.py, the cell
end to end at a tiny size, and its quick refusal by a program without
TDNN-F layers."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO

from asrbench import chain_counts, chain_gen, chain_ref

CONFIG = os.path.join(REPO, "asrbench", "configs",
                      "ls-tdnnf1d-chain-lex200k.json")


def config():
    return json.load(open(CONFIG))


@pytest.fixture(scope="module")
def graph():
    g = config()["graph"]
    return chain_gen.make_chain_graph(
        np.random.RandomState(0), num_words=3000,
        num_phones=g["num_phones"], variants=g["variants"],
        bigram_states=200)


def test_chain_graph_topology(graph):
    """7,000 pdfs; each trie state has one self-loop, on its phone's
    class-1 pdf, and is entered only by arcs on its class-0 pdf."""
    assert graph.num_pdfs == config()["num_pdfs"] == 7000
    pdf = np.where(graph.ilabel > 0, graph.tid2pdf[graph.ilabel], -1)
    emit = pdf >= 0
    lm_base = int(graph.final.size - 200)
    trie = (graph.dst > 0) & (graph.dst < lm_base) & emit
    loops = trie & (graph.src == graph.dst)
    enters = trie & (graph.src != graph.dst)
    n_trie = lm_base - 1
    assert np.array_equal(np.bincount(graph.dst[loops],
                                      minlength=lm_base)[1:],
                          np.ones(n_trie))
    variants = config()["graph"]["variants"]
    cls = (pdf // variants) % 2
    assert (cls[loops] == 1).all() and (cls[enters] == 0).all()
    # A state's class-0 and class-1 pdfs are one phone in one variant.
    loop_pdf = np.zeros(lm_base, np.int64)
    loop_pdf[graph.dst[loops]] = pdf[loops]
    assert (pdf[enters] == loop_pdf[graph.dst[enters]] - variants).all()
    # Every emitting arc ends in a trie state; words leave by epsilons.
    assert (graph.dst[emit] < lm_base).all()
    assert (graph.ilabel[graph.olabel > 0] == 0).all()


def test_planted_targets_follow_the_chain_topology(graph):
    rng = np.random.RandomState(5)
    targets, words = chain_gen.plant_chain_targets(rng, graph, 400)
    assert targets.size == 400 and words
    variants = config()["graph"]["variants"]
    t = 0
    for w in words:
        pairs = graph.word_pdf_flat[graph.word_pdf_off[w]:
                                    graph.word_pdf_off[w + 1]].reshape(-1, 2)
        for a, b in pairs:
            assert (a // variants) % 2 == 0 and b == a + variants
            assert targets[t] == a
            n = 1
            while t + n < targets.size and targets[t + n] == b:
                n += 1
            assert 2 <= n <= 4 or t + n == targets.size
            t += n


def test_flop_count_against_a_hand_count():
    """run_tdnn_1d.sh at 7,000 pdfs, two FLOPs a multiply-add: lda
    220 x 220 and tdnn1 220 x 1,536 and three stride-1 blocks
    ((2 x 1,536) x 160 + (2 x 160) x 1,536) at every 10 ms frame, three a
    row; the stride-0 block (1,536 x 160 + 160 x 1,536), twelve stride-3
    blocks, prefinal-l 1,536 x 256, prefinal-chain 256 x 1,536 and
    1,536 x 256, output 256 x 7,000 once a row."""
    am = config()["am"]
    full, sub = chain_counts.stack_flops(am, 7000)
    block = 2 * (3072 * 160 + 320 * 1536)
    assert full == 2 * 220 * 220 + 2 * 220 * 1536 + 3 * block
    assert sub == (2 * (1536 * 160 + 160 * 1536) + 12 * block
                   + 2 * 1536 * 256 * 3 + 2 * 256 * 7000)
    per = chain_counts.stack_flops_per_frame(am, 7000)
    assert per == 3 * full + sub == 50_531_936
    # Every layer at every 10 ms frame: 2.2 times the plan.
    assert 2.2 < 3 * (full + sub) / per < 2.25


def test_the_reference_copy_matches_the_tests_reference():
    spec = importlib.util.spec_from_file_location(
        "tdnnf_reference", os.path.join(REPO, "tests", "tdnnf_reference.py"))
    tests_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_ref)
    am = dict(config()["am"], tdnn1_dim=32, tdnnf_dim=32, bottleneck_dim=8,
              prefinal_big_dim=32, prefinal_small_dim=8, ivector_dim=6,
              time_strides=[1, 0, 3])
    g = torch.Generator().manual_seed(3)
    stats = (np.full(40, 100.0), np.full(40, 3.0))
    model = chain_gen.tdnnf_device(g, "cpu", am, 20, stats)
    rng = np.random.RandomState(1)
    waves = [(rng.randn(n) * 1000).astype(np.float32) for n in (5000, 2000)]
    ivs = rng.randn(2, 6).astype(np.float32)
    for precision in ("float64", "bfloat16"):
        a = chain_ref.logp(model, waves, ivs, "cpu", precision)
        b = tests_ref.logp(model, waves, ivs, "cpu", precision)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.shape[0] for x in a] == [-(-chain_ref.num_frames(n) // 3)
                                       for n in (5000, 2000)]


def tiny_chain(root: str) -> None:
    """A checkout at `root` holding BENCHMARK.json and asrbench/ with the
    chain cell cut to a CPU's size (the plan's shape kept: a stride-1,
    a stride-0 and two stride-3 blocks)."""
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "asrbench"),
                    os.path.join(root, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "asrbench", "configs",
                        "ls-tdnnf1d-chain-lex200k.json")
    c = json.load(open(path))
    c["graph"].update(num_words=300, num_phones=25, bigram_states=30,
                      variants=2)
    c["am"].update(tdnn1_dim=64, tdnnf_dim=64, bottleneck_dim=16,
                   prefinal_big_dim=64, prefinal_small_dim=16,
                   time_strides=[1, 0, 3, 3], context=[8, 8], ivector_dim=10)
    c["decoder"].update(beam_size=128, expand_size=4096)
    json.dump(c, open(path, "w"))
    path = os.path.join(root, "asrbench", "traffic",
                        "bulk16-librispeech-chain.json")
    t = json.load(open(path))
    t.update(batch=2, pool_batches=2)
    t["length_s"].update(mean=1.5, min=0.5, max=3.0)
    json.dump(t, open(path, "w"))


def run_cell(root, trace, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "asrbench.run", "--workload", "bulk-chain",
         "--seed", "3000000011", "--seconds", "0.5", "--trace", str(trace),
         "--root", root, "--device", "cpu"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_the_cell_runs_end_to_end(tmp_path):
    """Correct, with the end-to-end metrics untraced and the `.chain`
    metrics that a CPU run can read traced (the plan's FLOP ratio near 1,
    the whole step's share)."""
    root = str(tmp_path / "checkout")
    tiny_chain(root)
    out = run_cell(root, 0)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"bulk_xrt", "setup_s"}
    out = run_cell(root, 1)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    ratio = line["metrics"]["am_flop_ratio.chain"]["value"]
    assert 1.0 <= ratio <= 1.05
    assert "step_mfu.chain" in line["metrics"]
    assert "overflow_retries" in out.stderr


def test_a_program_without_tdnnf_fails_at_once(tmp_path, monkeypatch):
    from catears_tpu_torch.io import binfmt

    from asrbench import chain_system

    monkeypatch.delattr(binfmt, "LAYER_TDNNF")
    with pytest.raises(SystemExit):
        chain_system.require_program()
