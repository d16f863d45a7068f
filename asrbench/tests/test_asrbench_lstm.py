"""The TDNN-LSTM cell's pieces on the CPU: the benchmark's reference copy
against tests/tdnn_lstm_reference.py, the planned FLOP count and the
recurrence's least time against hand counts of the recipe's equations,
the weights' draw, the cell end to end at a tiny size, and its quick
refusal by a program without LSTMP layers."""

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

from asrbench import chain_ref, lstm_counts, lstm_gen, lstm_ref

CONFIG = os.path.join(REPO, "asrbench", "configs",
                      "swbd-tdnnlstm-chain-lex200k.json")
PEAKS = json.load(open(os.path.join(REPO, "asrbench", "peaks.json")))


def config():
    return json.load(open(CONFIG))


def small_am(**kw):
    return dict(config()["am"], tdnn_dim=32, cell_dim=16,
                recurrent_projection_dim=8, non_recurrent_projection_dim=8,
                ivector_dim=6, **kw)


def test_flop_count_against_a_hand_count():
    """run_tdnn_lstm.sh at 7,000 pdfs, two FLOPs a multiply-add: lda
    300 x 300, tdnn1 300 x 1,024 and tdnn2 3,072 x 1,024 at every 10 ms
    frame, three a row; tdnn3 3,072 x 1,024, three LSTMPs (W_all 1,280 x
    4,096, projection 1,024 x 512), tdnn4-7 (1,536 or 3,072) x 1,024 and
    the output 512 x 7,000 once a row: about 88 MFLOP."""
    am = config()["am"]
    full, sub = lstm_counts.stack_flops(am, 7000)
    assert full == 2 * (300 * 300 + 300 * 1024 + 3072 * 1024)
    lstm = 1280 * 4096 + 1024 * 512
    assert sub == 2 * (3072 * 1024 + 3 * lstm + 2 * 1536 * 1024
                       + 2 * 3072 * 1024 + 512 * 7000)
    assert lstm_counts.stack_flops_per_frame(am, 7000) == 3 * full + sub \
        == 88_194_400
    assert lstm_counts.context_after(am) == [8, 4, 0]


def test_recurrence_least_time_against_a_hand_count():
    """One batch of utterances of 10 and 4 output rows: lstm1 steps 18 +
    12, lstm2 14 + 8, lstm3 10 + 4; each the larger of its FLOPs at 67
    TFLOP/s and its bytes at 3.35 TB/s."""
    am = config()["am"]
    assert lstm_counts.recurrence_steps(am, [10, 4]) == [[18, 12], [14, 8],
                                                         [10, 4]]
    per_flops = 2 * 256 * 4096 + 2 * 1024 * 512 + lstm_counts.CELL_FLOPS \
        * 1024
    once = 4 * (256 * 4096 + 1024 * 512 + 512 + 3 * 1024)
    per_bytes = 4 * (4096 + 512 + 1024)
    want = sum(max(n * per_flops / 67e12, (once + n * per_bytes) / 3.35e12)
               for n in (30, 22, 14))
    assert lstm_counts.recurrence_least_s(am, [[10, 4]], PEAKS) == \
        pytest.approx(want, rel=1e-12)


def test_the_draw_has_the_reference_layout():
    am = small_am()
    g = torch.Generator().manual_seed(3)
    stats = (np.full(40, 100.0), np.full(40, 3.0))
    model = lstm_gen.tdnnlstm_device(g, "cpu", am, 20, stats)
    kinds = [x["kind"] for x in model["layers"]]
    assert kinds == [x["kind"] for x in am["layers"]]
    lstm = model["layers"][3]
    assert lstm["w_all"].shape == (32 + 8, 64) and lstm["scale"] == 0.85
    assert lstm["peephole"].shape == (3, 16) and lstm["w_rp"].shape == (16, 16)
    assert lstm_ref.context(model) == tuple(am["context"]) == (21, 11)


def test_the_reference_copy_matches_the_tests_reference():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        spec = importlib.util.spec_from_file_location(
            "tdnn_lstm_reference",
            os.path.join(REPO, "tests", "tdnn_lstm_reference.py"))
        tests_ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tests_ref)
    finally:
        sys.path.remove(os.path.join(REPO, "tests"))
    g = torch.Generator().manual_seed(3)
    stats = (np.full(40, 100.0), np.full(40, 3.0))
    model = lstm_gen.tdnnlstm_device(g, "cpu", small_am(), 20, stats)
    rng = np.random.RandomState(1)
    waves = [(rng.randn(n) * 1000).astype(np.float32) for n in (5000, 2000)]
    ivs = rng.randn(2, 6).astype(np.float32)
    for precision in ("float64", "bfloat16"):
        a = lstm_ref.logp(model, waves, ivs, "cpu", precision)
        b = tests_ref.logp(model, waves, ivs, "cpu", precision)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.shape[0] for x in a] == [-(-chain_ref.num_frames(n) // 3)
                                       for n in (5000, 2000)]


def tiny_lstm(root: str) -> None:
    """A checkout at `root` holding BENCHMARK.json and asrbench/ with the
    TDNN-LSTM cell cut to a CPU's size (the layers' plan kept)."""
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "asrbench"),
                    os.path.join(root, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "asrbench", "configs",
                        "swbd-tdnnlstm-chain-lex200k.json")
    c = json.load(open(path))
    c["graph"].update(num_words=300, num_phones=25, bigram_states=30,
                      variants=2)
    c["am"].update(tdnn_dim=32, cell_dim=16, recurrent_projection_dim=8,
                   non_recurrent_projection_dim=8, ivector_dim=10)
    c["decoder"].update(beam_size=128, expand_size=4096)
    json.dump(c, open(path, "w"))
    path = os.path.join(root, "asrbench", "traffic",
                        "bulk16-librispeech-chain-lstm.json")
    t = json.load(open(path))
    t.update(batch=2, pool_batches=2)
    t["length_s"].update(mean=1.5, min=0.5, max=3.0)
    json.dump(t, open(path, "w"))


def run_cell(root, trace, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "asrbench.run", "--workload",
         "bulk-chain-lstm", "--seed", "3000000011", "--seconds", "0.5",
         "--trace", str(trace), "--root", root, "--device", "cpu"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_the_cell_runs_end_to_end(tmp_path):
    """Correct, with the end-to-end metrics untraced and the `.lstm`
    metrics that a CPU run can read traced (no padded recurrence step,
    the whole step's share)."""
    root = str(tmp_path / "checkout")
    tiny_lstm(root)
    out = run_cell(root, 0)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert set(line["metrics"]) == {"bulk_xrt", "setup_s"}
    out = run_cell(root, 1)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["lstm_step_ratio.lstm"]["value"] == 1.0
    assert "step_mfu.lstm" in line["metrics"]
    assert "lstm_steps_needed" in out.stderr


def test_a_program_without_lstmp_fails_at_once(monkeypatch):
    from catears_tpu_torch.io import binfmt

    from asrbench import lstm_system

    monkeypatch.delattr(binfmt, "LAYER_LSTMP")
    with pytest.raises(SystemExit):
        lstm_system.require_program()
