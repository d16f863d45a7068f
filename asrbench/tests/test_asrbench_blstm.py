"""The BLSTM cell's pieces on the CPU: the benchmark's reference copy
against tests/blstm_reference.py, the planned FLOP count and the
recurrence's least time against hand counts of Kaldi's chunk windows, the
weights' draw, `blstm_system`'s NN02 spec through the program against
`blstm_ref`, the cell end to end at a tiny size, and its quick refusal by
a program without bidirectional LSTMP layers."""

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

from asrbench import blstm_counts, blstm_gen, blstm_ref, chain_ref

CONFIG = os.path.join(REPO, "asrbench", "configs",
                      "swbd-blstm-chain-lex200k.json")
PEAKS = json.load(open(os.path.join(REPO, "asrbench", "peaks.json")))
SMALL_CHUNK = {"frames_per_chunk": 30, "extra_left_context": 12,
               "extra_right_context": 12, "extra_left_context_initial": 0,
               "extra_right_context_final": 0}


def config():
    return json.load(open(CONFIG))


def small_am(**kw):
    return dict(config()["am"], cell_dim=16, recurrent_projection_dim=8,
                non_recurrent_projection_dim=8, ivector_dim=6, **kw)


def small_model(seed=3):
    g = torch.Generator().manual_seed(seed)
    stats = (np.full(40, 100.0), np.full(40, 3.0))
    return blstm_gen.blstm_device(g, "cpu", small_am(), 20, stats)


def test_windows_and_flops_against_a_hand_count():
    """run_blstm_6j.sh at 7,000 pdfs and the recipe's decode (150-frame
    chunks, 50 frames of extra context, none at the edges): an utterance
    of 120 output rows is 3 chunks of 50, 50 and 20 kept rows with 0 + 16,
    16 + 16 and 16 + 0 rows of context, 66 + 82 + 36 = 184 window rows.
    lda 300 x 300 and both directions of blstm1-2 (W_all (in + 256) x
    4,096, projection 1,024 x 512; in 300, then 1,024) at every window
    row; blstm3's forward at 50 + 66 + 36 rows, its backward at 66 + 66 +
    20; the output 1,024 x 7,000 at the 120 kept rows; two FLOPs a
    multiply-add."""
    c = config()
    am, chunk = c["am"], c["chunk"]
    assert blstm_counts.chunk_rows(120, chunk, 3) == [(0, 50, 16),
                                                      (16, 50, 16),
                                                      (16, 20, 0)]
    assert blstm_counts.direction_rows(am, chunk, [120]) == [
        (184, 184), (184, 184), (152, 152)]
    proj = 1024 * 512
    l1 = 556 * 4096 + proj
    l23 = 1280 * 4096 + proj
    want = 2.0 * (184 * 300 * 300 + 2 * 184 * l1 + 2 * 184 * l23
                  + 2 * 152 * l23 + 120 * 1024 * 7000)
    assert blstm_counts.stack_flops(am, chunk, 7000, [120]) == want
    # The published widths' parameters: about 36 M.
    params = sum(i * o + o for _, _, mats in blstm_gen.layer_shapes(am, 7000)
                 for i, o in mats) + 3 * 2 * 3 * 1024
    assert 35e6 < params < 37e6


def test_recurrence_least_time_against_a_hand_count():
    """One batch of utterances of 120 and 30 output rows: 184 + 30 window
    rows for each direction of blstm1-2, 152 + 30 for blstm3's; each
    launch the larger of its FLOPs at 67 TFLOP/s and its bytes at 3.35
    TB/s."""
    c = config()
    am, chunk = c["am"], c["chunk"]
    per_flops = 2 * 256 * 4096 + 2 * 1024 * 512 + 20 * 1024
    once = 4 * (256 * 4096 + 1024 * 512 + 512 + 3 * 1024)
    per_bytes = 4 * (4096 + 512 + 1024)
    want = sum(max(n * per_flops / 67e12, (once + n * per_bytes) / 3.35e12)
               for n in (214, 214, 214, 214, 182, 182))
    assert blstm_counts.recurrence_least_s(am, chunk, [[120, 30]], PEAKS) \
        == pytest.approx(want, rel=1e-12)


def test_the_draw_has_the_reference_layout():
    model = small_model()
    assert [x["kind"] for x in model["layers"]] == ["blstmp"] * 3
    layer = model["layers"][1]
    for side in ("forward", "backward"):
        p = layer[side]
        assert p["w_all"].shape == (32 + 8, 64) and p["scale"] == 0.85
        assert p["peephole"].shape == (3, 16) and p["w_rp"].shape == (16, 16)
    assert not torch.equal(layer["forward"]["w_all"],
                           layer["backward"]["w_all"])
    assert model["layers"][0]["forward"]["w_all"].shape[0] == 5 * 40 + 6 + 8
    assert blstm_ref.context(model) == tuple(config()["am"]["context"])


def _tests_reference():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        spec = importlib.util.spec_from_file_location(
            "blstm_reference", os.path.join(REPO, "tests",
                                            "blstm_reference.py"))
        tests_ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tests_ref)
    finally:
        sys.path.remove(os.path.join(REPO, "tests"))
    return tests_ref


def _inputs():
    rng = np.random.RandomState(1)
    waves = [(rng.randn(n) * 1000).astype(np.float32)
             for n in (9000, 2000)]
    return waves, rng.randn(2, 6).astype(np.float32)


def test_the_reference_copy_matches_the_tests_reference():
    tests_ref = _tests_reference()
    model = small_model()
    waves, ivs = _inputs()
    for precision in ("float64", "bfloat16"):
        a = blstm_ref.logp(model, waves, ivs, "cpu", SMALL_CHUNK, precision)
        b = tests_ref.logp(model, waves, ivs, "cpu", SMALL_CHUNK, precision)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.shape[0] for x in a] == [-(-chain_ref.num_frames(n) // 3)
                                       for n in (9000, 2000)]


def test_the_program_matches_the_reference_copy():
    """`blstm_system`'s NN02 spec and chunk settings through the program's
    AcousticModel and batched_logp agree with `blstm_ref` within the CPU
    tests' tolerance (tests/test_torch_blstm.py: 1e-5 of the scale)."""
    from asrbench import blstm_system, chain_system

    model = small_model()
    am = blstm_system.acoustic_model(model, small_am(), SMALL_CHUNK, 20,
                                     np.zeros(41, np.int32), "cpu")
    waves, ivs = _inputs()
    got, lengths = chain_system.batched_logp(am, waves, ivs)
    want = blstm_ref.logp(model, waves, ivs, "cpu", SMALL_CHUNK)
    assert lengths == [x.shape[0] for x in want] == [18, 4]
    for u, n in enumerate(lengths):
        err = float((got[u, :n].double() - want[u]).abs().max())
        assert err <= 1e-5 * float(want[u].abs().max())


def tiny_blstm(root: str) -> None:
    """A checkout at `root` holding BENCHMARK.json and asrbench/ with the
    BLSTM cell cut to a CPU's size (three layers kept, small chunks)."""
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "asrbench"),
                    os.path.join(root, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "asrbench", "configs",
                        "swbd-blstm-chain-lex200k.json")
    c = json.load(open(path))
    c["graph"].update(num_words=300, num_phones=25, bigram_states=30,
                      variants=2)
    c["am"].update(cell_dim=16, recurrent_projection_dim=8,
                   non_recurrent_projection_dim=8, ivector_dim=10)
    c["chunk"].update(SMALL_CHUNK)
    c["decoder"].update(beam_size=128, expand_size=4096)
    json.dump(c, open(path, "w"))
    path = os.path.join(root, "asrbench", "traffic",
                        "bulk16-librispeech-chain-blstm.json")
    t = json.load(open(path))
    t.update(batch=2, pool_batches=2)
    t["length_s"].update(mean=1.5, min=0.5, max=3.0)
    json.dump(t, open(path, "w"))


def run_cell(root, trace, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "asrbench.run", "--workload",
         "bulk-chain-blstm", "--seed", "3000000011", "--seconds", "0.5",
         "--trace", str(trace), "--root", root, "--device", "cpu"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_the_cell_runs_end_to_end(tmp_path):
    """Correct, with the end-to-end metrics untraced and the `.blstm`
    metrics that a CPU run can read traced (the chunk windows' padding,
    the whole step's share)."""
    root = str(tmp_path / "checkout")
    tiny_blstm(root)
    out = run_cell(root, 0)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert set(line["metrics"]) == {"bulk_xrt", "setup_s"}
    out = run_cell(root, 1)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["am_chunk_row_ratio.blstm"]["value"] >= 1.0
    assert "step_mfu.blstm" in line["metrics"]
    assert "lstm_launches_per_batch.blstm" not in line["metrics"]
    assert "am_chunk_rows_needed" in out.stderr


def test_a_program_without_blstmp_fails_at_once(monkeypatch):
    from catears_tpu_torch.io import binfmt

    from asrbench import blstm_system

    monkeypatch.delattr(binfmt, "LAYER_BLSTMP")
    with pytest.raises(SystemExit):
        blstm_system.require_program()
