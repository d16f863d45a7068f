"""BENCHMARK.json against the contract's shape, the files it names found
by name, and a cell, configuration and metric added by files alone."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


# BENCHMARK.json, and the same with the cells measured but not yet held
MANIFESTS = ["BENCHMARK.json", "asrbench/later_cells.json"]


def bench(name="BENCHMARK.json"):
    return json.load(open(os.path.join(REPO, name)))


@pytest.mark.parametrize("name", MANIFESTS)
def test_manifest_keys_names_and_units(name):
    b = bench(name)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["asrbench"]
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("asrbench/")
        assert c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {x["name"] for x in b["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    every = names + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(every) == len(set(every)) and all(NAME.match(n) for n in every)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", MANIFESTS)
def test_every_named_file_is_found(name):
    from asrbench import manifest

    b = bench(name)
    base = manifest.data_dir(REPO)
    for w in b["workloads"]:
        cfg = manifest.config(REPO, b, w["config"])
        assert cfg["name"] == w["config"]
        traffic = manifest.traffic(base, w["traffic"])
        assert hasattr(manifest.load_kind(base, traffic["kind"]), "run")
        assert manifest.limits(base, w["name"])
        moves = {m["name"] for m in manifest.end_to_end_for(b, w["name"])}
        assert "setup_s" in moves and len(moves) >= 2
        per = manifest.per_layer_for(b, w["name"], moves)
        assert per
        for m in per:
            assert hasattr(manifest.load_metric(base, m["name"]), "read")


def run_cell(root, cell, trace, seed=5, seconds=0.5):
    out = subprocess.run(
        [sys.executable, "-m", "asrbench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--root", root, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_added_files_alone_make_a_cell(tiny_root):
    """A configuration, a traffic mix, a cell and a per-layer metric, each
    a new file (and the manifest's entries), run with the harness as it
    is."""
    base = os.path.join(tiny_root, "asrbench")
    cfg = json.load(open(os.path.join(base, "configs",
                                      "trie50k-tdnn1024x5.json")))
    cfg["name"] = "tiny-trie"
    cfg["graph"]["num_words"] = 200
    json.dump(cfg, open(os.path.join(base, "configs", "tiny-trie.json"), "w"))
    traffic = json.load(open(os.path.join(base, "traffic",
                                          "bulk16-librispeech.json")))
    traffic["batch"] = 3
    json.dump(traffic, open(os.path.join(base, "traffic", "tiny-mix.json"),
                            "w"))
    json.dump({"logp_err": 1e-3, "cost_gap": 1e-2},
              open(os.path.join(base, "limits", "tiny-cell.json"), "w"))
    with open(os.path.join(base, "metrics", "audio_per_window.tiny.py"),
              "w") as fd:
        fd.write("def read(rec):\n"
                 "    return rec['audio_s'] / rec['window_s']\n")
    b = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    b["configs"].append({"name": "tiny-trie", "source": "a test",
                         "file": "asrbench/configs/tiny-trie.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-cell", "config": "tiny-trie",
                           "traffic": "tiny-mix", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "bulk_xrt":
            m["workloads"].append("tiny-cell")
    b["per_layer"].append({"name": "audio_per_window.tiny", "unit": "xRT",
                           "better": "higher", "source": "program_span",
                           "layer": "runtime, bulk", "moves": "bulk_xrt",
                           "workloads": ["tiny-cell"]})
    json.dump(b, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    line, err = run_cell(tiny_root, "tiny-cell", 1)
    assert "audio_per_window.tiny" in line["metrics"]
    assert line["correct"] is True
    assert err.strip().splitlines()[-1].startswith("compared cost_gap")


def test_last_line_holds_the_contract_keys(tiny_root):
    line, _ = run_cell(tiny_root, "bulk-lmoff", 0)
    assert set(line) == RESULT_KEYS | {"compared"}
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"bulk_xrt", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Without CUDA the run exits non-zero and prints no line; so it does
    in a checkout that holds only the benchmark."""
    import shutil

    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "asrbench"),
                    os.path.join(root, "asrbench"))
    for args in ([], ["--device", "cpu"]):
        out = subprocess.run(
            [sys.executable, "-m", "asrbench.run", "--workload",
             "bulk-lmoff", "--seed", "1", "--seconds", "1", "--trace", "0"]
            + args, cwd=root, capture_output=True, text=True, timeout=600,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and not out.stdout.strip()
