"""Fixtures of the benchmark's own tests (run on the CPU with
`python -m pytest asrbench/tests`; those marked `cuda` need a card)."""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shrink(root: str) -> None:
    """Cut the checkout's cells at `root` to a size the CPU decodes in
    seconds (the graph, AM, beam and traffic; the shapes stay)."""
    base = os.path.join(root, "asrbench")
    for name in os.listdir(os.path.join(base, "configs")):
        path = os.path.join(base, "configs", name)
        c = json.load(open(path))
        c["graph"].update(num_words=300, num_phones=25, bigram_states=30,
                          variants=2)
        c["num_pdfs"] = 150
        c["am"].update(hidden=32, layers=2)
        c["decoder"].update(beam_size=128, expand_size=4096,
                            eps_expand_size=512)
        if c.get("lm"):
            c["lm"]["num_words"] = 300
            c["decoder"]["lm_expand_size"] = 0
        json.dump(c, open(path, "w"))
    for name in os.listdir(os.path.join(base, "traffic")):
        path = os.path.join(base, "traffic", name)
        t = json.load(open(path))
        if t["kind"] == "bulk":
            t.update(batch=2, pool_batches=2, sample=3)
            t["length_s"].update(mean=1.5, min=0.5, max=3.0)
        else:
            t.update(streams=3, sample_streams=2)
        json.dump(t, open(path, "w"))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the checkout's benchmark (asrbench/) with every cell
    shrunk, and as its BENCHMARK.json `asrbench/later_cells.json`: the
    held cell and those measured but not yet held, so that the tests
    drive every kind, configuration and limit the benchmark keeps."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "asrbench", "later_cells.json"),
                os.path.join(root, "BENCHMARK.json"))
    shutil.copytree(os.path.join(REPO, "asrbench"),
                    os.path.join(root, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(root)
    return root


@pytest.fixture
def card():
    """The CUDA card, or a skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
