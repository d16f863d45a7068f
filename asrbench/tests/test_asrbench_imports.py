"""What the benchmark loads: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "catears_tpu"}


def loaded_after(code: str, cwd=REPO):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m "
                          "in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["bulk-lmoff", "live-streams"])
def test_a_run_loads_no_jax(tiny_root, cell):
    top = loaded_after(
        "from asrbench import run\n"
        f"run.main(['--workload', {cell!r}, '--seed', '3', "
        f"'--seconds', '1', '--trace', '0', '--root', {tiny_root!r}, "
        "'--device', 'cpu'])")
    assert "catears_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import asrbench.ref, asrbench.judge, asrbench.gen, "
                       "asrbench.counts, asrbench.trace, asrbench.readers")
    assert not top & (FORBIDDEN | {"catears_tpu_torch"})
    for name in ("ref.py", "judge.py", "gen.py", "counts.py"):
        src = open(os.path.join(REPO, "asrbench", name)).read()
        assert "catears_tpu" not in src.replace("catears_tpu_torch.tools",
                                                "")


def test_forbidden_names_are_whole():
    from asrbench import run

    sys.modules["catears_tpu_torch_probe"] = sys
    assert "catears_tpu_torch_probe" not in run.forbidden_modules()
    sys.modules["catears_tpu.probe"] = sys
    try:
        assert "catears_tpu.probe" in run.forbidden_modules()
    finally:
        del sys.modules["catears_tpu.probe"]
        del sys.modules["catears_tpu_torch_probe"]
