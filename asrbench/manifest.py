"""`BENCHMARK.json` and the files it names, found by name: nothing of the
harness lists cells, configurations, traffic kinds or metrics in code.

- `asrbench/configs/<config>.json`   a configuration (the manifest's
                                     `file` for it)
- `asrbench/traffic/<traffic>.json`  a traffic mix: its `kind` and the
                                     kind's parameters
- `asrbench/kinds/<kind>.py`         the generator of a kind: `run(ctx)`
- `asrbench/limits/<cell>.json`      the limits `correct` holds a cell to
- `asrbench/metrics/<metric>.py`     a per-layer metric's reader:
                                     `read(records)`, None where the
                                     traced run holds nothing to read

`asrbench/later_cells.json` is BENCHMARK.json as it reads with the cells
that were measured but are not held yet (PERF.md, Open questions): a
later benchmark change copies their entries; the tests run them all.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List, Set


def _json(path: str) -> dict:
    with open(path) as fd:
        return json.load(fd)


def load(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"asrbench: no workload {name!r} in BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise SystemExit(f"asrbench: no config {name!r} in BENCHMARK.json")


def data_dir(root: str) -> str:
    """The benchmark's folder in the checkout at `root`."""
    return os.path.join(root, "asrbench")


def traffic(base: str, name: str) -> dict:
    return _json(os.path.join(base, "traffic", f"{name}.json"))


def limits(base: str, cell: str) -> Dict[str, float]:
    return _json(os.path.join(base, "limits", f"{cell}.json"))


def peaks(base: str) -> dict:
    return _json(os.path.join(base, "peaks.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_kind(base: str, kind: str):
    return _module(os.path.join(base, "kinds", f"{kind}.py"),
                   f"asrbench.kinds.{kind}")


def load_metric(base: str, name: str):
    return _module(os.path.join(base, "metrics", f"{name}.py"),
                   f"asrbench_metric_{name.replace('.', '_')}")


def end_to_end_for(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str, moves: Set[str]) -> List[dict]:
    """The per-layer metrics a cell's traced run reports: those listing
    the cell, or listing none and moving a metric the cell reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in moves:
            out.append(m)
    return out
