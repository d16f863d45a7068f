"""The benchmark of the PyTorch port (`catears_tpu_torch`) on one card.

    python3 -m asrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is looked up by name in
`BENCHMARK.json`; its configuration in `asrbench/configs/<config>.json`,
its traffic in `asrbench/traffic/<traffic>.json`, whose `kind` names the
generator `asrbench/kinds/<kind>.py`, and each per-layer metric in
`asrbench/metrics/<metric>.py`.  With `--trace 0` the last line of
standard output holds the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics; the numbers that decided `correct`, each beside its
limit, are the last lines of standard error and the line's last key.

The run exits with 2 and prints no result without a CUDA card (or with
fewer than the cell asks for), and with 3 if the process has loaded JAX
or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "catears_tpu")


def few_threads() -> None:
    """One process with few threads: the host's pools stay single-threaded
    so that the thread launching the card's work is not crowded (the port
    is bound by those launches).  Call before numpy or torch is loaded."""
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = "1"


def cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc libraries already build into `catears_tpu_torch/_build/`)."""
    base = os.path.join(root, ".asrbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def result_line(base, ctx, cell, outcome, metric_defs, device_info):
    from asrbench import manifest

    values = {}
    if ctx.trace:
        for m in manifest.per_layer_for(metric_defs, cell["name"],
                                        cell_moves(metric_defs, cell)):
            value = manifest.load_metric(base, m["name"]).read(
                outcome.records)
            if value is not None:
                values[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end_for(metric_defs, cell["name"]):
            values[m["name"]] = {"value": outcome.e2e[m["name"]],
                                 "unit": m["unit"]}
    line = {"correct": all(c.ok for c in outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": values, "device": device_info}
    if ctx.trace:
        device_info["busy_s"] = outcome.busy_s
        device_info["window_s"] = outcome.window_s
        if outcome.breakdown:
            line["breakdown"] = outcome.breakdown
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return line


def cell_moves(metric_defs, cell):
    from asrbench import manifest

    return {m["name"] for m in manifest.end_to_end_for(metric_defs,
                                                       cell["name"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="the checkout: BENCHMARK.json and asrbench/")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    few_threads()
    cache_dirs(root)

    import torch

    from asrbench import harness, manifest

    torch.set_num_threads(1)
    bench = manifest.load(root)
    cell = manifest.workload(bench, args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"asrbench: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    device = torch.device(args.device)
    base = manifest.data_dir(root)
    config = manifest.config(root, bench, cell["config"])
    traffic = manifest.traffic(base, cell["traffic"])
    kind = manifest.load_kind(base, traffic["kind"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"# card: {card_line()}", file=sys.stderr, flush=True)
    ctx = harness.Ctx(cell=cell["name"], config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      t_start=T_START, scratch=harness.env_scratch(root),
                      peaks=manifest.peaks(base),
                      limits=manifest.limits(base, cell["name"]))
    outcome = kind.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"asrbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak}
    line = result_line(base, ctx, cell, outcome, bench, info)
    for msg in ctx.log:
        print(msg, file=sys.stderr)
    for c in outcome.checks:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def card_line() -> str:
    """`name, power limit` of card 0, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
