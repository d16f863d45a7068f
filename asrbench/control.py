"""Readings for the limits of `correct`: one process runs a cell on many
seeds (a short window each) and prints, per seed, the numbers the
program's run compared and the same numbers for the control (the
reference in the program's place, a precision lower: TF32 for the AM,
bfloat16 for the decoder's costs).

    python3 -m asrbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--out chiprun_out/control.jsonl]

The benchmark's own runs never run it.  The limit of each number lies
between the largest program reading and the smallest control reading
(PERF.md gives both).  The control's readings go through the cell's own
comparisons and limits: `control_correct` has to come out false on every
seed, and the program's `correct` true; the exit code is 1 where either
does not.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from asrbench.run import cache_dirs, few_threads

    few_threads()
    import torch

    from asrbench import harness, manifest

    root = os.path.abspath(args.root)
    cache_dirs(root)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = manifest.load(root)
    cell = manifest.workload(bench, args.workload)
    base = manifest.data_dir(root)
    kind = manifest.load_kind(base, manifest.traffic(base, cell["traffic"])
                              ["kind"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(
            cell=cell["name"], config=manifest.config(root, bench,
                                                      cell["config"]),
            traffic=manifest.traffic(base, cell["traffic"]), seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device(args.device), t_start=time.perf_counter(),
            scratch=harness.env_scratch(root), peaks=manifest.peaks(base),
            limits=manifest.limits(base, cell["name"]), control=True)
        out = kind.run(ctx)
        ctl = [harness.Check(c.name, ctx.control_readings[c.name], c.limit)
               for c in out.checks if c.name in ctx.control_readings]
        row = {"workload": cell["name"], "seed": seed,
               "correct": all(c.ok for c in out.checks),
               "program": {c.name: c.value for c in out.checks},
               "control": ctx.control_readings,
               "control_correct": bool(ctl) and all(c.ok for c in ctl),
               "limits": {c.name: c.limit for c in out.checks},
               "e2e": out.e2e}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out, ctx
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as fd:
            fd.writelines(json.dumps(r) + "\n" for r in rows)
    return 0 if all(r["correct"] and not r["control_correct"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
