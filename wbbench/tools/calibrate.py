#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one process.

    python3 wbbench/tools/calibrate.py --workload eq128.export --seeds 1 2 3 ... --seconds 5 --control 3

For each seed: the cell's set-up and a window of ``--seconds`` through the
same loop as ``run.py`` (the timed path at the cell's own sizes), then the
compared numbers of the program's outputs against the reference; for the
first ``--control`` seeds also the bfloat16 control's numbers (the
reference computed in bfloat16 in the program's place). The lower reading
of a number is the largest over the program's seeds, the upper the smallest
over the control's. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from wbbench.lib.check import judge
    from wbbench.lib.loop import Context
    from wbbench.lib.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also read the control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    program_worst, control_worst = {}, {}
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        loop = cell.loop.Loop(Context(cell.config, cell.traffic, seed, "cuda"))
        loop.warm()
        window = loop.run(args.seconds)
        torch.cuda.synchronize()
        loop.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        readings = loop.check(window, tuple(cell.limits))
        t2 = time.perf_counter()
        worst, failed = judge(readings, cell.limits)
        row = {"workload": args.workload, "seed": seed, "units": len(window.units), "checked": len(readings),
               "program": worst, "program_failed": failed, "run_s": t1 - t0, "reference_s": t2 - t1}
        for k, v in worst.items():
            program_worst[k] = max(program_worst.get(k, 0.0), v)
        if i < args.control:
            c_readings = loop.check(window, tuple(cell.limits), control=True)
            c_worst, c_failed = judge(c_readings, cell.limits)
            row.update(control=c_worst, control_failed=c_failed,
                       control_min={k: min(r[k] for r in c_readings) for k in cell.limits},
                       control_s=time.perf_counter() - t2)
            for k, v in row["control_min"].items():
                control_worst[k] = min(control_worst.get(k, float("inf")), v)
        window.kept.clear()
        del loop, window
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print(json.dumps({"workload": args.workload, "lower": program_worst, "upper": control_worst,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
