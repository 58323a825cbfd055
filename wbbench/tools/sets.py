#!/usr/bin/env python3
"""Run one cell several times, one process a run, and summarise the runs.

    python3 wbbench/tools/sets.py --workload eq128.export --seeds 11 12 13 --seconds 30 [--trace 1] [--out f.jsonl]

Each run is ``wbbench/run.py`` as the benchmark's command runs it. The
summary gives, for each metric, the runs' values, their median and their
spread (the distance between the first and third quartile by
``statistics.quantiles(values, n=4)``, as a share of the median), each run's
wall time, exit code, peak host memory and compared numbers.
"""

from __future__ import annotations

import argparse
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None, help="append each run's record to this JSON-lines file")
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "wbbench/run.py", "--workload", args.workload, "--seed", str(seed),
                               "--seconds", str(args.seconds), "--trace", str(args.trace)],
                              cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        rss_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode, "wall_s": wall,
               "max_rss_gb_so_far": rss_gb, "result": res}
        row["stderr_units"] = [ln for ln in proc.stderr.splitlines() if ln.startswith(("units ", "unit seconds"))]
        if res is None or proc.returncode:
            row["stderr_tail"] = proc.stderr[-3000:]
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = {k: round(v["value"], 4) for k, v in (res or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (res or {}).get("checks", {}).items()}
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f}s rss<= {rss_gb:.1f} GB "
              f"correct {(res or {}).get('correct')} n {(res or {}).get('attempted')} {brief} {checks}", flush=True)
        if res is None or proc.returncode:
            print(row.get("stderr_tail", ""), flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        line = f"{k}: median {statistics.median(vals)!r}"
        if len(vals) >= 2:
            line += f" spread {spread(vals):.5f}"
        print(line + f" values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
