#!/usr/bin/env python3
"""One run of one benchmark cell: set-up, the measured window, the check, one JSON line.

    python3 wbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the first ``trace_seconds`` of the window under
``torch.profiler``). Every run checks the outputs of the window against the
plain reference and prints each compared number beside its limit, on
standard error and under ``checks`` in the result line. The run exits with
another code than 0 and prints no result without the CUDA cards the cell
asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (10 ms resolution
    from /proc; the first line of this file where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T0 = process_start()


def _card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", bench_path=None,
            base_dir=None) -> dict:
    """One run on ``device`` -> the result object (without printing)."""
    import torch

    from wbbench.lib.check import judge
    from wbbench.lib.guard import forbidden_modules
    from wbbench.lib.loop import Context
    from wbbench.lib.rundata import RunData
    from wbbench.lib.spec import load_cell, metric_reader

    cell = load_cell(workload, bench_path, base_dir)
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"wbbench: {workload} needs {cell.chips} CUDA card(s); "
                         f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    loop = cell.loop.Loop(Context(cell.config, cell.traffic, seed, device))
    loop.warm()
    if on_card:
        torch.cuda.synchronize()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"wbbench: forbidden modules loaded after set-up: {', '.join(found)}")
    tracer = None
    if trace:
        from wbbench.lib.trace import Tracer

        tracer = Tracer()
    window = loop.run(seconds, tracer)
    if on_card:
        torch.cuda.synchronize()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"wbbench: forbidden modules loaded after the window: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    run = RunData(cell=workload, config=cell.config, traffic=cell.traffic, units=window.units,
                  setup_s=window.start - T0, traced=window.traced, trace=window.trace, loop=loop)
    metrics = {}
    for m in cell.metrics(trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = loop.check(window, tuple(cell.limits))
    t_ref = time.perf_counter() - t_ref
    window.kept.clear()
    window.blocks.clear()
    worst, failed = judge(readings, cell.limits)
    correct = bool(readings) and failed == 0
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and window.trace is not None:
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
    result = {"correct": correct, "attempted": len(window.units), "failed": int(failed), "metrics": metrics,
              "device": dev}
    if trace and window.trace is not None:
        result["breakdown"] = window.trace.breakdown()
    secs = [u.seconds for u in window.units]
    print(f"units {len(secs)}: min {min(secs):.4f} s, median {sorted(secs)[len(secs) // 2]:.4f} s, "
          f"max {max(secs):.4f} s; window {window.end - window.start:.2f} s; reference {t_ref:.1f} s",
          file=sys.stderr)
    if len(secs) <= 200:
        print("unit seconds " + " ".join(f"{s:.4f}" for s in secs), file=sys.stderr)
    # a number that could not be read (no output checked, or one of the wrong shape) is null
    result["checks"] = {k: {"value": worst[k] if math.isfinite(worst[k]) else None, "limit": lim,
                            "checked": len(readings)} for k, lim in cell.limits.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # caches of the program and of torch stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    from wbbench.lib.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"wbbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {_card_info()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} over {c['checked']} outputs", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
