"""Time the CUDA mix kernel of two checkouts on one card, in turns.

    python -m whitebox_tpu_torch.tools.ab_mix OTHER_CHECKOUT [--rounds 1]

Runs ``OTHER, THIS, THIS, OTHER`` (per round), each in a fresh process from
the root of its checkout, which builds that checkout's kernels with its own
``nvcc`` flags and times, by CUDA events (median of 20 launches after one
warm launch), the summing kernel on the 128-track x 60 s headline session
and its automation variant on the JAX package's configs 2 and 7 (the
sessions of ``chip_smoke.py``). Prints one JSON line per run and a summary
of the medians per checkout. Both checkouts must hold ``chip_smoke.py``
and ``whitebox_tpu_torch`` with ``mix_cuda.mix_cuda``/``mix_auto_cuda``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]

_RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from whitebox_tpu_torch.ops import cuda_build, mix_cuda
from whitebox_tpu_torch.render.demo import make_demo_session
from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
from whitebox_tpu_torch.timeline.carve import carve_session

cuda_build.load()
cells = {"headline": (make_demo_session(n_tracks=128, duration_seconds=60.0, sample_rate=48000, seed=7), False),
         "automation_32trk": (cs.automation_32trk(), True),
         "automation_tempo_128trk": (cs.automation_tempo_128trk(), True)}
out = {"checkout": sys.argv[1]}
for name, (s, auto) in cells.items():
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cuda",
                                 auto_tables=prepare_automation_tables_host(s, 48000.0) if auto else None)
    p = r.plan
    if auto:
        fn = lambda: mix_cuda.mix_auto_cuda(r.pool_device, r.tables, r.auto, p.n_tiles, p.tile, p.channels)
    else:
        fn = lambda: mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels)
    fn()
    torch.cuda.synchronize()
    out[name] = cs._event_ms(torch, fn, 20)[0]
print(json.dumps(out))
"""


def run(checkout: Path, label: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _RUN, label], cwd=checkout, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{label} ({checkout}) failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", type=Path, help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    rows = []
    for _ in range(args.rounds):
        for checkout, label in ((args.other, "other"), (THIS, "this"), (THIS, "this"), (args.other, "other")):
            rows.append(run(checkout.resolve(), label))
            print(json.dumps(rows[-1]), flush=True)
    cells = [k for k in rows[0] if k != "checkout"]
    summary = {label: {c: statistics.median(r[c] for r in rows if r["checkout"] == label) for c in cells}
               for label in ("other", "this")}
    print("[ab_mix] medians ms " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
