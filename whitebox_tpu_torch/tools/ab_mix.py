"""Time the CUDA mix kernels of two checkouts on one card, in turns.

    python -m whitebox_tpu_torch.tools.ab_mix OTHER_CHECKOUT [--rounds 1] [--cells a,b]
    python -m whitebox_tpu_torch.tools.ab_mix --from-log LOG   # summarise a saved run

Runs ``OTHER, THIS, THIS, OTHER`` (per round), each in a fresh process from
the root of its checkout, which builds that checkout's kernels with its own
``nvcc`` flags and times, by CUDA events (median of 20 launches after one
warm launch), one launch of each kernel row on the 128-track x 60 s
sessions of ``chip_smoke.py``: the summing kernel on the headline session
(K1) and with resampled clips (``headline_resampled``, K2-linear), its
automation variant on the JAX package's configs 2 and 7
(``automation_32trk``, ``automation_tempo_128trk``, K3), its Catmull-Rom and
polynomial-tap modes on config 3's session (``catmull_128trk``, K2-catmull;
``sinc_oversample_128trk``, K2-poly over the 4x oversampled pool), and the
per-track kernel on config 5's (``effects_eq_128trk``, K4); and the scan
finisher of config 5 on K4's per-track buffers (``scan_finish``: the chains'
cascade, gains, ordered sum, master chain and clip; median of 3 calls after
one warm call). ``--cells`` times a subset. Prints one JSON line per run and
a summary: the medians per checkout, the change in percent, the pairs
(the i-th run of each checkout) this checkout won, and the other's
interquartile range. Both checkouts must hold ``chip_smoke.py`` (with
``make_renderer``) and ``whitebox_tpu_torch``. Needs one CUDA card;
``--from-log`` re-reads the JSON lines of an earlier run and needs none.
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
from whitebox_tpu_torch.render.bounce import _effects_finisher
from whitebox_tpu_torch.render.demo import make_demo_session

cuda_build.load()
demo = dict(n_tracks=128, duration_seconds=60.0, seed=7)
config3 = make_demo_session(sample_rate=44100, clip_speeds=cs.CONFIG3_SPEEDS, **demo)
# cell -> (session, interpolation mode, kernel variant)
cells = {"headline": (make_demo_session(sample_rate=48000, **demo), "linear", "sum"),
         "headline_resampled": (make_demo_session(sample_rate=48000, clip_speeds=(1.0, 44100 / 48000), **demo),
                                "linear", "sum"),
         "automation_32trk": (cs.automation_32trk(), "linear", "auto"),
         "automation_tempo_128trk": (cs.automation_tempo_128trk(), "linear", "auto"),
         "catmull_128trk": (config3, "catmull", "sum"),
         "sinc_oversample_128trk": (config3, "poly", "sum"),
         "effects_eq_128trk": (cs.effects_eq_128trk(), "linear", "per_track"),
         "scan_finish": (cs.effects_eq_128trk(), "linear", "scan_finish")}
wanted = sys.argv[2].split(",") if sys.argv[2] else list(cells)
out = {"checkout": sys.argv[1]}
for name, (s, mode, variant) in cells.items():
    if name not in wanted:
        continue
    r, _, _, interp = cs.make_renderer(s, mode, auto=variant == "auto")
    p = r.plan
    args = (p.n_tiles, p.tile, p.channels)
    if variant == "scan_finish":
        pt = r.render_device_per_track()
        finish = _effects_finisher(s, r, p, cs.RATE, p.channels, "scan", False, torch.device("cuda"))
        finish(pt)
        torch.cuda.synchronize()
        out[name] = cs._event_ms(torch, lambda: finish(pt), 3)[0]
        del r, pt, finish
        continue
    if variant == "auto":
        fn = lambda: mix_cuda.mix_auto_cuda(r.pool_device, r.tables, r.auto, *args, interp=interp)
    elif variant == "per_track":
        fn = lambda: mix_cuda.mix_per_track_cuda(r.pool_device, r.tables, *args, interp=interp)
    else:
        fn = lambda: mix_cuda.mix_cuda(r.pool_device, r.tables, *args, interp=interp)
    fn()
    torch.cuda.synchronize()
    out[name] = cs._event_ms(torch, fn, 20)[0]
    del r, fn
print(json.dumps(out))
"""


def run(checkout: Path, label: str, cells: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _RUN, label, cells], cwd=checkout, capture_output=True,
                       text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{label} ({checkout}) failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def summarize(rows: list[dict]) -> None:
    cells = [k for k in rows[0] if k != "checkout"]
    runs = {label: [r for r in rows if r["checkout"] == label] for label in ("other", "this")}
    summary = {label: {c: statistics.median(r[c] for r in rs) for c in cells} for label, rs in runs.items()}
    print("[ab_mix] medians ms " + json.dumps(summary))
    print("[ab_mix] this vs other, percent " + json.dumps(
        {c: round(100.0 * (summary["this"][c] / summary["other"][c] - 1.0), 2) for c in cells}))
    pairs = list(zip(runs["other"], runs["this"]))
    print("[ab_mix] pairs this won, of " + str(len(pairs)) + " " + json.dumps(
        {c: sum(t[c] < o[c] for o, t in pairs) for c in cells}))
    if len(runs["other"]) >= 4:
        iqr = {}
        for c in cells:
            q = statistics.quantiles([r[c] for r in runs["other"]], n=4)
            iqr[c] = q[2] - q[0]
        print("[ab_mix] other's interquartile range ms " + json.dumps(iqr))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", type=Path, nargs="?", help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cells", default="", help="comma-separated cells to time (default: all)")
    ap.add_argument("--from-log", type=Path, help="summarise the JSON lines of an earlier run")
    args = ap.parse_args(argv)
    if args.from_log is not None:
        summarize([json.loads(line) for line in args.from_log.read_text().splitlines()
                   if line.startswith('{"checkout"')])
        return 0
    if args.other is None:
        ap.error("the other checkout is required")
    rows = []
    for _ in range(args.rounds):
        for checkout, label in ((args.other, "other"), (THIS, "this"), (THIS, "this"), (args.other, "other")):
            rows.append(run(checkout.resolve(), label, args.cells))
            print(json.dumps(rows[-1]), flush=True)
    summarize(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
