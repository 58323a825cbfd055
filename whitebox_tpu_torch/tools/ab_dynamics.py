"""Time the dynamics stages of two checkouts on one card, in turns.

    python -m whitebox_tpu_torch.tools.ab_dynamics OTHER_CHECKOUT [--rounds 1] [--cells a,b]
    python -m whitebox_tpu_torch.tools.ab_dynamics --sweep        # this checkout at each sub-block length
    python -m whitebox_tpu_torch.tools.ab_dynamics --from-log LOG  # summarise a saved run

Runs ``OTHER, THIS, THIS, OTHER`` (per round), each in a fresh process from
the root of its checkout, which builds that checkout's kernels and times,
by CUDA events around each call (median of 20 calls after one warm call),
what the finishers call at the shapes their paths give it, on seeded
noise swelling from quiet to loud:

- ``compressor_64x2x2^18``: ``ops/dynamics.py::compressor_process`` on
  the generic finisher's compressor group (64 stereo tracks, one chunk of
  ``CUDA_CHUNK_CAP`` frames, parameters one a row);
- ``master_limiter_1x2x2^18``: ``limiter_process`` with the 5 ms (240
  frames) lookahead on the generic master's chunk;
- ``bus_sidechain_compressor_1x2x2^20``, ``bus_compressors_3x2x2^20`` and
  ``master_limiter_1x2x2^20``: the routed finisher's ducking bus (keyed),
  its three compressor buses and its master, chunks of 2^20;
- ``gate_16x2x2^18``: ``gate_process`` with hysteresis on 16 stereo rows;
- ``ballistics_64x2^18``, ``ballistics_256x2^18`` and
  ``shard_ballistics_64x720384``: ``ops/dynamics_cuda.py::ballistics`` on
  gain reductions (the frame-sharded stages' recurrences; the last one a
  1x4 shard of 60 s, with the products);
- on request only (``--cells``), ``e2e_generic_fx_128trk`` and
  ``e2e_routed_sidechain_128trk``: ``bounce(device="cuda")`` of
  ``chip_smoke.py``'s 60 s sessions, the host clock around each
  synchronised call (median of 5).

In the parent of the fused kernel a processor call is the torch ops around
the five-launch ballistics kernel; here it is one launch, and
``<cell>:launch`` times the prepared launch alone (``prepare_stage`` /
``prepare_scan``) where the checkout has it, 20 in a row between two
events. ``--cells``
times a subset. Prints one JSON line per run and a summary: the medians
per checkout, the change in percent, the pairs this checkout won and the
other's interquartile range (``ab_mix.summarize``). ``--sweep`` times
this checkout's cells at each sub-block length of
``dynamics_cuda.SUB_FRAMES`` in place of ``sub_frames``' choice. Both
checkouts must hold ``chip_smoke.py`` (``_event_ms``) and
``whitebox_tpu_torch``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from whitebox_tpu_torch.tools.ab_mix import THIS, run, summarize

_RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from whitebox_tpu_torch.ops import cuda_build, dynamics as dyn, dynamics_cuda as dc

SUB = None
if SUB is not None:
    dc.sub_frames = lambda B, F, fused=False: SUB
cuda_build.load()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(7)


def noise(B, C, F):
    swell = torch.linspace(0.02, 1.6, F, device=dev)
    return torch.randn((B, C, F), generator=gen, device=dev) * swell


def rows(B, lo, hi):
    return lo + (hi - lo) * torch.rand((B, 1), generator=gen, device=dev)


def coef(B, lo, hi):  # time coefficients of constants between lo and hi seconds
    return torch.exp(-1.0 / (rows(B, lo, hi) * cs.RATE))


def stage(kind, proc, x, p, st, **kw):
    # -> (the processor call, the prepared launch alone where the checkout has one)
    call = dc.prepare_stage(kind, x, p, st, **kw) if hasattr(dc, "prepare_stage") else None
    return (lambda: proc(x, p, st, **kw)), call


def compressor(B, F, key=False):
    x = noise(B, 2, F)
    p = {"threshold_db": rows(B, -24.0, -18.0), "ratio": rows(B, 3.0, 4.0), "knee_db": rows(B, 6.0, 6.0),
         "attack": coef(B, 0.005, 0.005), "release": coef(B, 0.1, 0.1), "makeup_db": rows(B, 0.0, 0.0),
         "det_avg": coef(B, 0.03, 0.03)}
    z = torch.zeros(B, device=dev)
    k = noise(B, 2, F) if key else None
    return stage("compressor", dyn.compressor_process, x, p, {"red": z, "att": z, "det": z}, key=k)


def limiter(F, L=240):
    x = noise(1, 2, F)
    p = {"ceiling_db": rows(1, -0.5, -0.5), "attack": coef(1, 0.001, 0.001), "release": coef(1, 0.05, 0.05)}
    z = torch.zeros(1, device=dev)
    st = {"red": z, "att": z, "look": torch.zeros((1, L), device=dev), "xdelay": torch.zeros((1, 2, L), device=dev)}
    return stage("limiter", dyn.limiter_process, x, p, st, lookahead=L)


def gate(B, F):
    x = noise(B, 2, F)
    p = {"threshold_db": rows(B, -30.0, -20.0), "range_db": rows(B, 40.0, 60.0), "hyst_db": rows(B, 3.0, 3.0),
         "attack": coef(B, 0.001, 0.001), "release": coef(B, 0.1, 0.1)}
    z = torch.zeros(B, device=dev)
    return stage("gate", dyn.gate_process, x, p, {"open": z, "att": z})


def ballistics(B, F, products=False):
    v = torch.relu(torch.randn((B, F), generator=gen, device=dev) * 6.0 - 3.0)
    r, a, z = coef(B, 0.1, 0.3), coef(B, 0.005, 0.02), torch.zeros(B, device=dev)
    call = dc.prepare_scan(v, r, a, z, z, products=products) if hasattr(dc, "prepare_scan") else None
    return (lambda: dc.ballistics(v, r, a, z, z, products=products)), call


def e2e(make):  # a 60 s session of chip_smoke's through bounce(device="cuda")
    from whitebox_tpu_torch.render.bounce import bounce

    s = getattr(cs, make)(60.0)
    return (lambda: bounce(s, cs.RATE, device="cuda").audio.shape), None


cells = {"compressor_64x2x2^18": lambda: compressor(64, 1 << 18),
         "master_limiter_1x2x2^18": lambda: limiter(1 << 18),
         "bus_sidechain_compressor_1x2x2^20": lambda: compressor(1, 1 << 20, key=True),
         "bus_compressors_3x2x2^20": lambda: compressor(3, 1 << 20),
         "master_limiter_1x2x2^20": lambda: limiter(1 << 20),
         "gate_16x2x2^18": lambda: gate(16, 1 << 18),
         "ballistics_64x2^18": lambda: ballistics(64, 1 << 18),
         "ballistics_256x2^18": lambda: ballistics(256, 1 << 18),
         "shard_ballistics_64x720384": lambda: ballistics(64, 720384, products=True),
         "e2e_generic_fx_128trk": lambda: e2e("generic_fx_128trk"),
         "e2e_routed_sidechain_128trk": lambda: e2e("routed_sidechain_128trk")}
wanted = sys.argv[2].split(",") if sys.argv[2] else [c for c in cells if not c.startswith("e2e_")]
out = {"checkout": sys.argv[1]}
for name, make in cells.items():
    if name not in wanted:
        continue
    fn, call = make()
    fn()
    torch.cuda.synchronize()
    if name.startswith("e2e_"):  # the host clock around a synchronised bounce, median of 5
        out[name] = cs._wall_ms(torch, fn, 5)[0]
    else:
        out[name] = cs._event_ms(torch, fn, 20)[0]
    if call is not None:  # the kernel's launch alone, without the wrapper's host work, 20 in a row
        out[name + ":launch"] = cs._event_ms_batch(torch, call, 20)
    del fn, call
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", type=Path, nargs="?", help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cells", default="", help="comma-separated cells to time (default: all)")
    ap.add_argument("--sweep", action="store_true", help="this checkout at each sub-block length")
    ap.add_argument("--from-log", type=Path, help="summarise the JSON lines of an earlier run")
    args = ap.parse_args(argv)
    if args.from_log is not None:
        summarize([json.loads(line) for line in args.from_log.read_text().splitlines()
                   if line.startswith('{"checkout"')], tag="ab_dynamics")
        return 0
    if args.sweep:
        from whitebox_tpu_torch.ops.dynamics_cuda import SUB_FRAMES

        for _ in range(args.rounds):
            for sub in SUB_FRAMES:
                row = run(THIS, f"sub_{sub}", args.cells, _RUN.replace("SUB = None", f"SUB = {sub}"))
                print(json.dumps(row), flush=True)
        return 0
    if args.other is None:
        ap.error("the other checkout is required")
    rows = []
    for _ in range(args.rounds):
        for checkout, label in ((args.other, "other"), (THIS, "this"), (THIS, "this"), (args.other, "other")):
            rows.append(run(checkout.resolve(), label, args.cells, _RUN))
            print(json.dumps(rows[-1]), flush=True)
    summarize(rows, tag="ab_dynamics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
