"""Time the biquad cascade kernels of two checkouts on one card, in turns.

    python -m whitebox_tpu_torch.tools.ab_cascade OTHER_CHECKOUT [--rounds 1] [--cells a,b]
    python -m whitebox_tpu_torch.tools.ab_cascade --from-log LOG   # summarise a saved run

Runs ``OTHER, THIS, THIS, OTHER`` (per round), each in a fresh process from
the root of its checkout, which builds that checkout's kernels and times,
by CUDA events (median of 20 calls after one warm call),
``ops/biquad_cuda.py::biquad_cascade`` at the shapes the main paths give
it, on seeded noise (the recurrence's cost does not depend on the data):

- ``tracks_256x2^20``: config 5's three EQ sections on 128 stereo tracks,
  one chunk of ``CUDA_CHUNK`` frames as a row-strided view of a 60 s
  per-track buffer (the scan finisher and the generic EQ stages);
- ``master_2x2^20``: the 25 Hz highpass on the master's chunk;
- ``k_weighting_2x2880000``: the loudness measurement's two K-weighting
  sections on 60 s of stereo in one call;
- ``preview_tracks_64x32768`` and ``preview_master_2x32768``: a preview
  window of 32 stereo tracks (64 blocks of 512 frames);
- ``stream_tracks_256x131072`` and ``stream_master_2x131072``: a streamed
  bounce's window of 2^17 frames;
- ``sharded_shard_256x720384_two_passes``: one shard of a 1x4 mesh over
  60 s, the cascade twice (from zero, then from the folded state).

``--cells`` times a subset. Prints one JSON line per run and a summary: the
medians per checkout, the change in percent, the pairs this checkout won
and the other's interquartile range (``ab_mix.summarize``). Both
checkouts must hold ``chip_smoke.py`` (with ``cascade_rows`` and
``_event_ms``) and ``whitebox_tpu_torch``. Needs one CUDA card.
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
from whitebox_tpu_torch.ops import biquad_cuda, cuda_build
from whitebox_tpu_torch.ops.biquad import design_biquad
from whitebox_tpu_torch.ops.loudness import k_weighting_cascade

cuda_build.load()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(5)


def eq(B):  # config 5's three bands, each stereo track its own peak frequency
    chains = []
    for t in range(B // 2):
        secs = [design_biquad("lowshelf", 100.0, cs.RATE, 0.707, 2.0),
                design_biquad("peak", 1000.0 + 37.0 * t, cs.RATE, 1.0, -1.5),
                design_biquad("highshelf", 8000.0, cs.RATE, 0.707, 1.0)]
        chains += [secs, secs]
    return torch.from_numpy(cs.cascade_rows(chains)).to(dev)


def hp(B):
    return torch.from_numpy(cs.cascade_rows([[design_biquad("highpass", 25.0, cs.RATE)]] * B)).to(dev)


big = torch.randn((256, 2880000), generator=gen, device=dev) * 0.3  # 128 stereo tracks x 60 s
two = big[:2].contiguous()
# cell -> (x, coefficients, passes)
cells = {"tracks_256x2^20": (big[:, :1 << 20], eq(256), 1),
         "master_2x2^20": (two[:, :1 << 20], hp(2), 1),
         "k_weighting_2x2880000": (two, k_weighting_cascade(cs.RATE, 2, "cuda"), 1),
         "preview_tracks_64x32768": (big[:64, :32768], eq(64), 1),
         "preview_master_2x32768": (two[:, :32768], hp(2), 1),
         "stream_tracks_256x131072": (big[:, :1 << 17], eq(256), 1),
         "stream_master_2x131072": (two[:, :1 << 17], hp(2), 1),
         "sharded_shard_256x720384_two_passes": (big[:, :720384].contiguous(), eq(256), 2)}
wanted = sys.argv[2].split(",") if sys.argv[2] else list(cells)
out = {"checkout": sys.argv[1]}
for name, (x, coeffs, passes) in cells.items():
    if name not in wanted:
        continue
    zeros = [torch.zeros((x.shape[0], 2), device=dev) for _ in range(coeffs.shape[1])]

    def fn():
        for _ in range(passes):
            biquad_cuda.biquad_cascade(x, coeffs, zeros)
    fn()
    torch.cuda.synchronize()
    out[name] = cs._event_ms(torch, fn, 20)[0]
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", type=Path, nargs="?", help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cells", default="", help="comma-separated cells to time (default: all)")
    ap.add_argument("--from-log", type=Path, help="summarise the JSON lines of an earlier run")
    args = ap.parse_args(argv)
    if args.from_log is not None:
        summarize([json.loads(line) for line in args.from_log.read_text().splitlines()
                   if line.startswith('{"checkout"')], tag="ab_cascade")
        return 0
    if args.other is None:
        ap.error("the other checkout is required")
    rows = []
    for _ in range(args.rounds):
        for checkout, label in ((args.other, "other"), (THIS, "this"), (THIS, "this"), (args.other, "other")):
            rows.append(run(checkout.resolve(), label, args.cells, _RUN))
            print(json.dumps(rows[-1]), flush=True)
    summarize(rows, tag="ab_cascade")
    return 0


if __name__ == "__main__":
    sys.exit(main())
