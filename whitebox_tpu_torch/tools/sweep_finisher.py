"""Time the scan finisher's choices on one card: the cascade kernel's block
length and the finisher's chunk length.

    python -m whitebox_tpu_torch.tools.sweep_finisher [--blocks 512,1024,2048]
        [--chunks 262144,1048576,4194304] [--profile]

On config 5's session (``chip_smoke.effects_eq_128trk``: 128 tracks x 60 s,
a 3-band EQ per track, a 25 Hz highpass on the master) it renders K4's
per-track buffers once, then times by CUDA events (median of 5 after one
warm call):

- ``biquad_cascade`` on the tracks' first chunk of ``CUDA_CHUNK`` frames
  at each block length ``L`` (``biquad_cuda.BLOCK_FRAMES``), with the
  largest row relative RMS against the L of the build's default;
- ``finish_mix`` (plain and metered) at each chunk length, with the peak
  memory of the metered call.

With ``--profile``, one cascade call and one metered ``finish_mix`` (at the
default block and chunk lengths) run under ``torch.profiler``, which
prints the device time per kernel. Prints one JSON line per measurement
and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", default="256,512,1024,2048,4096")
    ap.add_argument("--chunks", default="262144,1048576,4194304")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from whitebox_tpu_torch.ops import biquad_cuda, cuda_build
    from whitebox_tpu_torch.render import effects_pipeline as pipe

    if not torch.cuda.is_available():
        print("sweep_finisher: needs a CUDA card", file=sys.stderr)
        return 2
    cuda_build.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    session = cs.effects_eq_128trk()
    r, _, _, _ = cs.make_renderer(session)
    p = r.plan
    pt = r.render_device_per_track()
    dev = torch.device("cuda")
    (S, coeffs), (Sm, mcoeffs) = pipe.prepare_effect_tables(session, cs.RATE, p.channels, device=dev)
    xc = pt.reshape(p.num_tracks * p.channels, -1)[:, :pipe.CUDA_CHUNK]
    zeros = [torch.zeros((xc.shape[0], 2), device=dev) for _ in range(S)]

    default = biquad_cuda.BLOCK_FRAMES
    base, _ = biquad_cuda.biquad_cascade(xc, coeffs, zeros)
    try:
        for L in (int(v) for v in args.blocks.split(",")):
            biquad_cuda.BLOCK_FRAMES = L
            y, _ = biquad_cuda.biquad_cascade(xc, coeffs, zeros)
            torch.cuda.synchronize()
            ms, all_ms = cs._event_ms(torch, lambda: biquad_cuda.biquad_cascade(xc, coeffs, zeros), 5)
            print(json.dumps({"cascade_block_frames": L, "rows": list(xc.shape), "ms": ms, "ms_all": all_ms,
                              "rel_rms_vs_default_L": float(cs.row_rel_rms(y, base).max())}), flush=True)
            del y
    finally:
        biquad_cuda.BLOCK_FRAMES = default
    del base

    tg = r.tables["track_gain"]
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        def metered():
            return pipe.finish_mix(pt, coeffs, mcoeffs, tg, T=p.num_tracks, C=p.channels, S=S, Sm=Sm,
                                   with_meters=True, valid_frames=p.total_frames)
        for name, fn in (("cascade", lambda: biquad_cuda.biquad_cascade(xc, coeffs, zeros)),
                         ("finish_mix_metered", metered)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f"[profile] {name}")
            print(prof.key_averages().table(sort_by="device_time_total", row_limit=14, max_name_column_width=60))
    for chunk in (int(v) for v in args.chunks.split(",")):
        for meters in (False, True):
            def finish():
                return pipe.finish_mix(pt, coeffs, mcoeffs, tg, T=p.num_tracks, C=p.channels, S=S, Sm=Sm,
                                       chunk=chunk, with_meters=meters, valid_frames=p.total_frames)
            finish()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, all_ms = cs._event_ms(torch, finish, 5)
            print(json.dumps({"finish_chunk": chunk, "meters": meters, "ms": ms, "ms_all": all_ms,
                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
