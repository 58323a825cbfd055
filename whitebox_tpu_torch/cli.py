"""Command-line interface of the port: offline render of a ``.wb`` project.

Counterpart of ``whitebox_tpu/cli.py`` (``_cmd_render`` and its parser),
on the surface the port's ``bounce`` covers:

    python -m whitebox_tpu_torch.cli render project.wb out.wav \\
        [--rate 48000] [--buffer-size 512] [--format f32] [--device cuda]
        [--effects-mode scan|fir] [--engine auto|pallas|xla] [--chunk-frames N]
        [--fast-sum] [--pdc] [--interpolation linear|catmull|sinc]
        [--no-prerender] [--meters] [--dither none|tpdf|tpdf-hp]
        [--tail SECONDS] [--from-beat B | --from-bar B] [--to-beat B | --to-bar B]
        [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _range(session, args):
    """``--from-*/--to-*`` -> ``(num_blocks, trim_frames)`` for ``bounce``
    (None, None without an end beat), after moving the playhead to the
    start; ``--tail`` renders past an explicit end beat
    (``whitebox_tpu/cli.py:83-109``)."""
    from whitebox_tpu_torch.timeline.transport import BlockTransport

    if args.from_bar is not None:
        if args.from_beat is not None:
            raise ValueError("--from-bar and --from-beat are mutually exclusive")
        args.from_beat = session.bar_to_beat(args.from_bar)
    if args.to_bar is not None:
        if args.to_beat is not None:
            raise ValueError("--to-bar and --to-beat are mutually exclusive")
        args.to_beat = session.bar_to_beat(args.to_bar)
    if args.from_beat is None and args.to_beat is None:
        return None, None
    start = float(args.from_beat) if args.from_beat is not None else session.playhead_start
    session.set_playhead_position(start)
    if args.to_beat is None:
        return None, None
    if args.to_beat <= start:
        raise ValueError(f"--to-beat {args.to_beat} must be past the start ({start})")
    tr = BlockTransport(float(args.rate), int(args.buffer_size), session.beat_duration, start,
                        tempo_map=session.tempo_map)
    num_blocks = max(tr.blocks_for_beats(float(args.to_beat)), 1)
    trim_frames = int(round(tr.delta_samples(start, float(args.to_beat))))
    if args.tail > 0.0:
        # bounce's own tail only applies when it computes num_blocks
        tail_frames = int(np.ceil(args.tail * args.rate))
        num_blocks += (tail_frames + args.buffer_size - 1) // args.buffer_size
        trim_frames += tail_frames
    return num_blocks, trim_frames


def _print_meters(session, stats) -> None:
    """Per-track and output peak/RMS in dB (``whitebox_tpu/cli.py:154-165``)."""
    from whitebox_tpu_torch.core.math import linear_to_db

    def db(x):
        return round(float(linear_to_db(float(max(x, 1e-12)))), 1)

    for i, t in enumerate(session.tracks):
        pk, rms = stats.track_peak[i], stats.track_rms[i]
        print(f"  track {i:3d} {t.name[:24]:24s} peak {db(pk.max()):+7.1f} dB  rms {db(rms.max()):+7.1f} dB")
    print(f"  output{'':28s} peak {db(stats.output_peak.max()):+7.1f} dB  "
          f"rms {db(stats.output_rms.max()):+7.1f} dB")


def _cmd_render(args) -> int:
    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session.project import read_project
    from whitebox_tpu_torch.render.bounce import bounce

    session = read_project(args.project)
    fmt = {"f32": AudioFormat.F32, "i16": AudioFormat.I16, "i24": AudioFormat.I24,
           "i32": AudioFormat.I32}[args.format]
    num_blocks, trim_frames = _range(session, args)
    result = bounce(session, sample_rate=args.rate, device=args.device,
                    buffer_size=args.buffer_size, num_blocks=num_blocks, trim_frames=trim_frames,
                    tail_seconds=args.tail, effects_mode=args.effects_mode, engine=args.engine,
                    chunk_frames=args.chunk_frames, strict_order=not args.fast_sum, pdc=args.pdc,
                    interpolation=args.interpolation,
                    prerender=False if args.no_prerender else None, meters=args.meters,
                    out_path=args.out, out_format=fmt,
                    out_dither=None if args.dither == "none" else args.dither)
    print(result.stats.summary())
    if args.meters:
        _print_meters(session, result.stats)
    if args.json:
        print(json.dumps({"frames": result.frames, "rtf": result.stats.rtf,
                          "msamples_per_sec": result.stats.msamples_per_sec,
                          "device": result.stats.device}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="whitebox-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline-bounce a .wb project to WAV")
    p.add_argument("project")
    p.add_argument("out")
    p.add_argument("--rate", type=float, default=48000.0)
    p.add_argument("--buffer-size", type=int, default=512, help="emulated engine block size (event semantics)")
    p.add_argument("--chunk-frames", type=int, default=1 << 17,
                   help="frames per chunk of the gather path (engine xla, or auto's fallback)")
    p.add_argument("--format", choices=["f32", "i16", "i24", "i32"], default="f32")
    p.add_argument("--fast-sum", action="store_true",
                   help="gather path: sum the tracks in one torch.sum (order not fixed, not bit-parity)")
    p.add_argument("--engine", choices=["auto", "pallas", "xla"], default="auto",
                   help="auto: the CUDA mix kernel, the gather mix where the slot plan cannot hold "
                        "the session; pallas: the kernel only; xla: the gather mix")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' renders with the plain PyTorch mix)")
    p.add_argument("--effects-mode", choices=["scan", "fir"], default="scan",
                   help="effect-chain finisher: biquad scan (default) or FFT-FIR")
    p.add_argument("--interpolation", choices=["linear", "catmull", "sinc"], default="linear",
                   help="resampled clips: linear (reference parity), catmull (4-point cubic) "
                        "or sinc (polyphase prerender; see --no-prerender)")
    p.add_argument("--no-prerender", action="store_true",
                   help="sinc through the 4x oversampled pool and six polynomial taps only")
    p.add_argument("--meters", action="store_true",
                   help="per-track and output level meters (forces the scan finisher)")
    p.add_argument("--pdc", action="store_true",
                   help="plugin-delay compensation: align tracks across chain latency "
                        "(limiter lookahead, linear-phase EQ); absorbs master latency")
    p.add_argument("--dither", choices=["none", "tpdf", "tpdf-hp"], default="none",
                   help="+-1 LSB TPDF dither before integer quantization "
                        "(tpdf-hp: high-passed, recommended for 16-bit)")
    p.add_argument("--tail", type=float, default=0.0, metavar="SECONDS",
                   help="render past the last clip (or --to-beat) so effect tails ring out")
    p.add_argument("--from-beat", type=float, default=None, metavar="BEAT",
                   help="render from this beat (default: the project playhead)")
    p.add_argument("--to-beat", type=float, default=None, metavar="BEAT",
                   help="stop at this beat (exact frame under the tempo map; "
                        "default: the last clip edge)")
    p.add_argument("--from-bar", type=float, default=None, metavar="BAR",
                   help="render from this (0-based) bar, via the meter map")
    p.add_argument("--to-bar", type=float, default=None, metavar="BAR",
                   help="stop at this (0-based) bar, via the meter map")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_render)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
