"""Command-line interface of the port: offline render of a ``.wb`` project.

Counterpart of ``whitebox_tpu/cli.py`` (``_cmd_render`` and its parser),
on the surface the port's ``bounce`` covers:

    python -m whitebox_tpu_torch.cli render project.wb out.wav \\
        [--rate 48000] [--buffer-size 512] [--format f32] [--device cuda] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_render(args) -> int:
    from whitebox_tpu.core.formats import AudioFormat
    from whitebox_tpu.session.project import read_project
    from whitebox_tpu_torch.render.bounce import bounce

    session = read_project(args.project)
    fmt = {"f32": AudioFormat.F32, "i16": AudioFormat.I16, "i24": AudioFormat.I24,
           "i32": AudioFormat.I32}[args.format]
    result = bounce(session, sample_rate=args.rate, device=args.device,
                    buffer_size=args.buffer_size, out_path=args.out, out_format=fmt)
    print(result.stats.summary())
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
    p.add_argument("--format", choices=["f32", "i16", "i24", "i32"], default="f32")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' renders with the plain PyTorch mix)")
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
