"""Command-line interface of the port: offline render, stems, container
conversion, loudness, clip stretch, track freeze, peak mipmaps, inspection
and tempo edits.

Counterpart of ``whitebox_tpu/cli.py``, every command; each command that
renders or measures takes ``--device`` (default: the CUDA card). Outputs
ending in .mp3/.ogg/.flac go through the codec runtime (``io/codec.py``)
with the encode flags (``--bitrate-mode``, ``--bitrate``,
``--min-bitrate``, ``--max-bitrate``, ``--vbr-quality``, ``--flac-level``,
``--no-tags``, ``--tag-title``, ``--tag-artist``, ``--tag-comment``).
The settings file (``config.py::Settings``, ``settings.json`` under
``$XDG_CONFIG_HOME/whitebox_tpu_torch/``) gives the defaults of
``--rate``, ``--buffer-size``, ``--engine``, ``--interpolation``,
``--chunk-frames`` and ``--fast-sum``; a flag on the command line wins:

    python -m whitebox_tpu_torch.cli [-v] render project.wb out.wav \\
        [--rate 48000] [--buffer-size 512] [--format f32] [--device cuda]
        [--effects-mode scan|fir] [--engine auto|pallas|xla] [--chunk-frames N]
        [--fast-sum] [--pdc] [--interpolation linear|catmull|sinc]
        [--no-prerender] [--meters] [--dither none|tpdf|tpdf-hp]
        [--tail SECONDS] [--from-beat B | --from-bar B] [--to-beat B | --to-bar B]
        [--loudness] [--normalize-lufs LUFS | --normalize-peak DBTP]
        [ENCODE FLAGS] [--profile DIR] [--json]
    python -m whitebox_tpu_torch.cli stems project.wb outdir [--buses] [--rate 48000]
        [--buffer-size 512] [--format f32] [--ext wav|flac|mp3|ogg]
        [--interpolation linear|catmull|sinc] [ENCODE FLAGS]
    python -m whitebox_tpu_torch.cli convert in.aiff out.flac [--rate R] [--format f32]
        [ENCODE FLAGS]
    python -m whitebox_tpu_torch.cli loudness audio.wav [--host] [--json]
    python -m whitebox_tpu_torch.cli stretch project.wb --track T --clip C --ratio R
        [--resample] [--out other.wb]
    python -m whitebox_tpu_torch.cli freeze project.wb --track T [--track T2] [--unfreeze]
        [--rate 48000] [--out other.wb]
    python -m whitebox_tpu_torch.cli peaks audio.wav out.npz [--quality low|high]
    python -m whitebox_tpu_torch.cli inspect project.wb
    python -m whitebox_tpu_torch.cli tempo project.wb [--out other.wb] [--set-bpm BPM]
        [--point BEAT:BPM[:CURVE[:BPM_END]]] [--remove BEAT] [--meter BAR:NUM/DEN]
        [--remove-meter BAR] [--from-smf FILE.mid]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from whitebox_tpu_torch.config import Settings


def _add_encode_flags(p) -> None:
    """Compressed-export properties (export_prop.h:8-45 parity) for
    .mp3/.ogg/.flac outputs; ignored for WAV (``whitebox_tpu/cli.py:20-43``)."""
    p.add_argument("--bitrate-mode", choices=["cbr", "abr", "vbr"], default="cbr",
                   help="compressed-codec rate control (ExportBitrateMode)")
    p.add_argument("--bitrate", type=int, default=192, metavar="KBPS",
                   help="CBR/ABR target bitrate (mp3_bitrate/vorbis_bitrate)")
    p.add_argument("--min-bitrate", type=int, default=0, metavar="KBPS",
                   help="ABR floor (vorbis managed mode; FFmpeg's libmp3lame "
                        "wrapper doesn't expose LAME's ABR bounds)")
    p.add_argument("--max-bitrate", type=int, default=0, metavar="KBPS",
                   help="ABR ceiling (vorbis managed mode; best-effort for mp3)")
    p.add_argument("--vbr-quality", type=float, default=100.0, metavar="Q",
                   help="VBR quality 0..100, 100 = best (mp3_vbr_quality)")
    p.add_argument("--flac-level", type=int, default=-1, metavar="N",
                   help="FLAC compression level 0..12 (flac_compression_level)")
    p.add_argument("--no-tags", action="store_true",
                   help="skip container metadata tags (export_metadata=false)")
    p.add_argument("--tag-title", default=None)
    p.add_argument("--tag-artist", default=None)
    p.add_argument("--tag-comment", default=None)


def _encode_opts(args, session=None):
    """``EncodeOptions`` from the flags; the session's project info fills
    the tags not given (the reference's export_metadata writes project
    info; ``whitebox_tpu/cli.py:46-70``)."""
    from whitebox_tpu_torch.io.codec import EncodeOptions

    info = getattr(session, "project_info", None)
    title, artist, comment = args.tag_title, args.tag_artist, args.tag_comment
    if not args.no_tags and info is not None:
        title = title if title is not None else (info.title or None)
        artist = artist if artist is not None else (info.author or None)
        comment = comment if comment is not None else (info.description or None)
    return EncodeOptions(
        bitrate_mode=args.bitrate_mode, bitrate=args.bitrate, min_bitrate=args.min_bitrate,
        max_bitrate=args.max_bitrate, vbr_quality=args.vbr_quality,
        flac_compression_level=args.flac_level,
        bit_depth={"i16": 16, "i24": 24, "i32": 32}.get(args.format, 0),
        title=None if args.no_tags else title,
        artist=None if args.no_tags else artist,
        comment=None if args.no_tags else comment,
    )


def _profiler(trace_dir):
    """``--profile DIR``: a ``torch.profiler`` trace of the render (the
    card's kernels where there is one), written to DIR as Chrome trace JSON
    (the JAX package writes an xprof trace there)."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts, on_trace_ready=lambda p: p.export_chrome_trace(
        os.path.join(trace_dir, "render.pt.trace.json")))


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
    from whitebox_tpu_torch.log import get_logger
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.session.project import read_project

    log = get_logger("cli")
    session = read_project(args.project)
    log.info("loaded %s: %d tracks, %d clips", args.project, len(session.tracks), session.num_clips())
    fmt = _fmt(args.format)
    num_blocks, trim_frames = _range(session, args)
    normalize = (("lufs", args.normalize_lufs) if args.normalize_lufs is not None
                 else ("peak", args.normalize_peak) if args.normalize_peak is not None else None)
    if args.profile:
        log.info("profiling to %s", args.profile)
    with _profiler(args.profile):
        result = bounce(session, sample_rate=args.rate, device=args.device,
                        buffer_size=args.buffer_size, num_blocks=num_blocks, trim_frames=trim_frames,
                        tail_seconds=args.tail, effects_mode=args.effects_mode, engine=args.engine,
                        chunk_frames=args.chunk_frames, strict_order=not args.fast_sum, pdc=args.pdc,
                        interpolation=args.interpolation,
                        prerender=False if args.no_prerender else None, meters=args.meters,
                        loudness=args.loudness, normalize=normalize,
                        out_path=args.out, out_format=fmt,
                        out_dither=None if args.dither == "none" else args.dither,
                        out_encode=_encode_opts(args, session))
    print(result.stats.summary())
    if args.loudness and result.stats.loudness is not None:
        _print_loudness("  loudness:", result.stats.loudness, result.frames, result.stats.sample_rate)
    if args.meters:
        _print_meters(session, result.stats)
    if args.json:
        blob = {"frames": result.frames, "rtf": result.stats.rtf,
                "msamples_per_sec": result.stats.msamples_per_sec, "device": result.stats.device}
        if result.stats.loudness is not None:
            blob["loudness"] = result.stats.loudness.as_dict()
        print(json.dumps(blob))
    return 0


def _print_loudness(head: str, lu, frames: int, sample_rate: float) -> None:
    """The R128 readings on one line (``whitebox_tpu/cli.py:143-153,270-277``)."""
    print(f"{head} I {lu.integrated_lufs:+.1f} LUFS  "
          f"M max {lu.momentary_max_lufs:+.1f}  S max {lu.shortterm_max_lufs:+.1f}  "
          f"LRA {lu.lra_lu:.1f} LU  TP {lu.true_peak_dbtp:+.1f} dBTP")
    if frames < int(10.0 * sample_rate):
        # BS.1770-4 gating uses fixed 400 ms / 75 %-overlap blocks; on
        # short program material the block phase alone legitimately
        # moves I by ~0.2 LU (spec behavior, ops/loudness.py tests)
        print("  note: program < 10 s — integrated loudness of short "
              "material varies ~0.2 LU with gating-block phase (BS.1770)")


_FORMATS = ("f32", "i16", "i24", "i32")


def _fmt(name: str):
    from whitebox_tpu_torch.core.formats import AudioFormat

    return {"f32": AudioFormat.F32, "i16": AudioFormat.I16, "i24": AudioFormat.I24,
            "i32": AudioFormat.I32}[name]


def _cmd_stems(args) -> int:
    from whitebox_tpu_torch.render.bounce import write_audio
    from whitebox_tpu_torch.render.stems import render_bus_stems, render_stems
    from whitebox_tpu_torch.session.project import read_project

    session = read_project(args.project)
    os.makedirs(args.outdir, exist_ok=True)
    fmt, rate = _fmt(args.format), int(args.rate)
    enc = _encode_opts(args, session)

    def sanitize(n, fallback):
        return "".join(c if c.isalnum() or c in "-_" else "_" for c in n) or fallback

    if args.buses:
        direct, bus, names = render_bus_stems(session, sample_rate=args.rate, buffer_size=args.buffer_size,
                                              interpolation=args.interpolation, device=args.device)
        write_audio(os.path.join(args.outdir, f"00_direct.{args.ext}"), direct, rate, fmt, encode=enc)
        for i, name in enumerate(names):
            write_audio(os.path.join(args.outdir, f"{i + 1:02d}_{sanitize(name, 'bus')}.{args.ext}"),
                        bus[i], rate, fmt, encode=enc)
        print(f"wrote direct + {len(names)} bus stems ({direct.shape[1]} frames) -> {args.outdir}")
        return 0

    stems, names = render_stems(session, sample_rate=args.rate, buffer_size=args.buffer_size,
                                interpolation=args.interpolation, device=args.device)
    for i, name in enumerate(names):
        write_audio(os.path.join(args.outdir, f"{i:02d}_{sanitize(name, 'track')}.{args.ext}"),
                    stems[i], rate, fmt, encode=enc)
    print(f"wrote {len(names)} stems ({stems.shape[2]} frames) -> {args.outdir}")
    return 0


def _load_f32(path):
    """Decode any supported container and normalize to f32 planar."""
    from whitebox_tpu_torch.core.formats import normalize_unclamped
    from whitebox_tpu_torch.io.wav import load_audio_file

    planar, info = load_audio_file(path)
    return np.asarray(normalize_unclamped(np.asarray(planar), info.format), dtype=np.float32), info


def _cmd_convert(args) -> int:
    """Container conversion, with a windowed-sinc rate change on the
    device when ``--rate`` differs (``whitebox_tpu/cli.py:227-241``)."""
    from whitebox_tpu_torch.render.bounce import write_audio

    f32, info = _load_f32(args.src)
    rate = int(args.rate) if args.rate else info.sample_rate
    if rate != info.sample_rate:
        from whitebox_tpu_torch.ops.resample import resample_audio

        f32 = resample_audio(f32, info.sample_rate, rate, device=args.device)
    write_audio(args.out, f32, rate, _fmt(args.format), encode=_encode_opts(args))
    print(f"{args.src} [{info.format.name} {info.channels}ch {info.sample_rate}Hz {info.count}f] -> {args.out}")
    return 0


def _cmd_stretch(args) -> int:
    from whitebox_tpu_torch.session.project import read_project, write_project

    session = read_project(args.project)
    session.stretch_clip(args.track, args.clip, args.ratio, preserve_pitch=not args.resample,
                         device=args.device)
    c = session.tracks[args.track].clips[args.clip]
    mode = "resample (pitch follows)" if args.resample else "phase vocoder (pitch constant)"
    print(f"stretched track {args.track} clip {args.clip} x{args.ratio:g} "
          f"[{mode}] -> [{c.min_time:g}, {c.max_time:g}] beats")
    write_project(session, args.out or args.project)
    return 0


def _cmd_loudness(args) -> int:
    """EBU R128 measurement of an audio FILE (the render-side measurement
    is ``render --loudness``)."""
    from whitebox_tpu_torch.ops.loudness import measure_loudness, measure_loudness_reference

    f32, info = _load_f32(args.src)
    if args.host:
        st = measure_loudness_reference(f32, float(info.sample_rate))
    else:
        st = measure_loudness(f32, float(info.sample_rate), device=args.device)
    if args.json:
        print(json.dumps({"file": str(args.src), "sample_rate": info.sample_rate,
                          "channels": info.channels, **st.as_dict()}))
    else:
        _print_loudness(f"{args.src}:", st, f32.shape[1], float(info.sample_rate))
    return 0


def _cmd_freeze(args) -> int:
    from whitebox_tpu_torch.session.project import read_project, write_project

    session = read_project(args.project)
    for slot in args.track:
        if args.unfreeze:
            session.unfreeze_track(slot)
            print(f"unfroze track {slot} ({session.tracks[slot].name})")
        else:
            session.freeze_track(slot, float(args.rate), device=args.device)
            print(f"froze track {slot} ({session.tracks[slot].name})")
    write_project(session, args.out or args.project)
    return 0


def _cmd_peaks(args) -> int:
    from whitebox_tpu_torch.ops.peaks import build_mipmaps
    from whitebox_tpu_torch.session.sample import Sample

    sample = Sample.load_file(args.audio)
    mips = build_mipmaps(sample, quality=args.quality, device=args.device)
    payload = {f"mip{i}_{m.mip_level}": m.data for i, m in enumerate(mips.levels)}
    np.savez(args.out, **payload)
    print(f"wrote {len(mips.levels)} mip levels for {sample.count} frames x {sample.channels}ch -> {args.out}")
    return 0


def _cmd_inspect(args) -> int:
    from whitebox_tpu_torch.session.project import read_project

    session = read_project(args.project)
    info = {
        "bpm": session.bpm,
        "title": session.project_info.title,
        "tracks": [
            {
                "name": t.name,
                "volume_db": t.volume_db,
                "pan": t.pan,
                "mute": t.mute,
                **({"output_bus": t.output_bus} if t.output_bus is not None else {}),
                **({"sends": [{"bus": s.bus, "gain_db": s.gain_db, "pre": s.pre_fader,
                               **({"sc": True} if s.sidechain else {})}
                              for s in t.sends]} if t.sends else {}),
                "clips": [
                    {
                        "name": c.name,
                        "type": c.type.name,
                        "start": c.min_time,
                        "end": c.max_time,
                        "offset": c.start_offset,
                    }
                    for c in t.clips
                ],
            }
            for t in session.tracks
        ],
        "samples": [a.sample.name for a in session.sample_table.samples.values()],
        "end_time_beats": session.end_time(),
    }
    if session.buses:
        info["buses"] = [
            {"name": b.name, "volume_db": b.volume_db, "pan": b.pan, "mute": b.mute,
             "effects": len(b.effects or [])}
            for b in session.buses
        ]
    if session.tempo_map is not None:
        info["tempo_map"] = session.tempo_map.as_dict()["points"]
    if session.meter_map is not None:
        info["meter_map"] = session.meter_map.as_dict()["points"]
        info["end_position"] = session.meter_map.label(session.end_time())
    print(json.dumps(info, indent=2))
    return 0


def _cmd_tempo(args) -> int:
    """Edit the project tempo map (add/remove points, set session bpm)."""
    from whitebox_tpu_torch.session.project import read_project, write_project

    session = read_project(args.project)
    if args.set_bpm is not None:
        session.set_bpm(args.set_bpm)
    if args.from_smf:
        from whitebox_tpu_torch.midi.smf import (
            load_notes_from_file, meter_map_from_smf, tempo_map_from_smf,
        )

        buf = load_notes_from_file(args.from_smf)
        tm = tempo_map_from_smf(buf)
        mm = meter_map_from_smf(buf)
        if tm is None and mm is None:
            raise ValueError(f"{args.from_smf} carries no tempo/time-signature events")
        if tm is not None:
            session.tempo_map = None
            session.set_bpm(tm.bpm_at(0.0))
            session.tempo_map = None if tm.is_constant else tm
        if mm is not None:
            session.meter_map = mm
    for spec in args.point or []:
        parts = spec.split(":")
        if len(parts) not in (2, 3, 4):
            raise ValueError(f"bad --point {spec!r}: expected BEAT:BPM[:CURVE[:BPM_END]]")
        session.set_tempo_point(float(parts[0]), float(parts[1]),
                                parts[2] if len(parts) >= 3 else "step",
                                float(parts[3]) if len(parts) == 4 else None)
    for beat in args.remove or []:
        session.remove_tempo_point(float(beat))
    for spec in args.meter or []:
        bar, _, sig = spec.partition(":")
        num, _, den = sig.partition("/")
        if not (bar and num and den):
            raise ValueError(f"bad --meter {spec!r}: expected BAR:NUM/DEN")
        session.set_meter(int(bar), int(num), int(den))
    for bar in args.remove_meter or []:
        session.remove_meter(int(bar))
    write_project(session, args.out or args.project)
    pts = (session.tempo_map.as_dict()["points"]
           if session.tempo_map is not None else [])
    blob = {"bpm": session.bpm, "tempo_map": pts}
    if session.meter_map is not None:
        blob["meter_map"] = session.meter_map.as_dict()["points"]
    print(json.dumps(blob, indent=2))
    return 0


def main(argv=None) -> int:
    cfg = Settings.load()  # the defaults of the render flags
    rate = float(cfg.sample_rate)
    parser = argparse.ArgumentParser(prog="whitebox-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline-bounce a .wb project to WAV")
    p.add_argument("project")
    p.add_argument("out")
    p.add_argument("--rate", type=float, default=rate)
    p.add_argument("--buffer-size", type=int, default=cfg.buffer_size,
                   help="emulated engine block size (event semantics)")
    p.add_argument("--chunk-frames", type=int, default=cfg.chunk_frames,
                   help="frames per chunk of the gather path (engine xla, or auto's fallback)")
    p.add_argument("--format", choices=_FORMATS, default="f32")
    p.add_argument("--fast-sum", action="store_true", default=not cfg.strict_order,
                   help="gather path: sum the tracks in one torch.sum (order not fixed, not bit-parity; "
                        "the default where the settings' strict_order is false)")
    p.add_argument("--engine", choices=["auto", "pallas", "xla"], default=cfg.engine,
                   help="auto: the CUDA mix kernel, the gather mix where the slot plan cannot hold "
                        "the session; pallas: the kernel only; xla: the gather mix")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' renders with the plain PyTorch mix)")
    p.add_argument("--effects-mode", choices=["scan", "fir"], default="scan",
                   help="effect-chain finisher: biquad scan (default) or FFT-FIR")
    p.add_argument("--interpolation", choices=["linear", "catmull", "sinc"], default=cfg.interpolation,
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
    p.add_argument("--loudness", action="store_true",
                   help="EBU R128 measurement of the output (integrated LUFS, "
                        "momentary/short-term max, LRA, true peak dBTP)")
    p.add_argument("--normalize-lufs", type=float, default=None, metavar="LUFS",
                   help="scale the output to an integrated-loudness target "
                        "(delivery-spec normalization, e.g. -14)")
    p.add_argument("--normalize-peak", type=float, default=None, metavar="DBTP",
                   help="scale the output so the oversampled TRUE peak hits "
                        "the target (e.g. -1.0)")
    _add_encode_flags(p)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the render (Chrome trace JSON) into DIR")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_render)

    device_help = "torch device (default: cuda; 'cpu' runs the plain PyTorch versions)"
    p = sub.add_parser("stems", help="render each track to its own post-fader file")
    p.add_argument("project")
    p.add_argument("outdir")
    p.add_argument("--rate", type=float, default=rate)
    p.add_argument("--buffer-size", type=int, default=cfg.buffer_size)
    p.add_argument("--format", choices=_FORMATS, default="f32")
    p.add_argument("--ext", choices=["wav", "flac", "mp3", "ogg"], default="wav")
    p.add_argument("--interpolation", choices=["linear", "catmull", "sinc"], default=cfg.interpolation)
    _add_encode_flags(p)
    p.add_argument("--buses", action="store_true",
                   help="export bus stems (pre-master routed components: "
                        "direct track sum + each bus post-chain/post-fader)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_stems)

    p = sub.add_parser("convert", help="convert between audio containers (wav/aiff/mp3/ogg/flac)")
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--rate", type=int, default=None, help="resample to this rate (windowed-sinc)")
    _add_encode_flags(p)
    p.add_argument("--format", choices=_FORMATS, default="f32",
                   help="WAV PCM format (compressed outputs pick their own)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("stretch", help="time-stretch a clip (phase vocoder or resample)")
    p.add_argument("project")
    p.add_argument("--track", type=int, required=True)
    p.add_argument("--clip", type=int, required=True)
    p.add_argument("--ratio", type=float, required=True,
                   help="duration scale (>1 = longer)")
    p.add_argument("--resample", action="store_true",
                   help="classic resample move: pitch follows duration")
    p.add_argument("--out", default=None, help="output .wb (default: in place)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_stretch)

    p = sub.add_parser("loudness", help="EBU R128 measurement of an audio file")
    p.add_argument("src")
    p.add_argument("--host", action="store_true",
                   help="measure on host f64 instead of the device")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_loudness)

    p = sub.add_parser("freeze", help="freeze (bounce-in-place) or unfreeze tracks")
    p.add_argument("project")
    p.add_argument("--track", type=int, action="append", required=True,
                   help="track slot to (un)freeze; repeatable")
    p.add_argument("--unfreeze", action="store_true")
    p.add_argument("--rate", type=float, default=rate)
    p.add_argument("--out", default=None, help="output .wb (default: in place)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_freeze)

    p = sub.add_parser("peaks", help="build waveform min/max peak mipmaps")
    p.add_argument("audio")
    p.add_argument("out")
    p.add_argument("--quality", choices=["low", "high"], default="high")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_peaks)

    p = sub.add_parser("inspect", help="dump a .wb project as JSON")
    p.add_argument("project")
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("tempo", help="edit the project tempo map")
    p.add_argument("project")
    p.add_argument("--out", help="write to a different .wb (default: in place)")
    p.add_argument("--set-bpm", type=float, help="session bpm (beat-0 anchor)")
    p.add_argument("--point", action="append", metavar="BEAT:BPM[:CURVE[:BPM_END]]",
                   help="add/replace a tempo point (CURVE: step|linear; "
                        "BPM_END: explicit linear ramp target, allowing a "
                        "discontinuity at the next point)")
    p.add_argument("--remove", action="append", metavar="BEAT",
                   help="remove the tempo point at BEAT")
    p.add_argument("--meter", action="append", metavar="BAR:NUM/DEN",
                   help="set the time signature from a (0-based) bar onward")
    p.add_argument("--remove-meter", action="append", metavar="BAR",
                   help="remove the time-signature change at BAR")
    p.add_argument("--from-smf", metavar="FILE.mid",
                   help="import tempo + time-signature maps from an SMF")
    p.set_defaults(fn=_cmd_tempo)

    parser.add_argument("-v", "--verbose", action="store_true", help="debug logging")
    args = parser.parse_args(argv)
    from whitebox_tpu_torch.log import configure

    configure(verbose=args.verbose)
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
