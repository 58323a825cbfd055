"""Standard MIDI File parsing — replaces src/core/midi_file.cpp + midi-parser.

Reads format 0/1 SMF, pairs note-on/note-off per key, converts ticks to
beats (ticks / division, matching the reference's tick->beat conversion),
normalizes velocity to [0, 1]. Set-Tempo meta events (FF 51) are collected
as ``MidiNoteBuffer.tempo`` [(beat, bpm), ...] — playback still follows the
session's BPM as in the reference, unless the caller imports them into a
``Session.tempo_map`` (``tempo_map_from_smf`` / ``cli tempo --from-smf``).
"""

from __future__ import annotations

import struct

from whitebox_tpu_torch.midi.notes import (
    MidiCCEvent, MidiNote, MidiNoteBuffer, MidiPolyPressureEvent,
)


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def parse_smf(data: bytes) -> MidiNoteBuffer:
    if data[0:4] != b"MThd":
        raise ValueError("not a Standard MIDI File")
    (hlen,) = struct.unpack_from(">I", data, 4)
    fmt, ntrks, division = struct.unpack_from(">HHH", data, 8)
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    if division == 0:
        raise ValueError("invalid division")

    notes: list[MidiNote] = []
    cc: list[MidiCCEvent] = []
    pp: list[MidiPolyPressureEvent] = []
    tempo: list[tuple[float, float]] = []  # (beat, bpm) from FF 51 metas
    meter: list[tuple[float, int, int]] = []  # (beat, num, den) from FF 58
    pos = 8 + hlen
    for _ in range(ntrks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("missing MTrk chunk")
        (tlen,) = struct.unpack_from(">I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + tlen]
        pos += 8 + tlen

        tick = 0
        p = 0
        running = 0
        active: dict[tuple[int, int], tuple[int, float]] = {}  # (ch, key) -> (start_tick, vel)
        while p < len(body):
            delta, p = _read_varlen(body, p)
            tick += delta
            status = body[p]
            if status & 0x80:
                p += 1
                running = status
            else:
                status = running
            ev = status & 0xF0
            ch = status & 0x0F
            if ev == 0x90:  # note on (vel 0 == off)
                key, vel = body[p], body[p + 1]
                p += 2
                if vel > 0:
                    active[(ch, key)] = (tick, vel / 127.0)
                else:
                    startv = active.pop((ch, key), None)
                    if startv is not None:
                        notes.append(MidiNote(startv[0] / division, tick / division, key=key, velocity=startv[1]))
            elif ev == 0x80:  # note off
                key = body[p]
                p += 2
                startv = active.pop((ch, key), None)
                if startv is not None:
                    notes.append(MidiNote(startv[0] / division, tick / division, key=key, velocity=startv[1]))
            elif ev == 0xB0:  # control change (event.h:48)
                ctrl, val = body[p], body[p + 1]
                p += 2
                cc.append(MidiCCEvent(tick / division, ctrl, val / 127.0, ch))
            elif ev == 0xA0:  # polyphonic key pressure (event.h:53)
                key, val = body[p], body[p + 1]
                p += 2
                pp.append(MidiPolyPressureEvent(tick / division, key, val / 127.0, ch))
            elif ev == 0xE0:  # pitch bend: no engine target (event.h has none)
                p += 2
            elif ev in (0xC0, 0xD0):
                p += 1
            elif status == 0xFF:  # meta
                mtype = body[p]
                p += 1
                ln, p = _read_varlen(body, p)
                if mtype == 0x51 and ln == 3:  # Set Tempo: usec per quarter
                    usec = (body[p] << 16) | (body[p + 1] << 8) | body[p + 2]
                    if usec > 0:
                        tempo.append((tick / division, 60_000_000.0 / usec))
                elif mtype == 0x58 and ln >= 2:  # Time Signature: nn dd cc bb
                    meter.append((tick / division, body[p], 1 << body[p + 1]))
                p += ln
            elif status in (0xF0, 0xF7):  # sysex
                ln, p = _read_varlen(body, p)
                p += ln
            else:
                raise ValueError(f"unhandled MIDI status {status:#x}")
        # unterminated notes end at track end
        for (ch, key), (t0, vel) in active.items():
            notes.append(MidiNote(t0 / division, tick / division, key=key, velocity=vel))

    buf = MidiNoteBuffer(notes, cc=cc, poly_pressure=pp)
    # later-wins at equal beats: dedup in FILE order first (two metas at
    # the same tick = an override, the last one is live), then sort
    buf.tempo = sorted({b: (b, v) for b, v in tempo}.values())
    buf.meter = sorted({b: (b, n, d) for b, n, d in meter}.values())
    return buf


def meter_map_from_smf(buf) -> "object | None":
    """Build a :class:`whitebox_tpu_torch.core.meter.MeterMap` from a parsed
    buffer's Time-Signature metas. SMF stamps them at beat positions; DAW
    meter changes live on bar boundaries, so each event is assigned the
    bar its beat position lands on (cumulatively, in file order). Returns
    None when the file carries no time-signature events."""
    meter = getattr(buf, "meter", None)
    if not meter:
        return None
    from whitebox_tpu_torch.core.meter import MeterMap, MeterPoint

    pts = []
    bar0, beat0, bpb = 0, 0.0, 4.0
    for beat, num, den in meter:
        bar = bar0 + int(round((beat - beat0) / bpb))
        pts.append(MeterPoint(max(bar, 0), int(num), int(den)))
        bar0, beat0, bpb = max(bar, 0), beat, num * (4.0 / den)
    m = MeterMap(pts)
    return None if m.is_default else m


def tempo_map_from_smf(buf) -> "object | None":
    """Build a :class:`whitebox_tpu_torch.core.tempo.TempoMap` from a parsed
    buffer's Set-Tempo metas (step curves — SMF tempo is stepwise).
    Returns None when the file carries no tempo events."""
    tempo = getattr(buf, "tempo", None)
    if not tempo:
        return None
    from whitebox_tpu_torch.core.tempo import TempoMap, TempoPoint

    return TempoMap([TempoPoint(b, v, "step") for b, v in tempo])


def load_notes_from_file(path) -> MidiNoteBuffer:
    """midi_file.cpp:19 load_notes_from_file equivalent."""
    with open(path, "rb") as f:
        return parse_smf(f.read())


def write_smf(notes: MidiNoteBuffer, path, division: int = 480,
              tempo: "list[tuple[float, float]] | None" = None,
              meter: "list[tuple[float, int, int]] | None" = None) -> None:
    """Minimal SMF format-0 writer (round-trip/testing) — notes plus the
    CC / poly-pressure events the buffer carries, optional Set-Tempo
    metas as (beat, bpm) pairs (defaults to the buffer's own ``tempo``;
    a TempoMap's step points export losslessly, ramps export their
    anchor BPMs), and optional Time-Signature metas as (beat, num, den)
    (defaults to the buffer's own ``meter``)."""
    events = []
    for n in notes:
        events.append((int(round(n.min_time * division)), 0x90, n.key, max(1, int(round(n.velocity * 127)))))
        events.append((int(round(n.max_time * division)), 0x80, n.key, 64))
    for e in getattr(notes, "cc", []):
        events.append((int(round(e.time * division)), 0xB0 | (e.channel & 0x0F),
                       e.controller, int(round(e.value * 127))))
    for e in getattr(notes, "poly_pressure", []):
        events.append((int(round(e.time * division)), 0xA0 | (e.channel & 0x0F),
                       e.key, int(round(e.pressure * 127))))
    if tempo is None:
        tempo = getattr(notes, "tempo", None) or []
    for beat, bpm in tempo:
        usec = max(1, min(0xFFFFFF, int(round(60_000_000.0 / float(bpm)))))
        events.append((int(round(float(beat) * division)), 0xFF,
                       bytes([0x51, 0x03, (usec >> 16) & 0xFF, (usec >> 8) & 0xFF, usec & 0xFF]), 0))
    if meter is None:
        meter = getattr(notes, "meter", None) or []
    for beat, num, den in meter:
        dd = max(0, int(den).bit_length() - 1)  # den == 1 << dd
        events.append((int(round(float(beat) * division)), 0xFF,
                       bytes([0x58, 0x04, int(num) & 0xFF, dd, 24, 8]), 0))
    events.sort(key=lambda e: (e[0], 0 if e[1] == 0xFF else 1, e[1] if isinstance(e[1], int) else 0))

    body = bytearray()
    last = 0
    for tick, status, key, vel in events:
        delta = tick - last
        last = tick
        chunk = bytearray()
        while True:
            chunk.insert(0, delta & 0x7F)
            delta >>= 7
            if not delta:
                break
        for i in range(len(chunk) - 1):
            chunk[i] |= 0x80
        if status == 0xFF:  # meta event: key carries the payload bytes
            body += chunk + bytes([0xFF]) + key
        else:
            body += chunk + bytes([status, key, vel])
    body += b"\x00\xff\x2f\x00"  # end of track

    blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
    blob += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
