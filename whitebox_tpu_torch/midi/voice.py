"""MIDI voice allocation + block-accurate note-event carving.

Ports the engine's MIDI pipeline semantics:

- ``MidiVoiceState`` (midi_voice.cpp): up to 64 voices; ``release_voice``
  returns the earliest-ending voice not past the timeout (scan order =
  allocation-list order); ``add_voice`` fails when full (the note is
  skipped, track.cpp:523-527).
- ``carve_midi_events``: the timeline-at-once inversion of
  Track::process_midi_event (track.cpp:453-570): walks the block grid with
  the exact f64 transport math and emits sample-accurate
  (frame, on/off, key, velocity, slot) voice events, including the
  (uint64)%buffer_size frame truncation, note-time mapping
  ``time_offset + note_time * (1/rate)`` with the clip-end cap, muted-note
  and voice-overflow skips, and end-of-clip voice flushes.

Slot numbers mirror TestSynth's lowest-free-bit allocation
(test_synth.cpp:12 countr_one) so per-slot event streams are
non-overlapping — that's what lets the synth render each slot with the same
segment machinery as the audio mix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from whitebox_tpu_torch.midi.notes import MidiNoteFlags
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.transport import BlockTransport

MAX_VOICES = 64


@dataclass
class _Voice:
    max_time: float
    velocity: float
    key: int
    slot: int


class MidiVoiceState:
    """Faithful port of MidiVoiceState (allocation-ordered release scan)."""

    def __init__(self) -> None:
        self.allocated: list[_Voice] = []  # allocation order (front-insert)
        self.free_slots = list(range(MAX_VOICES))

    def add_voice(self, max_time: float, velocity: float, key: int) -> _Voice | None:
        if len(self.allocated) >= MAX_VOICES:
            return None
        slot = min(self.free_slots)  # countr_one: lowest free bit
        self.free_slots.remove(slot)
        v = _Voice(max_time, velocity, key, slot)
        # InplaceList::push_item inserts at the front
        self.allocated.insert(0, v)
        return v

    def release_voice(self, timeout: float) -> _Voice | None:
        if not self.allocated:
            return None
        shortest = self.allocated[0]
        for v in self.allocated[1:]:
            if v.max_time < shortest.max_time and v.max_time <= timeout:
                shortest = v
        if shortest.max_time > timeout:
            return None
        self.allocated.remove(shortest)
        self.free_slots.append(shortest.slot)
        return shortest

    def has_voice(self) -> bool:
        return bool(self.allocated)


@dataclass
class VoiceEvent:
    frame: int  # global output frame
    on: bool
    key: int
    velocity: float
    slot: int
    time: float  # beats (diagnostics)


def carve_midi_events(
    session: Session,
    sample_rate: float,
    buffer_size: int = 512,
    num_blocks: int | None = None,
    playhead_start: float | None = None,
) -> dict[int, list[VoiceEvent]]:
    """Per-track sample-accurate voice events for every MIDI clip.

    Returns {track_index: [VoiceEvent...]} sorted by frame.
    """
    start = session.playhead_start if playhead_start is None else playhead_start
    transport = BlockTransport(float(sample_rate), int(buffer_size), session.beat_duration, start,
                               tempo_map=getattr(session, "tempo_map", None))
    if num_blocks is None:
        num_blocks = max(transport.blocks_for_beats(session.end_time()), 1)
    P = transport.playhead_grid(num_blocks)
    S = transport.sample_position_grid(num_blocks)
    bs = int(buffer_size)

    out: dict[int, list[VoiceEvent]] = {}

    for t_idx, track in enumerate(session.tracks):
        midi_clips = [c for c in track.clips if c.is_midi() and c.midi is not None and c.midi.asset is not None]
        if not midi_clips:
            continue
        events: list[VoiceEvent] = []
        state = MidiVoiceState()

        def frame_of(time_beats: float, k: int) -> int:
            # == beat_to_samples(time - P[k], rate, bd) bit-for-bit when
            # unmapped; the exact tempo-map integral when mapped. Mapped
            # grids have S[k] == k*bs exactly, so trunc(so) IS the global
            # frame — skipping the %bs wrap keeps an event landing exactly
            # on the next block edge at its exact frame instead of a block
            # early (the same half-open contract as the audio carve).
            off = transport.delta_samples(float(P[k]), time_beats)
            so = float(S[k]) + off
            if transport.mapped:
                return int(so) if so > 0 else 0
            return k * bs + ((int(so) if so > 0 else 0) % bs)

        # which clip index is next (fresh playback state, find_next_clip)
        ci = track.find_next_clip(float(P[0]))
        if ci is None:
            continue
        note_idx = 0
        partially_ended = False
        first = True

        k = 0
        clips = track.clips
        while k < num_blocks and ci is not None and ci < len(clips):
            start_time = float(P[k])
            end_time = float(P[k + 1])
            # --- process_event walk for this block (MIDI branches only) ---
            while ci < len(clips):
                clip = clips[ci]
                # mapped ownership is half-open [start, end): a clip starting
                # exactly at the block edge waits for its own block (closed
                # ownership would reset note_idx in BOTH blocks and
                # double-emit every note — see oracle._process_event)
                if (clip.min_time >= end_time) if transport.mapped else (clip.min_time > end_time):
                    break
                if clip.is_midi() and clip.midi is not None and clip.midi.asset is not None:
                    if clip.min_time >= start_time:
                        note_idx = clip.midi.asset.find_first_note(clip.start_offset, 0)
                    elif start_time > clip.min_time and not partially_ended:
                        note_idx = clip.midi.asset.find_first_note(
                            (start_time - clip.min_time) + clip.start_offset, 0
                        )
                    seg_end = min(clip.max_time, end_time)
                    note_idx = _process_midi_block(
                        clip, state, events, note_idx,
                        start_time, seg_end if clip.max_time <= end_time else end_time,
                        k, frame_of,
                    )
                if clip.max_time <= end_time:
                    partially_ended = False
                    ci += 1
                else:
                    partially_ended = True
                    break
                first = False
            k += 1
            # ci may be len(clips): done
            if ci is not None and ci < len(clips) and clips[ci].min_time > float(P[-1]):
                break

        # final flush at render end (engine stop kills voices)
        while True:
            v = state.release_voice(float("inf"))
            if v is None:
                break
            events.append(VoiceEvent(min(frame_of(v.max_time, num_blocks - 1), num_blocks * bs),
                                     False, v.key, v.velocity, v.slot, v.max_time))

        # same-frame ordering: releases precede allocations (the engine
        # releases voices before adding the new note, track.cpp:481-520)
        events.sort(key=lambda e: (e.frame, e.on))
        if events:
            out[t_idx] = events
    return out


def _process_midi_block(clip, state: MidiVoiceState, events, note_idx, start_time, end_time,
                        k, frame_of) -> int:
    """Port of Track::process_midi_event for one block."""
    notes = clip.midi.asset.notes
    time_offset = clip.min_time - clip.start_offset
    mult = 1.0 / float(clip.midi.rate)
    semi = int(clip.midi.transpose)

    while note_idx < len(notes):
        note = notes[note_idx]
        min_time = time_offset + note.min_time * mult
        max_time = min(time_offset + note.max_time * mult, clip.max_time)

        if min_time > end_time or min_time >= clip.max_time:
            break

        # release voices ending before this note starts
        while True:
            v = state.release_voice(min_time)
            if v is None:
                break
            events.append(VoiceEvent(frame_of(v.max_time, k), False, v.key, v.velocity, v.slot, v.max_time))

        if note.flags & MidiNoteFlags.MUTED:
            note_idx += 1
            continue

        v = state.add_voice(max_time, note.velocity, note.key + semi)
        if v is None:  # voice overflow: skip note
            note_idx += 1
            continue

        events.append(VoiceEvent(frame_of(min_time, k), True, v.key, v.velocity, v.slot, min_time))
        note_idx += 1

    while True:
        v = state.release_voice(end_time)
        if v is None:
            break
        events.append(VoiceEvent(frame_of(v.max_time, k), False, v.key, v.velocity, v.slot, v.max_time))

    return note_idx
