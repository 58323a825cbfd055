"""MIDI note model — mirrors src/core/midi.{h,cpp} and src/engine/midi_data.

Notes are kept sorted by ``min_time`` (beat units). ``flags`` carries the
reference's bitfield (midi.h:16).
"""

from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass, field


class MidiNoteFlags(enum.IntFlag):
    NONE = 0
    MUTED = 1 << 0
    SELECTED = 1 << 1
    MODIFIED = 1 << 2
    DELETED = 1 << 3


@dataclass
class MidiNote:
    min_time: float = 0.0  # beats
    max_time: float = 0.0  # beats
    meta_id: int = 0
    key: int = 60
    flags: int = 0
    velocity: float = 1.0


@dataclass
class MidiCCEvent:
    """Control-change event (event.h:48-52 MidiEvent::control_change).

    ``value`` is normalized to [0, 1] (data / 127)."""

    time: float = 0.0  # beats
    controller: int = 0  # 0-127
    value: float = 0.0
    channel: int = 0


@dataclass
class MidiPolyPressureEvent:
    """Polyphonic key pressure (event.h:53-57 MidiEvent::poly_pressure).

    ``pressure`` is normalized to [0, 1]."""

    time: float = 0.0  # beats
    key: int = 60
    pressure: float = 0.0
    channel: int = 0


#: midi_data.h:11 — highest representable key (+1) in the reference editor.
MAX_KEYS = 132


class MidiNoteBuffer:
    """Sorted note sequence + min/max metadata (midi_data.h:9-39).

    Also carries the non-note channel events the reference's MidiEvent
    union models (event.h:41-62): control changes (``cc``) and polyphonic
    pressure (``poly_pressure``), both time-sorted in beat units."""

    def __init__(self, notes: list[MidiNote] | None = None,
                 cc: list[MidiCCEvent] | None = None,
                 poly_pressure: list[MidiPolyPressureEvent] | None = None) -> None:
        self.notes: list[MidiNote] = list(notes or [])
        self.cc: list[MidiCCEvent] = sorted(cc or [], key=lambda e: e.time)
        self.poly_pressure: list[MidiPolyPressureEvent] = sorted(
            poly_pressure or [], key=lambda e: e.time)
        self.min_note: int = 127
        self.max_note: int = 0
        self.max_length: float = 0.0
        self.num_selected: int = 0
        self.create_metadata()

    def create_metadata(self) -> None:
        # monotonically stamps every note edit (Session.edit_stamp uses it
        # to invalidate live previews — track.cpp:289-345's refresh_voice)
        self.version = getattr(self, "version", 0) + 1
        self.notes.sort(key=lambda n: n.min_time)
        for i, n in enumerate(self.notes):
            n.meta_id = i
        if self.notes:
            self.min_note = min(n.key for n in self.notes)
            self.max_note = max(n.key for n in self.notes)
            self.max_length = max(n.max_time for n in self.notes)
        else:
            self.min_note, self.max_note, self.max_length = 127, 0, 0.0

    def add_note(self, note: MidiNote) -> None:
        self.notes.append(note)
        self.create_metadata()

    def update_channel(self, channel: int = 0) -> list[int]:
        """midi_data.cpp:105 MidiData::update_channel — re-sort the sequence
        by (min_time, key, velocity), clear MODIFIED flags and return the
        post-sort ids of the notes that carried them, and refresh the
        min/max-note, max-length and selection-count caches."""
        self.version = getattr(self, "version", 0) + 1
        self.notes.sort(key=lambda n: (n.min_time, n.key, n.velocity))
        modified: list[int] = []
        new_min, new_max = MAX_KEYS, 0
        length = 0.0
        selected = 0
        for i, note in enumerate(self.notes):
            note.meta_id = i
            length = max(length, note.max_time)
            new_min = min(new_min, note.key)
            new_max = max(new_max, note.key)
            if note.flags & MidiNoteFlags.MODIFIED:
                note.flags &= ~MidiNoteFlags.MODIFIED
                modified.append(i)
            if note.flags & MidiNoteFlags.SELECTED:
                selected += 1
        self.max_length = length
        self.min_note = new_min
        self.max_note = new_max
        self.num_selected = selected
        return modified

    def find_note(self, pos: float, key: int, channel: int = 0) -> int | None:
        """midi_data.cpp:52 — first note with min_time <= pos < max_time and
        a key match; None when nothing is hit."""
        for i, note in enumerate(self.notes):
            if note.min_time <= pos < note.max_time and note.key == key:
                return i
        return None

    def find_notes(self, min_pos: float, max_pos: float, min_key: int, max_key: int,
                   channel: int = 0) -> list[int]:
        """midi_data.cpp:68 — ids of notes overlapping the time/key box.
        Early-breaks on min_time > max_pos (the sequence is time-sorted)."""
        out: list[int] = []
        for i, note in enumerate(self.notes):
            if note.max_time < min_pos or note.key < min_key or note.key > max_key:
                continue
            if note.min_time > max_pos:
                break
            out.append(i)
        return out

    def find_first_note(self, time_pos: float, channel: int = 0) -> int:
        """Index of the first note with max_time > time_pos (playback cursor
        seek; mirrors MidiAsset::find_first_note, assets_table.cpp:99)."""
        lo, hi = 0, len(self.notes)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.notes[mid].max_time <= time_pos:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def __len__(self) -> int:
        return len(self.notes)

    def __iter__(self):
        return iter(self.notes)

    def __getitem__(self, i):
        return self.notes[i]
