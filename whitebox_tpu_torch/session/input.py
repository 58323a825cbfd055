"""Input routing for recording — the track_input model.

The reference routes physical capture channels to armed tracks through
three pieces (src/engine/track_input.h:10-45, engine.cpp:142-199,
1638-1648, 1677-1713):

- every track carries a ``TrackInput { type, index }`` (None / Midi /
  ExternalStereo / ExternalMono) packed into a u32 as
  ``index & 0xFFFFFF | type << 24`` for grouping and serialization;
- armed tracks sharing the same packed input form a ``TrackInputGroup``,
  so one capture stream feeds *several* simultaneously armed tracks;
- on each audio callback the engine slices the device input buffer per
  group (stereo input i -> channels [2i, 2i+1], mono input i -> channel
  [i]) and the recorder thread fans each group's block to every member
  track's growing sample.

This module is that model without the device: :func:`build_input_groups`
computes the group list from the session's armed tracks, and
:class:`MultiTrackRecording` fans ``record_block([N_capture, n])`` blocks
out to one ``RecordingTake`` per armed track (session/record.py keeps the
reference's 256 KiB chunked-growth contract per take). Physical audio
devices stay out of scope — capture blocks arrive as arrays — but the
routing semantics (grouping, channel slicing, multi-take finalize) match
the reference's recording workflow, punch-in against a live
``render.preview.PreviewStream`` included.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class TrackInputType(IntEnum):
    """track_input.h:10-15 — enum values match for packed-u32 parity."""

    NONE = 0
    MIDI = 1
    EXTERNAL_STEREO = 2
    EXTERNAL_MONO = 3


@dataclass(frozen=True)
class TrackInput:
    """One track's input assignment (track_input.h:17-30).

    ``index`` addresses the capture stream: ExternalStereo ``i`` reads
    channels ``[2i, 2i+1]`` of the capture block, ExternalMono ``i`` reads
    channel ``[i]`` (engine.cpp:1642-1645).
    """

    type: TrackInputType = TrackInputType.NONE
    index: int = 0

    def as_packed_u32(self) -> int:
        """track_input.h:20-22 — byte-compatible packing."""
        return (int(self.index) & 0xFFFFFF) | ((int(self.type) & 0xFF) << 24)

    @staticmethod
    def from_packed_u32(u32: int) -> "TrackInput":
        return TrackInput(TrackInputType((int(u32) >> 24) & 0xFF),
                          int(u32) & 0xFFFFFF)

    @property
    def channels(self) -> int:
        """Capture width this input consumes (engine.cpp:1681)."""
        return 1 if self.type == TrackInputType.EXTERNAL_MONO else 2

    def slice_block(self, capture: np.ndarray) -> np.ndarray:
        """The group's channel slice of a ``[N_capture, n]`` block
        (engine.cpp:1642-1645)."""
        if self.type == TrackInputType.EXTERNAL_STEREO:
            lo = 2 * int(self.index)
            if lo + 2 > capture.shape[0]:
                raise ValueError(
                    f"stereo input {self.index} needs capture channels "
                    f"[{lo},{lo + 1}] but the block has {capture.shape[0]}")
            return capture[lo : lo + 2]
        if self.type == TrackInputType.EXTERNAL_MONO:
            i = int(self.index)
            if i >= capture.shape[0]:
                raise ValueError(
                    f"mono input {i} out of range for a "
                    f"{capture.shape[0]}-channel capture block")
            return capture[i : i + 1]
        raise ValueError(f"input type {self.type!r} carries no audio")


@dataclass
class InputGroup:
    """One distinct packed input + the armed tracks draining it
    (track_input.h:40-44 TrackInputGroup)."""

    input: TrackInput
    track_indices: list[int]


def build_input_groups(session) -> list[InputGroup]:
    """Group the session's ARMED tracks by packed input, insertion-ordered
    (the engine maintains track_input_groups incrementally in
    set_track_input, engine.cpp:147-199; recomputing from session state is
    the offline-equivalent — same grouping, no linked-list bookkeeping).
    Only external audio inputs form groups; Midi/None tracks don't record
    audio (the recorder write switch, engine.cpp:1642-1646)."""
    groups: dict[int, InputGroup] = {}
    for i, tr in enumerate(session.tracks):
        inp = getattr(tr, "input", None)
        if inp is None or not getattr(tr, "armed", False):
            continue
        if inp.type not in (TrackInputType.EXTERNAL_STEREO,
                            TrackInputType.EXTERNAL_MONO):
            continue
        key = inp.as_packed_u32()
        if key not in groups:
            groups[key] = InputGroup(inp, [])
        groups[key].track_indices.append(i)
    return list(groups.values())


class MultiTrackRecording:
    """One recording pass over every armed track: the record() ->
    write_recorded_samples_ -> stop_record lifecycle (engine.cpp:96-140,
    1677-1702) as an explicit object.

    ``record_block`` accepts the full ``[N_capture, n]`` capture block and
    fans each input group's channel slice to every member track's
    :class:`~whitebox_tpu_torch.session.record.RecordingTake` — several armed
    tracks on the same input receive identical audio, tracks on different
    inputs record different slices, all from ONE stream. ``finalize``
    truncates + registers + places one clip per take and disarms.
    """

    def __init__(self, session, sample_rate: float, at_beat: float,
                 name_prefix: str = "") -> None:
        self.session = session
        self.sample_rate = float(sample_rate)
        self.at_beat = float(at_beat)
        self.groups = build_input_groups(session)
        if not self.groups:
            raise ValueError("no armed track has an external input assigned")
        self.takes: dict[int, object] = {}
        for g in self.groups:
            for ti in g.track_indices:
                tr = session.tracks[ti]
                nm = f"{name_prefix}{tr.name}" if name_prefix else ""
                self.takes[ti] = session.start_recording(
                    tr, self.sample_rate, at_beat=self.at_beat,
                    channels=g.input.channels, name=nm)
        self._capture_min = max(
            (2 * g.input.index + 2 if g.input.type == TrackInputType.EXTERNAL_STEREO
             else g.input.index + 1)
            for g in self.groups)

    @property
    def capture_channels_required(self) -> int:
        """Minimum capture-block width the assigned inputs address."""
        return self._capture_min

    @property
    def frames_written(self) -> int:
        return max((t.frames_written for t in self.takes.values()), default=0)

    def record_block(self, capture) -> int:
        """Ingest one ``[N_capture, n]`` f32 capture block; returns frames
        written so far. Each group slices its channels once and every
        member take appends the same view (engine.cpp:1677-1702)."""
        capture = np.atleast_2d(np.asarray(capture, dtype=np.float32))
        if capture.shape[0] < self._capture_min:
            raise ValueError(
                f"capture block has {capture.shape[0]} channels; assigned "
                f"inputs address {self._capture_min}")
        for g in self.groups:
            sl = g.input.slice_block(capture)
            for ti in g.track_indices:
                self.takes[ti].append(sl)
        return self.frames_written

    def cancel(self) -> None:
        for t in self.takes.values():
            t.cancel()

    def finalize(self) -> list:
        """stop_record (engine.cpp:107-140): every take truncates,
        registers its sample, and places its clip; armed tracks disarm
        (input assignments persist — re-arming records again)."""
        clips = []
        for ti, take in self.takes.items():
            clips.append(take.finalize())
            self.session.tracks[ti].armed = False
        return clips
