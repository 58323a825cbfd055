"""Clip model + pure clip-edit math.

Mirrors src/engine/clip.h (the Audio/Midi tagged union, beat-domain
min/max_time, start_offset in *samples* for audio and *beats* for MIDI,
clip.h:70) and src/engine/clip_edit.h (move/resize/shift math, including the
shift/content-lock and stretch/speed-change resize semantics).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from whitebox_tpu_torch.core.math import beat_to_samples, samples_to_beat

INVALID_CLIP_ID = 0xFFFFFFFF


class ClipType(enum.IntEnum):
    UNKNOWN = 0
    AUDIO = 1
    MIDI = 2


class ClipMode(enum.IntEnum):
    """clip.h:21 — loop modes. The reference enums these but never honors
    them in playback; whitebox_tpu implements ALL FIVE for audio clips as
    extensions (timeline/carve.py pass scheduler + the oracle's stream
    mirror): LOOP_STRAIGHT tiles forward source passes; the REVERSE modes
    play x = (count-1-v) - j*speed backward through the linear-interp path;
    LOOP_BIDIRECTIONAL alternates full forward/reverse passes, each pass
    after the first starting one `speed` step past the turn-around so the
    endpoint frame isn't doubled at the seam."""

    ONE_SHOT = 0
    ONE_SHOT_REVERSE = 1
    LOOP_STRAIGHT = 2
    LOOP_REVERSE = 3
    LOOP_BIDIRECTIONAL = 4


@dataclass
class AudioClipData:
    """clip.h:39 AudioClip. ``asset`` is a session.assets.SampleAsset."""

    asset: object = None
    fade_start: float = 0.0  # beats (applied by this framework; stored-only in reference, §2.9)
    fade_end: float = 0.0
    speed: float = 1.0
    gain: float = 1.0
    #: extension: LOOP_STRAIGHT tiles the source over the clip span
    mode: ClipMode = ClipMode.ONE_SHOT


@dataclass
class MidiClipData:
    """clip.h:47 MidiClip. ``asset`` is a session.assets.MidiAsset."""

    asset: object = None
    length: float = 0.0
    transpose: int = 0
    rate: int = 1
    mode: ClipMode = ClipMode.ONE_SHOT


@dataclass
class Clip:
    id: int = INVALID_CLIP_ID
    type: ClipType = ClipType.UNKNOWN
    name: str = ""
    color: int = 0
    active: bool = True
    deleted: bool = False
    internal_state_changed: bool = False
    min_time: float = 0.0  # beats
    max_time: float = 0.0  # beats
    start_offset: float = 0.0  # samples (audio) / beats (MIDI), clip.h:70
    audio: Optional[AudioClipData] = None
    midi: Optional[MidiClipData] = None

    def is_audio(self) -> bool:
        return self.type == ClipType.AUDIO

    def is_midi(self) -> bool:
        return self.type == ClipType.MIDI

    @property
    def length(self) -> float:
        return self.max_time - self.min_time

    def asset_sample_rate(self) -> float:
        assert self.is_audio() and self.audio.asset is not None
        return float(self.audio.asset.sample.sample_rate)

    def clone(self) -> "Clip":
        c = replace(self)
        if self.audio is not None:
            c.audio = replace(self.audio)
        if self.midi is not None:
            c.midi = replace(self.midi)
        return c


@dataclass
class ClipMoveResult:
    min: float
    max: float


@dataclass
class ClipResizeResult:
    min: float
    max: float
    start_offset: float
    speed: float


def calc_move_clip(clip: Clip, relative_pos: float, min_move: float = 0.0) -> ClipMoveResult:
    """clip_edit.h:10 — clamp move at min_move, preserve length."""
    new_pos = max(clip.min_time + relative_pos, min_move)
    return ClipMoveResult(new_pos, new_pos + (clip.max_time - clip.min_time))


def calc_resize_clip(
    clip: Clip,
    relative_pos: float,
    resize_limit: float,
    min_length: float,
    min_resize_pos: float,
    beat_duration: float,
    is_min: bool,
    shift: bool = False,
    stretch: bool = False,
    clamp_at_resize_pos: bool = False,
) -> ClipResizeResult:
    """clip_edit.h:18-126 — right/left-edge resize with shift & stretch modes."""
    if not is_min:
        old_max = clip.max_time
        actual_min_length = resize_limit + min_length - clip.min_time
        new_max = max(clip.max_time + relative_pos, 0.0)
        if new_max - clip.min_time < actual_min_length:
            new_max = clip.min_time + actual_min_length

        start_offset = clip.start_offset
        new_speed = 1.0

        if shift:
            asset = None
            mult = 1.0
            if clip.is_audio():
                asset = clip.audio.asset
                mult = clip.audio.speed
                start_offset = samples_to_beat(start_offset, float(asset.sample.sample_rate), beat_duration)
            if old_max < new_max:
                start_offset -= (new_max - old_max) * mult
            else:
                start_offset += (old_max - new_max) * mult
            start_offset = max(start_offset, 0.0)
            if clip.is_audio() and asset is not None:
                start_offset = min(start_offset, float(asset.sample.count))
                start_offset = beat_to_samples(start_offset, float(asset.sample.sample_rate), beat_duration)

        if stretch and clip.is_audio() and clip.audio.asset is not None:
            asset = clip.audio.asset
            sample_count = float(asset.sample.count)
            old_length = sample_count / clip.audio.speed
            num_samples = beat_to_samples(relative_pos, clip.asset_sample_rate(), beat_duration)
            new_speed = sample_count / (old_length + num_samples)

        return ClipResizeResult(clip.min_time, new_max, start_offset, new_speed)

    old_min = clip.min_time
    actual_min_length = clip.max_time - resize_limit + min_length
    new_min = max(clip.min_time + relative_pos, 0.0)
    if clip.max_time - new_min < actual_min_length:
        new_min = clip.max_time - actual_min_length
    if clamp_at_resize_pos and new_min < min_resize_pos:
        new_min = min_resize_pos

    start_offset = clip.start_offset
    new_speed = 1.0

    if not shift:
        asset = None
        if clip.is_audio():
            asset = clip.audio.asset
            start_offset = samples_to_beat(start_offset, float(asset.sample.sample_rate), beat_duration)

        if old_min < new_min:
            start_offset -= old_min - new_min
        else:
            start_offset += new_min - old_min

        if start_offset < 0.0:
            new_min = new_min - start_offset

        start_offset = max(start_offset, 0.0)
        if clip.is_audio() and asset is not None:
            start_offset = beat_to_samples(start_offset, float(asset.sample.sample_rate), beat_duration)

    if stretch and clip.is_audio() and clip.audio.asset is not None:
        asset = clip.audio.asset
        sample_count = float(asset.sample.count)
        old_length = sample_count / clip.audio.speed
        num_samples = beat_to_samples(old_min - new_min, clip.asset_sample_rate(), beat_duration)
        new_speed = sample_count / (old_length + num_samples)

    return ClipResizeResult(new_min, clip.max_time, start_offset, new_speed)


def calc_clip_shift(
    is_audio_clip: bool, start_offset: float, relative_pos: float, beat_duration: float, sample_rate: float
) -> float:
    """clip_edit.h:139 — shift clip content, clamped at content start."""
    if is_audio_clip:
        offset_in_beat = samples_to_beat(start_offset, sample_rate, beat_duration)
        return beat_to_samples(max(offset_in_beat - relative_pos, 0.0), sample_rate, beat_duration)
    return max(start_offset - relative_pos, 0.0)


def shift_clip_content(clip: Clip, relative_pos: float, time_base, old_beat: float | None = None) -> float:
    """clip_edit.h:150 — relative_pos in beats (scaled by speed for audio).

    ``time_base``: a scalar beat_duration keeps the reference's exact
    roundtrip arithmetic. A TempoMap (with ``old_beat`` = the content's
    current timeline anchor) computes the EXACT sample span of
    ``relative_pos`` beats over the map — a split/trim that straddles a
    tempo change stays seamless, which no single local beat duration can
    achieve (the shifted span integrates both tempi)."""
    is_audio = clip.is_audio()
    if not isinstance(time_base, float) and old_beat is not None:
        if not is_audio:
            return max(clip.start_offset - relative_pos, 0.0)
        sample_rate = float(clip.audio.asset.sample.sample_rate)
        # new content anchor is old_beat - relative_pos; the offset moves by
        # the exact integral over that beat interval, scaled by clip speed
        shift = time_base.delta_samples(float(old_beat), float(old_beat) - relative_pos,
                                        sample_rate) * clip.audio.speed
        return max(clip.start_offset + shift, 0.0)
    if not isinstance(time_base, float):
        # mapped but no anchor given: local linearization at beat 0
        time_base = 60.0 / time_base.bpm_at(0.0)
    sample_rate = 0.0
    if is_audio:
        sample_rate = float(clip.audio.asset.sample.sample_rate)
        relative_pos = relative_pos * clip.audio.speed
    return calc_clip_shift(is_audio, clip.start_offset, relative_pos, time_base, sample_rate)
