"""Track model + clip queries — mirrors src/engine/track.{h,cpp} (edit half).

The render half of Track (process_event/process, track.cpp:258,587) lives in
timeline.oracle (block-sequential parity oracle) and timeline.carve (the
timeline-at-once segment compiler).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from whitebox_tpu_torch.core.math import db_to_linear_f32
from whitebox_tpu_torch.core.panning import PanningLaw, calculate_panning_coefs
from whitebox_tpu_torch.session.clip import Clip


@dataclass
class ClipQueryResult:
    """track.h — range query result (indices + edge offsets)."""

    first: int
    last: int
    first_offset: float
    last_offset: float


@dataclass
class Track:
    name: str = ""
    color: int = 0
    height: float = 60.0
    shown: bool = True
    volume_db: float = 0.0
    pan: float = 0.0
    mute: bool = False
    solo: bool = False  # UI-level; solo flips other tracks' mute (engine.cpp:245)
    clips: list[Clip] = field(default_factory=list)
    #: effect chain (list of effects.base.Effect) — replaces the reference's
    #: single VST3 plugin slot per track (track.h:124).
    effects: list = field(default_factory=list)
    #: optional per-track automation (automation.TrackAutomation) — an
    #: extension over the reference, which edits envelopes but never plays
    #: them (SURVEY §2.9).
    automation: object = None
    #: routing extension (session/bus.py): destination bus index (None =
    #: master, the reference's only destination) and aux sends.
    output_bus: Optional[int] = None
    sends: list = field(default_factory=list)
    #: freeze / bounce-in-place stash (Session.freeze_track): the original
    #: clips, effect chain, and effect-param lanes, kept so
    #: unfreeze_track restores the live track. None == not frozen.
    frozen: object = None
    #: recording input assignment (session/input.py TrackInput — the
    #: track_input.h:17-30 model: None/Midi/ExternalStereo/ExternalMono +
    #: capture-stream index). None == TrackInputType.NONE.
    input: object = None
    #: record-arm flag (track_input.h:36 TrackInputAttr.armed); armed
    #: tracks with external inputs join input groups for capture fan-out.
    armed: bool = False

    # ---- audio-thread parameter mapping (track.cpp:608-643) ----

    @property
    def volume_linear(self) -> np.float32:
        """TrackParameter_Volume — db_to_linear(volume_db), f32."""
        return np.float32(db_to_linear_f32(self.volume_db))

    @property
    def pan_coeffs(self) -> tuple[np.float32, np.float32]:
        """ConstantPower -3 dB pan coefficients (track.cpp:629)."""
        return calculate_panning_coefs(self.pan, PanningLaw.CONSTANT_POWER_3DB)

    # ---- clip list management (track.cpp:112-216) ----

    def update_clip_ordering(self) -> None:
        """track.cpp:159 — drop deleted, sort by min_time, ids = index."""
        self.clips = [c for c in self.clips if not c.deleted]
        self.clips.sort(key=lambda c: c.min_time)
        for i, c in enumerate(self.clips):
            c.id = i

    def query_clip_by_range(self, qmin: float, qmax: float) -> Optional[ClipQueryResult]:
        """track.cpp:112 — clips overlapping [qmin, qmax] via lower-bound search."""
        assert qmin <= qmax
        clips = self.clips
        if not clips:
            return None
        if qmax <= clips[0].min_time:
            return None
        if qmin >= clips[-1].max_time:
            return None

        max_times = [c.max_time for c in clips]
        # find_lower_bound(pred: clip.max_time <= t) == bisect_right on max_time
        first = bisect.bisect_right(max_times, qmin)
        last = bisect.bisect_right(max_times, qmax)
        first = min(first, len(clips) - 1)
        last = min(last, len(clips) - 1)

        if first == last and (qmax <= clips[first].min_time or qmin >= clips[last].max_time):
            return None

        if qmin > clips[first].max_time:
            first += 1
            first_offset = qmin - clips[first].min_time
        else:
            first_offset = qmin - clips[first].min_time

        if qmax > clips[last].min_time:
            last_offset = qmax - clips[last].max_time
        else:
            last -= 1
            last_offset = qmax - clips[last].max_time

        return ClipQueryResult(first=first, last=last, first_offset=first_offset, last_offset=last_offset)

    def find_next_clip(self, time_pos: float) -> Optional[int]:
        """track.cpp:182 — id of first clip with max_time > time_pos."""
        clips = self.clips
        if not clips:
            return None
        if clips[-1].max_time < time_pos:
            return None
        # find_lower_bound (algorithm.h:24) never returns end: it clamps to
        # the last element, so mirror that (bisect_right clamped to len-1).
        max_times = [c.max_time for c in clips]
        i = min(bisect.bisect_right(max_times, time_pos), len(clips) - 1)
        return clips[i].id
