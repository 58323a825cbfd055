"""Tempo map — piecewise tempo (BPM) over the beat timeline.

A framework EXTENSION: the reference engine has exactly one tempo for the
whole session (``Engine::set_bpm``, engine.cpp:24 — a single f64
``beat_duration``); tempo changes/ramps cannot be expressed at all. Here a
:class:`TempoMap` defines BPM as a piecewise function of the beat position:

- ``curve="step"``  — BPM holds constant from a point to the next point;
- ``curve="linear"`` — BPM ramps linearly in the BEAT domain to the next
  point (the time integral is the exact closed form
  ``dt = (60/s)·ln(bpm1/bpm0)`` with ``s`` the BPM-per-beat slope).

All conversions are exact f64 closed forms over cumulative per-segment
seconds — there is no per-block accumulation and therefore no drift. The
map is the single source of truth for beat↔time whenever
``Session.tempo_map`` is set; sessions without a map keep the reference's
legacy single-``beat_duration`` arithmetic bit-for-bit (the two paths never
mix — see :mod:`whitebox_tpu_torch.timeline.transport`).

Semantics under a map (defined by this framework, mirrored exactly by the
NumPy oracle, the carve compiler, and the MIDI voice walk):

- POSITIONS move, RATES don't: a tempo change relocates clip starts/ends,
  MIDI notes, and automation points on the sample timeline, but audio
  inside a clip still plays at ``sample_rate_ratio × clip.speed`` samples
  per output frame (classic DAW time-anchored audio; "musical mode"
  stretching is `Session.stretch_clip`).
- Block ownership of an event time is HALF-OPEN ``[P[k], P[k+1])`` under a
  map. The reference walk uses a closed interval, which is harmless with
  f64-accumulated grids (exact beat==block-edge collisions essentially
  never happen) but would double-fire Play events and wrap them a block
  early through ``%buffer_size`` under the map's exact closed forms, where
  collisions are COMMON (beat 6.0 at 120→60 bpm is exactly block 375 at
  48 kHz/512). Half-open ownership places every event exactly once at its
  exact frame; events interior to a block keep the engine's
  ``(uint64)sample_position % buffer_size`` placement, with the mapped
  ``sample_position`` grid being exactly ``k·buffer_size``.
- Clip-edit *content* math (trim/split/shift start_offset arithmetic)
  uses the local beat duration at the clip's position
  (``Session.beat_duration_at``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TempoPoint", "TempoMap"]

_CURVES = ("step", "linear")


@dataclass(frozen=True)
class TempoPoint:
    """One tempo anchor: BPM at ``beat``, evolving via ``curve`` to the
    NEXT point ("step" holds, "linear" ramps in the beat domain).

    ``bpm_end`` (linear only) is an explicit ramp target: the segment
    ramps ``bpm -> bpm_end`` and the next point's own BPM takes over at
    its beat — allowing a DISCONTINUITY there (ramp up into a sudden
    half-time drop). Default None ramps continuously into the next
    point's BPM."""

    beat: float
    bpm: float
    curve: str = "step"
    bpm_end: float | None = None

    def __post_init__(self):
        if not (self.bpm > 0.0) or not np.isfinite(self.bpm):
            raise ValueError(f"bpm must be finite and > 0, got {self.bpm}")
        if self.beat < 0.0 or not np.isfinite(self.beat):
            raise ValueError(f"tempo point beat must be >= 0, got {self.beat}")
        if self.curve not in _CURVES:
            raise ValueError(f"curve must be one of {_CURVES}, got {self.curve!r}")
        if self.bpm_end is not None:
            if not (self.bpm_end > 0.0) or not np.isfinite(self.bpm_end):
                raise ValueError(f"bpm_end must be finite and > 0, got {self.bpm_end}")
            if self.curve != "linear":
                raise ValueError("bpm_end is only meaningful with curve='linear'")


class TempoMap:
    """Piecewise tempo over beats with exact closed-form beats↔seconds.

    ``points`` are sorted by beat and deduplicated (later wins at equal
    beats). A map always has an anchor at beat 0: if none is given, the
    first point's BPM is extended backwards ("step").
    """

    def __init__(self, points):
        pts: dict[float, TempoPoint] = {}
        for p in points:
            if not isinstance(p, TempoPoint):
                p = TempoPoint(*p) if isinstance(p, (tuple, list)) else TempoPoint(**p)
            pts[float(p.beat)] = p
        if not pts:
            raise ValueError("TempoMap needs at least one point")
        ordered = [pts[b] for b in sorted(pts)]
        if ordered[0].beat > 0.0:
            ordered.insert(0, TempoPoint(0.0, ordered[0].bpm, "step"))
        self.points: tuple[TempoPoint, ...] = tuple(ordered)

        n = len(self.points)
        self._b = np.array([p.beat for p in self.points], np.float64)
        self._v = np.array([p.bpm for p in self.points], np.float64)
        # effective per-segment slope in BPM/beat ("step" and the final
        # open-ended segment have slope 0)
        self._s = np.zeros(n, np.float64)
        for i in range(n - 1):
            if self.points[i].curve == "linear":
                db = self._b[i + 1] - self._b[i]
                target = self.points[i].bpm_end
                if target is None:
                    target = self._v[i + 1]
                if db > 0.0:
                    self._s[i] = (target - self._v[i]) / db
        # cumulative seconds at each anchor (exact per-segment closed form)
        self._t = np.zeros(n, np.float64)
        for i in range(n - 1):
            self._t[i + 1] = self._t[i] + self._seg_seconds(i, self._b[i + 1])

    # -- segment-local closed forms ---------------------------------------

    def _seg_seconds(self, i: int, beat: float) -> float:
        """Seconds from anchor i to ``beat`` (within segment i)."""
        db = beat - self._b[i]
        s = self._s[i]
        if s == 0.0:
            return db * (60.0 / self._v[i])
        return (60.0 / s) * np.log1p(s * db / self._v[i])

    def _seg_beats(self, i: int, dt: float) -> float:
        """Beats from anchor i after ``dt`` seconds (within segment i)."""
        s = self._s[i]
        if s == 0.0:
            return dt * self._v[i] / 60.0
        return (self._v[i] / s) * np.expm1(s * dt / 60.0)

    def _seg_of_beat(self, beat: float) -> int:
        return max(int(np.searchsorted(self._b, beat, side="right")) - 1, 0)

    def _seg_of_time(self, t: float) -> int:
        return max(int(np.searchsorted(self._t, t, side="right")) - 1, 0)

    # -- public conversions ------------------------------------------------

    @property
    def is_constant(self) -> bool:
        return bool(np.all(self._v == self._v[0]) and np.all(self._s == 0.0)
                    and all(p.bpm_end is None for p in self.points))

    def bpm_at(self, beat: float) -> float:
        i = self._seg_of_beat(float(beat))
        return float(self._v[i] + self._s[i] * (float(beat) - self._b[i]))

    def beat_duration_at(self, beat: float) -> float:
        return 60.0 / self.bpm_at(beat)

    def beats_to_seconds(self, beat):
        """Exact f64 seconds at beat position(s); beat 0 is t = 0."""
        b = np.asarray(beat, np.float64)
        i = np.maximum(np.searchsorted(self._b, b, side="right") - 1, 0)
        db = b - self._b[i]
        s, v = self._s[i], self._v[i]
        s_safe = np.where(s == 0.0, 1.0, s)
        lin = (60.0 / s_safe) * np.log1p(np.where(s == 0.0, 0.0, s) * db / v)
        out = self._t[i] + np.where(s == 0.0, db * (60.0 / v), lin)
        return out[()] if out.ndim == 0 else out

    def seconds_to_beats(self, t):
        """Exact f64 beat position(s) at ``t`` seconds (inverse of
        :meth:`beats_to_seconds`)."""
        tt = np.asarray(t, np.float64)
        i = np.maximum(np.searchsorted(self._t, tt, side="right") - 1, 0)
        dt = tt - self._t[i]
        s, v = self._s[i], self._v[i]
        s_safe = np.where(s == 0.0, 1.0, s)
        lin = (v / s_safe) * np.expm1(np.where(s == 0.0, 0.0, s) * dt / 60.0)
        out = self._b[i] + np.where(s == 0.0, dt * v / 60.0, lin)
        return out[()] if out.ndim == 0 else out

    def beats_to_samples(self, beat, sample_rate: float):
        """Exact f64 absolute sample position(s) of beat position(s)."""
        out = np.asarray(self.beats_to_seconds(beat), np.float64) * sample_rate
        return out[()] if out.ndim == 0 else out

    def delta_samples(self, beat_from: float, beat_to: float, sample_rate: float) -> float:
        """Exact f64 sample span between two beat positions (the mapped
        replacement for ``beat_to_samples(b_to - b_from, rate, bd)``)."""
        return (float(self.beats_to_seconds(beat_to))
                - float(self.beats_to_seconds(beat_from))) * sample_rate

    # -- serialization -----------------------------------------------------

    def as_dict(self) -> dict:
        return {"points": [
            {"beat": p.beat, "bpm": p.bpm, "curve": p.curve,
             **({"bpm_end": p.bpm_end} if p.bpm_end is not None else {})}
            for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict) -> "TempoMap":
        return cls([TempoPoint(float(p["beat"]), float(p["bpm"]),
                               str(p.get("curve", "step")),
                               (float(p["bpm_end"]) if p.get("bpm_end") is not None
                                else None))
                    for p in d["points"]])

    def __eq__(self, other) -> bool:
        return isinstance(other, TempoMap) and self.points == other.points

    def __repr__(self) -> str:
        body = ", ".join(
            f"({p.beat:g}, {p.bpm:g}, {p.curve}"
            + (f"->{p.bpm_end:g})" if p.bpm_end is not None else ")")
            for p in self.points)
        return f"TempoMap([{body}])"
