"""Meter (time-signature) map — piecewise time signatures over the bar line.

A framework EXTENSION: the reference has no meter model at all (its ruler
is beat-numbered; ppq=96 only quantizes clip lengths, engine.cpp:265).
Here a :class:`MeterMap` assigns a time signature to each bar, giving the
session a musical bar|beat addressing scheme:

- the session's beat unit is the QUARTER note (core_math.h beat_duration);
  a bar of ``num/den`` spans ``num * 4/den`` quarter beats;
- signature changes land on BAR boundaries (the invariant every DAW
  enforces — a change mid-bar would re-number every later bar ambiguously);
- conversions are exact piecewise-linear closed forms over cumulative
  per-segment beats (no accumulation, no drift).

Meter is pure ADDRESSING: rendering is driven entirely by beats (and the
tempo map, core/tempo.py); changing a time signature never moves audio.
Bars are 0-based in the API (display layers may add 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MeterPoint", "MeterMap", "DEFAULT_METER"]


@dataclass(frozen=True)
class MeterPoint:
    """Time signature ``num/den`` starting at ``bar`` (0-based)."""

    bar: int
    num: int
    den: int

    def __post_init__(self):
        if self.bar < 0:
            raise ValueError(f"meter bar must be >= 0, got {self.bar}")
        if not (1 <= self.num <= 99):
            raise ValueError(f"numerator out of range: {self.num}")
        if self.den not in (1, 2, 4, 8, 16, 32, 64):
            raise ValueError(f"denominator must be a power of two <= 64, got {self.den}")

    @property
    def beats_per_bar(self) -> float:
        """Quarter-note beats spanned by one bar of this signature."""
        return self.num * (4.0 / self.den)


class MeterMap:
    """Piecewise time signature by bar with exact bars<->beats closed forms.

    ``points`` sort by bar and dedup (later wins). A map always anchors at
    bar 0: if none is given, the first signature extends backwards.
    """

    def __init__(self, points):
        pts: dict[int, MeterPoint] = {}
        for p in points:
            if not isinstance(p, MeterPoint):
                p = MeterPoint(*p) if isinstance(p, (tuple, list)) else MeterPoint(**p)
            pts[int(p.bar)] = p
        if not pts:
            raise ValueError("MeterMap needs at least one point")
        ordered = [pts[b] for b in sorted(pts)]
        if ordered[0].bar > 0:
            ordered.insert(0, MeterPoint(0, ordered[0].num, ordered[0].den))
        self.points: tuple[MeterPoint, ...] = tuple(ordered)

        n = len(self.points)
        self._bar = np.array([p.bar for p in self.points], np.int64)
        self._bpb = np.array([p.beats_per_bar for p in self.points], np.float64)
        # cumulative quarter-beats at each anchor bar
        self._beat = np.zeros(n, np.float64)
        for i in range(n - 1):
            self._beat[i + 1] = self._beat[i] + (self._bar[i + 1] - self._bar[i]) * self._bpb[i]

    @property
    def is_default(self) -> bool:
        return all(p.num == 4 and p.den == 4 for p in self.points)

    def signature_at(self, bar: float) -> tuple[int, int]:
        i = max(int(np.searchsorted(self._bar, int(np.floor(bar)), side="right")) - 1, 0)
        return self.points[i].num, self.points[i].den

    def bar_to_beat(self, bar: float) -> float:
        """Quarter-beat position of (possibly fractional) ``bar``."""
        b = float(bar)
        i = max(int(np.searchsorted(self._bar, int(np.floor(b)), side="right")) - 1, 0)
        return float(self._beat[i] + (b - self._bar[i]) * self._bpb[i])

    def beat_to_bar(self, beat: float) -> float:
        """Fractional bar position of quarter-beat ``beat`` (inverse)."""
        t = float(beat)
        i = max(int(np.searchsorted(self._beat, t, side="right")) - 1, 0)
        return float(self._bar[i] + (t - self._beat[i]) / self._bpb[i])

    def label(self, beat: float) -> str:
        """bar|beat display label, 1-based (e.g. beat 4.5 in 4/4 -> '2|1.5');
        the intra-bar beat counts in the signature's own denominator unit."""
        bar_f = self.beat_to_bar(beat)
        bar = int(np.floor(bar_f + 1e-9))
        num, den = self.signature_at(bar)
        frac = (beat - self.bar_to_beat(bar)) / (4.0 / den)  # in den-units
        return f"{bar + 1}|{frac + 1:g}"

    # -- serialization ------------------------------------------------------

    def as_dict(self) -> dict:
        return {"points": [{"bar": p.bar, "num": p.num, "den": p.den}
                           for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict) -> "MeterMap":
        return cls([MeterPoint(int(p["bar"]), int(p["num"]), int(p["den"]))
                    for p in d["points"]])

    def __eq__(self, other) -> bool:
        return isinstance(other, MeterMap) and self.points == other.points

    def __repr__(self) -> str:
        body = ", ".join(f"({p.bar}, {p.num}/{p.den})" for p in self.points)
        return f"MeterMap([{body}])"


#: the session default — straight 4/4 from bar 0
DEFAULT_METER = MeterMap([MeterPoint(0, 4, 4)])
