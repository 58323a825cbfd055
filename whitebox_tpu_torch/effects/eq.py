"""Biquad and parametric EQ effects over ``ops/biquad.py``.

Counterpart of ``whitebox_tpu/effects/eq.py`` without ``LinearPhaseEQ``
and ``design_linear_phase_fir`` (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.effects.base import Effect
from whitebox_tpu_torch.ops.biquad import BiquadCoeffs, BiquadType, biquad_scan, design_biquad


class Biquad(Effect):
    """A single RBJ biquad section."""

    name = "biquad"

    def __init__(self, ftype: str | BiquadType, freq_hz: float, q: float = 0.7071067811865476,
                 gain_db: float = 0.0) -> None:
        super().__init__()
        self.ftype = BiquadType(ftype)
        self.freq_hz = float(freq_hz)
        self.q = float(q)
        self.gain_db = float(gain_db)
        self.coeffs: BiquadCoeffs | None = None

    def prepare(self, sample_rate: float, channels: int = 2) -> "Biquad":
        super().prepare(sample_rate, channels)
        self.coeffs = design_biquad(self.ftype, self.freq_hz, sample_rate, self.q, self.gain_db)
        return self

    def init_state(self, channels: int):
        return torch.zeros((channels, 2), dtype=torch.float32)

    def process(self, x, state):
        assert self.coeffs is not None, "call prepare(sample_rate) first"
        return biquad_scan(x, self.coeffs, state)

    def tail_frames(self) -> int:
        return 4096  # conservative IIR ring-out hint


class ParametricEQ(Effect):
    """Multi-band EQ: low shelf + N peaks + high shelf, as a biquad cascade.

    bands: list of (ftype, freq_hz, q, gain_db) tuples.
    """

    name = "eq"

    def __init__(self, bands: list[tuple]) -> None:
        super().__init__()
        self.bands = [(BiquadType(t), float(f), float(q), float(g)) for (t, f, q, g) in bands]
        self.coeffs: list[BiquadCoeffs] = []

    def prepare(self, sample_rate: float, channels: int = 2) -> "ParametricEQ":
        super().prepare(sample_rate, channels)
        self.coeffs = [design_biquad(t, f, sample_rate, q, g) for (t, f, q, g) in self.bands]
        return self

    def init_state(self, channels: int):
        return [torch.zeros((channels, 2), dtype=torch.float32) for _ in self.bands]

    def process(self, x, state):
        assert self.coeffs, "call prepare(sample_rate) first"
        new_states = []
        for c, st in zip(self.coeffs, state):
            x, ns = biquad_scan(x, c, st)
            new_states.append(ns)
        return x, new_states

    def tail_frames(self) -> int:
        return 4096 * max(len(self.bands), 1)


def cascade_magnitude(bands, freqs_hz: np.ndarray, sample_rate: float) -> np.ndarray:
    """|H| of the RBJ biquad cascade at ``freqs_hz`` (f64, exact eval)."""
    w = 2.0 * np.pi * np.asarray(freqs_hz, np.float64) / float(sample_rate)
    z1 = np.exp(-1j * w)
    z2 = z1 * z1
    mag = np.ones_like(w)
    for (t, f, q, g) in bands:
        c = design_biquad(t, f, sample_rate, q, g)
        num = c.b0 + c.b1 * z1 + c.b2 * z2
        den = 1.0 + c.a1 * z1 + c.a2 * z2
        mag = mag * np.abs(num / den)
    return mag
