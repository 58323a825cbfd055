"""RBJ Audio EQ Cookbook biquads in f64 (Robert Bristow-Johnson's public
formulas), frozen here: the reference designs every section again from the
band's type, frequency, Q and gain, and filters with ``scipy.signal.sosfilt``
in f64. The chain entries made of biquads (``reference/fx/``) share it."""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import sosfilt

#: f32 operations of one section per row and frame (transposed direct form II: 5 multiplies, 4 adds)
SECTION_OPS = 9


def design(ftype: str, freq_hz: float, q: float, gain_db: float, sample_rate: float) -> np.ndarray:
    """One section as a second-order-section row ``[b0, b1, b2, 1, a1, a2]``, normalised by a0."""
    w0 = 2.0 * math.pi * freq_hz / sample_rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    A = 10.0 ** (gain_db / 40.0)
    if ftype == "lowpass":
        b = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif ftype == "highpass":
        b = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif ftype == "bandpass":
        b = (alpha, 0.0, -alpha)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif ftype == "notch":
        b = (1.0, -2 * cw, 1.0)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif ftype == "allpass":
        b = (1 - alpha, -2 * cw, 1 + alpha)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif ftype == "peak":
        b = (1 + alpha * A, -2 * cw, 1 - alpha * A)
        a = (1 + alpha / A, -2 * cw, 1 - alpha / A)
    elif ftype == "lowshelf":
        sq = 2 * math.sqrt(A) * alpha
        b = (A * ((A + 1) - (A - 1) * cw + sq), 2 * A * ((A - 1) - (A + 1) * cw), A * ((A + 1) - (A - 1) * cw - sq))
        a = ((A + 1) + (A - 1) * cw + sq, -2 * ((A - 1) + (A + 1) * cw), (A + 1) + (A - 1) * cw - sq)
    elif ftype == "highshelf":
        sq = 2 * math.sqrt(A) * alpha
        b = (A * ((A + 1) + (A - 1) * cw + sq), -2 * A * ((A - 1) + (A + 1) * cw), A * ((A + 1) + (A - 1) * cw - sq))
        a = ((A + 1) - (A - 1) * cw + sq, 2 * ((A - 1) - (A + 1) * cw), (A + 1) - (A - 1) * cw - sq)
    else:
        raise ValueError(f"unknown biquad type {ftype!r}")
    a0 = a[0]
    return np.array([b[0] / a0, b[1] / a0, b[2] / a0, 1.0, a[1] / a0, a[2] / a0], dtype=np.float64)


def sections(bands, sample_rate: float) -> np.ndarray:
    """``[n, 6]`` second-order sections of ``bands`` ((type, hz, q, gain_db) each), in order."""
    return np.stack([design(t, f, q, g, sample_rate) for (t, f, q, g) in bands])


def run(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``x`` ``[C, F]`` through the sections in f64, from rest."""
    return sosfilt(sos, np.asarray(x, dtype=np.float64), axis=-1)


def process(bands, x: np.ndarray, state, sample_rate: float):
    """``x`` ``[C, n]`` through the sections of ``bands`` in f64 from
    ``state`` (None: from rest) -> ``(y, state)``, so that a signal can be
    filtered chunk by chunk."""
    sos = sections(bands, sample_rate)
    if state is None:
        state = np.zeros((sos.shape[0], x.shape[0], 2))
    return sosfilt(sos, np.asarray(x, dtype=np.float64), axis=-1, zi=state)
