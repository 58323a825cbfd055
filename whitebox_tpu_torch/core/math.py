"""Scalar/array math mirroring the reference's src/core/core_math.h.

All "beat"/"sample" conversions and gain laws are kept in float64 exactly as
the C++ engine computes them (C++ ``double``); narrowing to float32 happens
only where the C++ code narrows. Functions accept Python floats or NumPy
arrays; device-side (jnp) equivalents live next to the kernels that use them.

Reference: the reference's src/core/core_math.h
"""

from __future__ import annotations

import numpy as np

#: Default pulses-per-quarter-note of the engine (reference: engine.h `ppq = 96`).
DEFAULT_PPQ = 96.0

#: dB floor below which gain snaps to 0.0 (reference: core_math.h:84 `threshold = -72.0f`).
DB_SILENT_THRESHOLD = -72.0


def clamp(x, lo, hi):
    """math::clamp (core_math.h). Works on scalars and arrays."""
    return np.minimum(np.maximum(x, lo), hi)


def lerp(x, a, b):
    """core_math.h:92 ``(1.0 - x) * a + x * b`` (float64 form).

    NOTE: the *sampler's* lerp uses the other associativity
    ``a + fx * (b - a)`` in float32 (sampler.cpp:55); that form lives in
    :mod:`whitebox_tpu_torch.timeline.oracle` / the mix kernels, not here.
    """
    return (1.0 - x) * a + x * b


def fract(x):
    """core_math.h:66 ``x - floor(x)``."""
    return x - np.floor(x)


def cxx_round(x):
    """core_math.h:60 round-half-away-from-zero via trunc(x ± 0.5)."""
    x = np.asarray(x, dtype=np.float64)
    return np.trunc(x + np.where(x < 0.0, -0.5, 0.5))


def uround(x):
    """core_math.h uround — round to nearest unsigned integer value."""
    return cxx_round(x)


def exponential_ease(x, y, linear_thresh=0.01):
    """core_math.h:71 — exponential ease curve, linear near y == 0."""
    if abs(y) < linear_thresh:
        return x
    return (np.exp(x * y) - 1.0) / (np.exp(y) - 1.0)


def exponential_ease2(x, y):
    """core_math.h:78 — rational ease curve."""
    return (x - y * x) / (y - 2.0 * y * np.abs(x) + 1.0)


def _load_libm_powf():
    """glibc's powf, so the host mirror matches the C++ bit-for-bit.

    numpy's f32 power differs from glibc powf by 1 ulp on ~16% of inputs,
    and even f64-pow-then-round disagrees on rare double-rounding cases
    (measured 162/300k against the compiled reference twin)."""
    try:
        import ctypes
        import ctypes.util

        name = ctypes.util.find_library("m") or "libm.so.6"
        libm = ctypes.CDLL(name)
        libm.powf.restype = ctypes.c_float
        libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        return libm.powf
    except Exception:
        return None


_POWF = _load_libm_powf()


def db_to_linear_f32(db, threshold=DB_SILENT_THRESHOLD):
    """core_math.h:84 ``db_to_linear<float>`` — float32 result.

    C++ computes ``std::pow(10.0f, (float)((double)x * 0.05))`` (powf) and
    returns 0 at/below the -72 dB floor. Scalar or array. Uses libm's powf
    when available (bit-exact vs the reference); falls back to f64 pow
    rounded to f32 (≤1 ulp off in rare double-rounding cases).
    """
    db = np.asarray(db)
    exp32 = (np.asarray(db, dtype=np.float64) * 0.05).astype(np.float32)
    if _POWF is not None:
        flat = np.asarray(exp32).ravel()
        val = np.array([_POWF(10.0, float(e)) for e in flat], dtype=np.float32).reshape(np.shape(exp32))
    else:
        val = np.power(10.0, exp32.astype(np.float64)).astype(np.float32)
    out = np.where(db <= threshold, np.float32(0.0), val)
    return out[()] if out.ndim == 0 else out


def linear_to_db(x):
    """core_math.h:90 ``20 * log10(|x|)``."""
    return 20.0 * np.log10(np.abs(x))


def note_to_hz(note, a4_hz=440.0):
    """core_math.h — equal-tempered MIDI note number to Hz (A4 = note 69)."""
    return a4_hz * np.exp2((np.asarray(note, dtype=np.float64) - 69.0) / 12.0)


def samples_to_beat(samples, sample_rate: float, beat_duration: float):
    """core_math.h:199 — ``(samples / rate) / beat_duration`` in float64."""
    sec = np.asarray(samples, dtype=np.float64) / sample_rate
    out = sec / beat_duration
    return out[()] if out.ndim == 0 else out


def beat_to_samples(beat, sample_rate: float, beat_duration: float):
    """core_math.h:209 — ``beat * beat_duration * sample_rate`` in float64.

    Matches the C++ op order exactly: ``sec = beat * beat_duration`` first,
    then ``sec * sample_rate`` (two separately-rounded f64 multiplies).
    """
    sec = np.asarray(beat, dtype=np.float64) * beat_duration
    out = sec * sample_rate
    return out[()] if out.ndim == 0 else out


def beat_duration_from_bpm(bpm: float) -> float:
    """engine.cpp:24 ``set_bpm`` — beat duration in seconds = 60 / bpm."""
    return 60.0 / bpm


def is_pow_2(x: int) -> bool:
    return x != 0 and (x & (x - 1)) == 0
