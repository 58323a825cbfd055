"""PCM sample formats and the engine's exact normalization semantics.

Mirrors the reference's src/core/audio_format.h and the PCM normalizers used
by the playback sampler (src/dsp/sampler.cpp:7-18, :95-97).

The reference keeps decoded samples in their *native* format and normalizes
to f32 on the fly, with two subtly different recipes:

- the speed==1 "fast path" (sampler.cpp:106-158) normalizes then **clamps**
  to [-1, 1] (in f32 for I16, in f64 for I24/I32) before the gain multiply;
- the resampling path (sampler.cpp:34-59) normalizes **without clamping**
  (f32 product for I16, f64 product narrowed to f32 for I24/I32).

Because the clamp only bites for full-scale negative codes (e.g. -32768),
``normalize_unclamped`` composed with an f32 clamp reproduces the fast path
bit-exactly, so the TPU sample pool stores unclamped normalized f32 and the
kernels apply the clamp behind a per-segment flag.
"""

from __future__ import annotations

import enum

import numpy as np


class AudioFormat(enum.IntEnum):
    """audio_format.h:7 — decoded sample storage formats."""

    UNKNOWN = 0
    I8 = 1
    I16 = 2
    I24 = 3
    I24_X8 = 4  # 24-bit stored in 32-bit container
    I32 = 5
    F32 = 6
    F64 = 7


#: sampler.cpp:95 — f32 constant 1/32767.
I16_NORM_F32 = np.float32(1.0 / 32767.0)
#: sampler.cpp:96 — f64 constant 1/(2^23 - 1).
I24_NORM_F64 = 1.0 / float((1 << 23) - 1)
#: sampler.cpp:97 — f64 constant 1/(2^31 - 1).
I32_NORM_F64 = 1.0 / 2147483647.0

_INT_DTYPES = {
    AudioFormat.I16: np.int16,
    AudioFormat.I24: np.int32,
    AudioFormat.I24_X8: np.int32,
    AudioFormat.I32: np.int32,
}


def storage_dtype(fmt: AudioFormat):
    """NumPy dtype used to hold decoded samples of this format."""
    if fmt in _INT_DTYPES:
        return _INT_DTYPES[fmt]
    if fmt == AudioFormat.F32:
        return np.float32
    if fmt == AudioFormat.F64:
        return np.float64
    if fmt == AudioFormat.I8:
        return np.int8
    raise ValueError(f"unsupported storage format {fmt!r}")


def normalize_unclamped(data: np.ndarray, fmt: AudioFormat) -> np.ndarray:
    """Native PCM -> f32 exactly as sampler.cpp's linear path (no clamp).

    I16: ``(float)(norm_f32 * (float)x)`` — all-f32 product.
    I24/I32: ``(float)(norm_f64 * (double)x)`` — f64 product, one narrowing.
    F32: identity.
    """
    if fmt == AudioFormat.F32:
        return np.asarray(data, dtype=np.float32)
    if fmt == AudioFormat.I16:
        return (data.astype(np.float32) * I16_NORM_F32).astype(np.float32)
    if fmt in (AudioFormat.I24, AudioFormat.I24_X8):
        return (data.astype(np.float64) * I24_NORM_F64).astype(np.float32)
    if fmt == AudioFormat.I32:
        return (data.astype(np.float64) * I32_NORM_F64).astype(np.float32)
    raise ValueError(f"unsupported playback format {fmt!r}")


def normalize_fast_path(data: np.ndarray, fmt: AudioFormat) -> np.ndarray:
    """Native PCM -> f32 exactly as the sampler's speed==1 path (clamped).

    sampler.cpp:106-158. For I24/I32 the clamp happens in f64 *before* the
    narrowing to f32; for I16 it happens in f32. F32 input is NOT clamped.
    """
    if fmt == AudioFormat.F32:
        return np.asarray(data, dtype=np.float32)
    if fmt == AudioFormat.I16:
        v = data.astype(np.float32) * I16_NORM_F32
        return np.clip(v, np.float32(-1.0), np.float32(1.0)).astype(np.float32)
    if fmt in (AudioFormat.I24, AudioFormat.I24_X8):
        v = data.astype(np.float64) * I24_NORM_F64
        return np.clip(v, -1.0, 1.0).astype(np.float32)
    if fmt == AudioFormat.I32:
        v = data.astype(np.float64) * I32_NORM_F64
        return np.clip(v, -1.0, 1.0).astype(np.float32)
    raise ValueError(f"unsupported playback format {fmt!r}")


def fast_path_needs_clamp(fmt: AudioFormat) -> bool:
    """True when the speed==1 path clamps this format (everything but F32)."""
    return fmt != AudioFormat.F32
