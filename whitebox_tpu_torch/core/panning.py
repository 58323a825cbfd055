"""Panning laws — mirrors the reference's src/core/panning_law.cpp.

The reference implements Linear and ConstantPower_3db (the engine's default,
track.cpp:629) and leaves Balanced / -4.5 dB / -6 dB as silent stubs. Here
the implemented laws reproduce the C++ float64 math bit-for-bit (narrowed to
f32 at the end, exactly like ``PanningCoefficient``); the stubbed laws get
real constant-power formulas as a documented extension (returning silence
would be a bug, not a capability).
"""

from __future__ import annotations

import enum
import math

import numpy as np


class PanningLaw(enum.IntEnum):
    """panning_law.h — pan law selector."""

    LINEAR = 0
    BALANCED = 1
    CONSTANT_POWER_3DB = 2
    CONSTANT_POWER_4_5DB = 3
    CONSTANT_POWER_6DB = 4


def calculate_panning_coefs(pan, law: PanningLaw = PanningLaw.CONSTANT_POWER_3DB):
    """Pan position in [-1, 1] -> (left, right) f32 gain coefficients.

    Mirrors panning_law.cpp:9-32: all math in float64, pan rescaled to
    x = 0.5*(p+1), result narrowed to float32. Accepts scalars or arrays;
    returns a pair of float32 scalars/arrays.
    """
    p = np.asarray(pan, dtype=np.float64)
    x = 0.5 * (p + 1.0)

    if law == PanningLaw.LINEAR:
        left = (1.0 - x) * 0.5
        right = x * 0.5
        boost = 2.0
    elif law == PanningLaw.CONSTANT_POWER_3DB:
        left = np.sin(0.5 * math.pi * (1.0 - x))
        right = np.sin(0.5 * math.pi * x)
        boost = math.sqrt(2.0)
    elif law == PanningLaw.CONSTANT_POWER_6DB:
        # Extension (reference stubs this): -6 dB center, no boost.
        left = 1.0 - x
        right = x
        boost = 1.0
    elif law == PanningLaw.CONSTANT_POWER_4_5DB:
        # Extension: geometric mean of the -3 dB and -6 dB laws.
        left = np.sqrt((1.0 - x) * np.sin(0.5 * math.pi * (1.0 - x)))
        right = np.sqrt(x * np.sin(0.5 * math.pi * x))
        boost = math.sqrt(math.sqrt(2.0))
    elif law == PanningLaw.BALANCED:
        # Extension: attenuate only the opposite side, unity at center.
        left = np.minimum(1.0, 2.0 * (1.0 - x))
        right = np.minimum(1.0, 2.0 * x)
        boost = 1.0
    else:
        raise ValueError(f"unknown panning law {law!r}")

    l32 = np.asarray(left * boost, dtype=np.float32)
    r32 = np.asarray(right * boost, dtype=np.float32)
    if l32.ndim == 0:
        return l32[()], r32[()]
    return l32, r32
