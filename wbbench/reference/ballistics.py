"""The dynamics entries' shared parts in f64 (``reference/fx/compressor.py``,
``reference/fx/limiter.py``), written from the published description that the
program follows (Giannoulis, Massberg and Reiss, "Digital Dynamic Range
Compressor Design - A Tutorial and Analysis", JAES 2012): a stereo-linked
peak detector in dB, and the smooth decoupled peak detector of eq. 17, a
release ``R[n] = max(r[n], rho R[n-1])`` followed by an attack
``A[n] = a A[n-1] + (1 - a) R[n]``. Both recurrences are evaluated a block of
frames at a time with NumPy and SciPy, not frame by frame, and carry their
state from chunk to chunk.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy.signal import lfilter

#: the detector's floor: -200 dBFS
FLOOR = 1e-10
#: the largest exponent a release block may scale by, so that rho^-B stays finite in f64
MAX_EXP = 600.0
#: the longest release block
MAX_BLOCK = 1 << 20


def f32(v) -> float:
    """``v`` rounded to f32 (the effects' parameters are f32), as a Python float."""
    return float(np.float32(v))


def coef(seconds: float, sample_rate: float) -> float:
    """The f32 value of ``exp(-1 / (t fs))``, 0 at ``t <= 0`` (instant)."""
    t = float(seconds)
    return 0.0 if t <= 0.0 else f32(math.exp(-1.0 / (t * float(sample_rate))))


def level_db(x: np.ndarray) -> np.ndarray:
    """``[C, n]`` -> ``[n]``: ``20 log10(max(max_c |x_c|, 1e-10))``."""
    return 20.0 * np.log10(np.maximum(np.max(np.abs(x), axis=0), FLOOR))


@lru_cache(maxsize=16)
def _powers(rho: float) -> tuple:
    """``(rho^-k, rho^k)`` for ``k = 1 .. B``, the release block ``B`` of ``rho``."""
    lr = -math.log(rho)
    B = MAX_BLOCK if lr == 0.0 else max(1, min(MAX_BLOCK, int(MAX_EXP / lr)))
    k = np.arange(1, B + 1, dtype=np.float64)
    return np.power(rho, -k), np.power(rho, k)


def release(r: np.ndarray, rho: float, r0: float) -> np.ndarray:
    """``R[n] = max(r[n], rho R[n-1])`` from ``R[-1] = r0`` (``r >= 0``).

    Within a block of ``B`` frames from ``s``:
    ``R[s + j] = rho^(j+1) max(R[s-1], max_{k <= j} r[s+k] rho^-(k+1))``, a
    cumulative max; ``B`` keeps ``rho^-B`` finite."""
    n = r.shape[-1]
    if rho <= 0.0:
        return r.copy()
    up, down = _powers(float(rho))
    B = up.shape[0]
    out = np.empty(n, dtype=np.float64)
    prev = float(r0)
    for s in range(0, n, B):
        m = min(B, n - s)
        acc = np.maximum.accumulate(r[s:s + m] * up[:m])
        np.maximum(acc, prev, out=acc)
        out[s:s + m] = acc * down[:m]
        prev = float(out[s + m - 1])
    return out


def attack(R: np.ndarray, a: float, a0: float) -> np.ndarray:
    """``A[n] = a A[n-1] + (1 - a) R[n]`` from ``A[-1] = a0``."""
    y, _ = lfilter([1.0 - a], [1.0, -a], R, zi=[a * float(a0)])
    return y


def smooth(r: np.ndarray, rho: float, a: float, state) -> tuple:
    """The release then the attack over ``r`` from ``state`` ``(R, A)`` (None: 0, 0)
    -> ``(A, (R_last, A_last))``."""
    r0, a0 = state if state is not None else (0.0, 0.0)
    R = release(r, rho, r0)
    A = attack(R, a, a0)
    return A, (float(R[-1]), float(A[-1]))
