"""The reference of a ``compressor`` chain entry: a downward compressor with a
soft knee and a stereo-linked peak detector, in f64.

``{"type": "compressor", "threshold_db": t, "ratio": q, "knee_db": w,
"attack_s": ta, "release_s": tr, "makeup_db": m, "detector": "peak"}``
(knee 6 dB, attack 5 ms, release 100 ms, makeup 0 and the peak detector
when left out). Per frame: the level ``L`` (``reference/ballistics.py``),
the soft-knee reduction ``r`` (Giannoulis et al. eq. 4 as the level less
the curve: 0 below the knee, ``(1 - 1/q)(L - t)`` above it,
``(1 - 1/q)(L - t + w/2)^2 / (2w)`` inside it), the release and the
attack, and the gain ``10^((m - A) / 20)`` on every channel.
"""

from __future__ import annotations

import numpy as np

from wbbench.reference import ballistics as bl

#: f32 operations a frame shares over its channels (level 3: clamp, log,
#: scale; the knee 9: a difference, two tests, the line, the parabola's add,
#: square and scale, a select, a clamp; release 2; attack 3; gain 3:
#: difference, scale, exp) and a row pays alone (abs, the channel max, the
#: gain's multiply)
FRAME_OPS = 20
ROW_OPS = 3


def resolve(params: dict, track: int) -> dict:
    detector = params.get("detector", "peak")
    if detector != "peak":
        raise ValueError(f"the compressor reference takes the peak detector, got {detector!r}")
    return {"threshold_db": bl.f32(params["threshold_db"]), "ratio": bl.f32(params["ratio"]),
            "knee_db": bl.f32(params.get("knee_db", 6.0)), "attack_s": float(params.get("attack_s", 0.005)),
            "release_s": float(params.get("release_s", 0.1)), "makeup_db": bl.f32(params.get("makeup_db", 0.0)),
            "detector": detector}


def reduction_curve(level: np.ndarray, threshold_db: float, ratio: float, knee_db: float) -> np.ndarray:
    """The soft-knee reduction in dB (>= 0) of the levels ``level``."""
    slope = 1.0 - 1.0 / ratio
    w = max(knee_db, 1e-6)
    over = level - threshold_db
    r = np.where(over <= -0.5 * w, 0.0,
                 np.where(over >= 0.5 * w, slope * over, slope * np.square(over + 0.5 * w) / (2.0 * w)))
    return np.maximum(r, 0.0)


def reduction(params: dict, x: np.ndarray, state, sample_rate: float) -> tuple:
    """The smoothed reduction ``A`` in dB per frame of ``x`` ``[C, n]`` from
    ``state`` -> ``(A, state)``."""
    r = reduction_curve(bl.level_db(x), params["threshold_db"], params["ratio"], params["knee_db"])
    return bl.smooth(r, bl.coef(params["release_s"], sample_rate), bl.coef(params["attack_s"], sample_rate), state)


def process(params: dict, x, state, sample_rate: float):
    x = np.asarray(x, dtype=np.float64)
    A, state = reduction(params, x, state, sample_rate)
    return x * np.power(10.0, (params["makeup_db"] - A) / 20.0), state


def ops_per_frame(params: dict) -> int:
    """f32 operations per row and frame: the row's own, and the frame's
    shared work split over the two rows of a stereo pair."""
    return ROW_OPS + -(-FRAME_OPS // 2)
