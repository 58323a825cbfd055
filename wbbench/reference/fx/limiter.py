"""The reference of a ``limiter`` chain entry: a brickwall limiter with
lookahead, in f64.

``{"type": "limiter", "ceiling_db": c, "attack_s": ta, "release_s": tr,
"lookahead_s": tl}`` (attack 1 ms, release 50 ms, lookahead 5 ms when left
out). Per frame: the level ``L`` (``reference/ballistics.py``), the hard
reduction ``max(L - c, 0)``, its trailing max over the last ``lookahead + 1``
frames (``lookahead = round(tl fs)``), the release and the attack, and the
gain ``10^(-A / 20)`` on every channel of the audio delayed by
``lookahead`` frames. The state carries the last ``lookahead`` reductions and
the delay line from chunk to chunk, both from silence.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter1d

from wbbench.reference import ballistics as bl

#: f32 operations a frame shares over its channels (level 3; the ceiling's
#: difference and clamp 2; the window max, about 3 comparisons a frame by
#: van Herk's method; release 2; attack 3; gain 3) and a row pays alone
FRAME_OPS = 16
ROW_OPS = 3


def resolve(params: dict, track: int) -> dict:
    return {"ceiling_db": bl.f32(params["ceiling_db"]), "attack_s": float(params.get("attack_s", 0.001)),
            "release_s": float(params.get("release_s", 0.05)),
            "lookahead_s": float(params.get("lookahead_s", 0.005))}


def lookahead_frames(params: dict, sample_rate: float) -> int:
    return int(round(params["lookahead_s"] * float(sample_rate)))


def trailing_max(seq: np.ndarray, L: int, n: int) -> np.ndarray:
    """``out[i] = max(seq[i : i + L + 1])`` for ``i < n`` (``len(seq) = L + n``)."""
    h = (L + 1) // 2
    return maximum_filter1d(seq, L + 1)[h:h + n]


def reduction(params: dict, x: np.ndarray, state, sample_rate: float) -> tuple:
    """The smoothed reduction ``A`` in dB per frame of ``x`` ``[C, n]`` from
    ``state`` -> ``(A, state)``; the audio it applies to is ``x`` delayed by
    the lookahead (``state["xdelay"]`` first)."""
    C, n = x.shape
    L = lookahead_frames(params, sample_rate)
    state = state or {"ballistics": None, "look": np.zeros(L), "xdelay": np.zeros((C, L))}
    r = np.maximum(bl.level_db(x) - params["ceiling_db"], 0.0)
    look = state["look"]
    if L > 0:
        seq = np.concatenate([look, r])
        r, look = trailing_max(seq, L, n), seq[n:]
    A, ball = bl.smooth(r, bl.coef(params["release_s"], sample_rate), bl.coef(params["attack_s"], sample_rate),
                        state["ballistics"])
    return A, {"ballistics": ball, "look": look, "xdelay": state["xdelay"]}


def process(params: dict, x, state, sample_rate: float):
    x = np.asarray(x, dtype=np.float64)
    A, state = reduction(params, x, state, sample_rate)
    n = x.shape[-1]
    xs = np.concatenate([state["xdelay"], x], axis=-1)
    state["xdelay"] = xs[:, n:]
    return xs[:, :n] * np.power(10.0, -A / 20.0), state


def ops_per_frame(params: dict) -> int:
    """f32 operations per row and frame: the row's own, and the frame's
    shared work split over the two rows of a stereo pair."""
    return ROW_OPS + -(-FRAME_OPS // 2)
