"""Dynamics effects: Compressor, Limiter, NoiseGate.

Counterpart of ``whitebox_tpu/effects/dynamics.py``, built on the
frame-parallel scans of ``ops/dynamics.py``. Times are seconds; levels
dBFS.
"""

from __future__ import annotations

import torch

from whitebox_tpu_torch.effects.base import Effect
from whitebox_tpu_torch.ops import dynamics as dyn


def _as_params(d: dict) -> dict:
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float32)


class Compressor(Effect):
    """Downward compressor, soft knee, peak or RMS detector, stereo-linked.

    ``sidechain=True`` makes the detector listen to an external key signal
    (ducking); with no key routed it hears silence and the compressor
    passes audio at makeup gain."""

    name = "compressor"

    def __init__(self, threshold_db: float = -18.0, ratio: float = 4.0, *,
                 knee_db: float = 6.0, attack_s: float = 0.005,
                 release_s: float = 0.1, makeup_db: float = 0.0,
                 detector: str = "peak", rms_window_s: float = 0.03,
                 sidechain: bool = False) -> None:
        super().__init__()
        if detector not in ("peak", "rms"):
            raise ValueError(f"detector {detector!r}")
        self.threshold_db = float(threshold_db)
        self.ratio = float(ratio)
        self.knee_db = float(knee_db)
        self.attack_s = float(attack_s)
        self.release_s = float(release_s)
        self.makeup_db = float(makeup_db)
        self.detector = detector
        self.rms_window_s = float(rms_window_s)
        self.sidechain = bool(sidechain)

    def static_config(self):
        return (self.detector, self.sidechain)

    def param_arrays(self) -> dict:
        assert self.sample_rate is not None, "call prepare(sample_rate) first"
        return {
            "threshold_db": self.threshold_db,
            "ratio": self.ratio,
            "knee_db": self.knee_db,
            "attack": float(dyn.time_coef(self.attack_s, self.sample_rate)),
            "release": float(dyn.time_coef(self.release_s, self.sample_rate)),
            "makeup_db": self.makeup_db,
            "det_avg": float(dyn.time_coef(self.rms_window_s, self.sample_rate)),
        }

    def init_state(self, channels: int):
        return {"red": _z(), "att": _z(), "det": _z()}

    def process(self, x, state, key=None):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        return dyn.compressor_process(x, _as_params(self.param_arrays()), state, detector=self.detector,
                                      key=None if key is None else torch.atleast_2d(key))

    def tail_frames(self) -> int:
        return int(5.0 * self.release_s * (self.sample_rate or 48000.0))


class Limiter(Effect):
    """Brickwall limiter (infinite ratio), optional lookahead."""

    name = "limiter"

    def __init__(self, ceiling_db: float = -0.3, *, attack_s: float = 0.001,
                 release_s: float = 0.05, lookahead_s: float = 0.005) -> None:
        super().__init__()
        self.ceiling_db = float(ceiling_db)
        self.attack_s = float(attack_s)
        self.release_s = float(release_s)
        self.lookahead_s = float(lookahead_s)
        self.lookahead: int = 0

    def prepare(self, sample_rate: float, channels: int = 2) -> "Limiter":
        super().prepare(sample_rate, channels)
        self.lookahead = int(round(self.lookahead_s * sample_rate))
        return self

    def static_config(self):
        return (self.lookahead,)

    def param_arrays(self) -> dict:
        assert self.sample_rate is not None, "call prepare(sample_rate) first"
        return {
            "ceiling_db": self.ceiling_db,
            "attack": float(dyn.time_coef(self.attack_s, self.sample_rate)),
            "release": float(dyn.time_coef(self.release_s, self.sample_rate)),
        }

    def init_state(self, channels: int):
        L = self.lookahead
        return {"red": _z(), "att": _z(), "look": _z(L), "xdelay": _z(channels, L)}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        return dyn.limiter_process(x, _as_params(self.param_arrays()), state, lookahead=self.lookahead)

    def latency_frames(self) -> int:
        """The lookahead delay."""
        return self.lookahead

    def tail_frames(self) -> int:
        return self.lookahead + int(5.0 * self.release_s * (self.sample_rate or 48000.0))


class NoiseGate(Effect):
    """Downward gate: instant open, exponential close, declicked.
    ``sidechain=True``: the gate opens on an external key signal."""

    name = "gate"

    def __init__(self, threshold_db: float = -50.0, *, range_db: float = 80.0,
                 attack_s: float = 0.001, release_s: float = 0.1,
                 hysteresis_db: float = 0.0, sidechain: bool = False) -> None:
        super().__init__()
        self.threshold_db = float(threshold_db)
        self.range_db = float(range_db)
        self.attack_s = float(attack_s)
        self.release_s = float(release_s)
        self.hysteresis_db = float(hysteresis_db)
        self.sidechain = bool(sidechain)

    def static_config(self):
        return (self.sidechain,)

    def param_arrays(self) -> dict:
        assert self.sample_rate is not None, "call prepare(sample_rate) first"
        return {
            "threshold_db": self.threshold_db,
            "range_db": self.range_db,
            "attack": float(dyn.time_coef(self.attack_s, self.sample_rate)),
            "release": float(dyn.time_coef(self.release_s, self.sample_rate)),
            "hyst_db": self.hysteresis_db,
        }

    def init_state(self, channels: int):
        return {"open": _z(), "att": _z()}

    def process(self, x, state, key=None):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        return dyn.gate_process(x, _as_params(self.param_arrays()), state,
                                key=None if key is None else torch.atleast_2d(key))

    def tail_frames(self) -> int:
        return int(5.0 * self.release_s * (self.sample_rate or 48000.0))
