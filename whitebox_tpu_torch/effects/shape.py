"""Waveshaping and stereo-field effects: Saturator, StereoWidth.

Counterpart of ``whitebox_tpu/effects/shape.py``: memoryless processors.
"""

from __future__ import annotations

import math

import torch

from whitebox_tpu_torch.effects.base import Effect


class Saturator(Effect):
    """tanh soft clip: y = mix * tanh(d*x)/tanh(d) + (1-mix) * x; the
    1/tanh(d) normalization keeps a full-scale input at full scale."""

    name = "saturator"

    def __init__(self, drive_db: float = 6.0, mix: float = 1.0) -> None:
        super().__init__()
        self.drive_db = float(drive_db)
        self.mix = float(mix)

    def param_arrays(self) -> dict:
        d = 10.0 ** (self.drive_db / 20.0)
        return {"drive": d, "norm": 1.0 / math.tanh(d), "mix": self.mix}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        p = {k: torch.tensor(v, dtype=torch.float32) for k, v in self.param_arrays().items()}
        shaped = torch.tanh(p["drive"] * x) * p["norm"]
        return p["mix"] * shaped + (1.0 - p["mix"]) * x, state


class StereoWidth(Effect):
    """Mid/side width: 0 = mono, 1 = unchanged, >1 = wider (stereo only)."""

    name = "width"

    def __init__(self, width: float = 1.0) -> None:
        super().__init__()
        self.width = float(width)

    def param_arrays(self) -> dict:
        return {"width": self.width}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        if x.shape[-2] != 2:
            return x, state
        mid = 0.5 * (x[..., 0, :] + x[..., 1, :])
        side = 0.5 * (x[..., 0, :] - x[..., 1, :]) * torch.tensor(self.width, dtype=torch.float32)
        return torch.stack([mid + side, mid - side], dim=-2), state
