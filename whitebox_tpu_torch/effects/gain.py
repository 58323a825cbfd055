"""Gain effect, the simplest slot (dsp::apply_gain as a module).

Counterpart of ``whitebox_tpu/effects/gain.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.core.math import db_to_linear_f32
from whitebox_tpu_torch.effects.base import Effect


class Gain(Effect):
    name = "gain"

    def __init__(self, gain_db: float = 0.0) -> None:
        super().__init__()
        self.gain_db = float(gain_db)

    @property
    def gain_linear(self) -> np.float32:
        return np.float32(db_to_linear_f32(self.gain_db))

    def process(self, x, state):
        return torch.atleast_2d(torch.as_tensor(x)) * float(self.gain_linear), state
