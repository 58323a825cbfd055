"""Delay and modulation effects: Delay (echo / ping-pong), Chorus, Flanger.

Counterpart of ``whitebox_tpu/effects/delay.py``, built on the combs and
modulated taps of ``ops/delay.py``; every effect carries exact
chunk-boundary state.
"""

from __future__ import annotations

import math

import torch

from whitebox_tpu_torch.effects.base import Effect
from whitebox_tpu_torch.ops import delay as dl


class Delay(Effect):
    """Feedback delay: out = dry*x + wet*w, w[n] = x[n-D] + fb*w[n-D].
    mode "stereo": a comb per channel; "pingpong": the wet line feeds back
    through the opposite channel."""

    name = "delay"

    def __init__(self, time_s: float = 0.25, feedback: float = 0.35, *,
                 wet: float = 0.35, dry: float = 1.0, mode: str = "stereo") -> None:
        super().__init__()
        if mode not in ("stereo", "pingpong"):
            raise ValueError(f"mode {mode!r}")
        if not 0.0 <= abs(feedback) < 1.0:
            raise ValueError("feedback must satisfy |fb| < 1")
        self.time_s = float(time_s)
        self.feedback = float(feedback)
        self.wet = float(wet)
        self.dry = float(dry)
        self.mode = mode
        self.D: int = 0

    def prepare(self, sample_rate: float, channels: int = 2) -> "Delay":
        super().prepare(sample_rate, channels)
        self.D = max(int(round(self.time_s * sample_rate)), 1)
        return self

    def static_config(self):
        return (self.mode, self.D)

    def param_arrays(self) -> dict:
        return {"feedback": self.feedback, "wet": self.wet, "dry": self.dry}

    def init_state(self, channels: int):
        assert self.D > 0, "call prepare(sample_rate) first"
        return {"w": torch.zeros((channels, self.D)), "x": torch.zeros((channels, self.D))}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        fb = torch.tensor(self.feedback, dtype=torch.float32)
        if self.mode == "pingpong" and x.shape[-2] == 2:
            w, wl, xl = dl.comb_feedback_pingpong(x, fb, state["w"], state["x"], D=self.D)
        else:
            w, wl, xl = dl.comb_feedback(x, fb, state["w"], state["x"], D=self.D)
        y = torch.tensor(self.dry, dtype=torch.float32) * x + torch.tensor(self.wet, dtype=torch.float32) * w
        return y, {"w": wl, "x": xl}

    def tail_frames(self) -> int:
        # echoes decay by |fb| each D frames; ring down to -120 dB
        if self.feedback == 0.0:
            return self.D
        taps = math.log(1e-6) / math.log(abs(self.feedback))
        return int(self.D * min(taps + 1.0, 1000.0))


class Chorus(Effect):
    """Multi-voice feedforward chorus: LFO-swept fractional taps, summed.
    Voice phases spread over the unit circle; the channels a quarter turn
    apart."""

    name = "chorus"

    def __init__(self, *, rate_hz: float = 0.8, depth_s: float = 0.004,
                 center_s: float = 0.015, voices: int = 2,
                 wet: float = 0.5, dry: float = 1.0) -> None:
        super().__init__()
        if not 1 <= int(voices) <= 8:
            raise ValueError("voices must be 1..8")
        if depth_s >= center_s:
            raise ValueError("depth must be < center delay")
        self.rate_hz = float(rate_hz)
        self.depth_s = float(depth_s)
        self.center_s = float(center_s)
        self.voices = int(voices)
        self.wet = float(wet)
        self.dry = float(dry)
        self.max_delay: int = 0

    _channel_phase = 0.5 * 3.141592653589793  # quarter turn between L/R

    def prepare(self, sample_rate: float, channels: int = 2) -> "Chorus":
        super().prepare(sample_rate, channels)
        self.max_delay = int((self.center_s + self.depth_s) * sample_rate) + 4
        return self

    def static_config(self):
        return (self.voices, self.max_delay)

    def param_arrays(self) -> dict:
        fs = self.sample_rate or 48000.0
        return {
            "rate_hz": self.rate_hz,
            "rate_splits": dl.lfo_rate_splits(self.rate_hz, fs),
            "depth": self.depth_s * fs,
            "center": self.center_s * fs,
            "wet": self.wet,
            "dry": self.dry,
        }

    def init_state(self, channels: int):
        assert self.max_delay > 0, "call prepare(sample_rate) first"
        return {"xtail": torch.zeros((channels, self.max_delay)), "n0": 0}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        C, F = x.shape[-2], x.shape[-1]
        fs = self.sample_rate
        acc = torch.zeros_like(x)
        two_pi = 2.0 * 3.141592653589793
        new_tail = state["xtail"]
        for v in range(self.voices):
            phases = torch.tensor([two_pi * v / self.voices + c * self._channel_phase for c in range(C)],
                                  dtype=torch.float32, device=x.device)[:, None]
            d = dl.lfo_delay_frames(state["n0"], F, depth_frames=float(self.depth_s * fs),
                                    center_frames=float(self.center_s * fs), phase=phases,
                                    rate_splits=dl.lfo_rate_splits(self.rate_hz, fs), device=x.device)
            tap, new_tail = dl.modulated_tap(x, d, state["xtail"], max_delay=self.max_delay)
            acc = acc + tap
        y = torch.tensor(self.dry, dtype=torch.float32) * x + \
            torch.tensor(self.wet / self.voices, dtype=torch.float32) * acc
        return y, {"xtail": new_tail, "n0": state["n0"] + F}

    def tail_frames(self) -> int:
        return self.max_delay


class Flanger(Chorus):
    """Feedforward flanger: one short swept tap (the jet-sweep comb); the
    regenerative form is not offered."""

    name = "flanger"

    def __init__(self, *, rate_hz: float = 0.25, depth_s: float = 0.002,
                 center_s: float = 0.003, wet: float = 0.7, dry: float = 1.0) -> None:
        super().__init__(rate_hz=rate_hz, depth_s=depth_s, center_s=center_s,
                         voices=1, wet=wet, dry=dry)
