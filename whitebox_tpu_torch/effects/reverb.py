"""Convolution reverb: FFT overlap-add with a real or generated impulse
response.

Counterpart of ``whitebox_tpu/effects/reverb.py``. Each processed chunk
runs one overlap-add block through ``torch.fft.rfft``/``irfft``, the
``ir_len - 1`` frame tail carried as state, so chunked processing equals
one-shot. ``design_room_ir`` generates a seeded, stereo-decorrelated
exponential-decay noise IR on the host (the JAX package's generator,
copied: the same seed gives the same IR in both packages).
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.effects.base import Effect


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 1)


def design_room_ir(sample_rate: float, *, seconds: float = 1.2, rt60_s: float = 0.9,
                   predelay_s: float = 0.01, damp_hz: float = 6000.0,
                   channels: int = 2, seed: int = 0) -> np.ndarray:
    """Exponential-decay noise IR [channels, L] f32, energy-normalized:
    independent noise per channel, a fixed one-pole lowpass at ``damp_hz``
    on the tail, -60 dB at ``rt60_s``."""
    fs = float(sample_rate)
    L = max(int(seconds * fs), 8)
    pre = min(int(predelay_s * fs), L - 1)
    rng = np.random.RandomState(seed)
    t = np.arange(L, dtype=np.float64) / fs
    env = 10.0 ** (-3.0 * t / rt60_s)  # -60 dB at rt60
    ir = rng.standard_normal((channels, L)) * env
    ir[:, :pre] = 0.0
    a = float(np.exp(-2.0 * np.pi * damp_hz / fs))
    for c in range(channels):
        acc = 0.0
        for n in range(L):  # host-side once per prepare
            acc = a * acc + (1.0 - a) * ir[c, n]
            ir[c, n] = acc
    ir /= np.sqrt(np.sum(ir**2, axis=1, keepdims=True)) + 1e-12
    return ir.astype(np.float32)


def ir_spectrum(ir: torch.Tensor, frames: int) -> torch.Tensor:
    """rfft of ``ir`` [..., L] zero-padded to the overlap-add size of a
    ``frames``-frame block (the next power of two >= frames + L - 1)."""
    return torch.fft.rfft(ir, _next_pow2(frames + ir.shape[-1] - 1), dim=-1)


def fft_convolve_chunk(x, ir_f, ir_len: int, carry):
    """One overlap-add block: y = conv(x, ir)[:F] plus the carried tail.

    x [..., C, F]; ir_f [..., C, K], the rfft of the zero-padded IR at
    nfft >= F + ir_len - 1 (:func:`ir_spectrum`); carry [..., C, ir_len-1].
    Returns (y, new_carry)."""
    F = x.shape[-1]
    nfft = 2 * (ir_f.shape[-1] - 1)
    full = torch.fft.irfft(torch.fft.rfft(x, nfft, dim=-1) * ir_f, nfft, dim=-1)
    full = full[..., : F + ir_len - 1]
    head = full[..., : ir_len - 1] + carry
    full = torch.cat([head, full[..., ir_len - 1:]], dim=-1)
    return full[..., :F], full[..., F : F + ir_len - 1]


class ConvolutionReverb(Effect):
    """out = dry*x + wet*(x (*) ir). ``ir``: [L] (shared) or [C, L] f32;
    None selects the generated default room."""

    name = "convreverb"

    def __init__(self, ir: np.ndarray | None = None, *, wet: float = 0.3,
                 dry: float = 1.0, room_seconds: float = 1.2, rt60_s: float = 0.9,
                 room_seed: int = 0) -> None:
        super().__init__()
        self.ir_host = None if ir is None else np.atleast_2d(np.asarray(ir, np.float32))
        self.wet = float(wet)
        self.dry = float(dry)
        self.room_seconds = float(room_seconds)
        self.rt60_s = float(rt60_s)
        self.room_seed = int(room_seed)
        self._ir = None  # prepared [C, L]

    def prepare(self, sample_rate: float, channels: int = 2) -> "ConvolutionReverb":
        super().prepare(sample_rate, channels)
        if self.ir_host is None:
            ir = design_room_ir(sample_rate, seconds=self.room_seconds, rt60_s=self.rt60_s,
                                channels=channels, seed=self.room_seed)
        else:
            ir = self.ir_host
            if ir.shape[0] == 1 and channels > 1:
                ir = np.broadcast_to(ir, (channels, ir.shape[1]))
        self._ir = np.array(ir, np.float32)  # a writable copy
        return self

    @property
    def ir_len(self) -> int:
        assert self._ir is not None, "call prepare(sample_rate) first"
        return int(self._ir.shape[-1])

    def static_config(self):
        return (self.ir_len,)

    def param_arrays(self) -> dict:
        return {"wet": self.wet, "dry": self.dry}

    def init_state(self, channels: int):
        return {"carry": torch.zeros((channels, self.ir_len - 1))}

    def process(self, x, state):
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        ir = torch.from_numpy(self._ir).to(x.device)
        wetsig, carry = fft_convolve_chunk(x, ir_spectrum(ir, x.shape[-1]), self.ir_len, state["carry"])
        y = torch.tensor(self.dry, dtype=torch.float32) * x + torch.tensor(self.wet, dtype=torch.float32) * wetsig
        return y, {"carry": carry}

    def tail_frames(self) -> int:
        return self.ir_len
