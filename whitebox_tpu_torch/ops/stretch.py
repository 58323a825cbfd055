"""Phase-vocoder time-stretch and pitch-shift.

Counterpart of ``whitebox_tpu/ops/stretch.py``. The reference resamples
clips (speed != 1 changes duration AND pitch, src/dsp/sampler.cpp:34-59);
independent control of duration and pitch has no upstream equivalent.
This is the STFT phase vocoder:

    analysis frames at hop ``ha`` -> phase propagation at synthesis hop
    ``hs`` (true-frequency estimate per bin) -> overlap-add resynthesis

The host parts are the JAX package's: the integer frame positions, the
periodic Hann window, and the bins' expected phase advance and nominal
synthesis ramp, wrapped exactly on the host (f64 / int64) so that no
unwrapped phase reaches the device. The device part is torch ops: framing
as one gather, ``torch.fft.rfft`` over all frames, magnitude and phase,
the principal-value heterodyne deviation, its ``torch.cumsum`` over
frames, the re-wrap, the spectrum from ``mag*cos``/``mag*sin``,
``torch.fft.irfft``, the window, and the overlap-add divided by the window
power as ``torch.nn.functional.fold``: each output sample is a sum in a
fixed order, so two runs on one device give the same bits (a scatter-add
by atomics would not).

The device part runs in f64, where the JAX package (on a TPU) runs f32.
The deviation is wrapped to (-pi, pi] with a rounding whose side flips on
a last-bit difference, and a flip shifts that bin's phase for the rest of
the clip; the card's and the CPU's FFTs differ in the last bits of f32, so
in f32 the two devices would part by more than the output's rounding. The
result is rounded to f32 once, at the end.

``pitch_shift`` = time-stretch by the pitch ratio, then the windowed-sinc
SRC (``ops/resample.py::resample_audio``) back to the original duration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.resample import resample_audio

__all__ = ["time_stretch", "pitch_shift"]

_TWO_PI = 2.0 * math.pi


def _frame_positions(n_out_frames: int, ha: float) -> np.ndarray:
    """Integer analysis positions for each synthesis frame (host, static)."""
    return np.round(np.arange(n_out_frames, dtype=np.float64) * ha).astype(np.int64)


def _wrap(phi: torch.Tensor) -> torch.Tensor:
    """Principal value: ``phi - 2pi * round(phi / 2pi)`` (round half to even)."""
    return phi - _TWO_PI * torch.round(phi / _TWO_PI)


def _overlap_add(segs: torch.Tensor, hs: int, out_len: int) -> torch.Tensor:
    """``segs`` [B, n_frames, fft] -> [B, out_len]: frame t added at t*hs."""
    B, n, fft = segs.shape
    return torch.nn.functional.fold(segs.transpose(1, 2), output_size=(1, out_len),
                                    kernel_size=(1, fft), stride=(1, hs)).reshape(B, out_len)


def time_stretch(audio, ratio: float, *, fft_size: int = 2048, hop: int | None = None,
                 device=None) -> np.ndarray:
    """Stretch ``audio`` [C, F] by ``ratio`` (>1 = longer) at constant pitch,
    on ``device`` (default: the CUDA card; ``"cpu"`` runs the same torch ops).

    Returns f32 [C, round(F * ratio)]. ``hop`` is the synthesis hop
    (default fft_size // 4 — 75 % overlap Hann, COLA-exact).
    """
    dev = resolve_device(device)
    x = np.atleast_2d(np.asarray(audio, np.float32))
    C, F = x.shape
    ratio = float(ratio)
    if ratio <= 0:
        raise ValueError("ratio must be positive")
    hs = int(hop or fft_size // 4)
    ha = hs / ratio
    out_frames_target = int(round(F * ratio))

    # synthesis frame count covering the target length
    n_frames = max(int(math.ceil((out_frames_target + fft_size) / hs)) + 1, 2)
    pos = _frame_positions(n_frames, ha)  # analysis start per frame
    # actual per-frame analysis advance (phase propagation uses the true
    # integer hop between the rounded positions, not the ideal ha)
    dt = np.diff(pos, prepend=pos[0])  # [n_frames], dt[0] = 0
    pad = int(pos[-1]) + fft_size + 1
    xp = np.pad(x, ((0, 0), (0, max(pad - F, 0))))

    win = np.hanning(fft_size + 1)[:-1].astype(np.float32)  # periodic Hann
    k = np.arange(fft_size // 2 + 1, dtype=np.float64)
    wk = 2.0 * np.pi * k / fft_size  # bin center frequency (rad/sample)
    # the bin's expected advance over the ACTUAL analysis hop dt, and the
    # nominal synthesis ramp wk*hs*t, both wrapped exactly on the host:
    # wk = 2pi*k/fft, so wk*hs*t mod 2pi = 2pi * ((k*hs*t) mod fft) / fft
    expected = np.mod(dt[:, None] * wk[None, :], 2.0 * np.pi).astype(np.float32)
    ki = np.arange(fft_size // 2 + 1, dtype=np.int64)
    ti = np.arange(n_frames, dtype=np.int64)
    nominal = (((ti[:, None] * ((ki * hs) % fft_size)[None, :]) % fft_size)
               .astype(np.float32) * np.float32(2.0 * np.pi / fft_size))  # [T, K]

    f64 = torch.float64

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, f64)

    xj, winj = to_dev(xp), to_dev(win)
    dtj = to_dev(dt.astype(np.float32))

    # ---- framing: [C, n_frames, fft] by one gather ----
    idx = torch.from_numpy(pos).to(dev)[:, None] + torch.arange(fft_size, device=dev)[None, :]
    frames = xj[:, idx] * winj

    spec = torch.fft.rfft(frames, dim=-1)  # [C, n_frames, K]
    mag = spec.abs()
    phase = spec.angle()

    # ---- phase propagation as a cumsum of elementwise increments ----
    # heterodyned phase increment: observed inter-frame phase change minus
    # the bin's expected advance, wrapped to (-pi, pi]: the per-bin
    # frequency deviation; only it accumulates, the ramp comes wrapped
    dphase = torch.diff(phase, dim=1, prepend=phase[:, :1])  # [C, T, K]
    deviation = _wrap(dphase - to_dev(expected)[None])
    # deviation part of the synthesis increment: dev/dt per sample * hs
    dev_inc = torch.where(dtj[None, :, None] > 0,
                          deviation * (float(hs) / torch.clamp(dtj, min=1.0))[None, :, None], 0.0)
    out_phase = phase[:, 0:1, :] + to_dev(nominal)[None] + torch.cat(
        [torch.zeros_like(dev_inc[:, :1]), torch.cumsum(dev_inc[:, 1:], dim=1)], dim=1)
    out_phase = _wrap(out_phase)  # re-wrap the bounded sum before the transcendentals

    out_spec = torch.complex(mag * torch.cos(out_phase), mag * torch.sin(out_phase))
    ysegs = torch.fft.irfft(out_spec, fft_size, dim=-1) * winj

    # ---- overlap-add + window-power normalization ----
    out_len = (n_frames - 1) * hs + fft_size
    y = _overlap_add(ysegs, hs, out_len)
    wsum = _overlap_add((winj * winj).expand(1, n_frames, fft_size), hs, out_len)
    y = y / torch.clamp(wsum, min=1e-6)
    # frame t is window-centered at t*hs + fft/2 in BOTH domains, so the
    # stretched signal starts at output index 0 (ratio-1 reconstructs x)
    out = y[:, :out_frames_target].to(torch.float32).cpu().numpy()
    if out.shape[1] < out_frames_target:
        out = np.pad(out, ((0, 0), (0, out_frames_target - out.shape[1])))
    return out


def pitch_shift(audio, semitones: float, sample_rate: float, *, fft_size: int = 2048,
                device=None) -> np.ndarray:
    """Shift pitch by ``semitones`` at constant duration: stretch by the
    pitch ratio, then windowed-sinc resample back (``ops/resample``), both
    on ``device`` (default: the CUDA card)."""
    x = np.atleast_2d(np.asarray(audio, np.float32))
    r = 2.0 ** (float(semitones) / 12.0)
    if abs(r - 1.0) < 1e-9:
        return x.astype(np.float32)
    stretched = time_stretch(x, r, fft_size=fft_size, device=device)
    # playing the stretched audio at rate*r compresses it back to the
    # original duration while transposing by r
    out = resample_audio(stretched, float(sample_rate) * r, float(sample_rate), device=device)
    F = x.shape[1]
    if out.shape[1] < F:
        out = np.pad(out, ((0, 0), (0, F - out.shape[1])))
    return np.asarray(out[:, :F], np.float32)
