"""ITU-R BS.1770-4 / EBU R128 loudness measurement.

Counterpart of ``whitebox_tpu/ops/loudness.py``. The reference DAW meters
only instantaneous peak/RMS (src/engine/vu_meter.h); broadcast loudness
(the delivery spec every master is checked against) has no equivalent
there. This module measures:

- **Integrated loudness** (LUFS): K-weighted, 400 ms blocks at 75 % overlap,
  -70 LUFS absolute gate then -10 LU relative gate (BS.1770-4 §2).
- **Momentary / short-term maxima** (400 ms / 3 s windows, 100 ms hop).
- **Loudness range** (LRA, EBU Tech 3342): short-term distribution gated at
  -70 absolute / -20 relative, 10th->95th percentile spread.
- **True peak** (dBTP): 4x oversampled peak via a polyphase windowed-sinc
  interpolator (BS.1770-4 Annex 2).

:func:`measure_loudness` runs the K-filter and the true peak on a torch
device: the two K-weighting sections are one call of the biquad cascade
(``ops/biquad_cuda.py::biquad_cascade``: the hand CUDA kernel on the card,
the plain scan on the CPU) over the whole ``[C, F]``, the per-hop power
sums are read back as f64, and the four interpolator phases are four
spectral products with one ``torch.fft.rfft`` of the signal.
:func:`measure_loudness_reference` keeps everything in host f64 (the test
oracle). Gating, LRA and the LUFS arithmetic work on the small per-hop
power arrays on the host in f64, the same for both.

K-filter coefficients follow the BS.1770 analog prototype de-normalized to
the session rate (the spec tabulates 48 kHz; the prototype parameters
reproduce that table to 1e-6 and generalize to any fs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.biquad import BiquadCoeffs, biquad_sequential, eig_section_params
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade

# BS.1770 K-weighting analog prototype (de-normalization constants that
# reproduce the spec's 48 kHz coefficient table):
_SHELF_F0 = 1681.9744509555319
_SHELF_GAIN_DB = 3.99984385397
_SHELF_Q = 0.7071752369554193
_HP_F0 = 38.13547087613982
_HP_Q = 0.5003270373253953

#: BS.1770-4 channel weights: L/R/C = 1.0, Ls/Rs = 1.41 (we meter the
#: session's stereo/mono buses; >5 channels fall back to 1.0)
_ABS_GATE_LUFS = -70.0


_SHELF_VB_EXP = 0.4996667741545416  # band coefficient exponent of the prototype


def k_weighting_coeffs(sample_rate: float) -> tuple[BiquadCoeffs, BiquadCoeffs]:
    """(high-shelf, high-pass) K-weighting sections at ``sample_rate``.

    Bilinear transform of the BS.1770 analog prototype (the published
    de-normalization that reproduces the spec's 48 kHz table to ~1e-9 and
    generalizes to any rate). The high-pass numerator is exactly
    ``[1, -2, 1]`` — the spec leaves it un-normalized.
    """
    fs = float(sample_rate)

    # stage 1: high-frequency shelf
    K = math.tan(math.pi * _SHELF_F0 / fs)
    Vh = 10.0 ** (_SHELF_GAIN_DB / 20.0)
    Vb = Vh ** _SHELF_VB_EXP
    a0 = 1.0 + K / _SHELF_Q + K * K
    shelf = BiquadCoeffs(
        (Vh + Vb * K / _SHELF_Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / _SHELF_Q + K * K) / a0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / _SHELF_Q + K * K) / a0,
    )

    # stage 2: high-pass
    K = math.tan(math.pi * _HP_F0 / fs)
    a0 = 1.0 + K / _HP_Q + K * K
    hp = BiquadCoeffs(
        1.0, -2.0, 1.0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / _HP_Q + K * K) / a0,
    )
    return shelf, hp


def channel_weights(C: int) -> np.ndarray:
    w = np.ones(C, np.float64)
    if C >= 5:
        w[3:5] = 1.41  # Ls/Rs in L R C Ls Rs ordering
    return w


def _block_powers(z_hop: np.ndarray, hops_per_win: int) -> np.ndarray:
    """Windowed mean power from per-hop channel-weighted power sums.

    z_hop: [n_hops] mean power per hop; returns [n_windows] mean power per
    overlapping window of ``hops_per_win`` consecutive hops."""
    n = z_hop.shape[0] - hops_per_win + 1
    if n <= 0:
        return np.empty((0,), np.float64)
    cs = np.concatenate([[0.0], np.cumsum(z_hop, dtype=np.float64)])
    return (cs[hops_per_win:hops_per_win + n] - cs[:n]) / hops_per_win


def _lufs(power: np.ndarray | float) -> np.ndarray:
    return -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))


@dataclass
class LoudnessStats:
    """EBU R128 measurement of one rendered bus."""

    integrated_lufs: float
    momentary_max_lufs: float
    shortterm_max_lufs: float
    lra_lu: float
    true_peak_dbtp: float

    def as_dict(self) -> dict:
        """JSON-safe dict: non-finite readings (silence) become None —
        json.dumps would otherwise emit the non-standard -Infinity token."""
        fin = lambda v: float(v) if math.isfinite(v) else None
        return {
            "integrated_lufs": fin(self.integrated_lufs),
            "momentary_max_lufs": fin(self.momentary_max_lufs),
            "shortterm_max_lufs": fin(self.shortterm_max_lufs),
            "lra_lu": fin(self.lra_lu),
            "true_peak_dbtp": fin(self.true_peak_dbtp),
        }


def _true_peak_ir(phases: int = 4, taps_per_phase: int = 12) -> np.ndarray:
    """Polyphase windowed-sinc interpolator IR (BS.1770-4 Annex 2 style)."""
    n = phases * taps_per_phase
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / phases
    h = np.sinc(t) * np.hamming(n)
    return h  # gain 1 per phase (sinc zero crossings at integer t)


def k_weighting_cascade(sample_rate: float, channels: int, device="cpu") -> torch.Tensor:
    """The two K-weighting sections as the cascade's coefficients
    ``[9, 2, channels, 1]`` f32 on ``device`` (``eig_section_params`` of
    each, the same for every row)."""
    shelf, hp = k_weighting_coeffs(sample_rate)
    p = np.stack([eig_section_params(shelf), eig_section_params(hp)], axis=1)  # [9, 2]
    p = np.broadcast_to(p[:, :, None, None], (p.shape[0], 2, channels, 1))
    return torch.from_numpy(np.ascontiguousarray(p)).to(device)


def measure_loudness(audio: np.ndarray, sample_rate: float, *, device=None) -> LoudnessStats:
    """Measure a finished bus [C, F] (f32/f64 in ±1.0 full scale) on
    ``device`` (default: the CUDA card; ``"cpu"`` runs the same torch ops
    with the cascade's plain version).

    The whole ``[C, F]`` goes through the cascade in one call (a short
    batch is launch-bound, so it is not cut into chunks); the per-hop power
    sums of the K-weighted signal come back in f64; the true peak is the
    largest magnitude of the four interpolator phases (one rFFT of the
    signal, four spectral products), floored at the sample peak."""
    dev = resolve_device(device)
    audio = np.atleast_2d(np.asarray(audio))
    C, F = audio.shape
    fs = float(sample_rate)
    hop = max(int(round(0.1 * fs)), 1)
    n_hops = F // hop

    x = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32)).to(dev)
    if n_hops:
        zeros = [torch.zeros((C, 2), dtype=torch.float32, device=dev) for _ in range(2)]
        y, _ = biquad_cascade(x, k_weighting_cascade(fs, C, dev), zeros)
        sq = torch.square(y[:, : n_hops * hop]).reshape(C, n_hops, hop)
        zh = sq.sum(dim=-1, dtype=torch.float64).cpu().numpy()  # [C, n_hops]
    else:
        zh = np.zeros((C, 0), np.float64)
    # true peak: the 4 interpolator phases are 4 short FIRs over the
    # original-rate signal — one shared FFT of x, 4 spectral products
    tp = 0.0
    if F:
        ir = _true_peak_ir()
        K = ir.size // 4
        nf = 1
        while nf < F + K - 1:
            nf <<= 1
        Xf = torch.fft.rfft(x, nf, dim=-1)
        # floor at the raw sample peak: the interpolator phases sit between
        # samples, so BS.1770's true-peak >= sample-peak needs the max
        peak = x.abs().amax()
        for p in range(4):
            Hf = torch.fft.rfft(torch.from_numpy(ir[p::4].astype(np.float32)).to(dev), nf)
            yp = torch.fft.irfft(Xf * Hf[None, :], nf, dim=-1)
            peak = torch.maximum(peak, yp[:, : F + K - 1].abs().amax())
        tp = float(peak)
    return _gate(zh, hop, tp)


def measure_loudness_reference(audio: np.ndarray, sample_rate: float) -> LoudnessStats:
    """The same measurement in host f64 (the JAX package's ``device=False``
    branch): the K-filter by ``biquad_sequential``, the true peak by direct
    convolution of each interpolator phase."""
    audio = np.atleast_2d(np.asarray(audio))
    C, F = audio.shape
    fs = float(sample_rate)
    shelf, hp = k_weighting_coeffs(fs)
    hop = max(int(round(0.1 * fs)), 1)

    y, _ = biquad_sequential(audio, shelf)
    y, _ = biquad_sequential(y, hp)
    n_hops = F // hop
    zh = (np.square(y[:, : n_hops * hop]).reshape(C, n_hops, hop).sum(-1)
          if n_hops else np.zeros((C, 0), np.float64))
    ir = _true_peak_ir()
    tp = float(np.max(np.abs(audio))) if audio.size else 0.0
    for p in range(4):
        yp = np.stack([np.convolve(audio[c].astype(np.float64), ir[p::4])
                       for c in range(C)])
        tp = max(tp, float(np.max(np.abs(yp))))
    return _gate(zh, hop, tp)


def _gate(zh: np.ndarray, hop: int, tp: float) -> LoudnessStats:
    """Per-hop channel power sums ``zh`` [C, n_hops] (f64) and the true
    peak (linear) -> the R128 readings (host f64)."""
    w = channel_weights(zh.shape[0])
    z_hop = (w[:, None] * zh).sum(0) / hop  # [n_hops] weighted mean power/hop

    mom = _lufs(_block_powers(z_hop, 4))    # 400 ms, 100 ms hop
    st = _lufs(_block_powers(z_hop, 30))    # 3 s, 100 ms hop

    # integrated: gate the 400 ms blocks (abs -70, then relative -10 LU)
    if mom.size:
        p_mom = 10.0 ** ((mom + 0.691) / 10.0)
        keep = mom > _ABS_GATE_LUFS
        if keep.any():
            rel = _lufs(p_mom[keep].mean()) - 10.0
            keep &= mom > rel
        integrated = float(_lufs(p_mom[keep].mean())) if keep.any() else -np.inf
        momentary_max = float(mom.max())
    else:
        integrated, momentary_max = -math.inf, -math.inf

    # LRA (EBU Tech 3342): short-term, abs -70 then relative -20 LU gates
    if st.size:
        p_st = 10.0 ** ((st + 0.691) / 10.0)
        keep = st > _ABS_GATE_LUFS
        if keep.any():
            rel = _lufs(p_st[keep].mean()) - 20.0
            kept = st[keep & (st > rel)]
            lra = float(np.percentile(kept, 95) - np.percentile(kept, 10)) if kept.size else 0.0
        else:
            lra = 0.0
        shortterm_max = float(st.max())
    else:
        lra, shortterm_max = 0.0, -math.inf

    return LoudnessStats(
        integrated_lufs=integrated,
        momentary_max_lufs=momentary_max,
        shortterm_max_lufs=shortterm_max,
        lra_lu=lra,
        true_peak_dbtp=20.0 * math.log10(max(tp, 1e-30)),
    )
