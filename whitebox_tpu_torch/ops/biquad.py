"""Biquad filters: RBJ-cookbook design on the host, the eigenbasis prefix
scan on torch tensors.

Counterpart of the linear time-invariant half of
``whitebox_tpu/ops/biquad.py``:

- coefficient design (Robert Bristow-Johnson's Audio EQ Cookbook, f64),
  :func:`eig_section_params` and :func:`pack_chain_sections` are NumPy on
  the host and give arrays equal to the JAX package's, bit for bit;
- :func:`biquad_sequential` is the f64 ground truth (transposed direct
  form II, one sample at a time);
- :func:`biquad_scan` / :func:`biquad_scan_batched` evaluate the state-space
  recurrence ``z[n] = M z[n-1] + Bv x[n]`` as a composition of affine maps
  by ``ops.scan_util.hillis_scan`` in f32, each multiply and add its own
  op (no ``addcmul``), in the JAX package's order. XLA:CPU contracts some
  of these mul+add pairs into FMAs, so against the JAX scan on the CPU
  the port agrees to a tolerance, not to the bit.

The time-varying half (``design_biquad_device``, ``tv_section_params``,
``biquad_scan_blocked_tv``, ``tv_inject``, ``biquad_sequential_tv``) is
ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np
import torch

from whitebox_tpu_torch.ops.scan_util import hillis_scan


class BiquadType(enum.Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    NOTCH = "notch"
    ALLPASS = "allpass"
    PEAK = "peak"
    LOWSHELF = "lowshelf"
    HIGHSHELF = "highshelf"


@dataclass(frozen=True)
class BiquadCoeffs:
    """Normalized (a0 == 1) coefficients, float64."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    def as_arrays(self):
        return (np.float32(self.b0), np.float32(self.b1), np.float32(self.b2),
                np.float32(self.a1), np.float32(self.a2))


def design_biquad(
    ftype: BiquadType | str,
    freq_hz: float,
    sample_rate: float,
    q: float = math.sqrt(0.5),
    gain_db: float = 0.0,
) -> BiquadCoeffs:
    """RBJ Audio EQ Cookbook, float64."""
    ftype = BiquadType(ftype)
    w0 = 2.0 * math.pi * freq_hz / sample_rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    A = 10.0 ** (gain_db / 40.0)

    if ftype == BiquadType.LOWPASS:
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
        a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    elif ftype == BiquadType.HIGHPASS:
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
        a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    elif ftype == BiquadType.BANDPASS:
        b0, b1, b2 = alpha, 0.0, -alpha
        a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    elif ftype == BiquadType.NOTCH:
        b0, b1, b2 = 1.0, -2 * cw, 1.0
        a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    elif ftype == BiquadType.ALLPASS:
        b0, b1, b2 = 1 - alpha, -2 * cw, 1 + alpha
        a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    elif ftype == BiquadType.PEAK:
        b0, b1, b2 = 1 + alpha * A, -2 * cw, 1 - alpha * A
        a0, a1, a2 = 1 + alpha / A, -2 * cw, 1 - alpha / A
    elif ftype == BiquadType.LOWSHELF:
        sq = 2 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) - (A - 1) * cw + sq)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sq)
        a0 = (A + 1) + (A - 1) * cw + sq
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sq
    elif ftype == BiquadType.HIGHSHELF:
        sq = 2 * math.sqrt(A) * alpha
        b0 = A * ((A + 1) + (A - 1) * cw + sq)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sq)
        a0 = (A + 1) - (A - 1) * cw + sq
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sq
    else:  # pragma: no cover
        raise ValueError(ftype)

    return BiquadCoeffs(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def biquad_sequential(x: np.ndarray, c: BiquadCoeffs, state: np.ndarray | None = None):
    """Ground-truth filter: f64 transposed direct-form II, per channel.

    x: [C, F] (any float dtype). Returns (y [C, F] f64, state [C, 2] f64).
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    C, F = x.shape
    st = np.zeros((C, 2), dtype=np.float64) if state is None else state.astype(np.float64).copy()
    y = np.empty_like(x)
    for ch in range(C):
        s1, s2 = st[ch]
        for n in range(F):
            xn = x[ch, n]
            yn = c.b0 * xn + s1
            s1 = c.b1 * xn - c.a1 * yn + s2
            s2 = c.b2 * xn - c.a2 * yn
            y[ch, n] = yn
        st[ch] = (s1, s2)
    return y, st


def _affine_compose(left, right):
    """Combine scan elements (f32): ``left`` is the earlier prefix; the
    result applies left first (right o left). Elements are 6 tensors
    (m11, m12, m21, m22, v1, v2) of the affine map z -> M z + v."""
    (a11_l, a12_l, a21_l, a22_l, v1_l, v2_l) = left
    (a11_r, a12_r, a21_r, a22_r, v1_r, v2_r) = right
    a11 = a11_r * a11_l + a12_r * a21_l
    a12 = a11_r * a12_l + a12_r * a22_l
    a21 = a21_r * a11_l + a22_r * a21_l
    a22 = a21_r * a12_l + a22_r * a22_l
    v1 = (a11_r * v1_l + a12_r * v2_l) + v1_r
    v2 = (a21_r * v1_l + a22_r * v2_l) + v2_r
    return (a11, a12, a21, a22, v1, v2)


# left identity of _affine_compose (z -> I z + 0): compose(I, r) == r exactly
_AFFINE_IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def eig_section_params(c: BiquadCoeffs) -> np.ndarray:
    """Precompute the eigenbasis-transformed section (host, f64) -> 9 f32.

    The TDF2 state map z[n] = A z[n-1] + B x[n] uses the companion matrix
    A = [[-a1, 1], [-a2, 0]], which is highly non-normal near the unit
    circle: f32 parallel products of it lose up to ~-44 dB (e.g. a 30 Hz
    highpass). In the eigenbasis (M = P^-1 A P: a scaled rotation for
    complex poles, diagonal for real ones, both normal) f32 scan products
    stay well-conditioned.

    Returns (m11, m12, m21, m22, bv1, bv2, p11, p12, b0) where
    z'[n] = M z'[n-1] + Bv x[n] and y[n] = b0 x[n] + (p11 z'1 + p12 z'2)[n-1].
    """
    A = np.array([[-c.a1, 1.0], [-c.a2, 0.0]], dtype=np.float64)
    Bv = np.array([c.b1 - c.a1 * c.b0, c.b2 - c.a2 * c.b0], dtype=np.float64)

    if c.a1 == 0.0 and c.a2 == 0.0:
        # FIR section (gain / identity): A is nilpotent; keep companion form
        P = np.eye(2)
        M = A
    else:
        w, V = np.linalg.eig(A)
        if np.iscomplexobj(w) and abs(w[0].imag) > 1e-12:
            # complex pair: real canonical form [[re, im], [-im, re]]
            v = V[:, 0]
            P = np.stack([v.real, v.imag], axis=1)
            M = np.array([[w[0].real, w[0].imag], [-w[0].imag, w[0].real]])
        else:
            w = w.real
            V = V.real
            if abs(w[0] - w[1]) < 1e-9 or np.linalg.cond(V) > 1e6:
                # (nearly) defective: stay in companion form
                P = np.eye(2)
                M = A
            else:
                P = V
                M = np.diag(w)
        if np.linalg.cond(P) > 1e7:
            P = np.eye(2)
            M = A
    Pinv = np.linalg.inv(P)
    Bp = Pinv @ Bv
    return np.array(
        [M[0, 0], M[0, 1], M[1, 0], M[1, 1], Bp[0], Bp[1], P[0, 0], P[0, 1], c.b0],
        dtype=np.float32,
    )


N_SECTION_PARAMS = 9


def _biquad_scan_eig(x: torch.Tensor, params, state: torch.Tensor):
    """Core scan. params: 9 tensors [B, 1] f32 (see eig_section_params).

    x [B, F] f32; state [B, 2] f32 in the section's eigen coordinates.
    Returns (y [B, F] f32, new_state [B, 2]).
    """
    m11, m12, m21, m22, bv1, bv2, p11, p12, b0 = params
    shape = x.shape
    elems = (
        torch.broadcast_to(m11, shape), torch.broadcast_to(m12, shape),
        torch.broadcast_to(m21, shape), torch.broadcast_to(m22, shape),
        bv1 * x, bv2 * x,
    )
    a11, a12, a21, a22, v1, v2 = hillis_scan(_affine_compose, elems, _AFFINE_IDENTITY)
    s1, s2 = state[:, 0:1], state[:, 1:2]
    z1 = (a11 * s1 + a12 * s2) + v1
    z2 = (a21 * s1 + a22 * s2) + v2
    z1_shift = torch.cat([s1, z1[:, :-1]], dim=1)
    z2_shift = torch.cat([s2, z2[:, :-1]], dim=1)
    y = b0 * x + (p11 * z1_shift + p12 * z2_shift)
    new_state = torch.stack([z1[:, -1], z2[:, -1]], dim=1)
    return y, new_state


def coeffs_device_arrays(c: BiquadCoeffs) -> np.ndarray:
    """f64 coefficients -> the 9 eigenbasis section params (f32)."""
    return eig_section_params(c)


def biquad_scan(x, c: BiquadCoeffs, state=None):
    """Frame-parallel biquad by the eigenbasis prefix scan (log depth).

    x: [C, F] (or [F]) f32 tensor. state: [C, 2] f32 in eigen coordinates
    (opaque: thread it between chunked calls; zeros == silence). Returns
    (y, state).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.dim() == 1:
        x = x[None]
    B = x.shape[0]
    pa = eig_section_params(c)
    arrs = [torch.full((B, 1), float(v), dtype=torch.float32, device=x.device) for v in pa]
    if state is None:
        state = torch.zeros((B, 2), dtype=torch.float32, device=x.device)
    return _biquad_scan_eig(x, arrs, state.to(x.device))


IDENTITY_COEFFS = BiquadCoeffs(1.0, 0.0, 0.0, 0.0, 0.0)


def biquad_scan_batched(x: torch.Tensor, coeff_arrays, state: torch.Tensor):
    """Batched-section biquad: x [B, F]; coeff_arrays = 9 x [B, 1] f32
    (eig_section_params per row); state [B, 2] (eigen coords).

    Each row has its own section (identity rows pass through exactly), so
    a session's per-track chains run as one cascade of batched scans.
    """
    return _biquad_scan_eig(x.to(torch.float32), list(coeff_arrays), state)


#: param-block length for coefficient automation (the time-varying half,
#: ROADMAP.md queue 1, item 6): the reference's default audio buffer
#: (config.cpp:146), where effect params change at block rate
PARAM_BLOCK = 512


def pack_chain_sections(chains: list, channels: int, max_sections: int | None = None):
    """Flatten per-track effect chains into batched cascade coefficients.

    ``chains``: one prepared EffectChain (or None) per track. Every effect
    must reduce to biquad sections (Biquad / ParametricEQ bands / Gain as a
    b0-only section). Returns (S, [9, S, T*C, 1] f32) with identity
    sections padding shorter chains.
    """
    from whitebox_tpu_torch.effects.base import EffectChain
    from whitebox_tpu_torch.effects.eq import Biquad, ParametricEQ
    from whitebox_tpu_torch.effects.gain import Gain

    def sections_of(chain) -> list[BiquadCoeffs]:
        if chain is None:
            return []
        effs = chain.effects if isinstance(chain, EffectChain) else [chain]
        secs: list[BiquadCoeffs] = []
        for e in effs:
            if isinstance(e, Biquad):
                assert e.coeffs is not None, "effect not prepared"
                secs.append(e.coeffs)
            elif isinstance(e, ParametricEQ):
                assert e.coeffs, "effect not prepared"
                secs.extend(e.coeffs)
            elif isinstance(e, Gain):
                g = float(e.gain_linear)
                secs.append(BiquadCoeffs(g, 0.0, 0.0, 0.0, 0.0))
            else:
                raise TypeError(f"effect {e!r} has no biquad-section form")
        return secs

    per_track = [sections_of(c) for c in chains]
    S = max([len(p) for p in per_track] + [max_sections or 0, 1])
    T = len(chains)
    coeff = np.zeros((N_SECTION_PARAMS, S, T, 1), dtype=np.float32)
    for t, secs in enumerate(per_track):
        for s in range(S):
            c = secs[s] if s < len(secs) else IDENTITY_COEFFS
            coeff[:, s, t, 0] = coeffs_device_arrays(c)
    # expand to T*C rows (same section for every channel of a track)
    coeff = np.repeat(coeff, channels, axis=2)
    return S, coeff  # [N_SECTION_PARAMS, S, T*C, 1]
