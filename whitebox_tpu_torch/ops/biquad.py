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

The time-varying half runs coefficient automation: the RBJ design on
tensors (:func:`design_biquad_device`, per param block of
:data:`PARAM_BLOCK` frames), its eigenbasis (:func:`tv_section_params`),
the blocked scan that carries the state across coefficient changes
(:func:`biquad_scan_blocked_tv`, :func:`tv_inject`) and its f64 host
reference (:func:`biquad_sequential_tv`).
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


def biquad_scan_with_transition(x: torch.Tensor, params, state: torch.Tensor):
    """The core scan that also returns the per-position cumulative
    transition shifted by one (position n carries A^(0..n-1), as four
    ``[B, F]`` tensors) and the span's transition ``A_total`` ``[B, 2, 2]``:
    ``y[n] + P_row . (Acum_shift[n] @ z_in)`` injects an entry state later."""
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
    one, zero = torch.ones_like(x[:, :1]), torch.zeros_like(x[:, :1])
    acum = (torch.cat([one, a11[:, :-1]], dim=1), torch.cat([zero, a12[:, :-1]], dim=1),
            torch.cat([zero, a21[:, :-1]], dim=1), torch.cat([one, a22[:, :-1]], dim=1))
    A_total = torch.stack([torch.stack([a11[:, -1], a12[:, -1]], dim=-1),
                           torch.stack([a21[:, -1], a22[:, -1]], dim=-1)], dim=1)
    return y, new_state, acum, A_total


# ---------------------------------------------------------------------------
# time-varying sections (timed coefficient automation)
# ---------------------------------------------------------------------------

#: param-block length for coefficient automation: the reference's default
#: audio buffer (config.cpp:146), where effect params change at block rate
PARAM_BLOCK = 512


def design_biquad_device(ftype: BiquadType | str, freq_hz, q, gain_db, sample_rate: float):
    """RBJ design elementwise on f32 tensors -> dict(b0, b1, b2, a1, a2,
    bv1, bv2, re, imsq).

    Half-angle forms (1-cos w = 2 sin^2(w/2)) keep low-frequency designs
    precise in f32; ``bv1``/``bv2`` are the cancellation-free forms of
    b1 - a1*b0 and b2 - a2*b0, and the pole's (re, imsq) come from the
    analytic factorization, not from ``a2 - a1^2/4`` (the JAX package's
    ``ops/biquad.py:318-422``)."""
    ftype = BiquadType(ftype)
    w0 = float(np.float32(2.0 * math.pi / sample_rate)) * freq_hz
    s2 = torch.sin(0.5 * w0)
    s2sq = torch.square(s2)
    cw = 1.0 - 2.0 * s2sq
    sw = 2.0 * s2 * torch.sqrt(torch.clamp(1.0 - s2sq, min=0.0))
    alpha = sw / (2.0 * q)
    A = torch.exp2(float(np.float32(math.log2(10.0) / 40.0)) * gain_db)
    shelf = ftype in (BiquadType.LOWSHELF, BiquadType.HIGHSHELF)
    swsq = torch.square(sw)
    if ftype == BiquadType.LOWPASS:
        b0, b1, b2 = s2sq, 2.0 * s2sq, s2sq
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
        U1 = 2.0 * s2sq * (2.0 - 2.0 * s2sq + alpha)
        U2 = 2.0 * s2sq * alpha
    elif ftype == BiquadType.HIGHPASS:
        h = 1.0 - s2sq
        b0, b1, b2 = h, -2.0 * h, h
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
        U1 = -2.0 * h * (2.0 * s2sq + alpha)
        U2 = 2.0 * h * alpha
    elif ftype == BiquadType.BANDPASS:
        b0, b1, b2 = alpha, torch.zeros_like(alpha), -alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
        U1 = 2.0 * cw * alpha
        U2 = -2.0 * alpha
    elif ftype == BiquadType.NOTCH:
        b0, b1, b2 = torch.ones_like(alpha), -2.0 * cw, torch.ones_like(alpha)
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
        U1 = -2.0 * cw * alpha
        U2 = 2.0 * alpha
    elif ftype == BiquadType.ALLPASS:
        b0, b1, b2 = 1.0 - alpha, -2.0 * cw, 1.0 + alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
        U1 = -4.0 * cw * alpha
        U2 = 4.0 * alpha
    elif ftype == BiquadType.PEAK:
        b0, b1, b2 = 1.0 + alpha * A, -2.0 * cw, 1.0 - alpha * A
        a0, a1, a2 = 1.0 + alpha / A, -2.0 * cw, 1.0 - alpha / A
        dA = A - 1.0 / A
        U1 = 2.0 * cw * alpha * dA
        U2 = -2.0 * alpha * dA
    elif ftype == BiquadType.LOWSHELF:
        sq = 2.0 * torch.sqrt(A) * alpha
        b0 = A * ((A + 1.0) - (A - 1.0) * cw + sq)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cw)
        b2 = A * ((A + 1.0) - (A - 1.0) * cw - sq)
        a0 = (A + 1.0) + (A - 1.0) * cw + sq
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cw)
        a2 = (A + 1.0) + (A - 1.0) * cw - sq
        U1 = 4.0 * A * (A - 1.0) * ((A + 1.0) * swsq + sq)
        U2 = -4.0 * A * (A - 1.0) * cw * sq
    elif ftype == BiquadType.HIGHSHELF:
        sq = 2.0 * torch.sqrt(A) * alpha
        b0 = A * ((A + 1.0) + (A - 1.0) * cw + sq)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cw)
        b2 = A * ((A + 1.0) + (A - 1.0) * cw - sq)
        a0 = (A + 1.0) - (A - 1.0) * cw + sq
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cw)
        a2 = (A + 1.0) - (A - 1.0) * cw - sq
        U1 = -4.0 * A * (A - 1.0) * ((A + 1.0) * swsq + sq)
        U2 = 4.0 * A * (A - 1.0) * cw * sq
    else:  # pragma: no cover
        raise ValueError(ftype)
    inv_a0 = 1.0 / a0
    # the pole's imsq (signed; < 0 -> real poles) from the analytic
    # a0*a2 - a1^2/4 per family: sw^2 - alpha^2, sw^2 - (alpha/A)^2 for
    # the peak, 4A (sw^2 - alpha^2) for the shelves
    if ftype == BiquadType.PEAK:
        disc = torch.square(sw) - torch.square(alpha / A)
    elif shelf:
        disc = 4.0 * A * (torch.square(sw) - torch.square(alpha))
    else:
        disc = torch.square(sw) - torch.square(alpha)
    inv_a0sq = torch.square(inv_a0)
    return {"b0": b0 * inv_a0, "b1": b1 * inv_a0, "b2": b2 * inv_a0, "a1": a1 * inv_a0,
            "a2": a2 * inv_a0, "bv1": U1 * inv_a0sq, "bv2": U2 * inv_a0sq,
            "re": -0.5 * a1 * inv_a0, "imsq": disc * inv_a0sq}


_TV_EPS = 1e-8  # |imsq| below this -> (near-)defective: companion basis


def tv_section_params(d: dict):
    """Eigenbasis section params from a device design, elementwise: the
    closed-form eigenvectors of the companion matrix (v = (1, lambda + a1)),
    selected per element among complex-pair / real-diagonal / companion
    bases. Returns (params9, P [..., 2, 2], Pinv [..., 2, 2], aux): params9
    the 9-tuple (m11, m12, m21, m22, bv1, bv2, p11, p12, b0), P mapping
    eigen -> z (TDF2) coordinates, aux the complex-pair selector and
    (re, im) for :func:`biquad_scan_blocked_tv`."""
    b0, b1, b2, a1, a2 = d["b0"], d["b1"], d["b2"], d["a1"], d["a2"]
    re, imsq = d["re"], d["imsq"]
    bv1 = d["bv1"] if "bv1" in d else b1 - a1 * b0
    bv2 = d["bv2"] if "bv2" in d else b2 - a2 * b0
    is_c = imsq > _TV_EPS
    is_r = imsq < -_TV_EPS
    one, zero = torch.ones_like(re), torch.zeros_like(re)
    im = torch.sqrt(torch.where(is_c, imsq, 1.0))
    s = torch.sqrt(torch.where(is_r, -imsq, 1.0))
    lp = re + s
    lm = re - s

    def sel(c, r, k):
        return torch.where(is_c, c, torch.where(is_r, r, k))

    m11 = sel(re, lp, -a1)
    m12 = sel(im, zero, one)
    m21 = sel(-im, zero, -a2)
    m22 = sel(re, lm, zero)
    p_11 = sel(one, one, one)
    p_12 = sel(zero, one, zero)
    p_21 = sel(-re, -lm, zero)
    p_22 = sel(im, -lp, one)
    inv_im = 1.0 / im
    inv_2s = 1.0 / (2.0 * s)
    q_11 = sel(one, lp * inv_2s, one)
    q_12 = sel(zero, inv_2s, zero)
    q_21 = sel(re * inv_im, -lm * inv_2s, zero)
    q_22 = sel(inv_im, -inv_2s, one)
    bp1 = q_11 * bv1 + q_12 * bv2
    bp2 = q_21 * bv1 + q_22 * bv2
    params9 = (m11, m12, m21, m22, bp1, bp2, p_11, p_12, b0)
    P = torch.stack([torch.stack([p_11, p_12], dim=-1), torch.stack([p_21, p_22], dim=-1)], dim=-2)
    Pinv = torch.stack([torch.stack([q_11, q_12], dim=-1), torch.stack([q_21, q_22], dim=-1)], dim=-2)
    aux = {"is_c": is_c, "re": re, "im": torch.where(is_c, im, 0.0)}
    return params9, P, Pinv, aux


def _mv(A, v):
    """[R, 2, 2] @ [R, 2] -> [R, 2]."""
    return torch.einsum("rij,rj->ri", A, v)


def biquad_scan_blocked_tv(x, params9, P, Pinv, z_in, PB: int = PARAM_BLOCK, aux=None,
                           return_injection: bool = False):
    """Time-varying biquad: per-param-block coefficients, blocked scans.

    x [R, F] f32 with F a multiple of PB; params9: 9 tensors [R, K]
    (K = F // PB) from :func:`tv_section_params`; P / Pinv [R, K, 2, 2];
    z_in [R, 2] entry state in z (TDF2) coordinates, those the f64 host
    reference carries across coefficient changes.

    Within each block the eigenbasis prefix scan; across blocks a
    sequential loop over the K blocks (``[R]``-batched 2x2 products)
    carrying the state in the current block's eigen coordinates, adjacent
    blocks converting by J_k = Pinv_{k+1} P_k. For complex-pole pairs J has
    the cancellation-free form [[1,0],[(re_k - re_{k+1})/im_{k+1},
    im_k/im_{k+1}]], the identity when coefficients repeat (``aux``
    enables it). Returns (y, z_out); with ``return_injection`` also the
    span's linear map of an unknown entry state to its exit (Tz [R, 2, 2])
    and the pieces :func:`tv_inject` adds that entry state's response
    with."""
    R, F = x.shape
    K = F // PB
    assert K * PB == F, "frame count must be a multiple of the param block"
    xb = x.reshape(R * K, PB)
    pf = [p.reshape(R * K, 1) for p in params9]
    y0, v_eig, acum, A_eig = biquad_scan_with_transition(
        xb, pf, torch.zeros((R * K, 2), dtype=torch.float32, device=x.device))
    A_eig = A_eig.reshape(R, K, 2, 2)
    v_eig = v_eig.reshape(R, K, 2)
    Jg = torch.einsum("rkij,rkjl->rkil", Pinv[:, 1:], P[:, :-1])  # block k -> k+1 coords
    if aux is not None:
        is_c, re, im = aux["is_c"], aux["re"], aux["im"]
        both_c = is_c[:, 1:] & is_c[:, :-1]
        im1 = torch.where(both_c, im[:, 1:], 1.0)
        j21 = (re[:, 1:] - re[:, :-1]) / im1
        j22 = im[:, :-1] / im1
        Jc = torch.stack([torch.stack([torch.ones_like(j21), torch.zeros_like(j21)], dim=-1),
                          torch.stack([j21, j22], dim=-1)], dim=-2)
        Jg = torch.where(both_c[..., None, None], Jc, Jg)
    eye = torch.broadcast_to(torch.eye(2, dtype=torch.float32, device=x.device), (R, 1, 2, 2))
    J = torch.cat([Jg, eye], dim=1)  # [R, K, 2, 2] (the last unused -> I)

    e = _mv(Pinv[:, 0], z_in)
    M = Pinv[:, 0].clone() if return_injection else None
    entries, Ts = [], []
    exit_k = M_exit = None
    for k in range(K):
        entries.append(e)
        exit_k = _mv(A_eig[:, k], e) + v_eig[:, k]
        e = _mv(J[:, k], exit_k)
        if return_injection:
            Ts.append(M)
            M_exit = torch.einsum("rij,rjk->rik", A_eig[:, k], M)
            M = torch.einsum("rij,rjk->rik", J[:, k], M_exit)
    z_out = _mv(P[:, -1], exit_k)
    ze = torch.stack(entries, dim=1).reshape(R * K, 2)
    a11, a12, a21, a22 = acum  # [R*K, PB], shifted cumulative transitions
    p11, p12 = pf[6], pf[7]
    corr = p11 * (a11 * ze[:, 0:1] + a12 * ze[:, 1:2]) + p12 * (a21 * ze[:, 0:1] + a22 * ze[:, 1:2])
    y = (y0 + corr).reshape(R, F)
    if not return_injection:
        return y, z_out
    Tz = torch.einsum("rij,rjk->rik", P[:, -1], M_exit)
    inj = {"T": torch.stack(Ts, dim=1), "acum": acum, "p11": p11, "p12": p12, "K": K, "PB": PB}
    return y, z_out, Tz, inj


def tv_inject(y, z_in, inj):
    """Add the response to a span-entry state ``z_in`` [R, 2] to a
    ``return_injection`` result ``y`` [R, F]."""
    R, F = y.shape
    K = inj["K"]
    ze = torch.einsum("rkij,rj->rki", inj["T"], z_in).reshape(R * K, 2)
    a11, a12, a21, a22 = inj["acum"]
    corr = inj["p11"] * (a11 * ze[:, 0:1] + a12 * ze[:, 1:2]) + inj["p12"] * (
        a21 * ze[:, 0:1] + a22 * ze[:, 1:2])
    return y + corr.reshape(R, F)


def biquad_sequential_tv(x: np.ndarray, ftype, freq, q, gain_db, sample_rate: float,
                         PB: int = PARAM_BLOCK, state: np.ndarray | None = None):
    """Host f64 reference of coefficient automation: coefficients
    redesigned every PB frames (values indexed per block), the TDF2 state
    carried across the change. x [C, F]; freq/q/gain_db arrays [K]."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    C, F = x.shape
    K = -(-F // PB)
    st = np.zeros((C, 2), np.float64) if state is None else state.astype(np.float64).copy()
    y = np.empty_like(x)
    for k in range(K):
        c = design_biquad(ftype, float(freq[k]), sample_rate, float(q[k]), float(gain_db[k]))
        sl = slice(k * PB, min((k + 1) * PB, F))
        y[:, sl], st = biquad_sequential(x[:, sl], c, st)
    return y, st


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
