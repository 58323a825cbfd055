"""Delay lines on torch tensors: feedback combs and modulated taps.

Counterpart of ``whitebox_tpu/ops/delay.py``:

- feedback comb (echo): w[n] = x[n-D] + fb * w[n-D]. Reshaping the frame
  axis into blocks of D turns the lag-D recurrence into a first-order one
  over blocks, batched across the D lanes of a block, evaluated as a
  prefix scan over the block axis (``hillis_scan``; the JAX package uses
  ``lax.associative_scan``, which groups the products otherwise). The
  ping-pong comb feeds back through a channel swap, whose k-step map is
  fb^k * swap^(k odd), so it stays a pair of scalar scans over pairs of
  blocks;
- modulated fractional taps (chorus/flanger): gathers with linear
  interpolation at an LFO-swept delay, no recurrence.

The chunk-boundary state (the last D wet and dry samples, the last
``max_delay`` dry samples) carries exactly, so chunked processing equals
one-shot. The sequential f64 references are the JAX package's, copied.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from whitebox_tpu_torch.ops.scan_util import hillis_scan


def _affine(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


def _affine_scan(m, b, axis: int):
    """Inclusive prefix of the affine maps y -> m*y + b along ``axis``."""
    mm, bb = hillis_scan(_affine, (m.movedim(axis, -1), b.movedim(axis, -1)), (1.0, 0.0))
    return mm.movedim(-1, axis), bb.movedim(-1, axis)


def _blockify(x, D: int):
    """[..., F] -> ([..., nblk, D], F, nblk) padding F up to a multiple of D."""
    F = x.shape[-1]
    nblk = -(-F // D)
    xp = tF.pad(x, (0, nblk * D - F))
    return xp.reshape(x.shape[:-1] + (nblk, D)), F, nblk


def comb_feedback(x, fb, w0, x0, *, D: int):
    """Wet line w[n] = x[n-D] + fb*w[n-D] for x [..., F] (per-lane comb).

    ``w0``/``x0`` [..., D]: the last D wet / dry samples before this chunk
    (zeros at stream start). ``fb`` broadcasts against [..., nblk, D].
    Returns (w [..., F], w_last, x_last)."""
    xb, F, nblk = _blockify(x, D)  # [..., nblk, D]
    fb = torch.as_tensor(fb, dtype=torch.float32, device=x.device)
    # block recurrence wb[j] = fb*wb[j-1] + xb[j-1], block -1 from the carries
    inj = torch.cat([x0[..., None, :], xb[..., :-1, :]], dim=-2)
    mm, bb = _affine_scan(torch.broadcast_to(fb, inj.shape), inj, axis=-2)
    wb = mm * w0[..., None, :] + bb
    w = wb.reshape(x.shape[:-1] + (nblk * D,))[..., :F]
    w_last = torch.cat([w0, w], dim=-1)[..., F : F + D]
    x_last = torch.cat([x0, x], dim=-1)[..., F : F + D]
    return w, w_last, x_last


def _parity_scan(inj, fb, w0):
    """wb[j] = fb * swap(wb[j-1]) + inj[j-1] on [..., nblk, 2, D], by pairs
    of blocks: the 2-step map is fb^2 * identity (swap^2 = I), so the odd
    blocks of each pair run one affine scan and the even ones follow."""
    orig_nblk = nblk = inj.shape[-3]
    if nblk % 2:  # one zero block so the pairs are whole
        inj = tF.pad(inj, (0, 0, 0, 0, 0, 1))
        nblk += 1
    fb2 = fb * fb
    swap = lambda v: v.flip(-2)  # noqa: E731
    a = inj[..., 0::2, :, :]  # injections landing at even offsets within the pair
    b = inj[..., 1::2, :, :]
    odd_inj = fb * swap(a) + b  # W[p] = fb2*W[p-1] + (fb*swap(a[p]) + b[p])
    mm, bb = _affine_scan(torch.broadcast_to(fb2, odd_inj.shape), odd_inj, axis=-3)
    w_odd = mm * w0[..., None, :, :] + bb  # [..., npair, 2, D]
    w_prev_odd = torch.cat([w0[..., None, :, :], w_odd[..., :-1, :, :]], dim=-3)
    w_even = fb * swap(w_prev_odd) + a
    npair = w_even.shape[-3]
    wb = torch.stack([w_even, w_odd], dim=-3)  # [..., npair, 2(parity), C, D]
    wb = wb.reshape(w_even.shape[:-3] + (2 * npair, 2, w_even.shape[-1]))
    return wb[..., :orig_nblk, :, :]


def comb_feedback_pingpong(x, fb, w0, x0, *, D: int):
    """Ping-pong comb for stereo x [..., 2, F]: w[c, n] = x[c, n-D] +
    fb * w[1-c, n-D]. w0/x0 [..., 2, D] carry the last D wet/dry samples.
    Returns (w, w_last, x_last)."""
    xb, F, nblk = _blockify(x, D)  # [..., 2, nblk, D]
    xb = xb.transpose(-3, -2)  # [..., nblk, 2, D]
    fb = torch.as_tensor(fb, dtype=torch.float32, device=x.device)
    inj = torch.cat([x0[..., None, :, :], xb[..., :-1, :, :]], dim=-3)
    wb = _parity_scan(inj, fb, w0)
    w = wb.transpose(-3, -2).reshape(x.shape[:-1] + (nblk * D,))[..., :F]
    w_last = torch.cat([w0, w], dim=-1)[..., F : F + D]
    x_last = torch.cat([x0, x], dim=-1)[..., F : F + D]
    return w, w_last, x_last


def modulated_tap(x, delay_frames, xtail, *, max_delay: int):
    """Fractional-delay tap y[n] = x[n - delay_frames[n]] (linear interp).

    x [..., F]; delay_frames [..., F] f32 in [1, max_delay-1] (broadcast
    against x); xtail [..., max_delay]: the last max_delay dry samples
    before this chunk. Returns (tap, new_xtail)."""
    F = x.shape[-1]
    ext = torch.cat([xtail, x], dim=-1)  # index n+max_delay == x[n]
    # n - d = (n - di - 1) + (1 - fd): the integer part stays integer so
    # the fraction keeps its bits at large n
    di = torch.floor(delay_frames)
    fd = delay_frames - di
    i0 = torch.arange(F, dtype=torch.int64, device=x.device) + (max_delay - 1) - di.to(torch.int64)
    i0 = torch.clamp(i0, 0, F + max_delay - 2)
    frac = 1.0 - fd
    shape = torch.broadcast_shapes(ext.shape[:-1] + (F,), i0.shape)
    ext = torch.broadcast_to(ext, shape[:-1] + (ext.shape[-1],))
    i0 = torch.broadcast_to(i0, shape)
    a = torch.gather(ext, -1, i0)
    b = torch.gather(ext, -1, i0 + 1)
    return a + frac * (b - a), ext[..., -max_delay:]


def lfo_rate_splits(rate_hz, sample_rate) -> np.ndarray:
    """HOST: an LFO rate split into exact-product phase constants [..., 6].

    The phase is ``2*pi * frac(n * r)`` with r = rate/fs cycles per frame.
    n is split into exact 13-bit digits (n = n2*2^26 + n1*2^13 + n0) and
    each digit multiplies a per-digit cycle increment C_k = frac(2^(13k)*r),
    itself split into an 8-bit coarse part (digit*coarse is exact in f32)
    plus an f32 residue: the phase error stays ~2e-5 cycles to n = 2^31."""
    r = np.asarray(rate_hz, np.float64) / float(sample_rate)
    parts = []
    for shift in (26, 13, 0):
        c = np.mod(np.ldexp(r, shift), 1.0)
        a = np.floor(c * 256.0) / 256.0
        parts.append(a.astype(np.float32))
        parts.append((c - a).astype(np.float32))
    return np.stack(parts, axis=-1)  # [..., 6]


def lfo_delay_frames(start_frame, F: int, *, rate_hz=None, depth_frames, center_frames,
                     sample_rate=None, phase=0.0, rate_splits=None, device=None):
    """Sine-LFO swept delay, phase-exact from the absolute frame index (so
    chunked processing stays identical). ``rate_splits``: precomputed
    :func:`lfo_rate_splits` constants (a tensor, or host values);
    otherwise ``rate_hz``/``sample_rate`` are host values."""
    if rate_splits is None:
        rate_splits = lfo_rate_splits(rate_hz, sample_rate)
    s = torch.as_tensor(rate_splits, dtype=torch.float32, device=device)
    n = int(start_frame) + torch.arange(F, dtype=torch.int32, device=s.device)
    n2 = (n >> 26).to(torch.float32)
    n1 = ((n >> 13) & 0x1FFF).to(torch.float32)
    n0 = (n & 0x1FFF).to(torch.float32)

    def frac(v):
        return v - torch.floor(v)

    cyc = (frac(n2 * s[..., 0]) + n2 * s[..., 1]
           + frac(n1 * s[..., 2]) + n1 * s[..., 3]
           + frac(n0 * s[..., 4]) + n0 * s[..., 5])
    cyc = cyc - torch.round(cyc)  # [-0.5, 0.5] cycles
    arg = float(np.float32(2.0 * np.pi)) * cyc + phase
    return center_frames + depth_frames * torch.sin(arg)


# ---------------------------------------------------------------------------
# float64 sequential references, the JAX package's
# ---------------------------------------------------------------------------


def comb_feedback_ref(x: np.ndarray, fb: float, D: int) -> np.ndarray:
    """w[n] = x[n-D] + fb*w[n-D], zero initial history. x [..., F]."""
    x = np.asarray(x, np.float64)
    w = np.zeros_like(x)
    for n in range(D, x.shape[-1]):
        w[..., n] = x[..., n - D] + fb * w[..., n - D]
    return w


def comb_pingpong_ref(x: np.ndarray, fb: float, D: int) -> np.ndarray:
    """w[c,n] = x[c,n-D] + fb*w[1-c,n-D]. x [2, F]."""
    x = np.asarray(x, np.float64)
    w = np.zeros_like(x)
    for n in range(D, x.shape[-1]):
        w[0, n] = x[0, n - D] + fb * w[1, n - D]
        w[1, n] = x[1, n - D] + fb * w[0, n - D]
    return w


def modulated_tap_ref(x: np.ndarray, delay: np.ndarray) -> np.ndarray:
    """y[n] = x[n - delay[n]] linear-interp, zero history. x [..., F]."""
    x = np.asarray(x, np.float64)
    F = x.shape[-1]
    y = np.zeros_like(x)
    for n in range(F):
        p = n - float(delay[..., n] if delay.ndim else delay[n])
        i0 = int(np.floor(p))
        frac = p - i0
        a = x[..., i0] if i0 >= 0 else 0.0
        b = x[..., i0 + 1] if i0 + 1 >= 0 else 0.0
        y[..., n] = a + frac * (b - a)
    return y
