"""Double-single (two-float) resampler phase on torch tensors.

Counterpart of ``whitebox_tpu/ops/dsarith.py:22-73``. The engine's phase is
f64 (sampler.cpp:50-52); it is carried as an unevaluated sum of two f32 and
evaluated as ``x = frac + j * speed`` with FMA-free Dekker/Knuth error-free
transforms, so the port reproduces the JAX kernel's phase bit for bit. The
CUDA kernel (``csrc/mix_kernel.cu``) evaluates the same expression tree with
``__fmul_rn``/``__fadd_rn``; this module is its plain PyTorch twin.

Every operation below is one separate elementwise torch op, so no multiply
and add are ever contracted into an FMA.
"""

from __future__ import annotations

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1 Dekker split constant for f32 (exact in f32)


def split_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: exact f64 -> (hi, lo) f32 pair (hi+lo ~ x to ~2^-49 rel)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _dekker_split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    p = a * b
    ah, al = _dekker_split(a)
    bh, bl = _dekker_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def phase_eval(j: torch.Tensor, frac_hi, frac_lo, speed_hi, speed_lo):
    """Evaluate x = (frac_hi+frac_lo) + j*(speed_hi+speed_lo); return
    (ix int32, fx f32) with x = ix + fx, fx in [0, 1).

    ``j`` is an int32 tensor with values exactly representable in f32
    (< 2^24: a slot-local frame index). The four phase terms are f32
    tensors broadcastable against ``j``.
    """
    jf = j.to(torch.float32)
    p, pe = _two_prod(jf, speed_hi)
    lo_term = pe + jf * speed_lo
    s, se = _two_sum(frac_hi, p)
    lo = se + (frac_lo + lo_term)
    hi, lo = _two_sum(s, lo)  # renormalize

    ixf = torch.floor(hi)
    r = (hi - ixf) + lo
    # boundary adjustments: r can land just outside [0, 1)
    under = r < 0.0
    over = r >= 1.0
    ixf = torch.where(under, ixf - 1.0, torch.where(over, ixf + 1.0, ixf))
    r = torch.where(under, r + 1.0, torch.where(over, r - 1.0, r))
    return ixf.to(torch.int32), r
