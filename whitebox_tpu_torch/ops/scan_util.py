"""Inclusive prefix scans by Hillis-Steele doubling on torch tensors.

Counterpart of ``whitebox_tpu/ops/scan_util.py``. ``hillis_scan``
computes the inclusive prefix of a tuple of same-shape tensors along the
last axis in ceil(log2 F) steps; each step combines the tuple with a copy
shifted right by ``k`` frames (the identity fills the ``k`` frames on the
left, contiguous slices, no strided gathers). The combine's argument
order is ``(shifted, elems)``: ``left`` is the EARLIER span, as in the JAX
package, so both group the same floating-point products.
"""

from __future__ import annotations

import torch

__all__ = ["hillis_scan"]


def hillis_scan(combine, elems: tuple, identity: tuple) -> tuple:
    """Inclusive prefix of ``elems`` (tuple of same-shape tensors) along the
    last axis under ``combine((l0, l1, ...), (r0, r1, ...)) -> tuple``.

    ``identity``: a scalar per tuple element with ``combine(identity, r)
    == r``. Shapes and dtypes are preserved.
    """
    n = elems[0].shape[-1]
    k = 1
    while k < n:
        shifted = tuple(
            torch.cat([torch.full(e.shape[:-1] + (k,), idv, dtype=e.dtype, device=e.device),
                       e[..., :-k]], dim=-1)
            for e, idv in zip(elems, identity))
        elems = combine(shifted, elems)
        k *= 2
    return tuple(elems)
