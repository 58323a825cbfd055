"""The program's effect for a ``biquad`` chain entry (one band)."""

from __future__ import annotations


def build(params: dict):
    from whitebox_tpu_torch.effects import Biquad

    (ftype, hz, q, gain_db), = params["bands"]
    return Biquad(ftype, hz, q, gain_db)
