"""The program's effect for a ``parametric_eq`` chain entry (``reference/fx/parametric_eq.py``'s parameters)."""

from __future__ import annotations


def build(params: dict):
    from whitebox_tpu_torch.effects import ParametricEQ

    return ParametricEQ([tuple(b) for b in params["bands"]])
