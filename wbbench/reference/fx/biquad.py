"""The reference of a ``biquad`` chain entry: one RBJ section.

``{"type": "biquad", "bands": [[type, hz, q, gain_db]]}``.
"""

from __future__ import annotations

from wbbench.reference import rbj


def resolve(params: dict, track: int) -> dict:
    if len(params["bands"]) != 1:
        raise ValueError(f"a biquad entry holds one band, got {len(params['bands'])}")
    (ftype, hz, q, gain_db), = params["bands"]
    return {"bands": ((str(ftype), float(hz), float(q), float(gain_db)),)}


def process(params: dict, x, state, sample_rate: float):
    return rbj.process(params["bands"], x, state, sample_rate)


def ops_per_frame(params: dict) -> int:
    """f32 operations per row and frame."""
    return rbj.SECTION_OPS
