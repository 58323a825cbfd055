"""The reference of a ``parametric_eq`` chain entry: its bands as a cascade of RBJ sections.

``{"type": "parametric_eq", "bands": [[type, hz, q, gain_db(, hz per track)], ...]}``:
a band's optional fifth number moves its frequency by that many hertz per
track index.
"""

from __future__ import annotations

from wbbench.reference import rbj


def resolve(params: dict, track: int) -> dict:
    """The entry's parameters on track ``track``."""
    return {"bands": tuple((str(b[0]), float(b[1]) + (float(b[4]) * track if len(b) > 4 else 0.0), float(b[2]),
                            float(b[3])) for b in params["bands"])}


def process(params: dict, x, state, sample_rate: float):
    return rbj.process(params["bands"], x, state, sample_rate)


def ops_per_frame(params: dict) -> int:
    """f32 operations per row and frame."""
    return rbj.SECTION_OPS * len(params["bands"])
