"""The benchmark's own count of a render's dynamics stages, from the session
description (never from the program's plan, groups or kernels), for the
dynamics stage's share of its roofline.

Every chain entry of type ``compressor`` or ``limiter`` (a ``by_group``
entry seen through to the entry it chose), on its rows (each track's and
the master's channels), over every frame of the render: bytes, the f32 input
read once and the output written once; f32 operations, the entry's
``ops_per_frame`` (``reference/fx/``) per row and frame. The least time is
``lib/roofline.py``'s (the data-sheet peaks).
"""

from __future__ import annotations

from wbbench.lib import chains

#: the entry types that the dynamics stage runs
DYNAMICS = ("compressor", "limiter")


def entries(chain):
    """``(type, params)`` of each entry of a resolved chain, a ``by_group`` entry as the entry it chose."""
    for kind, params in chain:
        yield (params["type"], params["params"]) if kind == "by_group" else (kind, params)


def count(desc, kind) -> tuple:
    """``(bytes, f32 operations)`` of the dynamics stages of rendering ``desc``;
    ``kind`` is its kind's reference module (``reference/<kind>.py``)."""
    F, C = kind.Render(desc).frames, desc.channels
    n_bytes = ops = 0
    for chain in [tr.chain for tr in desc.tracks] + [desc.master_chain]:
        for e, params in entries(chain):
            if e in DYNAMICS:
                n_bytes += 2 * 4 * C * F
                ops += C * F * chains.ops_per_frame(((e, params),))
    return n_bytes, ops
