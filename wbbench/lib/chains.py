"""Effect chains of a configuration, each entry found by its ``type``.

A chain in a configuration is a list of entries ``{"type": e, ...}``; a
description holds it resolved per track as a tuple of ``(e, params)``.
``reference/fx/<e>.py`` has ``resolve(params, track)`` (the entry on one track),
``process(params, x, state, sample_rate) -> (y, state)`` (f64, ``state``
None from rest) and ``ops_per_frame(params)`` (f32 operations per row and
frame, for the roofline); ``program/fx/<e>.py`` has ``build(params)``, the
program's effect (``program/<kind>.py`` builds the chains). Nothing here
imports the program: the reference runs through this file.
"""

from __future__ import annotations

from wbbench.lib.spec import part


def resolve(spec, track: int) -> tuple:
    """A configuration's chain on track ``track`` (the master: 0)."""
    chain = []
    for entry in spec or ():
        kind = entry["type"]
        params = {k: v for k, v in entry.items() if k != "type"}
        chain.append((kind, part("reference/fx", kind).resolve(params, track)))
    return tuple(chain)


def process(chain, x, states, sample_rate: float, after=None):
    """``x`` ``[C, n]`` through every entry of ``chain`` in order from
    ``states`` (None: all from rest) -> ``(y, states)``. ``after`` is applied
    to each entry's output (the control rounds it)."""
    states = list(states) if states is not None else [None] * len(chain)
    for i, (kind, params) in enumerate(chain):
        x, states[i] = part("reference/fx", kind).process(params, x, states[i], sample_rate)
        if after is not None:
            x = after(x)
    return x, states


def ops_per_frame(chain) -> int:
    return sum(part("reference/fx", kind).ops_per_frame(params) for kind, params in chain)
