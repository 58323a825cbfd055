"""The reference of a ``by_group`` chain entry: track ``t`` takes entry
``t % len(entries)`` of its list, which its own type's files resolve and run.

``{"type": "by_group", "entries": [{"type": e, ...}, ...]}``: one entry a
group, for a configuration whose tracks carry different chains by group (a
master chain, resolved as track 0, takes the first). Resolved, it holds the
chosen entry's type and parameters: ``{"type": e, "params": {...}}``.
"""

from __future__ import annotations

from wbbench.lib.spec import part


def resolve(params: dict, track: int) -> dict:
    entry = params["entries"][track % len(params["entries"])]
    kind = entry["type"]
    inner = {k: v for k, v in entry.items() if k != "type"}
    return {"type": kind, "params": part("reference/fx", kind).resolve(inner, track)}


def process(params: dict, x, state, sample_rate: float):
    return part("reference/fx", params["type"]).process(params["params"], x, state, sample_rate)


def ops_per_frame(params: dict) -> int:
    return part("reference/fx", params["type"]).ops_per_frame(params["params"])
