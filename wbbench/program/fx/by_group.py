"""The program's effect for a ``by_group`` chain entry: the chosen entry's own
(``reference/fx/by_group.py``'s resolved parameters)."""

from __future__ import annotations

from wbbench.lib.spec import part


def build(params: dict):
    return part("program/fx", params["type"]).build(params["params"])
