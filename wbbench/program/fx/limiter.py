"""The program's effect for a ``limiter`` chain entry (``reference/fx/limiter.py``'s parameters)."""

from __future__ import annotations


def build(params: dict):
    from whitebox_tpu_torch.effects import Limiter

    return Limiter(params["ceiling_db"], attack_s=params["attack_s"], release_s=params["release_s"],
                   lookahead_s=params["lookahead_s"])
