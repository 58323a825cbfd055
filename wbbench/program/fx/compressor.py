"""The program's effect for a ``compressor`` chain entry (``reference/fx/compressor.py``'s parameters)."""

from __future__ import annotations


def build(params: dict):
    from whitebox_tpu_torch.effects import Compressor

    return Compressor(params["threshold_db"], params["ratio"], knee_db=params["knee_db"],
                      attack_s=params["attack_s"], release_s=params["release_s"], makeup_db=params["makeup_db"],
                      detector=params["detector"])
