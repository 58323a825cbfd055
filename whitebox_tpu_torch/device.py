"""Device policy for the port.

Counterpart of the JAX package's implicit backend choice
(``whitebox_tpu/ops/mix_pallas.py:659`` interprets the kernel when the JAX
backend is the CPU). Here the choice is explicit: every public entry takes
a ``device`` argument, ``None`` means the CUDA card, and the CPU is used
only when a caller asks for it by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent.

    Never moves on to the CPU on its own: the CPU runs the plain PyTorch
    version of each kernel, which is a different program from the one a
    CUDA render measures.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to render with the plain PyTorch mix")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev
