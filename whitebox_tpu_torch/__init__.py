"""whitebox_tpu_torch — the PyTorch/CUDA port of ``whitebox_tpu``.

Counterpart of ``whitebox_tpu/__init__.py``. The JAX package stays the
reference; this package renders the same ``Session`` to the same audio on
an NVIDIA Hopper card (H100), with its one TPU kernel (the fused timeline
mix, ``whitebox_tpu/ops/mix_pallas.py``) rewritten by hand in CUDA C++.

The host layer is shared, not copied: sessions, projects, the timeline
carve, the sample pool, the NumPy oracle and the WAV codec are imported
from ``whitebox_tpu`` (those modules load no JAX). This package imports
``torch`` and never ``jax``.

- ``device``  : device policy (``resolve_device``: CUDA unless the caller
                asks for the CPU; never a silent fallback).
- ``ops``     : double-single phase arithmetic, the GPU mix plan, the
                CUDA mix kernel's build, binding and plain PyTorch twin.
- ``render``  : the offline bounce (plain mix surface), render metrics,
                and the demo session builder.
- ``cli``     : ``python -m whitebox_tpu_torch.cli render in.wb out.wav``.
- ``csrc``    : CUDA C++ sources, built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
