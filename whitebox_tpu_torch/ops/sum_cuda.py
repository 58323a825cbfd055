"""The ordered track sum on the card: the wrapper of ``csrc/ordered_sum.cu``.

:func:`ordered_sum_cuda` sums ``y`` ``[T, ...]`` f32 over its first axis in
one launch, in track order from +0.0, bit-equal to ``ops/mix.py``'s torch
loop (``total = total + y[t]``, one launch a track), and counts the launch
(:data:`ordered_sum_launches`). ``ops/mix.py::_ordered_sum`` dispatches here
for f32 CUDA tensors. A malformed argument raises ``ValueError``; a failed
build or launch raises ``RuntimeError``. Nothing falls back to the loop.

Not a TPU kernel: the JAX package's finishers sum the tracks inside their
XLA programs.
"""

from __future__ import annotations

import torch

from whitebox_tpu_torch.ops import cuda_build

#: launches of the ordered-sum kernel in this process; :func:`ordered_sum_cuda`
#: adds one per launch and nothing else touches it (callers may reset it to 0)
ordered_sum_launches = 0


def ordered_sum_cuda(y: torch.Tensor) -> torch.Tensor:
    """``y[0] + y[1] + ...`` from zeros, in track order (``[T, ...]`` f32 on
    CUDA -> ``[...]``), on the current stream without synchronising."""
    global ordered_sum_launches
    if y.device.type != "cuda" or y.dtype != torch.float32 or y.dim() < 1:
        raise ValueError(f"want a float32 CUDA tensor [T, ...], got {y.dtype} {tuple(y.shape)} on {y.device}")
    T = int(y.shape[0])
    out = torch.zeros(y.shape[1:], dtype=torch.float32, device=y.device)
    n = out.numel()
    if T == 0 or n == 0:
        return out
    y = y.contiguous()
    lib = cuda_build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.wb_ordered_sum(y.data_ptr(), out.data_ptr(), T, n, n, stream)
    if rc != 0:
        raise RuntimeError(f"ordered sum launch failed: cudaError_t {rc}")
    ordered_sum_launches += 1
    return out
