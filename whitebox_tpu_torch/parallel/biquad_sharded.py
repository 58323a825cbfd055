"""Frame-sharded biquads: exact IIR state across frame shards.

Counterpart of ``whitebox_tpu/parallel/biquad_sharded.py``, the sequence
parallel state handoff: each frame shard filters its frames from a zero
state, the shards exchange their O(summary) end states with one gather
over the frames axis, every shard folds its predecessors' into its exact
incoming state, and that state enters the shard's output. Two forms:

- :func:`biquad_shard_framewise`, the plain version (the JAX package's
  recipe, in torch ops): the eigenbasis Hillis scan from zero with its
  cumulative transition (``ops/biquad.py::biquad_scan_with_transition``),
  the incoming state injected through that transition. It runs on the
  CPU, one section at a time;
- :func:`cascade_shard_framewise`, on the card: the hand cascade kernel
  (``ops/biquad_cuda.py::biquad_cascade``) in two passes over a whole
  cascade of sections, the kernel's own blocks/carry/blocks recipe with
  the shard as the block. The first pass from zero states gives the
  shard's end states ``e_j``; every shard has the same length and
  sections, so the zero-input transition ``Phi`` over a shard is the same
  for all, computed in f64 from the f32 parameters the kernel reads
  (:func:`shard_transition`); the fold ``z <- Phi z + e_j`` over the
  predecessors runs in f64; the second pass runs the kernel from that
  exact incoming state. Exact up to f32 rounding, and two kernel launches
  per cascade.
"""

from __future__ import annotations

import torch

from whitebox_tpu_torch.ops.biquad import biquad_scan_with_transition
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade, cascade_transition
from whitebox_tpu_torch.parallel.collectives import all_gather, axis


def biquad_shard_framewise(x_local, params, axis_name, num_shards: int):
    """Apply one biquad section to a frame shard ``[B, F_local]``
    (``params``: the 9 eigenbasis parameter tensors ``[B, 1]``) -> the
    shard's output with its exact incoming state injected."""
    ax = axis(axis_name)
    B = x_local.shape[0]
    state0 = torch.zeros((B, 2), dtype=torch.float32, device=x_local.device)
    # from a zero state, the scan's final state IS the shard's v_total
    y0, v_total, acum, A_total = biquad_scan_with_transition(x_local, params, state0)
    p11, p12 = params[6], params[7]
    A_all = all_gather(A_total, ax)  # [fp, B, 2, 2]
    v_all = all_gather(v_total, ax)  # [fp, B, 2]
    z_in = torch.zeros_like(v_total)
    for j in range(min(ax.index, num_shards)):
        z_in = torch.einsum("bij,bj->bi", A_all[j], z_in) + v_all[j]
    a11s, a12s, a21s, a22s = acum
    corr1 = a11s * z_in[:, 0:1] + a12s * z_in[:, 1:2]
    corr2 = a21s * z_in[:, 0:1] + a22s * z_in[:, 1:2]
    return y0 + (p11 * corr1 + p12 * corr2)


def shard_transition(coeffs: torch.Tensor, L: int) -> torch.Tensor:
    """``Phi_L`` ``[B, 2S, 2S]`` f64 for any ``L >= 1``: the cascade's state
    after ``L`` frames of zero input is ``Phi_L @ z``
    (``cascade_transition`` of one frame, raised to ``L`` by squaring)."""
    step = cascade_transition(coeffs, 1)
    out = None
    while L:
        if L & 1:
            out = step if out is None else step @ out
        L >>= 1
        if L:
            step = step @ step
    return out


def cascade_shard_framewise(x_local: torch.Tensor, coeffs: torch.Tensor, axis_name,
                            num_shards: int) -> torch.Tensor:
    """A cascade of sections (``coeffs`` ``[9, S, B, 1]``, the cascade
    kernel's layout) over a frame shard ``[B, F_local]`` -> the shard's
    output from its exact incoming states: two passes of
    :func:`~whitebox_tpu_torch.ops.biquad_cuda.biquad_cascade` (the kernel
    on the card, its plain version on the CPU) around the fold; one pass
    on an axis of one."""
    ax = axis(axis_name)
    B, F = x_local.shape
    S = coeffs.shape[1]
    zeros = [torch.zeros((B, 2), dtype=torch.float32, device=x_local.device) for _ in range(S)]
    if ax.size == 1:  # one shard: its incoming state is the stream's, zero
        return biquad_cascade(x_local, coeffs, zeros)[0]
    _, ends = biquad_cascade(x_local, coeffs, zeros)
    e = torch.stack(ends, dim=1).reshape(B, 2 * S)  # component 2s+i of section s
    e_all = all_gather(e, ax)  # [fp, B, 2S]
    z = torch.zeros((B, 2 * S), dtype=torch.float64, device=x_local.device)
    if ax.index:
        phi = shard_transition(coeffs, F)
        for j in range(min(ax.index, num_shards)):
            z = torch.einsum("bij,bj->bi", phi, z) + e_all[j].to(torch.float64)
    z_in = z.to(torch.float32).reshape(B, S, 2)
    y, _ = biquad_cascade(x_local, coeffs, [z_in[:, s].contiguous() for s in range(S)])
    return y
