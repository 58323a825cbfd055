"""The effect finisher's biquad cascade on the card: a hand CUDA kernel,
its plain twin, and the host model of its blocked recurrence.

A batch of ``B`` rows (``[T*C, F]`` for the tracks, ``[C, F]`` for the
master) goes through a cascade of ``S`` biquad sections, each row with its
own sections in the eigenbasis form ``ops/biquad.py::eig_section_params``
packs (``pack_chain_sections``: coefficients ``[9, S, B, 1]``), with the
states ``[S] x [B, 2]`` carried in and out in the same eigen coordinates
the plain scan uses, so a stream may mix the two.

- :func:`biquad_cascade` launches ``csrc/biquad_cascade.cu`` on a CUDA
  tensor and runs :func:`biquad_cascade_reference` on a CPU tensor; any
  other device, a malformed argument or a refused launch raises. It counts
  its calls in :data:`biquad_cascade_launches` (three kernel launches per
  group of at most :data:`MAX_SECTIONS` sections, counted as one).
- :func:`biquad_cascade_reference` is the finisher's plain torch-op cascade
  (one ``biquad_scan_batched`` per section), as
  ``render/effects_pipeline.py`` ran it before the kernel existed.
- :func:`cascade_transition` is ``Phi_L``, the cascade's ``2S x 2S``
  transition over ``L`` frames with zero input, in f64 from the f32
  parameters the kernel reads: one step of the unit states
  (:func:`cascade_step`), then ``L`` by repeated squaring.
- :func:`biquad_cascade_blocked` is the host model of the kernel's three
  phases in torch (f32 as the kernel runs them, or f64): blocks from a zero
  state, the carry ``s_{b+1} = Phi_L s_b + e_b`` in f64, the blocks again
  from their true starts.

Not a TPU kernel: the JAX package evaluates the same cascade as an XLA scan
(``whitebox_tpu/ops/biquad.py::_biquad_scan_eig``). The kernel sums in
another order than the Hillis scan, so it agrees with the plain version to
a tolerance (relative RMS 5e-6 per row), not to the bit.
"""

from __future__ import annotations

import torch

from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.biquad import N_SECTION_PARAMS, biquad_scan_batched

#: calls of :func:`biquad_cascade` that launched the kernel in this process;
#: nothing else touches it (callers may reset it to 0)
biquad_cascade_launches = 0
#: sections one launch holds (``kMaxSections`` in the source); longer chains
#: run in groups, each group's output the next one's input
MAX_SECTIONS = 4
#: frames per block of the blocked recurrence (a power of two >= 32; the
#: transition is taken over this many frames); chosen by timing 256 to 8192
#: on config 5's [256, 2^20] chunk (tools/sweep_finisher.py, PERF.md)
BLOCK_FRAMES = 4096


def _check(x: torch.Tensor, coeffs: torch.Tensor, states) -> int:
    """-> S; raises on shapes, types or devices the cascade does not take."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x must be a float32 [B, F] tensor with contiguous frames, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    B = x.shape[0]
    if (coeffs.dtype != torch.float32 or coeffs.dim() != 4 or coeffs.shape[0] != N_SECTION_PARAMS
            or coeffs.shape[2] != B or coeffs.shape[3] != 1 or coeffs.device != x.device):
        raise ValueError(f"coeffs must be float32 [9, S, {B}, 1] on {x.device}, got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)} on {coeffs.device}")
    S = coeffs.shape[1]
    if len(states) != S or any(tuple(s.shape) != (B, 2) or s.dtype != torch.float32
                               or s.device != x.device for s in states):
        raise ValueError(f"states must be {S} float32 [{B}, 2] tensors on {x.device}")
    return S


def biquad_cascade_reference(x: torch.Tensor, coeffs: torch.Tensor, states):
    """The cascade in plain torch ops: ``x`` ``[B, F]`` f32 through the
    ``S`` sections of ``coeffs`` ``[9, S, B, 1]`` from ``states`` (``S``
    tensors ``[B, 2]``) -> ``(y [B, F], new states)``."""
    S = _check(x, coeffs, states)
    new_states = []
    for s in range(S):
        x, ns = biquad_scan_batched(x, [coeffs[j, s] for j in range(N_SECTION_PARAMS)], states[s])
        new_states.append(ns)
    return x, new_states


def biquad_cascade(x: torch.Tensor, coeffs: torch.Tensor, states):
    """The cascade on ``x``'s device: the kernel on CUDA, the plain version
    on the CPU (same arguments and results as
    :func:`biquad_cascade_reference`). On CUDA, launches on the current
    stream and does not synchronise; ``x`` may be a view with a row stride
    (a chunk of a longer buffer)."""
    global biquad_cascade_launches
    if x.device.type == "cpu":
        return biquad_cascade_reference(x, coeffs, states)
    if x.device.type != "cuda":
        raise ValueError(f"no biquad cascade for device {x.device}")
    S = _check(x, coeffs, states)
    B, F = x.shape
    lib = cuda_build.load()
    nb = -(-F // BLOCK_FRAMES)
    y, new_states = x, []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for s0 in range(0, S, MAX_SECTIONS):
            s1 = min(s0 + MAX_SECTIONS, S)
            group = coeffs[:, s0:s1].contiguous()
            phi = cascade_transition(group, BLOCK_FRAMES)
            state_in = torch.stack(states[s0:s1]).contiguous()
            state_out = torch.empty_like(state_in)
            ends = torch.empty((B, nb, 2 * (s1 - s0)), dtype=torch.float32, device=x.device)
            starts = torch.empty_like(ends)
            out = torch.empty((B, F), dtype=torch.float32, device=x.device)
            stride = y.stride(0) if B > 1 else F  # a single row's stride is not its layout
            rc = lib.wb_biquad_cascade(y.data_ptr(), stride, out.data_ptr(), B, F, BLOCK_FRAMES,
                                       group.data_ptr(), s1 - s0, phi.data_ptr(), state_in.data_ptr(),
                                       state_out.data_ptr(), ends.data_ptr(), starts.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"biquad cascade launch failed: cudaError_t {rc}")
            y = out
            new_states.extend(state_out.unbind(0))
    biquad_cascade_launches += 1
    return y, new_states


# ------------------------------------------------------------------ host model


def cascade_step(p, z: torch.Tensor, x: torch.Tensor):
    """One frame of the cascade: ``p`` the 9 parameter tensors ``[S, N]``
    (``eig_section_params`` order), ``z`` the state ``[N, 2S, ...]``
    (component ``2s + i`` of section ``s``), ``x`` the input ``[N, ...]``
    -> ``(y, z)``, each multiply and add its own op, in the kernel's order."""
    m11, m12, m21, m22, bv1, bv2, p11, p12, b0 = p
    S = m11.shape[0]
    extra = (None,) * (z.dim() - 2)
    z = z.clone()
    for s in range(S):
        def at(a):
            return a[s][(...,) + extra]
        z1, z2 = z[:, 2 * s], z[:, 2 * s + 1]
        y = at(b0) * x + (at(p11) * z1 + at(p12) * z2)
        n1 = (at(m11) * z1 + at(m12) * z2) + at(bv1) * x
        n2 = (at(m21) * z1 + at(m22) * z2) + at(bv2) * x
        z[:, 2 * s], z[:, 2 * s + 1] = n1, n2
        x = y
    return x, z


def _params(coeffs: torch.Tensor, dtype) -> list:
    """``[9, S, B, 1]`` -> 9 tensors ``[S, B]`` of ``dtype``."""
    return list(coeffs[..., 0].to(dtype).unbind(0))


def cascade_transition(coeffs: torch.Tensor, L: int) -> torch.Tensor:
    """``Phi_L`` ``[B, 2S, 2S]`` f64 on ``coeffs``' device: the state after
    ``L`` frames of zero input is ``Phi_L @ z``. One step of the ``2S`` unit
    states through :func:`cascade_step` in f64 (the f32 parameters promoted,
    so it is the transition of the recurrence the kernel runs), then ``L``
    (a power of two) by repeated squaring."""
    if L < 1 or L & (L - 1):
        raise ValueError(f"L must be a power of two, got {L}")
    p = _params(coeffs, torch.float64)
    S, B = p[0].shape
    eye = torch.eye(2 * S, dtype=torch.float64, device=coeffs.device)
    _, phi = cascade_step(p, eye.expand(B, 2 * S, 2 * S),
                          torch.zeros((B, 2 * S), dtype=torch.float64, device=coeffs.device))
    while L > 1:
        phi = phi @ phi
        L //= 2
    return phi.contiguous()


def biquad_cascade_blocked(x: torch.Tensor, coeffs: torch.Tensor, states, L: int = BLOCK_FRAMES):
    """Host model of the kernel's blocked recurrence, in torch on ``x``'s
    device and dtype (f32 as the kernel runs it, or f64): ``x`` ``[B, F]``
    split into blocks of ``L`` frames (the last one ragged);

    1. every block but a row's last from a zero state -> end states ``e_b``;
    2. the carry in f64: ``s_0`` = the states in, ``s_{b+1} = Phi_L s_b +
       e_b`` (each component's products summed in index order, then
       ``+ e_b``), each start rounded to ``x``'s dtype;
    3. every block from its start, writing ``y``; the last block's end
       states are the states out.

    -> ``(y, new states)`` as :func:`biquad_cascade`. All sections run in
    one group (the kernel's grouping of long chains composes the same)."""
    B, F = x.shape
    S = coeffs.shape[1]
    dt = x.dtype
    p = _params(coeffs, dt)
    z_in = torch.stack([s.to(dt) for s in states], dim=1).reshape(B, 2 * S)
    nb = max(-(-F // L), 1)
    xp = torch.nn.functional.pad(x, (0, nb * L - F)).reshape(B, nb, L)

    def run(z, frames):  # z [B, nb', 2S]; frames [B, nb', n] -> (y, z)
        n_blocks = z.shape[1]
        pp = [a[:, :, None].expand(S, B, n_blocks).reshape(S, B * n_blocks) for a in p]
        z = z.reshape(B * n_blocks, 2 * S)
        xs = frames.reshape(B * n_blocks, -1)
        ys = torch.empty_like(xs)
        for k in range(xs.shape[1]):
            ys[:, k], z = cascade_step(pp, z, xs[:, k])
        return ys.reshape(B, n_blocks, -1), z.reshape(B, n_blocks, 2 * S)

    starts = z_in[:, None].expand(B, nb, 2 * S).clone()
    if nb > 1:
        _, ends = run(torch.zeros((B, nb - 1, 2 * S), dtype=dt, device=x.device), xp[:, :-1])
        phi = cascade_transition(coeffs, L)
        s = z_in.to(torch.float64)
        for b in range(nb - 1):
            r = phi[:, :, 0] * s[:, None, 0]
            for j in range(1, 2 * S):
                r = r + phi[:, :, j] * s[:, None, j]
            s = r + ends[:, b].to(torch.float64)
            starts[:, b + 1] = s.to(dt)
    # phase 3 runs every block from its start; the ragged tail's padding
    # frames come after the last real frame, so they change no output
    ys, zs = run(starts, xp)
    y = ys.reshape(B, nb * L)[:, :F]
    last = F - (nb - 1) * L  # frames of the last block
    if last < L:
        # the states out are those after the last real frame
        _, z_last = run(starts[:, -1:], xp[:, -1:, :last])
        zs = torch.cat([zs[:, :-1], z_last], dim=1)
    z_out = zs[:, -1].reshape(B, S, 2)
    return y, [z_out[:, s].to(states[s].dtype) for s in range(S)]
