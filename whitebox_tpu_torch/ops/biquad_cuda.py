"""The effect finisher's biquad cascade on the card: a hand CUDA kernel,
its plain twin, and the host model of its single-pass blocked recurrence.

A batch of ``B`` rows (``[T*C, F]`` for the tracks, ``[C, F]`` for the
master) goes through a cascade of ``S`` biquad sections, each row with its
own sections in the eigenbasis form ``ops/biquad.py::eig_section_params``
packs (``pack_chain_sections``: coefficients ``[9, S, B, 1]``), with the
states ``[S] x [B, 2]`` carried in and out in the same eigen coordinates
the plain scan uses, so a stream may mix the two.

- :func:`biquad_cascade` launches ``csrc/biquad_cascade.cu`` on a CUDA
  tensor and runs :func:`biquad_cascade_reference` on a CPU tensor; any
  other device, a malformed argument or a refused launch raises. It counts
  its calls in :data:`biquad_cascade_launches` (one kernel launch per group
  of at most :data:`MAX_SECTIONS` sections, counted as one).
- :func:`biquad_cascade_reference` is the finisher's plain torch-op cascade
  (one ``biquad_scan_batched`` per section), as
  ``render/effects_pipeline.py`` ran it before the kernel existed.
- :func:`cascade_transition` is ``Phi_L``, the cascade's ``2S x 2S``
  transition over ``L`` frames with zero input, in f64 from the f32
  parameters the kernel reads: one step of the unit states
  (:func:`cascade_step`), then ``L`` by repeated squaring.
- :func:`cascade_tables` holds what the kernel reads beside the signal:
  the powers ``Phi_l^(2^i)``, ``i = 0..5``, and the zero-input response of
  the cascade's output to each unit state over ``l`` frames; computed once
  per coefficient tensor and sub-block length (:func:`_tables` caches them).
- :func:`biquad_cascade_blocked` is the host model of the kernel in torch
  (f32 as the kernel runs it, or f64): sub-blocks of ``l`` frames walked
  from zero, a Kogge-Stone scan over each tile's 32 sub-blocks in f64, the
  tiles' prefixes ``s_{k+1} = Phi_W s_k + E_k`` in f64, each sub-block's
  output corrected by the response to its start.

Not a TPU kernel: the JAX package evaluates the same cascade as an XLA scan
(``whitebox_tpu/ops/biquad.py::_biquad_scan_eig``). The kernel sums in
another order than the Hillis scan, so it agrees with the plain version to
a tolerance (relative RMS 5e-6 per row), not to the bit.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.biquad import N_SECTION_PARAMS, biquad_scan_batched

#: calls of :func:`biquad_cascade` that launched the kernel in this process;
#: nothing else touches it (callers may reset it to 0)
biquad_cascade_launches = 0
#: sections one launch holds (``kMaxSections`` in the source); longer chains
#: run in groups, each group's output the next one's input
MAX_SECTIONS = 4
#: sub-blocks of a tile: the lanes of a warp (``kLanes`` in the source)
TILE_LANES = 32
#: frames of a sub-block the kernel takes (``kMaxBlock`` in the source is
#: the largest), and the powers of ``Phi_l`` it reads (``kPowers``)
BLOCK_CHOICES = (32, 64, 128, 256)
N_POWERS = 6
#: rows below which a call takes the longest sub-block: a row's tiles
#: then fold fewer predecessors in the look-back
FEW_ROWS = 16


def block_frames(B: int, F: int) -> int:
    """The sub-block length ``l`` for a ``[B, F]`` call: 128 frames (a
    tile of 4,096, three blocks of four warps on an SM), 256 for fewer
    than :data:`FEW_ROWS` rows, whose few tiles are all resident at once
    and whose time is the walk plus the look-back over a row's tiles."""
    return 256 if B < FEW_ROWS else 128


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
    if F < 1:
        raise ValueError(f"x must hold at least one frame, got {tuple(x.shape)}")
    lib = cuda_build.load()
    l = block_frames(B, F)
    n_tiles = B * -(-F // (TILE_LANES * l))
    y, new_states = x, []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for s0 in range(0, S, MAX_SECTIONS):
            s1 = min(s0 + MAX_SECTIONS, S)
            group, phis, resp = _tables(coeffs, s0, s1, l)
            D = 2 * (s1 - s0)
            state_in = torch.stack(states[s0:s1]).contiguous()
            state_out = torch.empty_like(state_in)
            ints = torch.empty(1 + n_tiles, dtype=torch.int32, device=x.device)
            doubles = torch.empty((2, n_tiles, D), dtype=torch.float64, device=x.device)
            out = torch.empty((B, F), dtype=torch.float32, device=x.device)
            stride = y.stride(0) if B > 1 else F  # a single row's stride is not its layout
            rc = lib.wb_biquad_cascade(y.data_ptr(), stride, out.data_ptr(), B, F, l, group.data_ptr(), s1 - s0,
                                       phis.data_ptr(), resp.data_ptr(), state_in.data_ptr(),
                                       state_out.data_ptr(), ints.data_ptr(), doubles.data_ptr(), stream)
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


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` for ``M`` ``[B, D, D]`` and ``v`` ``[B, ..., D]``, each
    component's products summed in index order (the kernel's order)."""
    Mb = M.reshape(M.shape[0], *([1] * (v.dim() - 2)), *M.shape[1:])
    r = Mb[..., :, 0] * v[..., 0:1]
    for j in range(1, v.shape[-1]):
        r = r + Mb[..., :, j] * v[..., j:j + 1]
    return r


def cascade_tables(coeffs: torch.Tensor, l: int, dtype=torch.float32):
    """What the kernel reads beside the signal, on ``coeffs``' device:

    - ``phis`` ``[B, 6, 2S, 2S]`` f64: ``Phi_l^(2^i)`` for ``i = 0..5``
      (:func:`cascade_transition` over ``l`` frames, then squared; the last
      is ``Phi_W``, the transition over a tile of ``32 l`` frames);
    - ``resp`` ``[B, l, DP]`` in ``dtype`` (``DP`` = 4 for ``S <= 2``, else
      8; columns past ``2S`` are 0): ``resp[n, d]`` is the cascade's output
      at frame ``n`` of zero input from the unit state ``d`` (one step of
      the unit states gives the output row ``c`` and the one-frame
      transition ``A``; then ``c A^n`` by doubling), in f64 before the cast.
    ``coeffs`` ``[9, S, B, 1]``; ``l`` a power of two."""
    p = _params(coeffs, torch.float64)
    S, B = p[0].shape
    D = 2 * S
    dev = coeffs.device
    eye = torch.eye(D, dtype=torch.float64, device=dev).expand(B, D, D)
    c, A = cascade_step(p, eye, torch.zeros((B, D), dtype=torch.float64, device=dev))
    phi = cascade_transition(coeffs, l)
    pows = [phi]
    for _ in range(N_POWERS - 1):
        pows.append(pows[-1] @ pows[-1])
    R, step = c[:, None, :], A
    while R.shape[1] < l:
        R = torch.cat([R, R @ step], dim=1)
        step = step @ step
    DP = 4 if D <= 4 else 8
    resp = torch.zeros((B, l, DP), dtype=torch.float64, device=dev)
    resp[:, :, :D] = R[:, :l]
    return torch.stack(pows, dim=1).contiguous(), resp.to(dtype).contiguous()


#: ``_tables``' cache: (pointer, version, shape, strides, device, group, l)
#: of a coefficient tensor -> (the tensor, the group's coefficients, phis,
#: resp); the tensor is held, so its memory cannot be reused under the key
_TABLES: OrderedDict = OrderedDict()
_TABLES_MAX = 32


def _tables(coeffs: torch.Tensor, s0: int, s1: int, l: int):
    """The group ``s0:s1`` of ``coeffs`` as the kernel reads it (``[9, S', B]``
    contiguous) and its :func:`cascade_tables`, computed once per tensor,
    group and ``l`` (an in-place edit of the tensor bumps its version)."""
    key = (coeffs.data_ptr(), coeffs._version, tuple(coeffs.shape), coeffs.stride(), str(coeffs.device),
           s0, s1, l)
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit[1:]
    group = coeffs[:, s0:s1].contiguous()
    phis, resp = cascade_tables(group, l)
    _TABLES[key] = (coeffs, group, phis, resp)
    while len(_TABLES) > _TABLES_MAX:
        _TABLES.popitem(last=False)
    return group, phis, resp


def biquad_cascade_blocked(x: torch.Tensor, coeffs: torch.Tensor, states, l: int | None = None):
    """Host model of the kernel, in torch on ``x``'s device and dtype (f32
    as the kernel runs it, or f64): each row of ``x`` ``[B, F]`` in
    sub-blocks of ``l`` frames (default :func:`block_frames`; a power of
    two), 32 consecutive ones a tile;

    1. every full sub-block but the row's last from a zero state: its
       zero-state output ``y0`` and end state ``e_j``;
    2. per tile, a Kogge-Stone scan over its 32 sub-blocks in f64: step
       ``i`` adds ``Phi_l^(2^i)`` times the value ``2^i`` lanes back, so
       lane ``j`` holds ``sum_{i <= j} Phi_l^(j-i) e_i``; lane 31's is the
       tile's aggregate ``E_k``;
    3. the tiles' starts in f64: ``s_0`` = the states in, ``s_{k+1} =
       Phi_W s_k + E_k`` (what the kernel's look-back computes, whichever
       tile it stops at);
    4. each sub-block's start ``Phi_l^j s_k`` (the powers of ``j``'s bits,
       low bit first) plus the scan's exclusive value, rounded to ``x``'s
       dtype; the output ``y0 + sum_d resp[n, d] * start_d`` (index order);
       the row's last sub-block walked from its start instead, its end
       states the states out.

    Each product sum runs in index order, each operation rounds on its
    own: the kernel's arithmetic. -> ``(y, new states)`` as
    :func:`biquad_cascade`. All sections run in one group (the kernel's
    grouping of long chains composes the same)."""
    B, F = x.shape
    S = coeffs.shape[1]
    D = 2 * S
    dt = x.dtype
    if l is None:
        l = block_frames(B, F)
    f64 = torch.float64
    p = _params(coeffs, dt)
    phis, resp = cascade_tables(coeffs, l, dtype=dt)
    phis = phis.to(x.device)
    resp = resp.to(x.device)[:, :, :D]
    z_in = torch.stack([s.to(f64) for s in states], dim=1).reshape(B, D)
    nsub = -(-F // l)
    nk = -(-nsub // TILE_LANES)
    lanes = nk * TILE_LANES
    xp = torch.nn.functional.pad(x, (0, lanes * l - F)).reshape(B, lanes, l)
    full = nsub - 1  # full sub-blocks walked from zero: all but the row's last

    def walk(z, frames):  # z [B, n, D]; frames [B, n, m] -> (y, z)
        n = z.shape[1]
        pp = [a[:, :, None].expand(S, B, n).reshape(S, B * n) for a in p]
        zz = z.reshape(B * n, D)
        xs = frames.reshape(B * n, -1)
        ys = torch.empty_like(xs)
        for k in range(xs.shape[1]):
            ys[:, k], zz = cascade_step(pp, zz, xs[:, k])
        return ys.reshape(B, n, -1), zz.reshape(B, n, D)

    y = xp.clone()
    e = torch.zeros((B, lanes, D), dtype=f64, device=x.device)
    if full:
        y0, e_full = walk(torch.zeros((B, full, D), dtype=dt, device=x.device), xp[:, :full])
        y[:, :full] = y0
        e[:, :full] = e_full.to(f64)
    acc = e.reshape(B, nk, TILE_LANES, D)
    lane = torch.arange(TILE_LANES, device=x.device)
    for i in range(5):
        off = 1 << i
        o = torch.nn.functional.pad(acc, (0, 0, off, 0))[:, :, :TILE_LANES]
        acc = torch.where((lane >= off)[None, None, :, None], acc + _matvec(phis[:, i], o), acc)
    ex = torch.nn.functional.pad(acc, (0, 0, 1, 0))[:, :, :TILE_LANES]
    starts = torch.empty((B, nk, D), dtype=f64, device=x.device)
    s = z_in
    for k in range(nk):
        starts[:, k] = s
        s = _matvec(phis[:, 5], s) + acc[:, k, TILE_LANES - 1]
    w = starts[:, :, None, :].expand(B, nk, TILE_LANES, D)
    for i in range(5):
        w = torch.where(((lane >> i) & 1 == 1)[None, None, :, None], _matvec(phis[:, i], w), w)
    st = (w + ex).reshape(B, lanes, D).to(dt)
    corr = resp[:, None, :, 0] * st[:, :full, None, 0]
    for d in range(1, D):
        corr = corr + resp[:, None, :, d] * st[:, :full, None, d]
    y[:, :full] = y[:, :full] + corr
    last = F - full * l  # frames of the row's last sub-block
    y_last, z_out = walk(st[:, full:full + 1], xp[:, full:full + 1, :last])
    y[:, full, :last] = y_last[:, 0]
    z_out = z_out[:, 0].reshape(B, S, 2)
    return y.reshape(B, lanes * l)[:, :F], [z_out[:, s].to(states[s].dtype) for s in range(S)]
