"""Stems export: render every track separately, post chain + volume/pan.

Counterpart of ``whitebox_tpu/render/stems.py``. A standard DAW
deliverable the reference's (stubbed) export dialog never reaches: each
track's signal exactly as it would enter the master sum (track.cpp:728-733
processing position), so the stems sum back to the pre-master mix.

The per-track mix is K4 (``CudaMixRenderer.render_device_per_track``: one
launch of the CUDA kernel's per-track mode on the card, its plain version
on the CPU) into ``[T, C, F]`` on the device, the MIDI tracks' synth added
to a copy of it; then a stems finisher, chunk by chunk with its states
carried: the chains' biquad cascade (``ops/biquad_cuda.py::
biquad_cascade``, the hand kernel on the card) and the per-frame track
gains for linear chains (:func:`stems_finish`), the generic finisher's
stems form for every other chain, the routed finisher's for bus stems.

Where the slot plan cannot hold the session (a slot overflow at the
smallest tile, or per-track buffers above
``render/bounce.py::per_track_limit_bytes``) or ``engine="xla"``, the
per-track chunks come from the gather mix (``ops/mix.py::
render_chunk_per_track``) instead, one chunk at a time into the same
finishers, each finished chunk copied to the host: nothing of the
session's length is held on the device. The choice is made by those
conditions only; a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk_per_track
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow, build_plan
from whitebox_tpu_torch.ops.readback import to_host
from whitebox_tpu_torch.render.bounce import (
    _add_synth, _prepare_synth_tables, per_track_limit_bytes, session_has_midi,
)
from whitebox_tpu_torch.render.effects_generic import (
    auto_chunk_frames, init_generic_states, make_generic_stems_chunk_fn, make_generic_stems_finisher,
    prepare_generic_fx, session_fx_packable,
)
from whitebox_tpu_torch.render.effects_pipeline import (
    CPU_CHUNK, CUDA_CHUNK, _frame_gains, prepare_automation_tables, prepare_effect_tables,
)
from whitebox_tpu_torch.render.metrics import span
from whitebox_tpu_torch.render.routing import (
    init_routed_states, make_routed_stems_chunk_fn, make_routed_stems_finisher, prepare_routed_fx,
    routed_auto_chunk_frames,
)
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_device

#: frames per chunk of the gather path's per-track render (bounce's
#: ``chunk_frames`` default); the generic and routed finishers round it to
#: their own chunk
GATHER_CHUNK = 1 << 17


def stems_finish_chunk(xc, coeffs, track_gain, states, start: int, auto=None, *, T: int, C: int):
    """One chunk ``xc`` ``[T, C, n]`` at global frame ``start``: the chains'
    cascade from ``states``, then the per-frame track gains -> (stems
    chunk ``[T, C, n]``, new states)."""
    n = xc.shape[-1]
    y, states = biquad_cascade(xc.reshape(T * C, n), coeffs, states)
    g = start + torch.arange(n, dtype=torch.int32, device=xc.device)
    return y.reshape(T, C, n) * _frame_gains(auto, track_gain, g, T, C), states


def stems_finish(per_track, coeffs, track_gain, auto=None, *, T, C, S, chunk=None):
    """per_track ``[T, C, F]`` -> post-chain post-gain stems ``[T, C, F]``,
    written chunk by chunk into one buffer on ``per_track``'s device, the
    section states carried; ``chunk`` frames each (default
    ``effects_pipeline.CUDA_CHUNK`` on the card, ``CPU_CHUNK`` on the
    CPU). ``per_track`` is read, not written."""
    F = per_track.shape[-1]
    dev = per_track.device
    if chunk is None:
        chunk = CUDA_CHUNK if dev.type == "cuda" else CPU_CHUNK
    states = [torch.zeros((T * C, 2), dtype=torch.float32, device=dev) for _ in range(S)]
    out = torch.empty((T, C, F), dtype=torch.float32, device=dev)
    for start in range(0, F, chunk):
        out[..., start:start + chunk], states = stems_finish_chunk(
            per_track[..., start:start + chunk], coeffs, track_gain, states, start, auto, T=T, C=C)
    return out


def _track_gains(session: Session, channels: int, dev) -> torch.Tensor:
    """Constant fader gains ``[T, C]`` f32 (volume * pan, 0 when muted)."""
    return torch.from_numpy(np.stack([
        [np.float32((np.float32(0.0) if t.mute else t.volume_linear) * np.float32(t.pan_coeffs[c % 2]))
         for c in range(channels)]
        for t in session.tracks
    ]).astype(np.float32)).to(dev)


class _PerTrack:
    """The per-track pre-gain mix of a session on a device, from K4 or,
    where the plan cannot hold it, from the gather mix chunk by chunk.

    ``buffer`` is K4's ``[T, C, >= frames]`` (the synth added to a copy),
    or None on the gather path, where :meth:`chunk` renders
    ``[T, C, n]`` from a global frame."""

    def __init__(self, session, sample_rate, buffer_size, channels, interpolation, engine, dev):
        if engine not in ("auto", "pallas", "xla"):
            raise ValueError(f"engine must be 'auto', 'pallas' or 'xla', got {engine!r}")
        table, pool = carve_session(session, sample_rate, buffer_size=buffer_size,
                                    out_channels=channels, slow_emit="runs")
        with span("wb.plan"):
            pre_pool_dev = None
            if interpolation == "sinc" and len(table) and not table.fast.all():
                # the same quality form as bounce: exact/Taylor polyphase
                # prerender, the oversampled pool and poly taps for the residue
                table, pool, interp, pre_pool_dev, _ = resolve_sinc_device(table, pool, device=dev)
            else:
                table, pool, interp = resolve_interpolation(table, pool, interpolation)
            plan = None
            if engine != "xla":
                try:
                    plan = build_plan(table, pool, session, channels=channels,
                                      max_slots=16 if isinstance(interp, tuple) else 8)
                except SlotOverflow as e:
                    if engine == "pallas":
                        raise SlotOverflow(f"{e} even at the smallest tile; engine='pallas' has no gather "
                                           "fallback (engine='auto' takes it)") from e
                if plan is not None and (plan.num_tracks * channels * plan.n_tiles * plan.tile * 4
                                         > per_track_limit_bytes(dev)):
                    plan = None  # per-track buffers would not fit: the gather path, chunk by chunk
        T = len(session.tracks)
        self.frames, self.interp, self.buffer = table.total_frames, interp, None
        with span("wb.fx.prepare"):
            self.synth = (_prepare_synth_tables(session, sample_rate, buffer_size,
                                                max(self.frames // buffer_size, 1), dev)
                          if session_has_midi(session) else {})
        self.kernel = plan is not None
        if self.kernel:
            renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                       interp=interp, pool_device=pre_pool_dev)
            with span("wb.mix"):
                pt = renderer.render_device_per_track()[:T]
                self.buffer = _add_synth(pt, self.synth, 0, pt.shape[-1])
        else:
            with span("wb.upload"):
                self.tables = pack_device_tables(table, pool, session, channels=channels).as_torch(dev)
                # a prerendered pool extension lives on the device only
                self.pool = (pre_pool_dev.reshape(-1) if pre_pool_dev is not None
                             else torch.from_numpy(pool.data).to(dev))

    def chunk(self, start: int, n: int) -> torch.Tensor:
        pt = render_chunk_per_track(self.pool, self.tables, start, n, interp=self.interp)
        return _add_synth(pt, self.synth, start, n)


def _gather_stems(src: _PerTrack, chunk: int, step, states, outs) -> None:
    """The gather path: each per-track chunk of ``src`` through ``step``
    (pt_chunk, states, start -> (outputs, states)), each output copied into
    the matching host array of ``outs`` (``[..., frames]``)."""
    F = src.frames
    for start in range(0, F, chunk):
        ys, states = step(src.chunk(start, chunk), states, start)
        n = min(chunk, F - start)
        for o, y in zip(outs, ys):
            o[..., start:start + n] = y[..., :n].cpu().numpy()


def render_stems(
    session: Session,
    sample_rate: float = 48000.0,
    *,
    buffer_size: int = 512,
    channels: int = 2,
    interpolation: str = "linear",
    engine: str = "auto",
    device=None,
) -> tuple[np.ndarray, list[str]]:
    """Render all tracks to stems [T, C, F] (+ track names) on ``device``
    (default: the CUDA card; ``"cpu"`` runs the plain versions).

    ``interpolation`` matches bounce: "linear" | "catmull" | "sinc" (the
    polyphase prerender, the oversampled pool for its residue).
    ``engine``: "auto" (K4, the gather mix where the plan cannot hold the
    session), "pallas" (K4 only) or "xla" (the gather mix).

    Resampled rows carve as closed-form runs here (for the slot plan); on
    the gather path their phases are the closed-form values rather than
    the blockwise sequentially-rounded ones — inside the 2.4e-7
    resampling contract, but not bit-parity with ``bounce(engine="xla")``.
    speed==1 stems are always bit-exact."""
    with span("wb.stems"):
        dev = resolve_device(device)
        T = len(session.tracks)
        src = _PerTrack(session, sample_rate, buffer_size, channels, interpolation, engine, dev)
        F = src.frames
        packable = session_fx_packable(session)
        with span("wb.fx.prepare"):
            tg = _track_gains(session, channels, dev)
            auto = prepare_automation_tables(session, sample_rate, device=dev)
            if packable:
                (S, coeffs), _ = prepare_effect_tables(session, sample_rate, channels, device=dev)
            else:
                gfx = prepare_generic_fx(session, sample_rate, channels)
        with span("wb.finish"):
            if packable and src.kernel:
                stems = stems_finish(src.buffer[..., :F], coeffs, tg, auto, T=T, C=channels, S=S)
            elif packable:
                stems = np.empty((T, channels, F), dtype=np.float32)

                def step(xc, states, start):
                    y, states = stems_finish_chunk(xc, coeffs, tg, states, start, auto, T=T, C=channels)
                    return (y,), states

                init = [torch.zeros((T * channels, 2), dtype=torch.float32, device=dev) for _ in range(S)]
                _gather_stems(src, GATHER_CHUNK, step, init, (stems,))
            elif src.kernel:
                stems = make_generic_stems_finisher(gfx, T, channels, device=dev)(src.buffer[..., :F], tg, auto)
            else:
                chunk = auto_chunk_frames(gfx, GATHER_CHUNK, device=dev)
                gstep = make_generic_stems_chunk_fn(gfx, T, channels, chunk=chunk, device=dev)
                stems = np.empty((T, channels, F), dtype=np.float32)

                def step(xc, states, start):
                    y, states = gstep(xc, states, start, tg, auto)
                    return (y,), states

                _gather_stems(src, chunk, step, init_generic_states(gfx, channels, dev)[0], (stems,))
        if src.kernel:
            with span("wb.readback"):
                stems = to_host(stems)
    return stems, [t.name or f"track{i}" for i, t in enumerate(session.tracks)]


def render_bus_stems(
    session: Session,
    sample_rate: float = 48000.0,
    *,
    buffer_size: int = 512,
    channels: int = 2,
    interpolation: str = "linear",
    engine: str = "auto",
    device=None,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Bus-stem export (stem-delivery workflows) on ``device`` (default: the
    CUDA card): returns ``(direct [C, F], bus_out [B, C, F], bus_names)``
    — the PRE-MASTER routed components. ``direct`` is the master-direct
    track sum, ``bus_out`` each bus post-chain/post-fader (sends, sidechain
    keys, and bus automation all applied); ``direct + bus_out.sum(0)``
    through the master chain reproduces the full mix. Requires a session
    with routing (session/bus.py). ``interpolation`` and ``engine`` as
    :func:`render_stems`."""
    if not session_has_routing(session):
        raise ValueError("render_bus_stems needs a session with buses/sends "
                         "(use render_stems for per-track stems)")
    with span("wb.stems"):
        dev = resolve_device(device)
        T = len(session.tracks)
        src = _PerTrack(session, sample_rate, buffer_size, channels, interpolation, engine, dev)
        F = src.frames
        with span("wb.fx.prepare"):
            tg = _track_gains(session, channels, dev)
            auto = prepare_automation_tables(session, sample_rate, device=dev)
            rfx = prepare_routed_fx(session, sample_rate, channels, device=dev)
        with span("wb.finish"):
            if src.kernel:
                finisher = make_routed_stems_finisher(rfx, T, channels, device=dev)
                direct, bus = finisher(src.buffer[..., :F], tg, auto)
            else:
                chunk = routed_auto_chunk_frames(rfx, GATHER_CHUNK, device=dev)
                rstep = make_routed_stems_chunk_fn(rfx, T, channels, chunk=chunk, device=dev)
                direct = np.empty((channels, F), dtype=np.float32)
                bus = np.empty((rfx.num_buses, channels, F), dtype=np.float32)
                _gather_stems(src, chunk, lambda xc, states, start: rstep(xc, states, start, tg, auto),
                              init_routed_states(rfx, channels, dev), (direct, bus))
        if src.kernel:
            with span("wb.readback"):
                direct, bus = direct.cpu().numpy(), bus.cpu().numpy()
    return direct, bus, [b.name or f"bus{i}" for i, b in enumerate(session.buses)]
