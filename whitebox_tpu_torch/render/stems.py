"""Stems export: render every track separately, post chain + volume/pan.

Counterpart of ``whitebox_tpu/render/stems.py``. A standard DAW
deliverable the reference's (stubbed) export dialog never reaches: each
track's signal exactly as it would enter the master sum (track.cpp:728-733
processing position), so the stems sum back to the pre-master mix.

The per-track mix is K4 (``CudaMixRenderer.render_device_per_track``: one
launch of the CUDA kernel's per-track mode on the card, its plain version
on the CPU) into ``[T, C, F]`` on the device, the MIDI tracks' synth added
to a copy of it; then a finisher's stems form (``render/finisher.py``:
the steps stop before the sum), chunk by chunk with its states carried
into one ``[T, C, F]`` buffer: the scan's biquad cascade
(``ops/biquad_cuda.py::biquad_cascade``, the hand kernel on the card) and
the per-frame track gains for linear chains, the generic finisher for
every other chain, the routed finisher for bus stems.

Where the slot plan cannot hold the session (a slot overflow at the
smallest tile, or per-track buffers above
``render/bounce.py::per_track_limit_bytes``) or ``engine="xla"``, the
per-track chunks come from the gather mix (``ops/mix.py::
render_chunk_per_track``) instead, one chunk at a time into the same
finishers, each finished chunk copied to the host: nothing of the
session's length is held on the device. The choice is
``render/bounce.py::kernel_plan``'s, made by those conditions only; a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk_per_track
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer, resident_pool
from whitebox_tpu_torch.ops.readback import to_host
from whitebox_tpu_torch.render.bounce import _add_synth, _prepare_synth_tables, kernel_plan
from whitebox_tpu_torch.render.finisher import choose_finisher, make_finisher, run
from whitebox_tpu_torch.render.metrics import span
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_device

#: frames per chunk of the gather path's per-track render (bounce's
#: ``chunk_frames`` default); the generic and routed finishers round it to
#: their own chunk
GATHER_CHUNK = 1 << 17


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
            plan = kernel_plan(table, pool, session, channels, interp, engine, dev, per_track=True)
        T = len(session.tracks)
        self.frames, self.interp, self.buffer = table.total_frames, interp, None
        with span("wb.fx.prepare"):
            self.synth = _prepare_synth_tables(session, sample_rate, buffer_size, max(self.frames // buffer_size, 1),
                                               dev)
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
                self.pool = pre_pool_dev.reshape(-1) if pre_pool_dev is not None else resident_pool(pool, dev)

    def chunk(self, start: int, n: int) -> torch.Tensor:
        pt = render_chunk_per_track(self.pool, self.tables, start, n, interp=self.interp)
        return _add_synth(pt, self.synth, start, n)


def _finish_stems(src: _PerTrack, session, sample_rate, channels, family: str, dev):
    """``src``'s stems through the ``family`` finisher's stems form: K4's
    buffer in one destination on the device, read back whole; the gather
    path's chunks each copied into a host array."""
    with span("wb.fx.prepare"):
        fin = make_finisher(family, session, sample_rate, _track_gains(session, channels, dev), form="stems",
                            max_chunk=None if src.kernel else GATHER_CHUNK, device=dev)
    with span("wb.finish"):
        res = run(fin, src.buffer[..., :src.frames] if src.kernel else src.chunk, src.frames, host=not src.kernel)
    if not src.kernel:
        return res.out
    with span("wb.readback"):
        return tuple(to_host(o) for o in res.out) if isinstance(res.out, tuple) else to_host(res.out)


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
        src = _PerTrack(session, sample_rate, buffer_size, channels, interpolation, engine, dev)
        stems = _finish_stems(src, session, sample_rate, channels, choose_finisher(session, "scan", form="stems"),
                              dev)
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
        src = _PerTrack(session, sample_rate, buffer_size, channels, interpolation, engine, dev)
        direct, bus = _finish_stems(src, session, sample_rate, channels,
                                    choose_finisher(session, "routed", form="stems"), dev)
    return direct, bus, [b.name or f"bus{i}" for i, b in enumerate(session.buses)]
