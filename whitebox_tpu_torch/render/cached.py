"""Stamp-keyed session render cache — persistent carve/plan/renderer.

Counterpart of ``whitebox_tpu/render/cached.py``. The reference engine never
re-walks the timeline for an unchanged session: event lists and voices
persist across process() calls and only rebuild on
``internal_state_changed`` (Track::refresh_voice, track.cpp:289-345). The
offline ``bounce`` re-carves per call — correct, but repeated renders of
an unchanged session (bounce-again workflows, A/B exports, benchmark
steady state) pay host carve + plan + table upload for nothing.

:class:`SessionRenderCache` is the analogue of the reference's persistence:
it holds the carved tables, the slot plan and the device-resident
``ops/mix_cuda.py::CudaMixRenderer``, keyed by ``Session.edit_stamp()``.
Every access revalidates the stamp — any edit (including direct field
mutations) rebuilds on the next render, exactly like
``render.preview.PreviewStream`` invalidates mid-playback. The sample pool
on the device survives edits that keep the asset set. An unchanged
re-render costs one stamp pass + one launch of the mix kernel (K1/K2, or
K3 for an automation-only session).

Scope: the mix kernel's surface (plain sessions and automation-only
sessions through the automation variant). Sessions with effect chains,
routing or MIDI finish through ``render.bounce``, whose per-render host
cost is the preparation of effect state, not the carve.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
from whitebox_tpu_torch.render.bounce import session_has_midi
from whitebox_tpu_torch.render.effects_pipeline import (
    prepare_automation_tables_host, session_has_effects,
)
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session


class SessionRenderCache:
    """The mix of ``session`` on ``device`` (default: the CUDA card;
    ``"cpu"`` by name runs the kernels' plain versions), rebuilt only when
    the session's edit stamp moves."""

    def __init__(self, session: Session, sample_rate: float = 48000.0,
                 *, buffer_size: int = 512, channels: int = 2, device=None) -> None:
        self.session = session
        self.sample_rate = float(sample_rate)
        self.buffer_size = int(buffer_size)
        self.channels = int(channels)
        self.device = resolve_device(device)
        self._stamp = None
        self._renderer = None
        self._pool = None
        self._pool_dev = None

    def _build(self) -> None:
        session = self.session
        if session_has_effects(session) or session_has_routing(session) or session_has_midi(session):
            raise ValueError(
                "SessionRenderCache serves the CUDA mix kernel's surface "
                "(plain / automation-only sessions); sessions with effect "
                "chains, routing, or MIDI render through render.bounce")
        if self._pool is not None:
            # the resident pool only survives edits that keep the asset set:
            # a clip now referencing an unseen asset drops pool + upload
            idx = self._pool.index_of
            if any(c.is_audio() and c.audio is not None and c.audio.asset is not None
                   and id(c.audio.asset) not in idx
                   for t in session.tracks for c in t.clips):
                self._pool = None
                self._pool_dev = None
        table, pool = carve_session(session, self.sample_rate, buffer_size=self.buffer_size,
                                    out_channels=self.channels, slow_emit="runs", pool=self._pool)
        auto = (prepare_automation_tables_host(session, self.sample_rate)
                if session_has_automation(session) else None)
        self._renderer = CudaMixRenderer(table, pool, session, device=self.device,
                                         channels=self.channels, pool_device=self._pool_dev,
                                         auto_tables=auto)
        self._pool = pool
        # the sample pool survives edits that don't add samples; tables and
        # plan rebuild, the big upload doesn't
        self._pool_dev = self._renderer.pool_device

    def renderer(self) -> CudaMixRenderer:
        """The resident renderer, revalidated against the session's edit
        stamp (stale tables are impossible — same contract as the
        PreviewStream's per-pull check)."""
        stamp = self.session.edit_stamp()
        if self._renderer is None or stamp != self._stamp:
            self._build()
            self._stamp = stamp
        return self._renderer

    def render_device(self) -> torch.Tensor:
        """Render on the device: ``[C, n_tiles*tile]`` f32, the port's
        layout (the plan's tiles end to end; the frames past
        ``total_frames`` are the last tile's padding). The JAX package's
        ``[C, n_tiles*R, 128]`` is its TPU layout; the port has none. An
        unchanged session launches the resident kernel once."""
        return self.renderer().render_device()

    def render(self) -> np.ndarray:
        """Render and read back host audio ``[C, frames]`` f32."""
        return self.renderer().render()
