"""Streaming preview: a block-pull interface over the timeline renderer.

Counterpart of ``whitebox_tpu/render/preview.py``. The reference's audio_io
backends pull one buffer_size block per device callback
(audio_io_pulseaudio.cpp:396-466). Offline, the equivalent capability is a
seekable block stream: the session is carved and packed for the device
ONCE, then the device renders ``lookahead_blocks``-sized windows on demand
and ``next_block()`` serves engine-sized blocks out of the current window —
memory stays bounded by one window regardless of session length. Seeking
drops the window (the next pull re-renders at the new position);
effect/IIR state carries across pulls like a live engine's filters would.
Edits during playback invalidate automatically: every pull compares the
session's edit_stamp and re-carves when it moved (the offline analogue of
Track::refresh_voice / internal_state_changed, track.cpp:289-345).

A window renders through the gather mix (``ops/mix.py``), as in the JAX
package: ``render_chunk`` for a session without effects, or
``render_chunk_per_track`` and the finisher whose state carries from pull
to pull (``render/finisher.py``, a window a step, as the streamed bounce
runs it: the scan's biquad cascade runs the hand CUDA kernel
``csrc/biquad_cascade.cu`` on the card; the generic and routed steps for
every other chain). The slot-plan mix kernel does not run here; on the
card each window is one launch of the gather kernel (``csrc/gather_mix.cu``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from whitebox_tpu_torch.core.math import beat_to_samples
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk, render_chunk_per_track
from whitebox_tpu_torch.render.bounce import _add_synth, _prepare_synth_tables, session_has_midi
from whitebox_tpu_torch.render.effects_pipeline import session_has_effects
from whitebox_tpu_torch.render.finisher import choose_finisher, make_finisher, run
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation


class PreviewStream:
    def __init__(
        self,
        session: Session,
        sample_rate: float = 48000.0,
        buffer_size: int = 512,
        channels: int = 2,
        lookahead_blocks: int = 64,
        interpolation: str = "linear",
        device=None,
    ) -> None:
        """A block stream of ``session`` rendered on ``device`` (default:
        the CUDA card; ``"cpu"`` by name runs the plain versions)."""
        self.session = session
        self.sample_rate = float(sample_rate)
        self.buffer_size = int(buffer_size)
        self.channels = channels
        self.device = resolve_device(device)
        self.lookahead = max(int(lookahead_blocks), 1) * self.buffer_size
        if self.lookahead % 512:
            # TV biquad/EQ lanes need PARAM_BLOCK(512)-aligned chunks, and
            # window fetches must stay contiguous multiples of buffer_size
            # (overlapping fetches would double-advance effect state), so
            # round up to a multiple of lcm(buffer_size, 512)
            step = math.lcm(self.buffer_size, 512)
            self.lookahead = -(-self.lookahead // step) * step
        self._interpolation = interpolation
        self._pos = 0
        self._build()

    def _build(self) -> None:
        """(Re-)carve and pack the session; called at construction and
        whenever the session's edit_stamp moves mid-playback (the offline
        refresh_voice / internal_state_changed, track.cpp:289-345)."""
        session = self.session
        sample_rate = self.sample_rate
        channels = self.channels
        dev = self.device
        self._stamp = session.edit_stamp()

        table, pool = carve_session(session, sample_rate, buffer_size=self.buffer_size,
                                    out_channels=channels)
        # the same sinc as bounce's fallback: oversampled pool + LS-optimal taps
        table, pool, self._interp = resolve_interpolation(table, pool, self._interpolation)
        tables = pack_device_tables(table, pool, session, channels=channels)
        self._tables = tables.as_torch(dev)
        self._pool = torch.from_numpy(pool.data).to(dev)
        self._total = tables.total_frames

        has_fx = (session_has_effects(session) or session_has_automation(session)
                  or session_has_midi(session) or session_has_routing(session))
        # the JAX package's preview steps every finisher a whole window at a
        # time (chunk = lookahead); the states carry from pull to pull
        self._fin = self._states = None
        if has_fx:
            self._fin = make_finisher(choose_finisher(session), session, sample_rate, self._tables["track_gain"],
                                      chunk=self.lookahead, device=dev)
            self._states = self._fin.init()
            self._synth = _prepare_synth_tables(session, sample_rate, self.buffer_size,
                                                max(self._total // self.buffer_size, 1), dev)

        self._window: np.ndarray | None = None
        self._win_start = 0

    # ---- device window fetch ----

    def fetch_window_device(self, start: int) -> torch.Tensor:
        """Render the ``lookahead``-frame window at ``start`` and return it
        as a DEVICE tensor ([channels, lookahead]); effect/IIR state commits
        exactly as a host pull would. This is the device-side consumer
        form of the block pull — and the instrument the real-time-budget
        measurement (the JAX package's benchmark config 8) uses to time
        the per-block device cost without the host readback leg."""
        frames = self.lookahead
        if self._fin is None:
            return render_chunk(self._pool, self._tables, start, frames, strict_order=True,
                                interp=self._interp)
        pt = _add_synth(render_chunk_per_track(self._pool, self._tables, start, frames, interp=self._interp),
                        self._synth, start, frames)
        res = run(self._fin, pt, frames, start=start, states=self._states)
        self._states = res.states
        return res.out

    def _fetch_window(self, start: int) -> None:
        self._window = self.fetch_window_device(start).cpu().numpy()
        self._win_start = start

    # ---- transport ----

    @property
    def total_frames(self) -> int:
        return self._total

    @property
    def position_frames(self) -> int:
        return self._pos

    @property
    def position_beats(self) -> float:
        tm = getattr(self.session, "tempo_map", None)
        if tm is not None:
            return float(tm.seconds_to_beats(self._pos / self.sample_rate))
        return self._pos / self.sample_rate / self.session.beat_duration

    @property
    def window_frames(self) -> int:
        """Resident device-rendered cache size (bounded memory contract)."""
        return 0 if self._window is None else self._window.shape[1]

    def seek(self, beat: float) -> None:
        tm = getattr(self.session, "tempo_map", None)
        if tm is not None:
            frame = int(tm.beats_to_samples(beat, self.sample_rate))
        else:
            frame = int(beat_to_samples(beat, self.sample_rate, self.session.beat_duration))
        self._pos = max(0, min(frame, self._total))
        self._window = None  # invalidate; next pull renders at the new position

    def next_block(self) -> np.ndarray | None:
        """Next [channels, buffer_size] block, zero-padded at the tail;
        None when the timeline is exhausted.

        Edits since the last pull (any change to Session.edit_stamp) drop
        the cached window and re-carve, so playback continues from the
        current position over the NEW session state — never stale tables."""
        if self.session.edit_stamp() != self._stamp:
            pos = self._pos
            self._build()
            self._pos = min(pos, self._total)
        if self._pos >= self._total:
            return None
        if (
            self._window is None
            or self._pos < self._win_start
            or self._pos + self.buffer_size > self._win_start + self._window.shape[1]
        ):
            self._fetch_window(self._pos)
        lo = self._pos - self._win_start
        end = min(self._pos + self.buffer_size, self._total)
        block = np.zeros((self.channels, self.buffer_size), dtype=np.float32)
        block[:, : end - self._pos] = self._window[:, lo : lo + (end - self._pos)]
        self._pos = end
        return block

    def __iter__(self):
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b
