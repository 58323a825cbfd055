"""Block transport grid — the engine's per-block f64 time bookkeeping.

Engine::process (engine.cpp:1576) advances two float64 accumulators each
block::

    buffer_duration          = n_samples / sample_rate
    buffer_duration_in_beats = buffer_duration / beat_duration
    playhead        += buffer_duration_in_beats                  (engine.cpp:1622)
    sample_position += beat_to_samples(bd_beats, rate, beat_dur) (engine.cpp:1620)

Because each step adds the *same* f64 constant with sequential rounding, the
playhead/sample_position at block k are NOT exactly ``p0 + k*c`` — they carry
the accumulated rounding the C++ engine carries. Event carving (clip-start
frame positions!) depends on these exact values, so the timeline compiler
reproduces the accumulation with ``np.add.accumulate`` (sequential pairwise
f64 adds, identical to the C++ loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.core.math import beat_to_samples
from whitebox_tpu_torch.core.tempo import TempoMap


@dataclass
class BlockTransport:
    sample_rate: float
    buffer_size: int
    beat_duration: float
    playhead_start: float = 0.0
    #: optional tempo map (framework extension, core/tempo.py). When set
    #: AND non-constant, the grids come from the map's exact closed forms
    #: instead of the reference's sequential f64 accumulation; the
    #: accumulation path below stays bit-identical for unmapped sessions.
    tempo_map: TempoMap | None = None

    @property
    def mapped(self) -> bool:
        """True when a non-trivial tempo map drives this transport.

        A constant map is demoted to the legacy scalar path (with the
        map's BPM as beat_duration) so single-tempo sessions stay on the
        reference's exact accumulation arithmetic."""
        return self.tempo_map is not None and not self.tempo_map.is_constant

    def __post_init__(self):
        if self.tempo_map is not None and self.tempo_map.is_constant:
            self.beat_duration = 60.0 / self.tempo_map.bpm_at(0.0)
            self.tempo_map = None

    @property
    def buffer_duration(self) -> float:
        return float(self.buffer_size) / self.sample_rate

    @property
    def buffer_duration_in_beats(self) -> float:
        return self.buffer_duration / self.beat_duration

    @property
    def sample_position_step(self) -> float:
        """The f64 constant added to sample_position per block."""
        return beat_to_samples(self.buffer_duration_in_beats, self.sample_rate, self.beat_duration)

    @property
    def start_seconds(self) -> float:
        """Timeline seconds at the playhead start."""
        if self.mapped:
            return float(self.tempo_map.beats_to_seconds(self.playhead_start))
        return self.playhead_start * self.beat_duration

    def playhead_grid(self, num_blocks: int) -> np.ndarray:
        """playhead value at the start of blocks 0..num_blocks (inclusive).

        Unmapped: exact sequential f64 accumulation (the C++ engine adds
        the same constant each block with sequential rounding — event
        positions depend on those exact values). Mapped: drift-free exact
        closed form ``seconds_to_beats(t0 + k·buffer_duration)``."""
        if self.mapped:
            t = self.start_seconds + np.arange(num_blocks + 1, dtype=np.float64) * self.buffer_duration
            return np.asarray(self.tempo_map.seconds_to_beats(t), np.float64)
        steps = np.full(num_blocks + 1, self.buffer_duration_in_beats, dtype=np.float64)
        steps[0] = self.playhead_start
        return np.add.accumulate(steps)

    def sample_position_grid(self, num_blocks: int) -> np.ndarray:
        """sample_position at the start of blocks 0..num_blocks (inclusive).

        Mapped transports advance by exactly buffer_size frames per block
        (sample position is frame count — tempo doesn't bend it); the
        unmapped path reproduces the reference's beats-roundtrip rounding."""
        if self.mapped:
            return np.arange(num_blocks + 1, dtype=np.float64) * float(self.buffer_size)
        steps = np.full(num_blocks + 1, self.sample_position_step, dtype=np.float64)
        steps[0] = 0.0
        return np.add.accumulate(steps)

    def delta_samples(self, beat_from: float, beat_to: float) -> float:
        """Sample span between two beat positions.

        Unmapped (or when callers pass the legacy scalar path): the
        reference's two-rounding ``beat_to_samples`` form. Mapped: the
        exact integral over the tempo map."""
        if self.mapped:
            return self.tempo_map.delta_samples(beat_from, beat_to, self.sample_rate)
        return beat_to_samples(beat_to - beat_from, self.sample_rate, self.beat_duration)

    def blocks_for_beats(self, end_beat: float) -> int:
        """Number of blocks needed so the playhead passes end_beat."""
        if self.mapped:
            span = float(self.tempo_map.beats_to_seconds(end_beat)) - self.start_seconds
            n = max(int(np.ceil(max(span, 0.0) / self.buffer_duration)), 0)
            while float(self.playhead_grid(n)[-1]) < end_beat:
                n += 1
            return n
        total = max(end_beat - self.playhead_start, 0.0)
        n = int(np.ceil(total / self.buffer_duration_in_beats))
        # Accumulated-rounding safety: make sure the grid really covers it.
        while float(self.playhead_grid(n)[-1]) < end_beat:
            n += 1
        return n

    def blocks_for_frames(self, frames: int) -> int:
        return -(-int(frames) // int(self.buffer_size))
