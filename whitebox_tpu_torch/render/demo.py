"""Synthetic session builders for benches and demos.

A copy of ``whitebox_tpu/render/demo.py`` on the port's session model.
Same arguments, same session: both builders draw from
``numpy.random.default_rng(seed)`` in the same order, so the sessions carve
to the same tables.
"""

from __future__ import annotations

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.session import Session
from whitebox_tpu_torch.session.sample import Sample


def make_demo_session(
    n_tracks: int = 8,
    duration_seconds: float = 10.0,
    sample_rate: int = 48000,
    bpm: float = 120.0,
    seed: int = 0,
    n_unique_samples: int = 8,
    sample_seconds: float = 2.0,
    clip_speeds=(1.0,),
    stereo: bool = True,
    fades: bool = False,
) -> Session:
    """A dense multi-track session: each track tiles clips over the timeline.

    Mirrors BASELINE.json config shapes (8/32/128-track mixes at 48 kHz).
    """
    rng = np.random.default_rng(seed)
    s = Session(bpm=bpm)
    bd = s.beat_duration

    n_frames = int(sample_seconds * sample_rate)
    assets = []
    for i in range(n_unique_samples):
        ch = 2 if stereo and i % 2 == 0 else 1
        t = np.arange(n_frames) / sample_rate
        freq = 55.0 * (2.0 ** (i % 8))
        base = np.sin(2 * np.pi * freq * t) * 0.25 + rng.standard_normal(n_frames) * 0.02
        data = np.stack([base.astype(np.float32)] * ch) * np.linspace(1.0, 0.7, ch, dtype=np.float32)[:, None]
        sample = Sample.from_planar(np.ascontiguousarray(data.astype(np.float32)), sample_rate, AudioFormat.F32, name=f"d{i}")
        assets.append(s.sample_table.add_sample(sample, key=f"d{i}"))

    total_beats = duration_seconds / bd
    clip_beats = sample_seconds / bd

    for ti in range(n_tracks):
        tr = s.add_track(
            f"track{ti}",
            volume_db=float(rng.uniform(-9.0, 0.0)),
            pan=float(rng.uniform(-0.8, 0.8)),
        )
        pos = float(rng.uniform(0, 0.5))
        while pos < total_beats - 0.01:
            length = min(clip_beats * float(rng.uniform(0.5, 1.0)), total_beats - pos)
            speed = float(clip_speeds[int(rng.integers(len(clip_speeds)))])
            kw = {}
            if fades:
                kw = {"fade_start": length * 0.1, "fade_end": length * 0.1}
            s.add_audio_clip(
                tr, f"c{ti}", pos, pos + length,
                start_offset=float(int(rng.integers(0, n_frames // 4))),
                asset=assets[int(rng.integers(len(assets)))],
                gain=float(rng.uniform(0.4, 1.0)),
                speed=speed,
                **kw,
            )
            pos += length + float(rng.uniform(0.05, 0.3))
    return s
