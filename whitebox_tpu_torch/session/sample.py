"""Decoded PCM sample container — mirrors src/dsp/sample.h.

Like the reference, samples keep planar per-channel arrays in their *native*
format (I16/I24/I32/F32; no up-front f32 convert — sample.h keeps bytes) and
carry zero padding at the tail so interpolating reads past the last frame
are safe (sample.h:19 pads 16 samples; linear interpolation reads at most
index ``count``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat, normalize_unclamped, storage_dtype

#: Tail zero-padding in frames (reference: sample.h:19).
SAMPLE_PADDING = 16


@dataclass
class Sample:
    name: str
    path: str
    format: AudioFormat
    channels: int
    sample_rate: int
    count: int
    #: list of per-channel 1-D arrays in native dtype, length count (unpadded).
    data: list[np.ndarray] = field(default_factory=list)

    @staticmethod
    def from_planar(planar: np.ndarray, sample_rate: int, fmt: AudioFormat, name: str = "", path: str = "") -> "Sample":
        planar = np.atleast_2d(planar)
        want = storage_dtype(fmt)
        if planar.dtype != want:
            raise ValueError(f"planar dtype {planar.dtype} does not match format {fmt!r} ({want})")
        return Sample(
            name=name,
            path=path,
            format=fmt,
            channels=planar.shape[0],
            sample_rate=int(sample_rate),
            count=planar.shape[1],
            data=[np.ascontiguousarray(planar[c]) for c in range(planar.shape[0])],
        )

    @staticmethod
    def load_file(path) -> "Sample":
        """Decode an audio file keeping native PCM (Sample::load_file parity)."""
        from whitebox_tpu_torch.io.wav import load_audio_file

        planar, info = load_audio_file(path)
        p = Path(path)
        return Sample.from_planar(planar, info.sample_rate, info.format, name=p.stem, path=str(p))

    def channel(self, c: int) -> np.ndarray:
        """Channel data with wraparound channel mapping (track.cpp uses i % channels)."""
        return self.data[c % self.channels]

    def padded(self, c: int, pad: int = SAMPLE_PADDING) -> np.ndarray:
        """Channel data with zero tail padding, native dtype."""
        d = self.channel(c)
        return np.concatenate([d, np.zeros(pad, dtype=d.dtype)])

    def normalized_f32(self, c: int, pad: int = SAMPLE_PADDING) -> np.ndarray:
        """Unclamped normalized f32 channel with tail padding.

        This is the representation uploaded to the device sample pool; the
        speed==1 clamp is applied in-kernel (see core.formats docstring).
        """
        return normalize_unclamped(self.padded(c, pad), self.format)

    @property
    def duration_seconds(self) -> float:
        return self.count / float(self.sample_rate)

    def __repr__(self) -> str:  # keep dataclass repr from dumping arrays
        return (
            f"Sample(name={self.name!r}, fmt={self.format.name}, ch={self.channels}, "
            f"rate={self.sample_rate}, count={self.count})"
        )
