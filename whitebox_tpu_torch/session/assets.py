"""Content-addressed asset caches — mirrors src/engine/assets_table.{h,cpp}.

``SampleTable`` interns decoded samples by path (the reference keys by
XXH64(path), assets_table.cpp:10; a content key of the path string is
equivalent for interning) with refcounts; waveform peak visuals are built
lazily on demand (the reference builds them eagerly at load,
assets_table.cpp:56 — lazy keeps the render path free of UI work).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from whitebox_tpu_torch.session.sample import Sample


@dataclass
class SampleAsset:
    key: str
    sample: Sample
    ref_count: int = 1
    peaks: object = None  # lazily-built ops.peaks.WaveformMipmaps

    def add_ref(self) -> None:
        self.ref_count += 1

    def release(self, table: "SampleTable | None" = None) -> None:
        self.ref_count -= 1
        if self.ref_count <= 0 and table is not None:
            table._evict(self.key)


@dataclass
class MidiAsset:
    """assets_table.h:99 — a pooled note sequence with metadata."""

    notes: object = None  # midi.notes.MidiNoteBuffer
    ref_count: int = 1

    def add_ref(self) -> None:
        self.ref_count += 1

    @property
    def max_length(self) -> float:
        return self.notes.max_length if self.notes is not None else 0.0

    def find_first_note(self, time_pos: float, channel: int = 0) -> int:
        return self.notes.find_first_note(time_pos, channel)


class SampleTable:
    def __init__(self) -> None:
        self.samples: dict[str, SampleAsset] = {}

    @staticmethod
    def _key(path) -> str:
        return str(Path(path).resolve()) if Path(str(path)).exists() else str(path)

    def load_from_file(self, path) -> SampleAsset:
        """assets_table.cpp:42 — return interned asset or decode anew."""
        key = self._key(path)
        asset = self.samples.get(key)
        if asset is not None:
            asset.add_ref()
            return asset
        sample = Sample.load_file(path)
        asset = SampleAsset(key=key, sample=sample)
        self.samples[key] = asset
        return asset

    def add_sample(self, sample: Sample, key: str | None = None) -> SampleAsset:
        """Register an in-memory sample (recording ingest / tests)."""
        key = key or sample.path or sample.name or f"mem:{id(sample)}"
        asset = self.samples.get(key)
        if asset is not None:
            asset.add_ref()
            return asset
        asset = SampleAsset(key=key, sample=sample)
        self.samples[key] = asset
        return asset

    def _evict(self, key: str) -> None:
        self.samples.pop(key, None)

    def __len__(self) -> int:
        return len(self.samples)


class MidiTable:
    def __init__(self) -> None:
        self.midi_assets: list[MidiAsset] = []

    def create_midi(self, notes=None) -> MidiAsset:
        from whitebox_tpu_torch.midi.notes import MidiNoteBuffer

        asset = MidiAsset(notes=notes if notes is not None else MidiNoteBuffer())
        self.midi_assets.append(asset)
        return asset

    def load_from_file(self, path) -> MidiAsset | None:
        from whitebox_tpu_torch.midi.smf import load_notes_from_file

        try:
            notes = load_notes_from_file(path)
        except (ValueError, OSError):
            return None
        return self.create_midi(notes)

    def __len__(self) -> int:
        return len(self.midi_assets)
