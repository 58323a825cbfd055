"""Streaming record ingestion — the audio_record path, offline-shaped.

The reference records through three cooperating pieces: the audio thread
writes device blocks into a bounded ring (audio_record.h:44-128), a
recorder thread drains it and grows the destination ``Sample`` in 256 KiB
chunks (engine.h:36 ``audio_record_chunk_size``), and ``stop_record``
truncates the sample to the frames actually written, registers it as an
asset, and places the clip over the recorded transport range
(engine.cpp:107-140).

:class:`RecordingTake` is that lifecycle as an explicit object: ``append``
accepts incoming ``[C, n]`` blocks under the same bounded-allocation
contract (fixed-size chunk buffers, no per-append reallocation of the
take), and ``finalize`` truncates + registers + places the clip. It is
safe to append while a ``render.preview.PreviewStream`` plays the same
session (the punch-in workflow): the take touches the session only at
finalize, which bumps the edit stamp the preview already watches.

``Session.add_recorded_take`` remains the one-shot convenience over this.
"""

from __future__ import annotations

import numpy as np

#: the reference's recorder-thread growth quantum (engine.h:36).
RECORD_CHUNK_BYTES = 256 * 1024


class RecordingTake:
    """One armed-track take being filled block by block.

    Parameters mirror the reference's record state: the session/track the
    take lands on, the capture rate, and the transport beat where
    recording started (``record_min_time``). ``channels`` fixes the take
    width up front (the device's channel count).
    """

    def __init__(self, session, track, sample_rate: float, at_beat: float,
                 channels: int = 2, name: str = "",
                 chunk_bytes: int = RECORD_CHUNK_BYTES) -> None:
        if channels < 1:
            raise ValueError("channels must be >= 1")
        self.session = session
        self.track = track
        self.sample_rate = float(sample_rate)
        self.at_beat = float(at_beat)
        self.channels = int(channels)
        self.name = name
        #: frames per growth chunk (256 KiB of f32 across channels,
        #: engine.h:36) — the bounded allocation quantum
        self.chunk_frames = max(int(chunk_bytes) // (4 * self.channels), 1024)
        self._chunks: list[np.ndarray] = []  # full [C, chunk_frames] blocks
        self._fill = 0  # frames used in the last chunk
        self._frames = 0
        self._done = False

    @property
    def frames_written(self) -> int:
        """num_samples_written (engine.cpp:126)."""
        return self._frames

    @property
    def seconds(self) -> float:
        return self._frames / self.sample_rate

    def append(self, block) -> int:
        """Ingest one ``[C, n]`` (or ``[n]`` mono) f32 block; returns the
        total frames written. Allocation is bounded: at most one new
        ``chunk_frames`` buffer per ``chunk_frames`` ingested, never a
        copy of the whole take (the recorder thread's chunked growth,
        engine.cpp's ``audio_record_chunk_size`` contract)."""
        if self._done:
            raise RuntimeError("take already finalized")
        block = np.atleast_2d(np.asarray(block, dtype=np.float32))
        if block.shape[0] != self.channels:
            raise ValueError(
                f"block has {block.shape[0]} channels, take records {self.channels}")
        n = block.shape[1]
        pos = 0
        while pos < n:
            if not self._chunks or self._fill == self.chunk_frames:
                self._chunks.append(
                    np.zeros((self.channels, self.chunk_frames), np.float32))
                self._fill = 0
            room = self.chunk_frames - self._fill
            take = min(room, n - pos)
            self._chunks[-1][:, self._fill : self._fill + take] = block[:, pos : pos + take]
            self._fill += take
            pos += take
        self._frames += n
        return self._frames

    def cancel(self) -> None:
        """Drop the take without touching the session."""
        self._chunks.clear()
        self._frames = 0
        self._done = True

    def finalize(self):
        """Truncate to the frames written, register the sample asset, and
        place the clip over [at_beat, at_beat + recorded length] — the
        stop_record path (engine.cpp:107-140). Returns the new Clip (or
        None when nothing was recorded)."""
        if self._done:
            raise RuntimeError("take already finalized")
        self._done = True
        if self._frames == 0:
            return None
        audio = np.concatenate(self._chunks, axis=1)[:, : self._frames]
        self._chunks.clear()
        name = self.name or f"take {len(self.session.sample_table.samples) + 1} - {self.track.name}"
        return self.session.add_recorded_take(
            self.track, audio, int(self.sample_rate), self.at_beat, name=name)
