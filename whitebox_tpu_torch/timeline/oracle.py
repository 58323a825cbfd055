"""The parity oracle: a NumPy block-sequential mixer that reproduces the
C++ engine's f32 mix path bit-for-bit.

This is a faithful port of the reference hot path:

- Engine::process        engine.cpp:1576-1654  (block loop, track sum, clip)
- Track::process_event   track.cpp:258-451     (clip -> sample-accurate events)
- Track::process         track.cpp:587-736     (event-segmented render, gain/pan)
- Sampler::stream        sampler.cpp:88-210    (fast copy path + linear resample)

Every float op is performed at the C++ width (f64 timeline math, f32 sample
math, documented narrowing points). Inner loops are vectorized with NumPy —
elementwise IEEE ops are identical to the scalar C++ loops.

The oracle is intentionally slow and simple; it exists to define ground
truth for the TPU renderer (BASELINE.md: parity within 1 ulp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat, I16_NORM_F32, I24_NORM_F64, I32_NORM_F64
from whitebox_tpu_torch.session.clip import Clip, ClipType
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.session.track import Track
from whitebox_tpu_torch.timeline.transport import BlockTransport

_PLAY = 1
_STOP = 2


@dataclass
class _AudioEvent:
    type: int
    buffer_offset: int
    time: float
    speed: float = 1.0
    sample_offset: int = 0
    clip: Optional[Clip] = None


class _Sampler:
    """dsp::Sampler (sampler.h) — f64 phase state + stream()."""

    def __init__(self) -> None:
        self.playback_speed = 1.0
        self.sample_offset = 0.0

    def reset_state(self, sample_offset: float, speed: float, src_rate: float, dst_rate: float) -> None:
        # sampler.h:24 — speed = (src_rate / dst_rate) * clip_speed
        self.playback_speed = (src_rate / dst_rate) * speed
        self.sample_offset = float(sample_offset)

    def stream(self, sample, num_channels: int, num_samples: int, buffer_offset: int, gain: np.float32, out: np.ndarray) -> None:
        """sampler.cpp:88-210. ``out`` is [channels, block] f32, accumulated."""
        if num_samples == 0:
            return
        if self.sample_offset >= sample.count:
            return  # finished streaming (sampler.cpp:99) — offset NOT advanced

        stream_max_length = (float(sample.count) - self.sample_offset) / self.playback_speed
        next_sample_offset = self.sample_offset + float(num_samples) * self.playback_speed
        num_actual = min(num_samples, int(math.ceil(stream_max_length)))
        gain = np.float32(gain)
        fmt = sample.format

        if self.playback_speed == 1.0:
            # fast path (sampler.cpp:106-158): normalize + clamp + accumulate
            off = int(np.uint32(np.uint64(self.sample_offset) & 0xFFFFFFFF))
            for i in range(num_channels):
                data = sample.padded(i)[off : off + num_actual]
                if fmt == AudioFormat.I16:
                    v = data.astype(np.float32) * I16_NORM_F32
                    v = np.clip(v, np.float32(-1.0), np.float32(1.0))
                elif fmt in (AudioFormat.I24, AudioFormat.I24_X8):
                    v = np.clip(data.astype(np.float64) * I24_NORM_F64, -1.0, 1.0).astype(np.float32)
                elif fmt == AudioFormat.I32:
                    v = np.clip(data.astype(np.float64) * I32_NORM_F64, -1.0, 1.0).astype(np.float32)
                elif fmt == AudioFormat.F32:
                    v = data.astype(np.float32)
                else:
                    raise ValueError(f"unsupported playback format {fmt!r}")
                out[i, buffer_offset : buffer_offset + num_actual] += v * gain
        else:
            # linear-interpolation path (sampler.cpp:34-59): no clamp
            j = np.arange(num_actual, dtype=np.float64)
            x = self.sample_offset + j * self.playback_speed  # per-element f64, C op order
            ix = np.trunc(x).astype(np.int64)
            fx = (x - ix.astype(np.float64)).astype(np.float32)
            for i in range(num_channels):
                data = sample.padded(i)
                if fmt == AudioFormat.I16:
                    a = data[ix].astype(np.float32) * I16_NORM_F32
                    b = data[ix + 1].astype(np.float32) * I16_NORM_F32
                elif fmt in (AudioFormat.I24, AudioFormat.I24_X8):
                    a = (data[ix].astype(np.float64) * I24_NORM_F64).astype(np.float32)
                    b = (data[ix + 1].astype(np.float64) * I24_NORM_F64).astype(np.float32)
                elif fmt == AudioFormat.I32:
                    a = (data[ix].astype(np.float64) * I32_NORM_F64).astype(np.float32)
                    b = (data[ix + 1].astype(np.float64) * I32_NORM_F64).astype(np.float32)
                elif fmt == AudioFormat.F32:
                    a = data[ix].astype(np.float32)
                    b = data[ix + 1].astype(np.float32)
                else:
                    raise ValueError(f"unsupported playback format {fmt!r}")
                s = a + fx * (b - a)  # sampler.cpp:55 — f32 lerp form
                out[i, buffer_offset : buffer_offset + num_actual] += s * gain

        self.sample_offset = next_sample_offset

    def stream_reverse(self, sample, num_channels: int, num_samples: int, buffer_offset: int, gain: np.float32, out: np.ndarray) -> None:
        """Reverse playback (framework extension — the reference enums
        reverse clip modes, clip.h:21, but never implements playback for
        them). ``sample_offset`` acts as a *virtual forward offset* v that
        advances exactly like the forward sampler; the read position is
        x = (count-1-v) - j*speed, interpolated with the same f32 lerp as
        the forward linear path (no fast-copy form, no clamp)."""
        if num_samples == 0:
            return
        count = float(sample.count)
        v = self.sample_offset
        speed = self.playback_speed
        x0 = (count - 1.0) - v
        if x0 < 0.0:
            return  # finished (mirrors the frozen forward sampler)
        num_actual = min(num_samples, int(math.floor(x0 / speed)) + 1)
        gain = np.float32(gain)
        fmt = sample.format

        j = np.arange(num_actual, dtype=np.float64)
        x = x0 - j * speed  # per-element f64
        ix = np.trunc(x).astype(np.int64)
        fx = (x - ix.astype(np.float64)).astype(np.float32)
        for i in range(num_channels):
            data = sample.padded(i)
            if fmt == AudioFormat.I16:
                a = data[ix].astype(np.float32) * I16_NORM_F32
                b = data[ix + 1].astype(np.float32) * I16_NORM_F32
            elif fmt in (AudioFormat.I24, AudioFormat.I24_X8):
                a = (data[ix].astype(np.float64) * I24_NORM_F64).astype(np.float32)
                b = (data[ix + 1].astype(np.float64) * I24_NORM_F64).astype(np.float32)
            elif fmt == AudioFormat.I32:
                a = (data[ix].astype(np.float64) * I32_NORM_F64).astype(np.float32)
                b = (data[ix + 1].astype(np.float64) * I32_NORM_F64).astype(np.float32)
            elif fmt == AudioFormat.F32:
                a = data[ix].astype(np.float32)
                b = data[ix + 1].astype(np.float32)
            else:
                raise ValueError(f"unsupported playback format {fmt!r}")
            s = a + fx * (b - a)
            out[i, buffer_offset : buffer_offset + num_actual] += s * gain

        self.sample_offset = v + float(num_samples) * speed


class _TrackState:
    """TrackEventState (track.h:36) + the persistent current event/sampler."""

    def __init__(self) -> None:
        self.clip_idx: Optional[int] = None
        self.midi_note_idx: int = 0
        self.partially_ended: bool = False
        self.refresh_voice: bool = False
        self.current_event = _AudioEvent(type=0, buffer_offset=0, time=0.0)
        self.sampler = _Sampler()
        self.bidir_reverse: bool = False  # LOOP_BIDIRECTIONAL pass direction


class OracleRenderer:
    """Block-sequential session renderer with C++ engine semantics.

    Only audio clips render in the oracle's strict-parity path; MIDI clips
    participate in event iteration but synthesize via the extension synth
    (midi.synth) when enabled.
    """

    def __init__(self, session: Session, sample_rate: float, buffer_size: int = 512, channels: int = 2) -> None:
        self.session = session
        self.sample_rate = float(sample_rate)
        self.buffer_size = int(buffer_size)
        self.channels = int(channels)

    # -- Track::process_event (track.cpp:258) --------------------------------

    def _process_event(
        self,
        track: Track,
        st: _TrackState,
        events: list[_AudioEvent],
        start_time: float,
        end_time: float,
        sample_position: float,
        transport: BlockTransport,
    ) -> None:
        clips = track.clips
        rate = self.sample_rate
        bufsize = self.buffer_size

        if not clips:
            if st.refresh_voice:
                events.append(_AudioEvent(_STOP, 0, start_time))
                st.clip_idx = None
                st.midi_note_idx = 0
                st.refresh_voice = False
            return

        num_clips = len(clips)
        if st.refresh_voice:
            clip_at_playhead = track.find_next_clip(start_time)
            if clip_at_playhead is not None:
                if st.clip_idx is not None:
                    idx = st.clip_idx
                    if idx < num_clips:
                        clip = clips[clip_at_playhead]
                        current_clip = clips[idx]
                        if clip is not current_clip and start_time >= clip.min_time and start_time <= clip.max_time:
                            if clip.is_audio():
                                events.append(_AudioEvent(_STOP, 0, start_time))
                            st.clip_idx = clip_at_playhead
                            st.midi_note_idx = 0
                            st.partially_ended = False
                        elif clip is current_clip and (start_time < clip.min_time or start_time > clip.max_time):
                            if clip.is_audio():
                                events.append(_AudioEvent(_STOP, 0, start_time))
                            st.clip_idx = clip_at_playhead
                            st.midi_note_idx = 0
                            st.partially_ended = False
                else:
                    st.clip_idx = clip_at_playhead
                    st.midi_note_idx = 0
            else:
                events.append(_AudioEvent(_STOP, 0, start_time))
                st.clip_idx = None
                st.midi_note_idx = 0
            st.refresh_voice = False

        if st.clip_idx is None:
            return

        # Block ownership of an event time t. Unmapped: the reference's
        # closed interval [start, end] (track.cpp walk) — f64-accumulated
        # grids essentially never land exactly on a beat, so the ambiguous
        # equality case is moot. Mapped: HALF-OPEN [start, end) — the exact
        # closed-form grids DO hit beats exactly (e.g. beat 6.0 == a block
        # edge at 120->60 bpm), and closed ownership would double-fire the
        # Play in two adjacent blocks (plus truncate it a block early via
        # the %buffer_size wrap). Half-open places every event exactly once
        # at its exact frame. core/tempo.py documents this contract.
        mapped = transport.mapped
        next_clip = st.clip_idx
        while next_clip < num_clips:
            clip = clips[next_clip]
            min_time = clip.min_time
            max_time = clip.max_time

            if (min_time >= end_time) if mapped else (min_time > end_time):
                break

            is_audio = clip.is_audio()
            if min_time >= start_time:  # started from the beginning
                if is_audio:
                    # delta_samples == beat_to_samples(min_time-start_time,
                    # rate, bd) bit-for-bit when unmapped (transport.py)
                    offset_from_start = transport.delta_samples(start_time, min_time)
                    sample_offset = sample_position + offset_from_start
                    buffer_offset = int(np.uint64(sample_offset)) % bufsize
                    events.append(
                        _AudioEvent(
                            _PLAY, buffer_offset, min_time,
                            speed=clip.audio.speed, sample_offset=int(clip.start_offset), clip=clip,
                        )
                    )
                else:
                    st.midi_note_idx = clip.midi.asset.find_first_note(clip.start_offset, 0)
                clip.internal_state_changed = False
            elif start_time > min_time and not st.partially_ended:  # started mid-clip
                relative_start_time = start_time - min_time
                if is_audio:
                    sample_pos = transport.delta_samples(min_time, start_time)
                    sample_offset = int(clip.start_offset + sample_pos * clip.audio.speed)
                    events.append(
                        _AudioEvent(_PLAY, 0, start_time, speed=clip.audio.speed, sample_offset=sample_offset, clip=clip)
                    )
                else:
                    st.midi_note_idx = clip.midi.asset.find_first_note(relative_start_time + clip.start_offset, 0)
                clip.internal_state_changed = False
            elif clip.internal_state_changed and st.partially_ended:  # edited while playing
                relative_start_time = start_time - min_time
                if is_audio:
                    sample_pos = transport.delta_samples(min_time, start_time)
                    sample_offset = int(clip.start_offset + sample_pos * clip.audio.speed)
                    events.append(_AudioEvent(_STOP, 0, start_time))
                    events.append(
                        _AudioEvent(_PLAY, 0, start_time, speed=clip.audio.speed, sample_offset=sample_offset, clip=clip)
                    )
                else:
                    st.midi_note_idx = clip.midi.asset.find_first_note(relative_start_time + clip.start_offset, 0)
                clip.internal_state_changed = False

            if (max_time < end_time) if mapped else (max_time <= end_time):
                # clip ends inside this block (mapped: a stop exactly at the
                # block edge belongs to the NEXT block, where delta == 0
                # gives the exact frame instead of a %bufsize early wrap)
                if is_audio:
                    offset_from_start = transport.delta_samples(start_time, max_time)
                    sample_offset = sample_position + offset_from_start
                    buffer_offset = int(np.uint64(sample_offset)) % bufsize
                    events.append(_AudioEvent(_STOP, buffer_offset, max_time))
                st.partially_ended = False
            else:
                st.partially_ended = True
                break

            next_clip += 1

        st.clip_idx = next_clip

    # -- Track::process render loop (track.cpp:664-736) -----------------------

    def _stream_clip(self, st: _TrackState, clip, event_length: int, start_sample: int, out: np.ndarray) -> None:
        """One stream call for the current PLAY clip; LOOP_STRAIGHT clips
        (extension — see session/clip.py ClipMode) wrap the sampler back to
        source frame 0 whenever a pass exhausts within the event window."""
        from whitebox_tpu_torch.session.clip import ClipMode

        gain = np.float32(clip.audio.gain)
        sample = clip.audio.asset.sample
        mode = clip.audio.mode
        count = float(sample.count)
        speed = st.sampler.playback_speed
        if mode == ClipMode.ONE_SHOT:
            st.sampler.stream(sample, self.channels, event_length, start_sample, gain, out)
            return
        if mode == ClipMode.ONE_SHOT_REVERSE:
            st.sampler.stream_reverse(sample, self.channels, event_length, start_sample, gain, out)
            return
        remaining = event_length
        at = start_sample
        if mode == ClipMode.LOOP_STRAIGHT:
            while remaining > 0:
                off = st.sampler.sample_offset
                if off >= count:
                    st.sampler.sample_offset = 0.0
                    off = 0.0
                n_actual = min(remaining, int(math.ceil((count - off) / speed)))
                if n_actual <= 0:
                    break
                st.sampler.stream(sample, self.channels, n_actual, at, gain, out)
                remaining -= n_actual
                at += n_actual
            return
        if mode == ClipMode.LOOP_REVERSE:
            while remaining > 0:
                x0 = (count - 1.0) - st.sampler.sample_offset
                if x0 < 0.0:
                    st.sampler.sample_offset = 0.0  # restart at the source end
                    x0 = count - 1.0
                n_actual = min(remaining, int(math.floor(x0 / speed)) + 1)
                if n_actual <= 0:
                    break
                st.sampler.stream_reverse(sample, self.channels, n_actual, at, gain, out)
                remaining -= n_actual
                at += n_actual
            return
        if mode == ClipMode.LOOP_BIDIRECTIONAL:
            # alternate full forward / reverse passes; each pass after the
            # first starts one `speed` step past the turn-around point so the
            # endpoint frame isn't doubled at the seam
            stalls = 0
            while remaining > 0 and stalls <= 2:
                if not st.bidir_reverse:
                    off = st.sampler.sample_offset
                    if off >= count:
                        st.bidir_reverse = True
                        st.sampler.sample_offset = speed
                        stalls += 1
                        continue
                    n_actual = min(remaining, int(math.ceil((count - off) / speed)))
                    if n_actual <= 0:
                        break
                    st.sampler.stream(sample, self.channels, n_actual, at, gain, out)
                else:
                    x0 = (count - 1.0) - st.sampler.sample_offset
                    if x0 < 0.0:
                        st.bidir_reverse = False
                        st.sampler.sample_offset = speed
                        stalls += 1
                        continue
                    n_actual = min(remaining, int(math.floor(x0 / speed)) + 1)
                    if n_actual <= 0:
                        break
                    st.sampler.stream_reverse(sample, self.channels, n_actual, at, gain, out)
                remaining -= n_actual
                at += n_actual
                stalls = 0
            return
        raise ValueError(f"unknown clip mode {mode!r}")

    def _render_track_block(self, track: Track, st: _TrackState, events: list[_AudioEvent], out: np.ndarray) -> None:
        n = out.shape[1]
        start_sample = 0
        ev_i = 0
        while start_sample < n:
            if ev_i < len(events):
                ev = events[ev_i]
                event_length = ev.buffer_offset - start_sample
                if st.current_event.type == _PLAY:
                    self._stream_clip(st, st.current_event.clip, event_length, start_sample, out)
                if ev.type == _PLAY:
                    sample = ev.clip.audio.asset.sample
                    st.sampler.reset_state(float(ev.sample_offset), ev.speed, float(sample.sample_rate), self.sample_rate)
                    st.bidir_reverse = False
                st.current_event = ev
                start_sample += event_length
                ev_i += 1
            else:
                event_length = n - start_sample
                if st.current_event.type == _PLAY:
                    self._stream_clip(st, st.current_event.clip, event_length, start_sample, out)
                start_sample = n

        # volume / pan / mute (track.cpp:728-733)
        volume = np.float32(0.0) if track.mute else track.volume_linear
        pan = track.pan_coeffs
        for i in range(out.shape[0]):
            out[i, :] *= volume * np.float32(pan[i % 2])

    # -- Engine::process (engine.cpp:1576) ------------------------------------

    def render(self, num_blocks: int | None = None, *, playhead_start: float | None = None, trim_frames: int | None = None) -> np.ndarray:
        session = self.session
        beat_duration = session.beat_duration
        start = session.playhead_start if playhead_start is None else playhead_start

        transport = BlockTransport(self.sample_rate, self.buffer_size, beat_duration, start,
                                   tempo_map=getattr(session, "tempo_map", None))
        if num_blocks is None:
            num_blocks = max(transport.blocks_for_beats(session.end_time()), 1)
        # mapped transports drive playhead/sample_position from the exact
        # grids; the unmapped grids ARE the sequential accumulation below
        # (np.add.accumulate — identical f64 op sequence), so one code path
        P = transport.playhead_grid(num_blocks)
        S = transport.sample_position_grid(num_blocks)

        states = []
        for track in session.tracks:
            st = _TrackState()
            st.clip_idx = track.find_next_clip(start)  # reset_playback_state (track.cpp:220)
            states.append(st)

        n = self.buffer_size
        output = np.zeros((self.channels, num_blocks * n), dtype=np.float32)
        mix = np.empty((self.channels, n), dtype=np.float32)

        for k in range(num_blocks):
            playhead = float(P[k])
            next_playhead = float(P[k + 1])
            sample_position = float(S[k])
            block = output[:, k * n : (k + 1) * n]

            for track, st in zip(session.tracks, states):
                mix[:] = 0.0
                events: list[_AudioEvent] = []
                self._process_event(track, st, events, playhead, next_playhead, sample_position, transport)
                self._render_track_block(track, st, events, mix)
                block += mix  # output.mix(mixing_buffer), track index order

            # hard clip (engine.cpp:1627-1636)
            np.copyto(block, np.where(block > 1.0, np.float32(1.0), block))
            np.copyto(block, np.where(block < -1.0, np.float32(-1.0), block))

        if trim_frames is not None:
            output = output[:, :trim_frames]
        return output
