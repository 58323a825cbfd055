"""The session graph + edit API — mirrors src/engine/engine.{h,cpp} (edit half).

Holds the track list, tempo, playhead, and asset tables, and implements the
clip CRUD the reference's undo commands call into: add/move/resize/delete
with overlap trim/split (``reserve_track_region``, engine.cpp:478-569).
Rendering lives in timeline/ and render/.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from whitebox_tpu_torch.core.math import DEFAULT_PPQ, beat_duration_from_bpm, samples_to_beat, uround
from whitebox_tpu_torch.session.assets import MidiTable, SampleAsset, SampleTable
from whitebox_tpu_torch.session.clip import (
    AudioClipData,
    Clip,
    ClipType,
    MidiClipData,
    calc_move_clip,
    calc_resize_clip,
    shift_clip_content,
)
from whitebox_tpu_torch.session.track import Track


@dataclass
class TrackEditResult:
    """engine.h — edit results carry clip snapshots for undo."""

    deleted_clips: list[Clip] = field(default_factory=list)
    added_clips: list[Clip] = field(default_factory=list)
    modified_clips: list[Clip] = field(default_factory=list)


@dataclass
class MidiEditResult:
    """engine.h MidiEditResult — post-sort ids of modified notes plus backup
    copies of the pre-edit notes (the reference's undo payload)."""

    modified_notes: list[int] = field(default_factory=list)
    deleted_notes: list = field(default_factory=list)


@dataclass
class NoteSelectResult:
    """engine.h NoteSelectResult — ids whose selection state flipped plus the
    key span of the new selection (GUI Y-scaling in the reference)."""

    selected: list[int] = field(default_factory=list)
    deselected: list[int] = field(default_factory=list)
    min_key: int = 0
    max_key: int = 0


@dataclass
class ProjectInfo:
    author: str = ""
    title: str = ""
    genre: str = ""
    description: str = ""


class Session:
    def __init__(self, bpm: float = 120.0, ppq: float = DEFAULT_PPQ) -> None:
        self.bpm = float(bpm)
        self.beat_duration = beat_duration_from_bpm(self.bpm)
        self.ppq = float(ppq)
        self.playhead = 0.0
        self.playhead_start = 0.0
        self.tracks: list[Track] = []
        self.sample_table = SampleTable()
        self.midi_table = MidiTable()
        self.project_info = ProjectInfo()
        #: master-bus effect chain — an extension over the reference's flat
        #: track sum (engine.cpp:1600-1617 has no master effects, SURVEY §2.9).
        self.master_effects: list = []
        #: timed master-chain effect-param lanes, keyed (slot, param) like
        #: TrackAutomation.effects (the plugin param-queue analogue,
        #: param_changes.h:56-115).
        self.master_automation: dict = {}
        #: aux buses / track groups (session/bus.py) — a routing extension
        #: over the reference's flat track sum (SURVEY §2.9 "no sends/
        #: groups"). Buses sum into the master bus in index order.
        self.buses: list = []
        #: optional tempo map (core/tempo.py) — a framework extension; the
        #: reference has exactly one session-wide tempo (engine.cpp:24).
        #: None = the legacy single-bpm arithmetic, bit-for-bit.
        self.tempo_map = None
        #: optional meter (time-signature) map (core/meter.py) — bar|beat
        #: addressing only, never moves audio. None = straight 4/4.
        self.meter_map = None

    # ---- transport / tempo (engine.cpp:24-41) ----

    def set_bpm(self, bpm: float) -> None:
        self.bpm = float(bpm)
        self.beat_duration = beat_duration_from_bpm(self.bpm)
        if self.tempo_map is not None:
            # the map's beat-0 anchor follows the session bpm; only its BPM
            # value moves — an explicit beat-0 curve (e.g. a linear ramp
            # into the next point) is preserved
            from whitebox_tpu_torch.core.tempo import TempoMap, TempoPoint

            zero = next((p for p in self.tempo_map.points if p.beat == 0.0), None)
            pts = [p for p in self.tempo_map.points if p.beat > 0.0]
            pts.insert(0, TempoPoint(0.0, self.bpm,
                                     zero.curve if zero is not None else "step",
                                     zero.bpm_end if zero is not None else None))
            m = TempoMap(pts)
            self.tempo_map = None if m.is_constant else m

    # ---- tempo map (framework extension — core/tempo.py) ----

    def _make_tempo_map(self, points):
        from whitebox_tpu_torch.core.tempo import TempoMap, TempoPoint

        anchored = list(points)
        if not any(p.beat == 0.0 for p in anchored):
            anchored.insert(0, TempoPoint(0.0, self.bpm, "step"))
        return TempoMap(anchored)

    def set_tempo_point(self, beat: float, bpm: float, curve: str = "step",
                        bpm_end: float | None = None):
        """Add/replace a tempo point at ``beat``. The map is anchored at
        beat 0 with the session bpm unless a point at 0 overrides it.
        ``bpm_end`` (linear curves) sets an explicit ramp target, allowing
        a discontinuity at the next point (see core.tempo.TempoPoint)."""
        from whitebox_tpu_torch.core.tempo import TempoPoint

        pts = list(self.tempo_map.points) if self.tempo_map is not None else []
        pts = [p for p in pts if p.beat != float(beat)]
        pts.append(TempoPoint(float(beat), float(bpm), curve, bpm_end))
        self.tempo_map = self._make_tempo_map(pts)
        if float(beat) == 0.0:
            self.bpm = float(bpm)
            self.beat_duration = beat_duration_from_bpm(self.bpm)
        return self.tempo_map

    def remove_tempo_point(self, beat: float):
        """Remove the tempo point at ``beat``; an empty map becomes None."""
        if self.tempo_map is None:
            return None
        pts = [p for p in self.tempo_map.points if p.beat != float(beat)]
        nontrivial = [p for p in pts if not (p.beat == 0.0 and p.bpm == self.bpm
                                             and p.curve == "step")]
        self.tempo_map = self._make_tempo_map(pts) if nontrivial else None
        return self.tempo_map

    # ---- meter map (framework extension — core/meter.py) ----

    def set_meter(self, bar: int, num: int, den: int):
        """Set the time signature from ``bar`` (0-based) onward."""
        from whitebox_tpu_torch.core.meter import MeterMap, MeterPoint

        pts = list(self.meter_map.points) if self.meter_map is not None else []
        pts = [p for p in pts if p.bar != int(bar)]
        pts.append(MeterPoint(int(bar), int(num), int(den)))
        if not any(p.bar == 0 for p in pts):
            pts.append(MeterPoint(0, 4, 4))  # bars before the first change stay 4/4
        m = MeterMap(pts)
        self.meter_map = None if m.is_default else m
        return self.meter_map

    def remove_meter(self, bar: int):
        """Remove the signature change at ``bar``; an all-4/4 map becomes None."""
        if self.meter_map is None:
            return None
        from whitebox_tpu_torch.core.meter import MeterMap

        pts = [p for p in self.meter_map.points if p.bar != int(bar)]
        m = MeterMap(pts) if pts else None
        self.meter_map = None if (m is None or m.is_default) else m
        return self.meter_map

    def bar_to_beat(self, bar: float) -> float:
        """Quarter-beat position of a (fractional, 0-based) bar number."""
        if self.meter_map is not None:
            return self.meter_map.bar_to_beat(bar)
        return float(bar) * 4.0  # straight 4/4

    def beat_to_bar(self, beat: float) -> float:
        if self.meter_map is not None:
            return self.meter_map.beat_to_bar(beat)
        return float(beat) / 4.0

    def beat_duration_at(self, beat: float) -> float:
        """Local beat duration — the tempo map's when set, else the session
        scalar (exactly the legacy value)."""
        if self.tempo_map is not None:
            return self.tempo_map.beat_duration_at(float(beat))
        return self.beat_duration

    @property
    def time_base(self):
        """What converts beats to frames: the TempoMap when one is set,
        else the scalar beat_duration (automation/lane packers accept
        either — ops/automation.lane_frame_table)."""
        return self.tempo_map if self.tempo_map is not None else self.beat_duration

    def set_playhead_position(self, beat_position: float) -> None:
        self.playhead_start = beat_position
        self.playhead = beat_position

    # ---- track CRUD (engine.cpp:200-263) ----

    def add_track(self, name: str = "", **kwargs) -> Track:
        track = Track(name=name or f"Track {len(self.tracks) + 1}", **kwargs)
        self.tracks.append(track)
        return track

    def delete_track(self, index: int) -> Track:
        return self.tracks.pop(index)

    def move_track(self, from_slot: int, to_slot: int) -> None:
        track = self.tracks.pop(from_slot)
        self.tracks.insert(to_slot, track)

    def solo_track(self, slot: int) -> None:
        """engine.cpp:245 — exclusive solo implemented by flipping mutes."""
        track = self.tracks[slot]
        if track.solo:
            track.solo = False
            mute = False
        else:
            track.solo = True
            track.mute = False
            mute = True
        for i, t in enumerate(self.tracks):
            if i == slot:
                continue
            t.solo = False
            t.mute = mute

    # ---- bus / routing CRUD (extension; session/bus.py) ----

    def add_bus(self, name: str = "", **kwargs):
        """Create an aux bus / track group destination. Returns the Bus."""
        from whitebox_tpu_torch.session.bus import Bus

        bus = Bus(name=name or f"Bus {len(self.buses) + 1}", **kwargs)
        self.buses.append(bus)
        return bus

    def delete_bus(self, index: int):
        """Remove a bus; tracks grouped to it fall back to the master and
        sends to it are dropped; higher bus indices shift down."""
        bus = self.buses.pop(index)
        for t in self.tracks:
            if t.output_bus is not None:
                if t.output_bus == index:
                    t.output_bus = None
                elif t.output_bus > index:
                    t.output_bus -= 1
            kept = []
            for s in t.sends:
                if s.bus == index:
                    continue
                if s.bus > index:
                    s.bus -= 1
                kept.append(s)
            t.sends = kept
        return bus

    def set_track_output(self, track_slot: int, bus: int | None) -> None:
        """Route a track's finished signal to a bus (group) or the master."""
        if bus is not None and not (0 <= bus < len(self.buses)):
            raise IndexError(f"bus {bus} out of range ({len(self.buses)} buses)")
        self.tracks[track_slot].output_bus = bus

    def add_send(self, track_slot: int, bus: int, gain_db: float = 0.0,
                 pre_fader: bool = False, sidechain: bool = False):
        """Add an aux send from a track to a bus. Returns the Send.

        ``sidechain=True`` feeds the bus's KEY input (the detector of
        sidechain-flagged dynamics on the bus chain) instead of its audio.
        """
        from whitebox_tpu_torch.session.bus import Send

        if not (0 <= bus < len(self.buses)):
            raise IndexError(f"bus {bus} out of range ({len(self.buses)} buses)")
        send = Send(bus=bus, gain_db=gain_db, pre_fader=pre_fader, sidechain=sidechain)
        self.tracks[track_slot].sends.append(send)
        return send

    def remove_send(self, track_slot: int, send_index: int):
        return self.tracks[track_slot].sends.pop(send_index)

    # ---- track freeze / bounce-in-place (extension; no upstream equiv) ----

    def freeze_track(self, slot: int, sample_rate: float = 48000.0, *,
                     buffer_size: int = 512, engine: str = "auto", device=None) -> None:
        """Bounce-in-place: render the track's clips through its effect
        chain (and effect-param lanes) into a new sample asset, swap the
        clips for one speed-1 audio clip of that render, and clear the
        baked chain/lanes. The fader (volume/pan/mute), fader automation,
        sends, and bus routing stay LIVE — exactly what freezing means in
        a production mixer. ``unfreeze_track`` restores the original state.

        The capture point is post-chain / pre-fader: the temp render runs
        the track at volume 0 dB, pan center (exactly unity under the
        -3 dB constant-power law's sqrt(2) normalization), no master bus.
        """
        from dataclasses import replace as _replace

        import numpy as np

        from whitebox_tpu_torch.core.formats import AudioFormat
        from whitebox_tpu_torch.render.bounce import bounce
        from whitebox_tpu_torch.session.sample import Sample

        track = self.tracks[slot]
        if track.frozen is not None:
            raise ValueError(f"track {slot} is already frozen")
        if not track.clips:
            raise ValueError(f"track {slot} has no clips to freeze")

        eff_lanes = dict(track.automation.effects) if (
            track.automation is not None and track.automation.effects) else {}

        tmp = Session(bpm=self.bpm)
        tmp.tempo_map = self.tempo_map  # frozen render must use the same timeline
        tmp.sample_table = self.sample_table
        tmp.midi_table = self.midi_table
        rt = _replace(track, volume_db=0.0, pan=0.0, mute=False, solo=False,
                      output_bus=None, sends=[], frozen=None,
                      clips=[c.clone() for c in track.clips])
        if eff_lanes:
            from whitebox_tpu_torch.ops.automation import TrackAutomation

            rt.automation = TrackAutomation(effects=dict(eff_lanes))
        else:
            rt.automation = None
        tmp.tracks = [rt]
        # the chain and its lanes through the port's bounce, on ``device``
        res = bounce(tmp, sample_rate, buffer_size=buffer_size, engine=engine, device=device)

        asset = self.sample_table.add_sample(
            Sample.from_planar(np.ascontiguousarray(res.audio), int(sample_rate),
                               AudioFormat.F32, name=f"{track.name} (frozen)"),
            key=f"frozen:{track.name}:{slot}:{id(res.audio)}",
        )
        track.frozen = {
            "clips": track.clips,
            "effects": track.effects,
            "eff_lanes": eff_lanes,
            "asset_key": asset.key,
        }
        end_beats = max(c.max_time for c in track.clips)
        track.clips = []
        # +1 beat of margin: playback simply stops at the sample's end, and
        # the margin keeps beat->sample rounding from shaving the last frame
        self.add_audio_clip(track, f"{track.name} (frozen)", 0.0,
                            end_beats + 1.0, asset=asset)
        track.effects = []
        if track.automation is not None:
            track.automation.effects = {}

    def unfreeze_track(self, slot: int) -> None:
        """Restore the pre-freeze clips, chain, and effect lanes."""
        track = self.tracks[slot]
        if track.frozen is None:
            raise ValueError(f"track {slot} is not frozen")
        st = track.frozen
        render_asset = (track.clips[0].audio.asset
                        if track.clips and track.clips[0].is_audio() else None)
        track.clips = st["clips"]
        track.effects = st["effects"]
        if st["eff_lanes"]:
            from whitebox_tpu_torch.ops.automation import TrackAutomation

            if track.automation is None:
                track.automation = TrackAutomation()
            track.automation.effects = dict(st["eff_lanes"])
        track.frozen = None
        # drop the now-unreferenced frozen render so repeated freeze cycles
        # don't accumulate multi-MB orphans (and sidecar WAVs on save);
        # the render asset is read off the frozen clip so this also works
        # after a .wb reload (where the stash's asset_key is not persisted)
        if render_asset is not None:
            self.sample_table._evict(render_asset.key)

    # ---- clip time-stretch (extension; the reference only resamples,
    #      sampler.cpp:34-59 — duration and pitch always move together) ----

    def stretch_clip(self, track_slot: int, clip_index: int, ratio: float, *,
                     preserve_pitch: bool = True, device=None) -> None:
        """Stretch an audio clip's duration by ``ratio``.

        ``preserve_pitch=True`` renders the source through the phase
        vocoder (ops/stretch.py, on ``device``: default the CUDA card) into
        a new sample asset — duration scales, pitch stays.
        ``preserve_pitch=False`` is the classic resample move: the clip's
        playback speed drops by ``ratio`` (pitch follows), no new audio.
        Either way the clip's span scales in place, trimming neighbors it
        now overlaps (reserve_track_region semantics).
        """
        import numpy as np

        track = self.tracks[track_slot]
        clip = track.clips[clip_index]
        if not clip.is_audio() or clip.audio.asset is None:
            raise ValueError("stretch_clip needs an audio clip")
        ratio = float(ratio)
        if ratio <= 0:
            raise ValueError("ratio must be positive")

        length = clip.max_time - clip.min_time
        if preserve_pitch:
            from whitebox_tpu_torch.core.formats import AudioFormat, normalize_unclamped
            from whitebox_tpu_torch.ops.stretch import time_stretch
            from whitebox_tpu_torch.session.sample import Sample

            src = clip.audio.asset.sample
            f32 = np.asarray(normalize_unclamped(np.stack(src.data), src.format),
                             np.float32)
            stretched = time_stretch(f32, ratio, device=device)
            asset = self.sample_table.add_sample(
                Sample.from_planar(stretched, int(src.sample_rate), AudioFormat.F32,
                                   name=f"{src.name or clip.name} (x{ratio:g})"),
                key=f"stretch:{clip.name}:{id(stretched)}",
            )
            clip.audio.asset = asset
            clip.start_offset = clip.start_offset * ratio
        else:
            clip.audio.speed = clip.audio.speed / ratio
            clip.start_offset = clip.start_offset * ratio
        # fades keep their relative musical position within the clip
        clip.audio.fade_start *= ratio
        clip.audio.fade_end *= ratio
        # re-reserve the (possibly longer) span, trimming overlapped clips
        track.clips.pop(clip_index)
        clip.max_time = clip.min_time + length * ratio
        self._add_to_cliplist(track, clip)

    # ---- clip CRUD (engine.cpp:293-569) ----

    def add_audio_clip(
        self,
        track: Track,
        name: str,
        min_time: float,
        max_time: float,
        start_offset: float = 0.0,
        *,
        asset: SampleAsset,
        gain: float = 1.0,
        speed: float = 1.0,
        fade_start: float = 0.0,
        fade_end: float = 0.0,
        active: bool = True,
    ) -> TrackEditResult:
        clip = Clip(
            type=ClipType.AUDIO,
            name=name,
            color=track.color,
            min_time=min_time,
            max_time=max_time,
            start_offset=start_offset,
            active=active,
            audio=AudioClipData(asset=asset, gain=gain, speed=speed, fade_start=fade_start, fade_end=fade_end),
        )
        return self._add_to_cliplist(track, clip)

    def add_midi_clip(
        self,
        track: Track,
        name: str,
        min_time: float,
        max_time: float,
        start_offset: float = 0.0,
        *,
        asset,
        transpose: int = 0,
        rate: int = 1,
        active: bool = True,
    ) -> TrackEditResult:
        clip = Clip(
            type=ClipType.MIDI,
            name=name,
            color=track.color,
            min_time=min_time,
            max_time=max_time,
            start_offset=start_offset,
            active=active,
            midi=MidiClipData(asset=asset, length=max_time - min_time, transpose=transpose, rate=rate),
        )
        return self._add_to_cliplist(track, clip)

    def clip_length_beats(self, num_samples: float, sample_rate: float, at_beat: float = 0.0) -> float:
        """Beat span covered by ``num_samples`` source frames placed at
        ``at_beat``. Unmapped: the reference's samples_to_beat. Mapped: the
        exact tempo-map inversion (so the clip's [min,max) frame span equals
        the sample length wherever it sits on the timeline)."""
        if self.tempo_map is not None:
            t0 = float(self.tempo_map.beats_to_seconds(at_beat))
            return float(self.tempo_map.seconds_to_beats(t0 + num_samples / float(sample_rate))) - at_beat
        return samples_to_beat(num_samples, float(sample_rate), self.beat_duration)

    def add_clip_from_file(self, track: Track, path, time_pos: float) -> TrackEditResult:
        """engine.cpp:265 add_clip_from_file — length snapped to PPQ grid."""
        asset = self.sample_table.load_from_file(path)
        sample_rate = float(asset.sample.sample_rate)
        clip_length = self.clip_length_beats(asset.sample.count, sample_rate, time_pos)
        max_time = time_pos + float(uround(clip_length * self.ppq)) / self.ppq
        from pathlib import Path

        return self.add_audio_clip(track, Path(str(path)).name, time_pos, max_time, 0.0, asset=asset, gain=1.0)

    def move_clip(self, track: Track, clip: Clip, relative_pos: float) -> TrackEditResult:
        """engine.cpp:346 — move with overlap trim."""
        if relative_pos == 0.0:
            return TrackEditResult()
        r = calc_move_clip(clip, relative_pos)
        q = track.query_clip_by_range(r.min, r.max)
        result = (
            self._reserve_track_region(track, q.first, q.last, r.min, r.max, ignore_clip=clip)
            if q
            else TrackEditResult()
        )
        result.deleted_clips.append(clip.clone())
        clip.min_time = r.min
        clip.max_time = r.max
        clip.internal_state_changed = True
        track.update_clip_ordering()
        result.added_clips.append(clip)
        return result

    def resize_clip(
        self,
        track: Track,
        clip: Clip,
        relative_pos: float,
        resize_limit: float,
        min_length: float,
        left_side: bool,
        shift: bool = False,
        stretch: bool = False,
    ) -> TrackEditResult:
        """engine.cpp:365 — edge resize with shift/stretch semantics."""
        if relative_pos == 0.0:
            return TrackEditResult()
        r = calc_resize_clip(
            clip, relative_pos, resize_limit, min_length, clip.min_time,
            self.beat_duration_at(clip.min_time), left_side, shift, stretch
        )
        q = track.query_clip_by_range(r.min, r.max)
        result = (
            self._reserve_track_region(track, q.first, q.last, r.min, r.max, ignore_clip=clip)
            if q
            else TrackEditResult()
        )
        result.deleted_clips.append(clip.clone())
        if left_side:
            clip.min_time = r.min
        else:
            clip.max_time = r.max
        clip.start_offset = r.start_offset
        if clip.is_audio() and stretch:
            clip.audio.speed = r.speed
        clip.internal_state_changed = shift or stretch
        track.update_clip_ordering()
        result.added_clips.append(clip)
        return result

    def delete_clip(self, track: Track, clip: Clip) -> TrackEditResult:
        result = TrackEditResult(deleted_clips=[clip.clone()])
        clip.deleted = True
        track.update_clip_ordering()
        return result

    def delete_region(self, track: Track, tmin: float, tmax: float) -> TrackEditResult:
        """engine.cpp:1042 delete_region (single-track form)."""
        q = track.query_clip_by_range(tmin, tmax)
        if not q:
            return TrackEditResult()
        result = self._reserve_track_region(track, q.first, q.last, tmin, tmax, ignore_clip=None)
        track.update_clip_ordering()
        return result

    def _add_to_cliplist(self, track: Track, clip: Clip) -> TrackEditResult:
        """engine.cpp:409 add_to_cliplist — trims/splits overlapped clips."""
        clips = track.clips
        result = TrackEditResult(added_clips=[clip])

        if not clips:
            clip.id = 0
            clips.append(clip)
            return result
        if clips[-1].max_time < clip.min_time:
            clip.id = clips[-1].id + 1
            clips.append(clip)
            return result
        if clips[0].min_time > clip.max_time:
            clips.insert(0, clip)
            for i, c in enumerate(clips):
                c.id = i
            return result

        q = track.query_clip_by_range(clip.min_time, clip.max_time)
        if not q:
            clips.append(clip)
            track.update_clip_ordering()
            return result

        trim = self._reserve_track_region(track, q.first, q.last, clip.min_time, clip.max_time, ignore_clip=None)
        trim.added_clips.append(clip)
        clips.append(clip)
        track.update_clip_ordering()
        return trim

    def _reserve_track_region(
        self,
        track: Track,
        first_clip: int,
        last_clip: int,
        rmin: float,
        rmax: float,
        ignore_clip: Clip | None,
    ) -> TrackEditResult:
        """engine.cpp:478-569 — clear [rmin, rmax]: trim edges, split, delete."""
        clips = track.clips
        if not clips:
            return TrackEditResult()

        result = TrackEditResult()

        if first_clip == last_clip:
            clip = clips[first_clip]
            if clip is ignore_clip:
                return TrackEditResult()
            result.deleted_clips.append(clip.clone())
            if rmin > clip.min_time and rmax < clip.max_time:
                # split into two
                new_clip = clip.clone()
                new_clip.min_time = rmax
                new_clip.start_offset = shift_clip_content(
                    new_clip, clip.min_time - rmax, self.time_base, old_beat=clip.min_time)
                result.modified_clips.append(new_clip)
                clip.max_time = rmin
                clips.append(new_clip)
            elif rmin > clip.min_time:
                clip.max_time = rmin
            elif rmax < clip.max_time:
                clip.start_offset = shift_clip_content(clip, clip.min_time - rmax,
                                                       self.time_base, old_beat=clip.min_time)
                clip.min_time = rmax
            else:
                clip.deleted = True
                return TrackEditResult(deleted_clips=result.deleted_clips)
            result.modified_clips.append(clip)
            return result

        first = clips[first_clip]
        last = clips[last_clip]

        if first is not ignore_clip and rmin > first.min_time:
            result.deleted_clips.append(first.clone())
            result.modified_clips.append(first)
            first.max_time = rmin
            first_clip += 1

        if last is not ignore_clip and rmax < last.max_time:
            result.deleted_clips.append(last.clone())
            result.modified_clips.append(last)
            last.start_offset = shift_clip_content(last, last.min_time - rmax,
                                                   self.time_base, old_beat=last.min_time)
            last.min_time = rmax
            last_clip -= 1

        for i in range(first_clip, last_clip + 1):
            if clips[i] is not ignore_clip:
                result.deleted_clips.append(clips[i].clone())
                clips[i].deleted = True

        return result

    # ---- multi-track region ops (engine.cpp:600 move_or_duplicate_region,
    #      :877 resize_clips, :953 shift_clips, :1042 delete_region) ----

    def _extract_region(self, track: Track, rmin: float, rmax: float) -> list[Clip]:
        """Clones of the clips intersecting [rmin, rmax], trimmed to the
        region with content shifts (the reference's substitute-clip logic)."""
        out = []
        for clip in track.clips:
            if clip.max_time <= rmin or clip.min_time >= rmax:
                continue
            c = clip.clone()
            if c.min_time < rmin:
                c.start_offset = shift_clip_content(c, c.min_time - rmin,
                                                    self.time_base, old_beat=c.min_time)
                c.min_time = rmin
            if c.max_time > rmax:
                c.max_time = rmax
            out.append(c)
        return out

    def move_or_duplicate_region(
        self,
        first_track: int,
        num_tracks: int,
        min_pos: float,
        max_pos: float,
        dst_track_offset: int = 0,
        dst_time_offset: float = 0.0,
        duplicate: bool = False,
    ) -> None:
        """Move (or copy) every clip region across a block of tracks."""
        if dst_track_offset == 0 and dst_time_offset == 0.0 and not duplicate:
            return
        dst_first = max(0, min(first_track + dst_track_offset, len(self.tracks) - num_tracks))
        extracted = [
            self._extract_region(self.tracks[first_track + i], min_pos, max_pos)
            for i in range(num_tracks)
        ]
        if not duplicate:
            for i in range(num_tracks):
                self.delete_region(self.tracks[first_track + i], min_pos, max_pos)
        for i, clones in enumerate(extracted):
            dst = self.tracks[dst_first + i]
            for c in clones:
                c.min_time += dst_time_offset
                c.max_time += dst_time_offset
                if c.min_time < 0.0:
                    shift = -c.min_time
                    c.start_offset = shift_clip_content(c, -shift, self.time_base,
                                                        old_beat=c.min_time)
                    c.min_time = 0.0
                self._add_to_cliplist(dst, c)

    def shift_clips(self, track: Track, tmin: float, tmax: float, relative_pos: float) -> None:
        """engine.cpp:953 — shift the *content* of clips in a region."""
        for clip in track.clips:
            if clip.max_time <= tmin or clip.min_time >= tmax:
                continue
            clip.start_offset = shift_clip_content(clip, relative_pos,
                                                   self.time_base, old_beat=clip.min_time)
            clip.internal_state_changed = True

    def resize_clips(self, specs: list, relative_pos: float, resize_limit: float = 0.0,
                     min_length: float = 1.0 / 96.0, left_side: bool = False, shift: bool = False) -> None:
        """engine.cpp:877 — resize one clip per track; specs = [(track_idx, clip_id), ...]."""
        for track_idx, clip_id in specs:
            track = self.tracks[track_idx]
            self.resize_clip(track, track.clips[clip_id], relative_pos, resize_limit,
                             min_length, left_side, shift)

    # ---- MIDI note editing (engine.cpp:1103-1463) ----

    @staticmethod
    def _midi_notes(clip: Clip):
        """get_midi_clip_ null-check: the note buffer, or None for non-MIDI."""
        if not clip.is_midi() or clip.midi is None or clip.midi.asset is None:
            return None
        return clip.midi.asset.notes

    def add_note(self, track: Track, clip: Clip, min_time: float, max_time: float,
                 velocity: float, key: int, channel: int = 0):
        """engine.cpp:1103 Engine::add_note."""
        from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        buf.notes.append(MidiNote(min_time=min_time, max_time=max_time, key=key,
                                  flags=MidiNoteFlags.MODIFIED, velocity=velocity))
        return MidiEditResult(modified_notes=buf.update_channel(channel))

    def add_notes(self, track: Track, clip: Clip, notes: list, channel: int = 0):
        """engine.cpp:1134 Engine::add_note (bulk; MidiPaintNotesCmd)."""
        buf = self._midi_notes(clip)
        if buf is None:
            return None
        buf.notes.extend(notes)
        return MidiEditResult(modified_notes=buf.update_channel(channel))

    def move_note(self, track: Track, clip: Clip, note_id: int,
                  relative_key_pos: int, relative_pos: float):
        """engine.cpp:1150 — deleted_notes carries the pre-move backup."""
        from dataclasses import replace

        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        note = buf.notes[note_id]
        backup = replace(note)
        note.min_time += relative_pos
        note.max_time += relative_pos
        note.key = int(note.key) + int(relative_key_pos)
        note.flags |= MidiNoteFlags.MODIFIED
        return MidiEditResult(modified_notes=buf.update_channel(0), deleted_notes=[backup])

    def move_selected_note(self, track: Track, clip: Clip,
                           relative_key_pos: int, relative_pos: float):
        """engine.cpp:1171 — move every SELECTED note."""
        from dataclasses import replace

        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        backup = []
        for note in buf.notes:
            if note.flags & MidiNoteFlags.SELECTED:
                backup.append(replace(note))
                note.min_time += relative_pos
                note.max_time += relative_pos
                note.key = int(note.key) + int(relative_key_pos)
                note.flags |= MidiNoteFlags.MODIFIED
        return MidiEditResult(modified_notes=buf.update_channel(0), deleted_notes=backup)

    def resize_note(self, track: Track, clip: Clip, note_id: int,
                    relative_pos: float, left_side: bool):
        """engine.cpp:1196 — grow/shrink one edge."""
        from dataclasses import replace

        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        note = buf.notes[note_id]
        backup = replace(note)
        if left_side:
            note.min_time += relative_pos
        else:
            note.max_time += relative_pos
        note.flags |= MidiNoteFlags.MODIFIED
        return MidiEditResult(modified_notes=buf.update_channel(0), deleted_notes=[backup])

    def resize_selected_note(self, track: Track, clip: Clip,
                             relative_pos: float, left_side: bool):
        """engine.cpp:1219 — resize every SELECTED note on one side."""
        from dataclasses import replace

        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        backup = []
        for note in buf.notes:
            if note.flags & MidiNoteFlags.SELECTED:
                backup.append(replace(note))
                if left_side:
                    note.min_time += relative_pos
                else:
                    note.max_time += relative_pos
                note.flags |= MidiNoteFlags.MODIFIED
        return MidiEditResult(modified_notes=buf.update_channel(0), deleted_notes=backup)

    def slice_note(self, track: Track, clip: Clip, slice_pos: float,
                   velocity: float, note_key: int, channel: int = 0):
        """engine.cpp:1252 — split the note under (slice_pos, key) in two.

        The second half keeps the original note's velocity (the ``velocity``
        parameter is accepted but unused, exactly as upstream)."""
        from dataclasses import replace

        from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        seq_id = buf.find_note(slice_pos, note_key, channel)
        if seq_id is None:
            return None
        note = buf.notes[seq_id]
        if not (note.min_time < slice_pos < note.max_time):
            return None
        backup = replace(note)
        tmp_velocity = note.velocity
        tmp_max_time = note.max_time
        note.max_time = slice_pos
        note.flags |= MidiNoteFlags.MODIFIED
        buf.notes.append(MidiNote(min_time=slice_pos, max_time=tmp_max_time, key=note_key,
                                  flags=MidiNoteFlags.MODIFIED, velocity=tmp_velocity))
        return MidiEditResult(modified_notes=buf.update_channel(channel), deleted_notes=[backup])

    def mute_selected_note(self, track: Track, clip: Clip, should_mute: bool) -> list[int]:
        """engine.cpp:1300 — (un)mute SELECTED notes, returning affected ids."""
        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return []
        note_ids = []
        if should_mute:
            for note_id, note in enumerate(buf.notes):
                if not (note.flags & MidiNoteFlags.MUTED) and (note.flags & MidiNoteFlags.SELECTED):
                    note.flags |= MidiNoteFlags.MUTED
                    note_ids.append(note_id)
        else:
            for note_id, note in enumerate(buf.notes):
                if (note.flags & MidiNoteFlags.MUTED) and (note.flags & MidiNoteFlags.SELECTED):
                    note.flags &= ~MidiNoteFlags.MUTED
                    note_ids.append(note_id)
        return note_ids

    def delete_marked_notes(self, track: Track, clip: Clip, delete_selected: bool):
        """engine.cpp:1333 — drop notes flagged SELECTED (or DELETED); the
        DELETED flag is cleared on the backup copies, as upstream."""
        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        flag = MidiNoteFlags.SELECTED if delete_selected else MidiNoteFlags.DELETED
        backup, kept = [], []
        for note in buf.notes:
            if note.flags & flag:
                if not delete_selected:
                    note.flags &= ~flag
                backup.append(note)
            else:
                kept.append(note)
        buf.notes = kept
        return MidiEditResult(modified_notes=buf.update_channel(0), deleted_notes=backup)

    def select_note(self, track: Track, clip: Clip, min_pos: float, max_pos: float,
                    min_key: int, max_key: int):
        """engine.cpp:1370 — exclusive box select: previous selection is
        dropped (ids reported in ``deselected``), notes overlapping the
        time/key box become the new selection."""
        from whitebox_tpu_torch.midi.notes import MAX_KEYS, MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        result = NoteSelectResult(min_key=MAX_KEYS, max_key=0)
        for note_id, note in enumerate(buf.notes):
            if note.flags & MidiNoteFlags.SELECTED:
                result.deselected.append(note_id)
            flags = note.flags & ~MidiNoteFlags.SELECTED
            if note.min_time <= max_pos and note.max_time >= min_pos and min_key <= note.key <= max_key:
                note.flags = flags | MidiNoteFlags.SELECTED
                result.selected.append(note_id)
                result.min_key = min(result.min_key, note.key)
                result.max_key = max(result.max_key, note.key)
            else:
                note.flags = flags
        buf.num_selected = len(result.selected)
        return result

    def select_or_deselect_notes(self, track: Track, clip: Clip, should_select: bool = True):
        """engine.cpp:1404 — select or clear ALL notes. Changed ids land in
        ``deselected`` in both directions (upstream quirk, kept)."""
        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return None
        result = NoteSelectResult()
        if should_select:
            for note_id, note in enumerate(buf.notes):
                if not (note.flags & MidiNoteFlags.SELECTED):
                    result.deselected.append(note_id)
                    note.flags = MidiNoteFlags.SELECTED
                    buf.num_selected += 1
        else:
            for note_id, note in enumerate(buf.notes):
                if note.flags & MidiNoteFlags.SELECTED:
                    result.deselected.append(note_id)
                    note.flags &= ~MidiNoteFlags.SELECTED
                    buf.num_selected -= 1
        return result

    def append_note_selection(self, track: Track, clip: Clip, should_select: bool,
                              note_ids: list[int]) -> None:
        """engine.cpp:1437 — toggle selection of the given ids (the
        ``should_select`` parameter is unused upstream; kept for parity)."""
        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return
        for note_id in note_ids:
            note = buf.notes[note_id]
            if note.flags & MidiNoteFlags.SELECTED:
                note.flags &= ~MidiNoteFlags.SELECTED
                buf.num_selected -= 1
            else:
                note.flags |= MidiNoteFlags.SELECTED
                buf.num_selected += 1

    def change_note_velocity(self, track: Track, clip: Clip, note_id: int,
                             relative_velocity: float) -> float | None:
        """command.cpp:691 MidiChangeNoteVelocityCmd — returns the old value."""
        buf = self._midi_notes(clip)
        if buf is None:
            return None
        old = buf.notes[note_id].velocity
        buf.notes[note_id].velocity = old + relative_velocity
        return old

    def change_selected_note_velocity(self, track: Track, clip: Clip,
                                      relative_velocity: float) -> list[tuple[int, float]]:
        """command.cpp:713 — bump velocity of SELECTED notes; returns
        (id, old_velocity) pairs for undo."""
        from whitebox_tpu_torch.midi.notes import MidiNoteFlags

        buf = self._midi_notes(clip)
        if buf is None:
            return []
        old = []
        for note_id, note in enumerate(buf.notes):
            if note.flags & MidiNoteFlags.SELECTED:
                old.append((note_id, note.velocity))
                note.velocity += relative_velocity
        return old

    # ---- recording ingestion (Engine::stop_record flow, engine.cpp:107-140:
    #      recorded audio becomes a registered Sample + a clip at the record
    #      region; here takes arrive as arrays instead of a recorder thread) ----

    def start_recording(self, track: Track, sample_rate: float,
                        at_beat: float | None = None, channels: int = 2,
                        name: str = ""):
        """Begin a streaming take on ``track`` (the record-arm +
        start_record flow, engine.cpp:84-105): returns a
        ``session.record.RecordingTake`` that ingests ``[C, n]`` blocks
        incrementally under the reference's 256 KiB chunked-growth
        contract; ``take.finalize()`` truncates, registers the asset, and
        places the clip at ``at_beat`` (default: the playhead)."""
        from whitebox_tpu_torch.session.record import RecordingTake

        beat = self.playhead_start if at_beat is None else float(at_beat)
        return RecordingTake(self, track, sample_rate, beat,
                             channels=channels, name=name)

    def set_track_input(self, track_index: int, input_type, index: int = 0,
                        armed: bool | None = None) -> None:
        """Assign a recording input to a track (Engine::set_track_input,
        engine.cpp:147-199): ``input_type`` is a
        ``session.input.TrackInputType`` (or its name, e.g. "external_mono"),
        ``index`` the capture-stream index (stereo i -> channels
        [2i, 2i+1], mono i -> channel [i]). ``armed`` optionally flips the
        record-arm flag in the same call."""
        from whitebox_tpu_torch.session.input import TrackInput, TrackInputType

        if isinstance(input_type, str):
            input_type = TrackInputType[input_type.upper()]
        tr = self.tracks[track_index]
        tr.input = (None if input_type == TrackInputType.NONE
                    else TrackInput(TrackInputType(input_type), int(index)))
        if armed is not None:
            tr.armed = bool(armed)

    def arm_track(self, track_index: int, armed: bool = True) -> None:
        """Engine::arm_track_recording (engine.cpp:142-145)."""
        self.tracks[track_index].armed = bool(armed)

    def input_groups(self):
        """Armed tracks grouped by packed input (track_input.h:40-44);
        see session.input.build_input_groups."""
        from whitebox_tpu_torch.session.input import build_input_groups

        return build_input_groups(self)

    def record_armed(self, sample_rate: float, at_beat: float | None = None,
                     name_prefix: str = ""):
        """Begin a multi-track recording pass over every armed track
        (Engine::record, engine.cpp:96-105): returns a
        ``session.input.MultiTrackRecording`` whose ``record_block`` fans
        one [N_capture, n] block out to all armed tracks through their
        input groups; ``finalize()`` places one clip per take."""
        from whitebox_tpu_torch.session.input import MultiTrackRecording

        beat = self.playhead_start if at_beat is None else float(at_beat)
        return MultiTrackRecording(self, sample_rate, beat,
                                   name_prefix=name_prefix)

    def add_recorded_take(self, track: Track, audio, sample_rate: int, at_beat: float, name: str = "") -> "Clip":
        """Register recorded planar f32 audio [C, N] and place it as a clip
        (one-shot convenience over ``start_recording``/RecordingTake)."""
        import numpy as np

        from whitebox_tpu_torch.core.formats import AudioFormat
        from whitebox_tpu_torch.core.math import samples_to_beat
        from whitebox_tpu_torch.session.sample import Sample

        audio = np.atleast_2d(np.asarray(audio, dtype=np.float32))
        name = name or f"take {len(self.sample_table.samples) + 1}"
        sample = Sample.from_planar(audio, int(sample_rate), AudioFormat.F32, name=name)
        asset = self.sample_table.add_sample(sample, key=f"take:{name}:{id(sample)}")
        length = self.clip_length_beats(sample.count, float(sample_rate), at_beat)
        self.add_audio_clip(track, name, at_beat, at_beat + length, 0.0, asset=asset, gain=1.0)
        return track.clips[-1] if track.clips else None

    # ---- introspection ----

    def end_time(self) -> float:
        """Last clip edge across all tracks, in beats."""
        end = 0.0
        for t in self.tracks:
            for c in t.clips:
                end = max(end, c.max_time)
        return end

    def num_clips(self) -> int:
        return sum(len(t.clips) for t in self.tracks)

    def edit_stamp(self) -> int:
        """Cheap structural fingerprint of everything the render depends on
        (clip layout, track params, note-buffer versions, automation and
        effect identities). Live consumers (render.preview.PreviewStream)
        compare stamps to re-carve mid-playback after edits — the offline
        analogue of Track::refresh_voice / internal_state_changed
        (track.cpp:289-345,396-417). Catching *direct field* mutations is
        the point: no edit-API bookkeeping to forget."""
        items: list = [self.bpm, len(self.tracks), len(self.master_effects or []),
                       len(getattr(self, "master_automation", {}) or {})]
        tm = getattr(self, "tempo_map", None)
        if tm is not None:
            items.append(tuple((p.beat, p.bpm, p.curve) for p in tm.points))
        mm = getattr(self, "meter_map", None)
        if mm is not None:
            items.append(tuple((p.bar, p.num, p.den) for p in mm.points))

        def lane_key(lane):
            if lane is None:
                return 0
            return tuple((p.x, p.y, int(p.curve), p.tension) for p in lane.points)

        def auto_key(a):
            return 0 if a is None else (lane_key(a.volume), lane_key(a.pan),
                                        tuple(sorted((k, lane_key(l))
                                                     for k, l in a.effects.items())))

        for b in getattr(self, "buses", []):
            items.append((b.volume_db, b.pan, b.mute,
                          id(b.effects) if b.effects else 0,
                          len(b.effects) if b.effects else 0,
                          auto_key(getattr(b, "automation", None))))
        # the clip loop below is the preview path's per-pull cost at scale
        # (thousands of clips): flat tuple literals + bound locals, no
        # method calls or tuple concatenation in the body
        from whitebox_tpu_torch.session.clip import ClipType

        _AUDIO = ClipType.AUDIO
        _MIDI = ClipType.MIDI
        append = items.append
        for t in self.tracks:
            a = t.automation
            append((t.volume_db, t.pan, t.mute, t.solo, len(t.clips),
                    t.frozen is not None,
                    t.output_bus if t.output_bus is not None else -1,
                    tuple((s.bus, s.gain_db, s.pre_fader, s.sidechain) for s in t.sends),
                    id(t.effects) if t.effects else 0,
                    len(t.effects) if t.effects else 0,
                    auto_key(a)))
            for c in t.clips:
                ctype = c.type
                d = c.audio
                if ctype == _AUDIO and d is not None:
                    append((c.min_time, c.max_time, c.start_offset,
                            not c.active, 0,
                            id(d.asset), d.gain, d.speed, d.fade_start,
                            d.fade_end, int(d.mode)))
                    continue
                d = c.midi
                if ctype == _MIDI and d is not None:
                    append((c.min_time, c.max_time, c.start_offset,
                            not c.active, 1,
                            id(d.asset), d.transpose, d.rate,
                            (getattr(d.asset.notes, "version", 0)
                             if d.asset is not None else 0)))
                    continue
                append((c.min_time, c.max_time, c.start_offset,
                        not c.active, int(ctype)))
        return hash(tuple(items))

    def __repr__(self) -> str:
        return f"Session(bpm={self.bpm}, tracks={len(self.tracks)}, clips={self.num_clips()})"
