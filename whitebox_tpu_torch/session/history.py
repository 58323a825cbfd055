"""Undo/redo command history — replaces src/ui/command{,_manager}.{h,cpp}.

The reference implements 30+ Command subclasses with hand-written
execute/undo pairs over the engine edit API (command.h:22-374) and a
history ring with a project-modified flag. Here commands wrap the Session
edit API and capture track-level clip snapshots (clips are cheap clones;
assets are refcounted handles), which uniformly undoes every clip edit the
API can express — including the reserve_track_region trims/splits that make
hand-written inverses fiddly.

    mgr = CommandManager(session)
    mgr.execute(ClipMove(track_idx=0, clip_id=2, relative_pos=1.5))
    mgr.undo(); mgr.redo()
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.session.track import Track


class Command:
    """One undoable edit. Subclasses implement ``apply``; snapshotting of the
    affected tracks is handled by the manager via ``touched_tracks``."""

    name = "command"

    def touched_tracks(self, session: Session) -> list[int]:
        raise NotImplementedError

    def apply(self, session: Session) -> None:
        raise NotImplementedError


@dataclass
class _TrackSnapshot:
    index: int
    clips: list
    volume_db: float
    pan: float
    mute: bool
    solo: bool
    name: str
    automation: object = None  # deep copy of TrackAutomation (lanes are tiny)
    output_bus: Optional[int] = None
    sends: list = field(default_factory=list)

    @staticmethod
    def capture(session: Session, index: int) -> "_TrackSnapshot":
        import copy
        from dataclasses import replace

        t = session.tracks[index]
        return _TrackSnapshot(
            index=index, clips=[c.clone() for c in t.clips],
            volume_db=t.volume_db, pan=t.pan, mute=t.mute, solo=t.solo, name=t.name,
            automation=copy.deepcopy(t.automation),
            output_bus=t.output_bus, sends=[replace(s) for s in t.sends],
        )

    def restore(self, session: Session) -> None:
        import copy
        from dataclasses import replace

        t = session.tracks[self.index]
        t.clips = [c.clone() for c in self.clips]
        t.volume_db, t.pan, t.mute, t.solo, t.name = (
            self.volume_db, self.pan, self.mute, self.solo, self.name,
        )
        t.automation = copy.deepcopy(self.automation)
        t.output_bus = self.output_bus
        t.sends = [replace(s) for s in self.sends]


# ---- clip commands (command.h: ClipMoveCmd, ClipResizeCmd, ClipDeleteCmd,
#      ClipAddAudioCmd, ClipDuplicateCmd, ClipAdjustGainCmd, ...) ----


@dataclass
class ClipAddAudio(Command):
    name = "add audio clip"
    track_idx: int = 0
    clip_name: str = ""
    min_time: float = 0.0
    max_time: float = 0.0
    start_offset: float = 0.0
    asset: object = None
    gain: float = 1.0
    speed: float = 1.0
    fade_start: float = 0.0
    fade_end: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.add_audio_clip(
            session.tracks[self.track_idx], self.clip_name, self.min_time, self.max_time,
            self.start_offset, asset=self.asset, gain=self.gain, speed=self.speed,
            fade_start=self.fade_start, fade_end=self.fade_end,
        )


@dataclass
class ClipAddMidi(Command):
    name = "add midi clip"
    track_idx: int = 0
    clip_name: str = ""
    min_time: float = 0.0
    max_time: float = 0.0
    start_offset: float = 0.0
    asset: object = None
    transpose: int = 0
    rate: int = 1

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.add_midi_clip(
            session.tracks[self.track_idx], self.clip_name, self.min_time, self.max_time,
            self.start_offset, asset=self.asset, transpose=self.transpose, rate=self.rate,
        )


@dataclass
class ClipMove(Command):
    name = "move clip"
    track_idx: int = 0
    clip_id: int = 0
    relative_pos: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        track = session.tracks[self.track_idx]
        session.move_clip(track, track.clips[self.clip_id], self.relative_pos)


@dataclass
class ClipResize(Command):
    name = "resize clip"
    track_idx: int = 0
    clip_id: int = 0
    relative_pos: float = 0.0
    left_side: bool = False
    shift: bool = False
    stretch: bool = False
    min_length: float = 1.0 / 96.0
    resize_limit: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        track = session.tracks[self.track_idx]
        session.resize_clip(
            track, track.clips[self.clip_id], self.relative_pos, self.resize_limit,
            self.min_length, self.left_side, self.shift, self.stretch,
        )


@dataclass
class ClipDelete(Command):
    name = "delete clip"
    track_idx: int = 0
    clip_id: int = 0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        track = session.tracks[self.track_idx]
        session.delete_clip(track, track.clips[self.clip_id])


@dataclass
class ClipAdjustGain(Command):
    name = "adjust clip gain"
    track_idx: int = 0
    clip_id: int = 0
    gain: float = 1.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.tracks[self.track_idx].clips[self.clip_id].audio.gain = self.gain


@dataclass
class ClipSetFades(Command):
    name = "set clip fades"
    track_idx: int = 0
    clip_id: int = 0
    fade_start: float = 0.0
    fade_end: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        c = session.tracks[self.track_idx].clips[self.clip_id]
        c.audio.fade_start = self.fade_start
        c.audio.fade_end = self.fade_end


@dataclass
class DeleteRegion(Command):
    name = "delete region"
    track_idx: int = 0
    min_time: float = 0.0
    max_time: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.delete_region(session.tracks[self.track_idx], self.min_time, self.max_time)


@dataclass
class ClipAddFromFile(Command):
    """command.h:46 ClipAddFromFileCmd."""

    name = "add clip from file"
    track_idx: int = 0
    path: str = ""
    time_pos: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.add_clip_from_file(session.tracks[self.track_idx], self.path, self.time_pos)


@dataclass
class ClipRename(Command):
    """command.h:57 ClipRenameCmd."""

    name = "rename clip"
    track_idx: int = 0
    clip_id: int = 0
    new_name: str = ""

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.tracks[self.track_idx].clips[self.clip_id].name = self.new_name


@dataclass
class ClipChangeColor(Command):
    """command.h:67 ClipChangeColorCmd."""

    name = "change clip color"
    track_idx: int = 0
    clip_id: int = 0
    color: int = 0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.tracks[self.track_idx].clips[self.clip_id].color = self.color


@dataclass
class ClipShift(Command):
    """command.h:89 ClipShiftCmd — shift one clip's content."""

    name = "shift clip"
    track_idx: int = 0
    clip_id: int = 0
    relative_pos: float = 0.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        from whitebox_tpu_torch.session.clip import shift_clip_content

        clip = session.tracks[self.track_idx].clips[self.clip_id]
        clip.start_offset = shift_clip_content(clip, self.relative_pos,
                                               session.time_base, old_beat=clip.min_time)
        clip.internal_state_changed = True


@dataclass
class ClipDuplicate(Command):
    """command.h:114 ClipDuplicateCmd — copy a clip to (dst track, +offset)."""

    name = "duplicate clip"
    src_track_idx: int = 0
    dst_track_idx: int = 0
    clip_id: int = 0
    relative_pos: float = 0.0

    def touched_tracks(self, session):
        return sorted({self.src_track_idx, self.dst_track_idx})

    def apply(self, session):
        clip = session.tracks[self.src_track_idx].clips[self.clip_id].clone()
        clip.min_time += self.relative_pos
        clip.max_time += self.relative_pos
        session._add_to_cliplist(session.tracks[self.dst_track_idx], clip)


@dataclass
class MidiClipParamChange(Command):
    """command.h:223 MidiClipParamChangeCmd — transpose / rate."""

    name = "change midi clip params"
    track_idx: int = 0
    clip_id: int = 0
    transpose: Optional[int] = None
    rate: Optional[int] = None

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        clip = session.tracks[self.track_idx].clips[self.clip_id]
        if self.transpose is not None:
            clip.midi.transpose = self.transpose
        if self.rate is not None:
            clip.midi.rate = self.rate


# ---- track structural commands (command.h:30 TrackAddCmd, :38 TrackMoveCmd;
#      delete is an extension — the reference GUI deletes tracks without an
#      undoable command). These return None from touched_tracks: the manager
#      snapshots the whole track list since indices shift. ----


@dataclass
class TrackAdd(Command):
    name = "add track"
    track_name: str = ""
    volume_db: float = 0.0
    pan: float = 0.0
    color: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        t = session.add_track(self.track_name, volume_db=self.volume_db, pan=self.pan)
        t.color = self.color


@dataclass
class TrackDelete(Command):
    name = "delete track"
    track_idx: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.delete_track(self.track_idx)


@dataclass
class TrackMove(Command):
    name = "move track"
    from_slot: int = 0
    to_slot: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.move_track(self.from_slot, self.to_slot)


# ---- track parameter commands (TrackParameterChangedCmd etc.) ----


@dataclass
class TrackSetParam(Command):
    name = "set track parameter"
    track_idx: int = 0
    volume_db: Optional[float] = None
    pan: Optional[float] = None
    mute: Optional[bool] = None

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        t = session.tracks[self.track_idx]
        if self.volume_db is not None:
            t.volume_db = self.volume_db
        if self.pan is not None:
            t.pan = self.pan
        if self.mute is not None:
            t.mute = self.mute


@dataclass
class SetEffectAutomation(Command):
    """Set or clear one timed effect-param lane on a track's chain — the
    undoable edit over the param_changes.h-analogue automation surface
    (ops.automation.TrackAutomation.effects)."""

    name = "set effect automation"
    track_idx: int = 0
    slot: int = 0
    param: str = ""
    #: [(x_beats, y, curve, tension), ...], or None to clear the lane
    points: Optional[list] = None

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        from whitebox_tpu_torch.ops.automation import (
            AutomationLane, CurveType, EnvelopePoint, TrackAutomation,
        )

        t = session.tracks[self.track_idx]
        key = (self.slot, self.param)
        if self.points is None:
            if t.automation is not None:
                t.automation.effects.pop(key, None)
            return
        if t.automation is None:
            t.automation = TrackAutomation()
        t.automation.effects[key] = AutomationLane([
            EnvelopePoint(float(x), float(y), CurveType(int(c)), float(tn))
            for (x, y, c, tn) in self.points
        ])


# ---- bus / routing commands (extension; session/bus.py) ----


@dataclass
class BusAdd(Command):
    name = "add bus"
    bus_name: str = ""
    volume_db: float = 0.0
    pan: float = 0.0

    def touched_tracks(self, session):
        return None  # structural: bus list + track routing snapshots

    def apply(self, session):
        session.add_bus(self.bus_name, volume_db=self.volume_db, pan=self.pan)


@dataclass
class BusDelete(Command):
    name = "delete bus"
    bus_idx: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.delete_bus(self.bus_idx)


@dataclass
class BusSetParam(Command):
    name = "set bus parameter"
    bus_idx: int = 0
    volume_db: Optional[float] = None
    pan: Optional[float] = None
    mute: Optional[bool] = None

    def touched_tracks(self, session):
        return None  # bus state lives in the session snapshot

    def apply(self, session):
        b = session.buses[self.bus_idx]
        if self.volume_db is not None:
            b.volume_db = self.volume_db
        if self.pan is not None:
            b.pan = self.pan
        if self.mute is not None:
            b.mute = self.mute


@dataclass
class TrackSetOutputBus(Command):
    name = "route track output"
    track_idx: int = 0
    bus: Optional[int] = None  # None = master

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.set_track_output(self.track_idx, self.bus)


@dataclass
class SendAdd(Command):
    name = "add send"
    track_idx: int = 0
    bus: int = 0
    gain_db: float = 0.0
    pre_fader: bool = False
    sidechain: bool = False

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.add_send(self.track_idx, self.bus, self.gain_db, self.pre_fader,
                         self.sidechain)


@dataclass
class SendRemove(Command):
    name = "remove send"
    track_idx: int = 0
    send_idx: int = 0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.remove_send(self.track_idx, self.send_idx)


@dataclass
class SetBusAutomation(Command):
    """Set or clear a bus fader lane ("volume"/"pan") or a bus-chain
    effect-param lane ((slot, param)) — SetEffectAutomation's bus twin."""

    name = "set bus automation"
    bus_idx: int = 0
    target: object = "volume"  # "volume" | "pan" | (slot, param)
    points: Optional[list] = None  # [(x, y, curve, tension), ...] or None

    def touched_tracks(self, session):
        return None  # bus state lives in the session snapshot

    def apply(self, session):
        from whitebox_tpu_torch.ops.automation import (
            AutomationLane, CurveType, EnvelopePoint, TrackAutomation,
        )

        b = session.buses[self.bus_idx]
        if b.automation is None:
            b.automation = TrackAutomation()
        lane = None
        if self.points is not None:
            lane = AutomationLane([
                EnvelopePoint(float(x), float(y), CurveType(int(c)), float(tn))
                for (x, y, c, tn) in self.points
            ])
        if self.target == "volume":
            b.automation.volume = lane
        elif self.target == "pan":
            b.automation.pan = lane
        else:
            slot, param = self.target
            if lane is None:
                b.automation.effects.pop((int(slot), str(param)), None)
            else:
                b.automation.effects[(int(slot), str(param))] = lane


# ---- tempo commands (extension; core/tempo.py) ----


@dataclass
class SetTempoPoint(Command):
    """Add/replace a tempo point (Session.set_tempo_point). A point at
    beat 0 also moves the session bpm — the snapshot captures both."""

    name = "set tempo point"
    beat: float = 0.0
    bpm: float = 120.0
    curve: str = "step"

    def touched_tracks(self, session):
        return None  # transport state lives in the session snapshot

    def apply(self, session):
        session.set_tempo_point(self.beat, self.bpm, self.curve)


@dataclass
class RemoveTempoPoint(Command):
    name = "remove tempo point"
    beat: float = 0.0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.remove_tempo_point(self.beat)


@dataclass
class SetBpm(Command):
    """Session-wide tempo change (Engine::set_bpm, engine.cpp:24)."""

    name = "set bpm"
    bpm: float = 120.0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.set_bpm(self.bpm)


@dataclass
class SetMeter(Command):
    """Set the time signature from a bar onward (Session.set_meter)."""

    name = "set meter"
    bar: int = 0
    num: int = 4
    den: int = 4

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.set_meter(self.bar, self.num, self.den)


@dataclass
class RemoveMeter(Command):
    name = "remove meter"
    bar: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.remove_meter(self.bar)


# ---- clip time-stretch command (extension; session/session.py) ----


@dataclass
class StretchClip(Command):
    name = "stretch clip"
    track_idx: int = 0
    clip_idx: int = 0
    ratio: float = 1.0
    preserve_pitch: bool = True

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        session.stretch_clip(self.track_idx, self.clip_idx, self.ratio,
                             preserve_pitch=self.preserve_pitch)


# ---- freeze / bounce-in-place commands (extension; session/session.py) ----


@dataclass
class FreezeTrack(Command):
    name = "freeze track"
    track_idx: int = 0
    sample_rate: float = 48000.0

    def touched_tracks(self, session):
        return None  # clips + effects + lanes: needs the session snapshot

    def apply(self, session):
        session.freeze_track(self.track_idx, self.sample_rate)


@dataclass
class UnfreezeTrack(Command):
    name = "unfreeze track"
    track_idx: int = 0

    def touched_tracks(self, session):
        return None

    def apply(self, session):
        session.unfreeze_track(self.track_idx)


# ---- note commands (NoteAddCmd/NoteDeleteCmd/NoteMoveCmd...) operate on a
#      clip's note buffer; snapshots capture the asset's notes too ----


@dataclass
class NoteAdd(Command):
    name = "add note"
    track_idx: int = 0
    clip_id: int = 0
    min_time: float = 0.0
    max_time: float = 0.0
    key: int = 60
    velocity: float = 1.0

    def touched_tracks(self, session):
        return [self.track_idx]

    def apply(self, session):
        from whitebox_tpu_torch.midi.notes import MidiNote

        clip = session.tracks[self.track_idx].clips[self.clip_id]
        clip.midi.asset.notes.add_note(MidiNote(self.min_time, self.max_time, key=self.key, velocity=self.velocity))


@dataclass
class _NoteClipRef:
    """Shared (track_idx, clip_id) head for note commands (MidiCmd base,
    command.h:236)."""

    track_idx: int = 0
    clip_id: int = 0

    def touched_tracks(self, session):
        return [self.track_idx]

    def _clip(self, session):
        return session.tracks[self.track_idx].clips[self.clip_id]


@dataclass
class NotePaint(_NoteClipRef, Command):
    """command.h:258 MidiPaintNotesCmd — bulk note insert."""

    name = "paint notes"
    notes: list = field(default_factory=list)
    channel: int = 0

    def apply(self, session):
        from dataclasses import replace

        t = session.tracks[self.track_idx]
        session.add_notes(t, self._clip(session), [replace(n) for n in self.notes], self.channel)


@dataclass
class NoteMove(_NoteClipRef, Command):
    """command.h:276 MidiMoveNoteCmd (single or selected)."""

    name = "move note"
    note_id: Optional[int] = None  # None = move the selection
    relative_key_pos: int = 0
    relative_pos: float = 0.0

    def apply(self, session):
        t = session.tracks[self.track_idx]
        if self.note_id is None:
            session.move_selected_note(t, self._clip(session), self.relative_key_pos, self.relative_pos)
        else:
            session.move_note(t, self._clip(session), self.note_id, self.relative_key_pos, self.relative_pos)


@dataclass
class NoteResize(_NoteClipRef, Command):
    """command.h:286 MidiResizeNoteCmd (single or selected)."""

    name = "resize note"
    note_id: Optional[int] = None
    relative_pos: float = 0.0
    left_side: bool = False

    def apply(self, session):
        t = session.tracks[self.track_idx]
        if self.note_id is None:
            session.resize_selected_note(t, self._clip(session), self.relative_pos, self.left_side)
        else:
            session.resize_note(t, self._clip(session), self.note_id, self.relative_pos, self.left_side)


@dataclass
class NoteSlice(_NoteClipRef, Command):
    """command.h:266 MidiSliceNoteCmd."""

    name = "slice note"
    slice_pos: float = 0.0
    velocity: float = 1.0
    note_key: int = 60
    channel: int = 0

    def apply(self, session):
        t = session.tracks[self.track_idx]
        session.slice_note(t, self._clip(session), self.slice_pos, self.velocity, self.note_key, self.channel)


@dataclass
class NoteMute(_NoteClipRef, Command):
    """command.h:329 MidiMuteNoteCmd — (un)mute the selection."""

    name = "mute notes"
    should_mute: bool = True

    def apply(self, session):
        session.mute_selected_note(session.tracks[self.track_idx], self._clip(session), self.should_mute)


@dataclass
class NoteDelete(_NoteClipRef, Command):
    """command.h:339 MidiDeleteNoteCmd — delete SELECTED (or DELETED-flagged)."""

    name = "delete notes"
    delete_selected: bool = True

    def apply(self, session):
        session.delete_marked_notes(session.tracks[self.track_idx], self._clip(session), self.delete_selected)


@dataclass
class NoteSelect(_NoteClipRef, Command):
    """command.h:296 MidiSelectNoteCmd — box select."""

    name = "select notes"
    min_pos: float = 0.0
    max_pos: float = 0.0
    min_key: int = 0
    max_key: int = 131

    def apply(self, session):
        session.select_note(session.tracks[self.track_idx], self._clip(session),
                            self.min_pos, self.max_pos, self.min_key, self.max_key)


@dataclass
class NoteSelectOrDeselectAll(_NoteClipRef, Command):
    """command.h:309 MidiSelectOrDeselectNotesCmd."""

    name = "select/deselect all notes"
    should_select: bool = True

    def apply(self, session):
        session.select_or_deselect_notes(session.tracks[self.track_idx], self._clip(session), self.should_select)


@dataclass
class NoteAppendSelection(_NoteClipRef, Command):
    """command.h:319 MidiAppendNoteSelectionCmd — toggle the given ids."""

    name = "append note selection"
    should_select: bool = True
    note_ids: list = field(default_factory=list)

    def apply(self, session):
        session.append_note_selection(session.tracks[self.track_idx], self._clip(session),
                                      self.should_select, list(self.note_ids))


@dataclass
class NoteVelocity(_NoteClipRef, Command):
    """command.h:346/:357 MidiChangeNoteVelocityCmd (single or selected)."""

    name = "change note velocity"
    note_id: Optional[int] = None
    relative_velocity: float = 0.0

    def apply(self, session):
        t = session.tracks[self.track_idx]
        if self.note_id is None:
            session.change_selected_note_velocity(t, self._clip(session), self.relative_velocity)
        else:
            session.change_note_velocity(t, self._clip(session), self.note_id, self.relative_velocity)


@dataclass
class _SessionSnapshot:
    """Whole-track-list snapshot for structural commands (add/delete/move
    track), where per-index snapshots can't survive the index shuffle."""

    tracks: list
    buses: list = field(default_factory=list)
    #: transport state (bpm + tempo/meter maps) — the maps are immutable
    #: (frozen points), so sharing by reference is safe
    bpm: float = 120.0
    tempo_map: object = None
    meter_map: object = None

    @staticmethod
    def _clone_fx(effects):
        """Shallow-copy an effect container, preserving its type (a plain
        list or an EffectChain)."""
        from whitebox_tpu_torch.effects.base import EffectChain

        if isinstance(effects, EffectChain):
            return EffectChain(list(effects.effects))
        return list(effects)

    @staticmethod
    def _clone_track(t: Track) -> Track:
        import copy
        from dataclasses import replace

        frozen = t.frozen
        if frozen is not None:
            # the stash's clips become LIVE objects again on unfreeze, so
            # sharing them by reference would let post-snapshot edits leak
            # into history (and back out through a later unfreeze)
            frozen = {
                "clips": [c.clone() for c in frozen["clips"]],
                "effects": _SessionSnapshot._clone_fx(frozen["effects"]),
                "eff_lanes": copy.deepcopy(frozen["eff_lanes"]),
                "asset_key": frozen["asset_key"],
            }
        return replace(t, clips=[c.clone() for c in t.clips],
                       effects=_SessionSnapshot._clone_fx(t.effects),
                       sends=[replace(s) for s in t.sends], frozen=frozen)

    @staticmethod
    def _clone_bus(b):
        import copy
        from dataclasses import replace

        return replace(b, effects=_SessionSnapshot._clone_fx(b.effects),
                       automation=copy.deepcopy(b.automation))

    @staticmethod
    def capture(session: Session) -> "_SessionSnapshot":
        return _SessionSnapshot(
            tracks=[_SessionSnapshot._clone_track(t) for t in session.tracks],
            buses=[_SessionSnapshot._clone_bus(b) for b in session.buses],
            bpm=session.bpm,
            tempo_map=getattr(session, "tempo_map", None),
            meter_map=getattr(session, "meter_map", None),
        )

    def restore(self, session: Session) -> None:
        from whitebox_tpu_torch.core.math import beat_duration_from_bpm

        session.tracks = [self._clone_track(t) for t in self.tracks]
        session.buses = [self._clone_bus(b) for b in self.buses]
        session.bpm = self.bpm
        session.beat_duration = beat_duration_from_bpm(self.bpm)
        session.tempo_map = self.tempo_map
        session.meter_map = self.meter_map


@dataclass
class _HistoryEntry:
    command: Command
    before: list  # _TrackSnapshot / _SessionSnapshot list
    after: list


class CommandManager:
    """command_manager.cpp equivalent: bounded history + modified flag."""

    def __init__(self, session: Session, max_history: int = 256) -> None:
        self.session = session
        self.max_history = max_history
        self.undo_stack: list[_HistoryEntry] = []
        self.redo_stack: list[_HistoryEntry] = []
        self.is_modified = False

    def execute(self, command: Command) -> None:
        tracks = command.touched_tracks(self.session)
        # MIDI note edits mutate shared assets: snapshot their note lists too.
        # touched_tracks() -> None marks a structural command (track
        # add/delete/move): snapshot the whole track list instead.
        if tracks is None:
            before = [_SessionSnapshot.capture(self.session)]
            note_snaps = self._capture_notes(range(len(self.session.tracks)))
            command.apply(self.session)
            after = [_SessionSnapshot.capture(self.session)]
            notes_after = self._capture_notes(range(len(self.session.tracks)))
        else:
            before = [_TrackSnapshot.capture(self.session, i) for i in tracks]
            note_snaps = self._capture_notes(tracks)
            command.apply(self.session)
            after = [_TrackSnapshot.capture(self.session, i) for i in tracks]
            notes_after = self._capture_notes(tracks)
        entry = _HistoryEntry(command, before, after)
        entry.notes_before = note_snaps
        entry.notes_after = notes_after
        self.undo_stack.append(entry)
        if len(self.undo_stack) > self.max_history:
            self.undo_stack.pop(0)
        self.redo_stack.clear()
        self.is_modified = True

    def _capture_notes(self, tracks):
        snaps = {}
        for i in tracks:
            for c in self.session.tracks[i].clips:
                if c.is_midi() and c.midi is not None and c.midi.asset is not None:
                    from dataclasses import replace

                    snaps[id(c.midi.asset)] = (c.midi.asset, [replace(n) for n in c.midi.asset.notes])
        return snaps

    @staticmethod
    def _restore_notes(snaps):
        from whitebox_tpu_torch.midi.notes import MidiNoteBuffer

        for asset, notes in snaps.values():
            asset.notes = MidiNoteBuffer([n for n in notes])

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        entry = self.undo_stack.pop()
        for snap in entry.before:
            snap.restore(self.session)
        self._restore_notes(entry.notes_before)
        self.redo_stack.append(entry)
        self.is_modified = True
        return True

    def redo(self) -> bool:
        if not self.redo_stack:
            return False
        entry = self.redo_stack.pop()
        for snap in entry.after:
            snap.restore(self.session)
        self._restore_notes(entry.notes_after)
        self.undo_stack.append(entry)
        self.is_modified = True
        return True

    def mark_saved(self) -> None:
        self.is_modified = False

    @property
    def can_undo(self) -> bool:
        return bool(self.undo_stack)

    @property
    def can_redo(self) -> bool:
        return bool(self.redo_stack)
