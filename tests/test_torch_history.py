"""The port's ``session/history.py`` (undo/redo over the edit API) against
the JAX package's (CPU, no rendering).

Each scenario runs the same commands through both packages' ``Session``
and ``CommandManager`` and records the session's state after every step:
the clips' spans and parameters, track and bus parameters, sends, notes,
automation lanes, the tempo and meter maps, and the manager's undo/redo
and modified flags. The records must be equal, and each scenario also
holds the port to the outcome ``tests/test_history.py`` (and the command
cases of ``tests/test_note_edit.py``, ``tests/test_routing.py``,
``tests/test_tempo_session.py`` and ``tests/test_effect_automation.py``)
assert for the JAX package.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("whitebox_tpu", "whitebox_tpu_torch")


def _pkg(name):
    mod = {k: importlib.import_module(f"{name}.{k}") for k in
           ("session", "session.history", "session.sample", "core.formats", "midi.notes", "effects")}
    return SimpleNamespace(Session=mod["session"].Session, h=mod["session.history"],
                           Sample=mod["session.sample"].Sample, AudioFormat=mod["core.formats"].AudioFormat,
                           notes=mod["midi.notes"], fx=mod["effects"])


def _lane(lane):
    return None if lane is None else [(p.x, p.y, int(p.curve), p.tension) for p in lane.points]


def _auto(a):
    return None if a is None else (_lane(a.volume), _lane(a.pan),
                                   sorted((k, _lane(v)) for k, v in a.effects.items()))


def state(s, mgr):
    """Everything a scenario's commands may touch, as plain values."""
    def clip(c):
        d = c.audio if c.audio is not None else None
        m = c.midi.asset.notes if c.midi is not None and c.midi.asset is not None else None
        return (c.name, c.min_time, c.max_time, c.start_offset, c.active, int(c.type), c.color,
                None if d is None else (d.gain, d.speed, d.fade_start, d.fade_end, int(d.mode)),
                None if c.midi is None else (c.midi.transpose, c.midi.rate),
                None if m is None else [(n.min_time, n.max_time, n.key, n.velocity, int(n.flags))
                                        for n in m.notes])

    tm = None if s.tempo_map is None else [(p.beat, p.bpm, p.curve) for p in s.tempo_map.points]
    mm = None if s.meter_map is None else [(p.bar, p.num, p.den) for p in s.meter_map.points]
    return {
        "bpm": s.bpm, "tempo": tm, "meter": mm,
        "tracks": [(t.name, t.volume_db, t.pan, t.mute, t.solo, t.output_bus,
                    [(x.bus, x.gain_db, x.pre_fader, x.sidechain) for x in t.sends],
                    _auto(t.automation), [clip(c) for c in t.clips]) for t in s.tracks],
        "buses": [(b.name, b.volume_db, b.pan, b.mute, _auto(b.automation)) for b in s.buses],
        "mgr": (mgr.can_undo, mgr.can_redo, mgr.is_modified),
    }


def _ctx(m):
    s = m.Session(bpm=120.0)
    data = np.zeros((1, 48000), dtype=np.float32)
    asset = s.sample_table.add_sample(m.Sample.from_planar(data, 48000, m.AudioFormat.F32), key="a")
    s.add_track("t0")
    return s, asset, m.h.CommandManager(s)


def spans(track):
    return [(c.min_time, c.max_time) for c in track.clips]


def sc_add_undo_redo(m, s, asset, mgr, rec):
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="c", min_time=0.0, max_time=4.0, asset=asset))
    rec()
    assert mgr.undo() and spans(s.tracks[0]) == []
    rec()
    assert mgr.redo() and spans(s.tracks[0]) == [(0.0, 4.0)]
    rec()


def sc_move_with_trim(m, s, asset, mgr, rec):
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="a", min_time=0.0, max_time=4.0, asset=asset))
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="b", min_time=6.0, max_time=10.0, asset=asset))
    mgr.execute(m.h.ClipMove(track_idx=0, clip_id=1, relative_pos=-4.0))  # b -> [2,6) trims a
    assert spans(s.tracks[0]) == [(0.0, 2.0), (2.0, 6.0)]
    rec()
    mgr.undo()
    assert spans(s.tracks[0]) == [(0.0, 4.0), (6.0, 10.0)]  # trim fully restored
    rec()
    mgr.redo()
    rec()


def sc_resize_and_delete_region(m, s, asset, mgr, rec):
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="a", min_time=0.0, max_time=8.0, asset=asset))
    mgr.execute(m.h.DeleteRegion(track_idx=0, min_time=3.0, max_time=5.0))
    assert spans(s.tracks[0]) == [(0.0, 3.0), (5.0, 8.0)]
    rec()
    mgr.undo()
    rec()
    mgr.execute(m.h.ClipResize(track_idx=0, clip_id=0, relative_pos=-2.0))
    assert spans(s.tracks[0]) == [(0.0, 6.0)]
    rec()


def sc_param_and_gain(m, s, asset, mgr, rec):
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="a", min_time=0.0, max_time=2.0, asset=asset, gain=1.0))
    mgr.execute(m.h.TrackSetParam(track_idx=0, volume_db=-6.0, pan=0.5))
    mgr.execute(m.h.ClipAdjustGain(track_idx=0, clip_id=0, gain=0.5))
    mgr.execute(m.h.ClipSetFades(track_idx=0, clip_id=0, fade_start=0.25, fade_end=0.5))
    rec()
    mgr.undo()
    mgr.undo()
    assert s.tracks[0].clips[0].audio.gain == 1.0
    rec()
    mgr.undo()
    assert s.tracks[0].volume_db == 0.0 and s.tracks[0].pan == 0.0
    rec()


def sc_redo_cleared_and_modified(m, s, asset, mgr, rec):
    assert not mgr.is_modified
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="a", min_time=0.0, max_time=2.0, asset=asset))
    mgr.mark_saved()
    assert not mgr.is_modified
    rec()
    mgr.undo()
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="b", min_time=4.0, max_time=6.0, asset=asset))
    assert not mgr.can_redo and spans(s.tracks[0]) == [(4.0, 6.0)]
    rec()


def sc_notes(m, s, asset, mgr, rec):
    midi = s.midi_table.create_midi(m.notes.MidiNoteBuffer([]))
    s.add_midi_clip(s.tracks[0], "m", 0.0, 4.0, asset=midi)
    mgr.execute(m.h.NoteAdd(track_idx=0, clip_id=0, min_time=0.0, max_time=1.0, key=64))
    mgr.execute(m.h.NoteAdd(track_idx=0, clip_id=0, min_time=2.0, max_time=3.0, key=60))
    assert len(midi.notes) == 2
    rec()
    mgr.execute(m.h.NoteMove(track_idx=0, clip_id=0, note_id=0, relative_key_pos=2, relative_pos=0.5))
    mgr.execute(m.h.NoteVelocity(track_idx=0, clip_id=0, note_id=1, relative_velocity=-0.25))
    mgr.execute(m.h.NoteSlice(track_idx=0, clip_id=0, slice_pos=2.5))
    rec()
    mgr.execute(m.h.NoteSelect(track_idx=0, clip_id=0, min_pos=0.0, max_pos=4.0, min_key=0, max_key=131))
    mgr.execute(m.h.NoteDelete(track_idx=0, clip_id=0))
    rec()
    for _ in range(4):
        mgr.undo()
        rec()
    mgr.redo()
    rec()


def sc_tracks_and_clips(m, s, asset, mgr, rec):
    mgr.execute(m.h.ClipAddAudio(track_idx=0, clip_name="a", min_time=0.0, max_time=2.0, asset=asset))
    mgr.execute(m.h.TrackAdd(track_name="t1", volume_db=-2.0))
    mgr.execute(m.h.ClipDuplicate(src_track_idx=0, dst_track_idx=1, clip_id=0, relative_pos=1.0))
    mgr.execute(m.h.ClipRename(track_idx=0, clip_id=0, new_name="renamed"))
    mgr.execute(m.h.ClipShift(track_idx=0, clip_id=0, relative_pos=0.25))
    rec()
    mgr.execute(m.h.TrackMove(from_slot=0, to_slot=1))
    rec()
    mgr.execute(m.h.TrackDelete(track_idx=0))
    rec()
    for _ in range(3):
        mgr.undo()
        rec()


def sc_routing(m, s, asset, mgr, rec):
    s.add_track("t1")
    mgr.execute(m.h.BusAdd(bus_name="aux", volume_db=-3.0))
    mgr.execute(m.h.TrackSetOutputBus(track_idx=0, bus=0))
    mgr.execute(m.h.SendAdd(track_idx=1, bus=0, gain_db=-6.0, pre_fader=True))
    mgr.execute(m.h.BusSetParam(bus_idx=0, volume_db=-9.0, mute=True))
    mgr.execute(m.h.SetBusAutomation(bus_idx=0, target="volume", points=[(0.0, 1.0, 1, 0.0), (2.0, 0.5, 1, 0.0)]))
    rec()
    mgr.undo()
    mgr.undo()
    assert s.buses[0].volume_db == -3.0 and not s.buses[0].mute
    rec()
    mgr.execute(m.h.SendRemove(track_idx=1, send_idx=0))
    rec()
    mgr.undo()
    mgr.execute(m.h.BusDelete(bus_idx=0))
    assert not s.buses and s.tracks[0].output_bus is None
    rec()
    mgr.undo()
    assert len(s.buses) == 1 and s.tracks[0].output_bus == 0
    rec()


def sc_tempo_and_meter(m, s, asset, mgr, rec):
    mgr.execute(m.h.SetTempoPoint(beat=4.0, bpm=60.0))
    mgr.execute(m.h.SetBpm(bpm=100.0))
    assert s.bpm == 100.0 and s.tempo_map.bpm_at(0.0) == 100.0
    mgr.execute(m.h.SetMeter(bar=2, num=3, den=4))
    rec()
    mgr.execute(m.h.RemoveMeter(bar=2))
    mgr.execute(m.h.RemoveTempoPoint(beat=4.0))
    rec()
    for _ in range(5):
        mgr.undo()
        rec()
    assert s.tempo_map is None and s.meter_map is None and s.bpm == 120.0


def sc_effect_automation(m, s, asset, mgr, rec):
    s.tracks[0].effects = m.fx.EffectChain([m.fx.Biquad("lowpass", 2000.0)])
    mgr.execute(m.h.SetEffectAutomation(track_idx=0, slot=0, param="freq_hz",
                                        points=[(0.0, 2000.0, 1, 0.0), (1.0, 300.0, 1, 0.0)]))
    assert (0, "freq_hz") in s.tracks[0].automation.effects
    rec()
    mgr.undo()
    rec()
    mgr.redo()
    mgr.execute(m.h.SetEffectAutomation(track_idx=0, slot=0, param="freq_hz", points=None))
    assert (0, "freq_hz") not in s.tracks[0].automation.effects
    rec()
    mgr.undo()
    rec()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_add_undo_redo, sc_move_with_trim, sc_resize_and_delete_region, sc_param_and_gain,
    sc_redo_cleared_and_modified, sc_notes, sc_tracks_and_clips, sc_routing, sc_tempo_and_meter,
    sc_effect_automation)}


def _run(pkg, scenario):
    m = _pkg(pkg)
    s, asset, mgr = _ctx(m)
    records = []
    SCENARIOS[scenario](m, s, asset, mgr, lambda: records.append(state(s, mgr)))
    return records


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_history_matches_jax(scenario):
    want, got = (_run(pkg, scenario) for pkg in PACKAGES)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}"


def test_port_history_imports_only_the_port():
    h = _pkg("whitebox_tpu_torch").h
    assert h.Session.__module__.startswith("whitebox_tpu_torch.")
    s, asset, mgr = _ctx(_pkg("whitebox_tpu_torch"))
    mgr.execute(h.SetEffectAutomation(track_idx=0, slot=0, param="gain_db", points=[(0.0, 1.0, 1, 0.0)]))
    assert type(s.tracks[0].automation).__module__ == "whitebox_tpu_torch.ops.automation"
