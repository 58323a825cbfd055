"""Carry a session across from the JAX package: the port's counterpart of
loading weights.

:func:`from_reference` builds this package's :class:`Session` from any
object shaped like a ``whitebox_tpu`` Session. It reads attributes only,
maps enums by their ``int`` value, copies sample arrays, and imports
nothing of the JAX package, so a caller that holds such a session (the
CPU tests, a tool that builds sessions with the JAX package) hands the
port an equal one.
"""

from __future__ import annotations

import enum

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch import effects as fx
from whitebox_tpu_torch.effects import (
    Biquad, Effect, EffectChain, Gain, LinearPhaseEQ, ParametricEQ, UnportedEffect,
)
from whitebox_tpu_torch.effects.registry import UnknownEffect, lookup_effect
from whitebox_tpu_torch.core.meter import MeterMap, MeterPoint
from whitebox_tpu_torch.core.tempo import TempoMap, TempoPoint
from whitebox_tpu_torch.midi.notes import (
    MidiCCEvent, MidiNote, MidiNoteBuffer, MidiPolyPressureEvent,
)
from whitebox_tpu_torch.ops.automation import (
    AutomationLane, CurveType, EnvelopePoint, TrackAutomation,
)
from whitebox_tpu_torch.session.assets import MidiAsset, SampleAsset
from whitebox_tpu_torch.session.bus import Bus, Send
from whitebox_tpu_torch.session.clip import AudioClipData, Clip, ClipMode, ClipType, MidiClipData
from whitebox_tpu_torch.session.sample import Sample
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.session.track import Track


class _Carrier:
    """Maps each reference asset (by identity) to one port asset, so clips
    that shared an asset share its copy, as the carve's pool expects."""

    def __init__(self) -> None:
        self.samples: dict[int, SampleAsset] = {}
        self.midi: dict[int, MidiAsset] = {}

    def sample_asset(self, a) -> SampleAsset | None:
        if a is None:
            return None
        got = self.samples.get(id(a))
        if got is None:
            s = a.sample
            sample = Sample(name=s.name, path=s.path, format=AudioFormat(int(s.format)),
                            channels=int(s.channels), sample_rate=int(s.sample_rate),
                            count=int(s.count), data=[np.array(d, copy=True) for d in s.data])
            got = SampleAsset(key=a.key, sample=sample, ref_count=int(a.ref_count))
            self.samples[id(a)] = got
        return got

    def midi_asset(self, a) -> MidiAsset | None:
        if a is None:
            return None
        got = self.midi.get(id(a))
        if got is None:
            nb = a.notes
            notes = None
            if nb is not None:
                notes = MidiNoteBuffer(
                    [MidiNote(n.min_time, n.max_time, n.meta_id, n.key, int(n.flags), n.velocity)
                     for n in nb.notes],
                    cc=[MidiCCEvent(e.time, e.controller, e.value, e.channel) for e in nb.cc],
                    poly_pressure=[MidiPolyPressureEvent(e.time, e.key, e.pressure, e.channel)
                                   for e in nb.poly_pressure])
                for meta in ("tempo", "meter"):  # a parsed SMF's Set-Tempo / Time-Signature metas
                    if hasattr(nb, meta):
                        setattr(notes, meta, [tuple(x) for x in getattr(nb, meta)])
            got = MidiAsset(notes=notes, ref_count=int(a.ref_count))
            self.midi[id(a)] = got
        return got

    def clip(self, c) -> Clip:
        out = Clip(id=c.id, type=ClipType(int(c.type)), name=c.name, color=c.color,
                   active=c.active, deleted=c.deleted,
                   internal_state_changed=c.internal_state_changed,
                   min_time=c.min_time, max_time=c.max_time, start_offset=c.start_offset)
        if c.audio is not None:
            d = c.audio
            out.audio = AudioClipData(asset=self.sample_asset(d.asset), fade_start=d.fade_start,
                                      fade_end=d.fade_end, speed=d.speed, gain=d.gain,
                                      mode=ClipMode(int(d.mode)))
        if c.midi is not None:
            d = c.midi
            out.midi = MidiClipData(asset=self.midi_asset(d.asset), length=d.length,
                                    transpose=d.transpose, rate=d.rate, mode=ClipMode(int(d.mode)))
        return out


def _lane(lane) -> AutomationLane | None:
    if lane is None:
        return None
    return AutomationLane([EnvelopePoint(p.x, p.y, CurveType(int(p.curve)), p.tension)
                           for p in lane.points])


def _lanes(d: dict) -> dict:
    return {k: _lane(v) for k, v in (d or {}).items()}


def _automation(a) -> TrackAutomation | None:
    if a is None:
        return None
    return TrackAutomation(volume=_lane(a.volume), pan=_lane(a.pan), effects=_lanes(a.effects))


def _plain(v):
    """An attribute value as plain data: enums by value, arrays (anything
    with ``__array__``) as NumPy copies, containers element by element,
    other objects by ``repr``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if hasattr(v, "__array__"):
        return np.array(v, copy=True)
    return repr(v)


#: built-in effect classes rebuilt by class name from these constructor
#: arguments, read as attributes of the reference effect
_BUILTIN_ARGS = {
    "Compressor": ("threshold_db", "ratio", "knee_db", "attack_s", "release_s", "makeup_db",
                   "detector", "rms_window_s", "sidechain"),
    "Limiter": ("ceiling_db", "attack_s", "release_s", "lookahead_s"),
    "NoiseGate": ("threshold_db", "range_db", "attack_s", "release_s", "hysteresis_db", "sidechain"),
    "Delay": ("time_s", "feedback", "wet", "dry", "mode"),
    "Chorus": ("rate_hz", "depth_s", "center_s", "voices", "wet", "dry"),
    "Flanger": ("rate_hz", "depth_s", "center_s", "wet", "dry"),
    "Saturator": ("drive_db", "mix"),
    "StereoWidth": ("width",),
}


def _effect(e) -> Effect:
    """A port effect rebuilt from a reference effect's attributes, by class
    name. A user effect comes back through the port's registry under its
    registered name (``from_dict(e.as_dict())``), an unknown persisted one
    as an ``UnknownEffect``; a class registered only in the JAX package
    becomes an :class:`UnportedEffect`, which ``bounce`` names."""
    kind = type(e).__name__
    if kind == "Gain":
        return Gain(e.gain_db)
    if kind == "Biquad":
        return Biquad(e.ftype.value, e.freq_hz, e.q, e.gain_db)
    if kind == "ParametricEQ":
        return ParametricEQ([(t.value, f, q, g) for (t, f, q, g) in e.bands])
    if kind == "LinearPhaseEQ":
        return LinearPhaseEQ([(t.value, f, q, g) for (t, f, q, g) in e.bands], taps=e.taps)
    if kind == "ConvolutionReverb":
        ir = None if e.ir_host is None else np.array(e.ir_host, dtype=np.float32, copy=True)
        return fx.ConvolutionReverb(ir, wet=e.wet, dry=e.dry, room_seconds=e.room_seconds,
                                    rt60_s=e.rt60_s, room_seed=e.room_seed)
    if kind in _BUILTIN_ARGS:
        return getattr(fx, kind)(**{a: _plain(getattr(e, a)) for a in _BUILTIN_ARGS[kind]})
    if kind == "EffectChain":
        return EffectChain([_effect(x) for x in e.effects])
    if kind == "UnknownEffect":
        return UnknownEffect(e.type_name, _plain(e.state))
    name = str(getattr(e, "name", kind))
    cls = lookup_effect(name)
    if cls is not None and callable(getattr(e, "as_dict", None)):
        return cls.from_dict(_plain(e.as_dict()))
    return UnportedEffect(kind, name, {k: _plain(v) for k, v in vars(e).items()})


def _chain(effects):
    """A reference chain (a list or an EffectChain) rebuilt from port
    effects, in the same container kind; an empty chain -> ``[]``."""
    if not effects:
        return []
    if type(effects).__name__ == "EffectChain":
        return EffectChain([_effect(e) for e in effects.effects])
    return [_effect(e) for e in effects]


def from_reference(ref) -> Session:
    """A port :class:`Session` equal to ``ref`` (a ``whitebox_tpu`` Session).

    Carries tracks, clips (loop modes, fades, gains, speeds), sample and
    MIDI assets with copies of their data, the tempo and meter maps,
    buses and sends, automation lanes (volume/pan and effect-param), and
    effect chains rebuilt as port effects (every built-in type; a user
    effect through the port's registry, or as an ``UnportedEffect``, which
    ``bounce`` refuses by name, when only the JAX package registers it).
    No object of the
    reference survives in the result. A recording input
    (``session/input.py``, not copied yet) raises ``NotImplementedError``.
    """
    s = Session(bpm=ref.bpm, ppq=ref.ppq)
    s.beat_duration = ref.beat_duration
    s.playhead, s.playhead_start = ref.playhead, ref.playhead_start
    info = ref.project_info
    s.project_info.author, s.project_info.title = info.author, info.title
    s.project_info.genre, s.project_info.description = info.genre, info.description

    carry = _Carrier()
    for key, a in ref.sample_table.samples.items():
        s.sample_table.samples[key] = carry.sample_asset(a)
    s.midi_table.midi_assets = [carry.midi_asset(a) for a in ref.midi_table.midi_assets]

    if ref.tempo_map is not None:
        s.tempo_map = TempoMap([TempoPoint(p.beat, p.bpm, p.curve, p.bpm_end)
                                for p in ref.tempo_map.points])
    if ref.meter_map is not None:
        s.meter_map = MeterMap([MeterPoint(p.bar, p.num, p.den) for p in ref.meter_map.points])
    s.master_effects = _chain(ref.master_effects)
    s.master_automation = _lanes(ref.master_automation)
    s.buses = [Bus(name=b.name, volume_db=b.volume_db, pan=b.pan, mute=b.mute,
                   effects=_chain(b.effects), automation=_automation(b.automation))
               for b in ref.buses]

    for t in ref.tracks:
        if t.input is not None:
            raise NotImplementedError(
                f"track {t.name!r} has a recording input: whitebox_tpu_torch has no "
                "session/input.py yet, ROADMAP.md queue 1, item 14")
        frozen = None
        if t.frozen is not None:
            frozen = {"clips": [carry.clip(c) for c in t.frozen["clips"]],
                      "effects": _chain(t.frozen["effects"]),
                      "eff_lanes": _lanes(t.frozen["eff_lanes"]),
                      "asset_key": t.frozen["asset_key"]}
        s.tracks.append(Track(
            name=t.name, color=t.color, height=t.height, shown=t.shown,
            volume_db=t.volume_db, pan=t.pan, mute=t.mute, solo=t.solo,
            clips=[carry.clip(c) for c in t.clips], effects=_chain(t.effects),
            automation=_automation(t.automation), output_bus=t.output_bus,
            sends=[Send(bus=x.bus, gain_db=x.gain_db, pre_fader=x.pre_fader,
                        sidechain=x.sidechain) for x in t.sends],
            frozen=frozen, armed=t.armed))
    return s
