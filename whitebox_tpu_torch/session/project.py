"""``.wb`` project serialization — msgpack, byte-compatible with the
reference's ``wbpr`` document (src/engine/project.cpp:221-330 write,
:22-219 read).

Schema (all keys as the reference writes them)::

    {"wbpr": {version, bpm, playhead_pos, timeline_view_min,
              timeline_view_max, main_vol, project_info{author,title,genre,desc},
              sample_table[path...],
              midi_table[{min_note,max_note,notes[[min,max,key,flags,vel]...]}...],
              tracks[{name,col,height,vol,pan,mute,solo,shown,
                      clips[{type,name,col,active,start,end,ofs,
                             data{asset_id,fstart,fend,gain[,speed]}  # audio
                             data{asset_id,trans,rate}}...]}...]}}

Notes: the reference writer never persists clip speed (its reader defaults
it to 1.0, project.cpp:188); we write it as an extra "speed" key — the
reference reader scans maps by key so extras are ignored. Likewise, track
effect chains and automation lanes (framework extensions) persist as extra
"fx" / "auto" track keys. Missing sample
files are searched for recursively next to the project file
(project.cpp:71-99 relocation).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer
from whitebox_tpu_torch.session.clip import AudioClipData, Clip, ClipMode, ClipType, MidiClipData
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.session.track import Track

PROJECT_VERSION = 1

_log = logging.getLogger("whitebox_tpu_torch.project")

#: the port has the linear effects only (gain, biquad, eq): a project that
#: stores another type neither reads nor writes
_EFFECTS_TODO = ("whitebox_tpu_torch has only the gain, biquad and eq effects yet: "
                 "ROADMAP.md queue 1, item 6 (generic effects)")
_INPUT_TODO = ("whitebox_tpu_torch has no recording inputs yet (session/input.py): "
               "ROADMAP.md queue 1, item 14")


def find_file_recursive(root, filename: str, max_depth: int = 8):
    """core/fs find_file_recursive — locate a file by name under root."""
    root = Path(root)
    if not root.is_dir():
        return None
    base_depth = len(root.parts)
    for dirpath, dirnames, filenames in os.walk(root):
        if len(Path(dirpath).parts) - base_depth > max_depth:
            dirnames[:] = []
            continue
        if filename in filenames:
            return Path(dirpath) / filename
    return None


def _effect_to_doc(e) -> dict:
    from whitebox_tpu_torch.effects import Biquad, Gain, ParametricEQ

    if isinstance(e, Gain):
        return {"type": "gain", "gain_db": e.gain_db}
    if isinstance(e, Biquad):
        return {"type": "biquad", "ftype": e.ftype.value, "freq": e.freq_hz, "q": e.q, "gain_db": e.gain_db}
    if isinstance(e, ParametricEQ):
        return {"type": "eq", "bands": [[t.value, f, q, g] for (t, f, q, g) in e.bands]}
    raise NotImplementedError(f"cannot write effect {e!r}: {_EFFECTS_TODO}")


def _effect_from_doc(d):
    from whitebox_tpu_torch.effects import Biquad, Gain, ParametricEQ

    t = _as_str(d.get("type"))
    if t == "gain":
        return Gain(float(d.get("gain_db", 0.0)))
    if t == "biquad":
        return Biquad(_as_str(d.get("ftype", "lowpass")), float(d.get("freq", 1000.0)),
                      float(d.get("q", 0.7071067811865476)), float(d.get("gain_db", 0.0)))
    if t == "eq":
        return ParametricEQ([(_as_str(b[0]), float(b[1]), float(b[2]), float(b[3])) for b in d.get("bands", [])])
    raise NotImplementedError(f"cannot read effect type {t!r}: {_EFFECTS_TODO}")


def _chain_to_doc(effects) -> list:
    from whitebox_tpu_torch.effects import EffectChain

    effs = effects.effects if isinstance(effects, EffectChain) else list(effects or [])
    return [_effect_to_doc(e) for e in effs]


def _chain_from_doc(docs):
    from whitebox_tpu_torch.effects import EffectChain

    return EffectChain([_effect_from_doc(d) for d in docs])


def _lane_to_doc(lane) -> list:
    return [[p.x, p.y, int(p.curve), p.tension] for p in lane.points]


def _lane_from_doc(docs):
    from whitebox_tpu_torch.ops.automation import AutomationLane, CurveType, EnvelopePoint

    return AutomationLane([EnvelopePoint(float(p[0]), float(p[1]), CurveType(int(p[2])), float(p[3])) for p in docs])


def _fx_lanes_from_doc(doc: dict) -> dict:
    """{"slot:param": lane_doc} -> {(slot, param): AutomationLane}."""
    out = {}
    for key, lane_doc in doc.items():
        slot, _, param = _as_str(key).partition(":")
        out[(int(slot), param)] = _lane_from_doc(lane_doc)
    return out


def _clip_to_doc(clip, sample_index: dict, midi_index: dict) -> dict:
    doc = {
        "type": int(clip.type),
        "name": clip.name,
        "col": clip.color,
        "active": bool(clip.active),
        "start": clip.min_time,
        "end": clip.max_time,
        "ofs": clip.start_offset,
    }
    if clip.is_audio():
        doc["data"] = {
            "asset_id": sample_index.get(id(clip.audio.asset), 0xFFFFFFFF),
            "fstart": clip.audio.fade_start,
            "fend": clip.audio.fade_end,
            "gain": float(clip.audio.gain),
            "speed": float(clip.audio.speed),  # extension key (see module doc)
        }
        if clip.audio.mode != ClipMode.ONE_SHOT:
            doc["data"]["mode"] = int(clip.audio.mode)  # extension key
    elif clip.is_midi():
        doc["data"] = {
            "asset_id": midi_index.get(id(clip.midi.asset), 0xFFFFFFFF),
            "trans": clip.midi.transpose,
            "rate": clip.midi.rate,
        }
    return doc


def _clip_from_doc(c: dict, j: int, sample_assets: list, midi_assets: list):
    ctype = ClipType(int(c.get("type", 0)))
    clip = Clip(
        id=j,
        type=ctype,
        name=_as_str(c.get("name", "")),
        color=int(c.get("col", 0)),
        active=bool(c.get("active", True)),
        min_time=float(c.get("start", 0.0)),
        max_time=float(c.get("end", 0.0)),
        start_offset=float(c.get("ofs", 0.0)),
    )
    data = c.get("data") or {}
    asset_id = int(data.get("asset_id", 0xFFFFFFFF))
    if ctype == ClipType.AUDIO and asset_id != 0xFFFFFFFF and sample_assets[asset_id] is not None:
        clip.audio = AudioClipData(
            asset=sample_assets[asset_id],
            fade_start=float(data.get("fstart", 0.0)),
            fade_end=float(data.get("fend", 0.0)),
            speed=float(data.get("speed", 1.0)),
            gain=float(data.get("gain", 0.0)),
            mode=ClipMode(int(data.get("mode", 0))),
        )
    elif ctype == ClipType.MIDI and asset_id != 0xFFFFFFFF:
        clip.midi = MidiClipData(
            asset=midi_assets[asset_id],
            transpose=int(data.get("trans", 0)),
            rate=int(data.get("rate", 1)),
            length=clip.max_time - clip.min_time,
        )
    return clip


def _persist_memory_samples(session: Session, path) -> None:
    """Memory-only samples (frozen renders, recorded takes not yet saved)
    get sidecar WAVs next to the project so the .wb survives a reload —
    the reference assumes every asset already lives on disk."""
    import re

    import numpy as np

    from whitebox_tpu_torch.io.wav import write_wav

    proj = Path(path)
    for idx, asset in enumerate(session.sample_table.samples.values()):
        s = asset.sample
        if s.path:
            continue
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", s.name or "sample") or "sample"
        side = proj.parent / f"{proj.stem}_{safe}_{idx}.wav"
        write_wav(side, np.stack(s.data), int(s.sample_rate), s.format)
        s.path = str(side)
        _log.info("persisted in-memory sample %r -> %s", s.name, side)


def write_project(session: Session, path, timeline_view=(0.0, 1.0)) -> None:
    _persist_memory_samples(session, path)
    sample_index: dict[int, int] = {}
    sample_paths: list[str] = []
    for idx, (key, asset) in enumerate(session.sample_table.samples.items()):
        sample_index[id(asset)] = idx
        sample_paths.append(asset.sample.path or key)

    midi_index: dict[int, int] = {}
    midi_docs = []
    for idx, asset in enumerate(session.midi_table.midi_assets):
        midi_index[id(asset)] = idx
        notes = asset.notes
        mdoc = {
            "min_note": notes.min_note,
            "max_note": notes.max_note,
            "notes": [[n.min_time, n.max_time, n.key, n.flags, float(n.velocity)] for n in notes],
        }
        if getattr(notes, "cc", None):
            # extension keys: CC / poly-pressure events (event.h:41-62)
            mdoc["cc"] = [[e.time, e.controller, float(e.value), e.channel] for e in notes.cc]
        if getattr(notes, "poly_pressure", None):
            mdoc["pp"] = [[e.time, e.key, float(e.pressure), e.channel] for e in notes.poly_pressure]
        midi_docs.append(mdoc)

    track_docs = []
    for track in session.tracks:
        clip_docs = [_clip_to_doc(clip, sample_index, midi_index) for clip in track.clips]

        extras = {}
        if track.effects:
            extras["fx"] = _chain_to_doc(track.effects)
        if track.frozen is not None:
            # extension key: freeze stash (Session.freeze_track) — original
            # clips/chain/effect-lanes so unfreeze works after a reload
            extras["frozen"] = {
                "clips": [_clip_to_doc(c, sample_index, midi_index)
                          for c in track.frozen["clips"]],
                "fx": _chain_to_doc(track.frozen["effects"]) if track.frozen["effects"] else [],
                "auto_fx": {
                    f"{slot}:{param}": _lane_to_doc(lane)
                    for (slot, param), lane in sorted(track.frozen["eff_lanes"].items())
                },
            }
        if track.output_bus is not None:
            extras["out_bus"] = int(track.output_bus)  # extension key (routing)
        if getattr(track, "input", None) is not None or getattr(track, "armed", False):
            # recording input assignment, stored as the reference's packed
            # u32 (track_input.h:20-22) + the arm flag; 0 packs type NONE
            if track.input is not None:
                raise NotImplementedError(_INPUT_TODO)
            extras["input"] = 0
            if track.armed:
                extras["armed"] = True
        if track.sends:
            extras["sends"] = [
                {"bus": int(s.bus), "gain": float(s.gain_db), "pre": bool(s.pre_fader),
                 **({"sc": True} if s.sidechain else {})}
                for s in track.sends
            ]
        if track.automation is not None:
            auto_doc = {}
            if track.automation.volume is not None:
                auto_doc["vol"] = _lane_to_doc(track.automation.volume)
            if track.automation.pan is not None:
                auto_doc["pan"] = _lane_to_doc(track.automation.pan)
            if track.automation.effects:
                # timed effect-param lanes, keyed "slot:param"
                auto_doc["fx"] = {
                    f"{slot}:{param}": _lane_to_doc(lane)
                    for (slot, param), lane in sorted(track.automation.effects.items())
                }
            extras["auto"] = auto_doc
        track_docs.append(
            {
                **extras,
                "name": track.name,
                "col": track.color,
                "height": float(track.height),
                "vol": float(track.volume_db),
                "pan": float(track.pan),
                "mute": bool(track.mute),
                "solo": bool(track.solo),
                "shown": bool(track.shown),
                "clips": clip_docs,
            }
        )

    doc = {
        "wbpr": {
            "version": PROJECT_VERSION,
            "bpm": float(session.bpm),
            "playhead_pos": float(session.playhead),
            "timeline_view_min": float(timeline_view[0]),
            "timeline_view_max": float(timeline_view[1]),
            "main_vol": 0.0,
            "project_info": {
                "author": session.project_info.author,
                "title": session.project_info.title,
                "genre": session.project_info.genre,
                "desc": session.project_info.description,
            },
            "sample_table": sample_paths,
            "midi_table": midi_docs,
            "tracks": track_docs,
        }
    }
    if getattr(session, "buses", None):
        # extension key: aux buses / track groups (session/bus.py)
        def _bus_auto_doc(b):
            a = getattr(b, "automation", None)
            if a is None:
                return {}
            d = {}
            if a.volume is not None:
                d["vol"] = _lane_to_doc(a.volume)
            if a.pan is not None:
                d["pan"] = _lane_to_doc(a.pan)
            if a.effects:
                d["fx"] = {f"{slot}:{param}": _lane_to_doc(lane)
                           for (slot, param), lane in sorted(a.effects.items())}
            return {"auto": d} if d else {}

        doc["wbpr"]["buses"] = [
            {
                "name": b.name,
                "vol": float(b.volume_db),
                "pan": float(b.pan),
                "mute": bool(b.mute),
                **({"fx": _chain_to_doc(b.effects)} if b.effects else {}),
                **_bus_auto_doc(b),
            }
            for b in session.buses
        ]
    if getattr(session, "tempo_map", None) is not None:
        # extension key: piecewise tempo map (core/tempo.py) — the
        # reference has a single session bpm (engine.cpp:24) and its
        # reader ignores unknown keys
        doc["wbpr"]["tempo_map"] = [
            {"beat": p.beat, "bpm": p.bpm, "curve": p.curve,
             **({"bpm_end": p.bpm_end} if p.bpm_end is not None else {})}
            for p in session.tempo_map.points
        ]
    if getattr(session, "meter_map", None) is not None:
        # extension key: meter / time-signature map (core/meter.py)
        doc["wbpr"]["meter_map"] = [
            {"bar": p.bar, "num": p.num, "den": p.den}
            for p in session.meter_map.points
        ]
    if session.master_effects:
        doc["wbpr"]["master_fx"] = _chain_to_doc(session.master_effects)
    if getattr(session, "master_automation", None):
        doc["wbpr"]["master_auto"] = {
            f"{slot}:{param}": _lane_to_doc(lane)
            for (slot, param), lane in sorted(session.master_automation.items())
        }

    import msgpack

    blob = msgpack.packb(doc, use_bin_type=False, use_single_float=False)
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def _as_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return str(v) if v is not None else ""


def read_project(path, search_dirs: list | None = None) -> Session:
    if hasattr(path, "read"):
        blob = path.read()
        project_dir = Path(".")
    else:
        with open(path, "rb") as f:
            blob = f.read()
        project_dir = Path(str(path)).parent

    import msgpack

    doc = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    project = doc.get("wbpr")
    if project is None:
        raise ValueError("not a wbpr project file")

    session = Session(bpm=float(project.get("bpm", 120.0)))
    session.set_playhead_position(float(project.get("playhead_pos", 0.0)))
    info = project.get("project_info") or {}
    session.project_info.author = _as_str(info.get("author", ""))
    session.project_info.title = _as_str(info.get("title", ""))
    session.project_info.genre = _as_str(info.get("genre", ""))
    session.project_info.description = _as_str(info.get("desc", ""))

    sample_assets = []
    for p in project.get("sample_table", []) or []:
        p = _as_str(p)
        sample_path = Path(p)
        if not sample_path.is_file():
            found = find_file_recursive(project_dir, sample_path.name)
            if found is None:
                for d in search_dirs or []:
                    found = find_file_recursive(d, sample_path.name)
                    if found is not None:
                        break
            if found is None:
                _log.warning("missing sample %s: relocation failed", sample_path)
                sample_assets.append(None)
                continue
            _log.info("relocated sample %s -> %s", sample_path.name, found)
            sample_path = found
        sample_assets.append(session.sample_table.load_from_file(sample_path))

    midi_assets = []
    for m in project.get("midi_table", []) or []:
        notes = []
        for nd in m.get("notes", []):
            if len(nd) < 5:
                continue
            notes.append(
                MidiNote(
                    min_time=float(nd[0]),
                    max_time=float(nd[1]),
                    key=int(nd[2]),
                    flags=int(nd[3]),
                    velocity=float(nd[4]),
                )
            )
        from whitebox_tpu_torch.midi.notes import MidiCCEvent, MidiPolyPressureEvent

        cc = [MidiCCEvent(float(e[0]), int(e[1]), float(e[2]), int(e[3]))
              for e in m.get("cc", []) or []]
        pp = [MidiPolyPressureEvent(float(e[0]), int(e[1]), float(e[2]), int(e[3]))
              for e in m.get("pp", []) or []]
        midi_assets.append(session.midi_table.create_midi(
            MidiNoteBuffer(notes, cc=cc, poly_pressure=pp)))

    if project.get("tempo_map"):
        from whitebox_tpu_torch.core.tempo import TempoMap

        session.tempo_map = TempoMap.from_dict(
            {"points": [{k: (_as_str(v) if k == "curve" else float(v))
                         for k, v in p.items() if v is not None}
                        for p in project["tempo_map"]]})
    if project.get("meter_map"):
        from whitebox_tpu_torch.core.meter import MeterMap, MeterPoint

        session.meter_map = MeterMap(
            [MeterPoint(int(p["bar"]), int(p["num"]), int(p["den"]))
             for p in project["meter_map"]])
    if project.get("master_fx"):
        session.master_effects = _chain_from_doc(project["master_fx"])
    if project.get("master_auto"):
        session.master_automation = _fx_lanes_from_doc(project["master_auto"])
    for b in project.get("buses", []) or []:
        bus = session.add_bus(
            name=_as_str(b.get("name", "")),
            volume_db=float(b.get("vol", 0.0)),
            pan=float(b.get("pan", 0.0)),
            mute=bool(b.get("mute", False)),
        )
        if b.get("fx"):
            bus.effects = _chain_from_doc(b["fx"])
        if b.get("auto"):
            from whitebox_tpu_torch.ops.automation import TrackAutomation

            a = b["auto"]
            bus.automation = TrackAutomation(
                volume=_lane_from_doc(a["vol"]) if a.get("vol") else None,
                pan=_lane_from_doc(a["pan"]) if a.get("pan") else None,
                effects=_fx_lanes_from_doc(a.get("fx") or {}),
            )

    for t in project.get("tracks", []) or []:
        track = Track(
            name=_as_str(t.get("name", "")),
            color=int(t.get("col", 0)),
            height=float(t.get("height", 0.0)),
            volume_db=float(t.get("vol", 0.0)),
            pan=float(t.get("pan", 0.0)),
            mute=bool(t.get("mute", False)),
            solo=bool(t.get("solo", False)),
            shown=bool(t.get("shown", True)),
        )
        if t.get("fx"):
            track.effects = _chain_from_doc(t["fx"])
        if t.get("out_bus") is not None:
            track.output_bus = int(t["out_bus"])
        if t.get("input") is not None:
            if (int(t["input"]) >> 24) & 0xFF:  # a type other than NONE
                raise NotImplementedError(_INPUT_TODO)
            track.armed = bool(t.get("armed", False))
        if t.get("sends"):
            from whitebox_tpu_torch.session.bus import Send

            track.sends = [
                Send(bus=int(s["bus"]), gain_db=float(s.get("gain", 0.0)),
                     pre_fader=bool(s.get("pre", False)),
                     sidechain=bool(s.get("sc", False)))
                for s in t["sends"]
            ]
        if t.get("auto"):
            from whitebox_tpu_torch.ops.automation import TrackAutomation

            a = t["auto"]
            track.automation = TrackAutomation(
                volume=_lane_from_doc(a["vol"]) if a.get("vol") else None,
                pan=_lane_from_doc(a["pan"]) if a.get("pan") else None,
                effects=_fx_lanes_from_doc(a.get("fx") or {}),
            )
        for j, c in enumerate(t.get("clips", []) or []):
            track.clips.append(_clip_from_doc(c, j, sample_assets, midi_assets))
        if t.get("frozen"):
            fz = t["frozen"]
            track.frozen = {
                "clips": [_clip_from_doc(c, j, sample_assets, midi_assets)
                          for j, c in enumerate(fz.get("clips", []) or [])],
                "effects": _chain_from_doc(fz["fx"]) if fz.get("fx") else [],
                "eff_lanes": _fx_lanes_from_doc(fz.get("auto_fx") or {}),
                "asset_key": "",
            }
        session.tracks.append(track)

    return session
