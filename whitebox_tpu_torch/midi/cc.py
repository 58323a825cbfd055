"""MIDI CC -> parameter-lane mapping.

The reference's event union carries ControlChange / PolyPressure members
(src/engine/event.h:41-62) so plugins can receive controller data
(plugin_interface.h:77-90); with native effect chains the natural target
is the timed effect-param automation surface: CC events from a track's
MIDI clips become an AutomationLane driving any automatable effect
parameter (render/effects_generic.AUTOMATABLE).

Timeline mapping matches the note carve (midi/voice.py:187-194): an
asset-local event at beat ``tau`` lands at
``clip.min_time - clip.start_offset + tau / clip.midi.rate``, windowed to
the clip span; the last event *before* the window sets the value at the
clip start (controllers are hold-last semantics).
"""

from __future__ import annotations

from whitebox_tpu_torch.ops.automation import AutomationLane, CurveType, EnvelopePoint, TrackAutomation


def cc_lane_for_track(track, controller: int, *, lo: float, hi: float,
                      curve: CurveType = CurveType.HOLD) -> AutomationLane | None:
    """Collect controller ``controller``'s events across the track's MIDI
    clips into one timeline-domain AutomationLane mapping the normalized
    CC value onto [lo, hi].

    ``curve=HOLD`` (default) is stepped controller semantics; LINEAR ramps
    between events. Returns None when the track has no matching events."""
    pts: list[EnvelopePoint] = []
    for clip in track.clips:
        if not clip.is_midi() or clip.midi is None or clip.midi.asset is None:
            continue
        buf = clip.midi.asset.notes
        events = [e for e in getattr(buf, "cc", []) if e.controller == controller]
        if not events:
            continue
        mult = 1.0 / float(clip.midi.rate)
        toff = clip.min_time - clip.start_offset
        last_before = None
        for e in events:  # buffer is time-sorted
            t = toff + e.time * mult
            if t < clip.min_time:
                last_before = e
                continue
            if t >= clip.max_time:
                break
            pts.append(EnvelopePoint(t, lo + e.value * (hi - lo), curve))
        if last_before is not None:
            # hold-last: the latest event before the window seeds the value
            # at the clip start
            pts.append(EnvelopePoint(clip.min_time, lo + last_before.value * (hi - lo), curve))
    if not pts:
        return None
    pts.sort(key=lambda p: p.x)
    return AutomationLane(pts)


def apply_cc_map(session, track_idx: int, mapping: dict) -> list:
    """Install CC-driven effect-param lanes on a track.

    ``mapping``: {controller: (slot, param, lo, hi)} — e.g.
    ``{1: (0, "freq_hz", 200.0, 8000.0)}`` routes the mod wheel to a
    Biquad cutoff. Returns the list of (slot, param) keys installed
    (controllers with no events on the track are skipped)."""
    track = session.tracks[track_idx]
    installed = []
    for controller, (slot, param, lo, hi) in sorted(mapping.items()):
        lane = cc_lane_for_track(track, controller, lo=float(lo), hi=float(hi))
        if lane is None:
            continue
        if track.automation is None:
            track.automation = TrackAutomation()
        track.automation.effects[(int(slot), str(param))] = lane
        installed.append((int(slot), str(param)))
    return installed
