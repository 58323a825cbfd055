"""The roofline's count on a small session, worked by hand."""

from __future__ import annotations

import numpy as np
import pytest

from wbbench.lib import roofline
from wbbench.lib.spec import part

SESSIONS = part("sessions", "clips")
KIND = part("reference", "clips")


def _track(clips, chain=()):
    """clips: (min_beat, max_beat, offset, asset, fade beats)."""
    a = np.asarray(clips, dtype=np.float64)
    return SESSIONS.TrackDesc(volume_db=0.0, pan=0.0, min_beat=a[:, 0], max_beat=a[:, 1], offset=a[:, 2],
                     asset=a[:, 3].astype(np.int32), gain=np.ones(len(a)), fade_in=a[:, 4], fade_out=a[:, 4],
                     movable=0, chain=chain)


def _desc(chain=(), master=()):
    # 120 bpm at 48 kHz: a beat is 24,000 frames; blocks of 512 frames
    assets = [np.zeros((2, 30000), np.float32), np.zeros((1, 30000), np.float32)]
    tracks = [
        # track 0: beats 1-1.5 (frames 24,000-36,000) read asset 0 from 0, no fade
        _track([(1.0, 1.5, 0.0, 0, 0.0)], chain),
        # track 1: beats 0.5-1 read asset 0 from 6,000 (overlaps track 0's 0-12,000
        # by 6,000), beats 2-2.25 read mono asset 1 from 0 with fades
        _track([(0.5, 1.0, 6000.0, 0, 0.0), (2.0, 2.25, 0.0, 1, 0.05)], chain),
    ]
    return SESSIONS.SessionDesc(sample_rate=48000, buffer_size=512, channels=2, bpm=120.0, assets=assets, tracks=tracks,
                       master_chain=master)


#: the played spans as the engine's f64 transport places them: beat 1.5
#: lands on frame 35,999 and beat 2 on 47,999 (the accumulated sample
#: position truncates), so track 0 plays 11,999 frames, track 1 12,000 and
#: 6,000; the 106 blocks end past beat 2.25 (54,000 frames)
PLAYED = {"t0": 11999, "t1a": 12000, "t1b": 6000}
F = 106 * 512


def test_played_spans():
    d = _desc()
    g = KIND.grid(d)
    assert g.frames == F
    spans = [[(r.start, r.stop, r.src) for r in KIND.track_runs(d, t, g)] for t in range(2)]
    assert spans == [[(24000, 35999, 0)], [(12000, 24000, 6000), (47999, 53999, 0)]]


def test_mix_count_without_chains():
    b, ops = roofline.count(_desc(), "mix", KIND)
    # asset 0 read over source frames 0-18,000 (0-11,999 and 6,000-18,000; stereo),
    # mono asset 1 over 0-6,000; the [2, F] mix written
    assert b == (18000 * 2 + 6000 * 1) * 4 + 2 * F * 4
    # per played (track, channel, frame): clip gain, track gain, sum = 3; the
    # faded clip adds the envelope (5 a frame) and its product (1 a channel)
    plain = (PLAYED["t0"] + PLAYED["t1a"]) * 2 * 3
    faded = PLAYED["t1b"] * 5 + PLAYED["t1b"] * 2 * 4
    assert ops == plain + faded


def test_chains_charge_every_frame_and_the_master():
    eq = (("parametric_eq", {"bands": (("peak", 1000.0, 1.0, -1.5), ("lowshelf", 100.0, 0.707, 2.0))}),)
    hp = (("biquad", {"bands": (("highpass", 25.0, 0.7071, 0.0),)}),)
    d = _desc(eq, hp)
    _, ops = roofline.count(d, "mix", KIND)
    # clip gain (and envelope) on the played frames, then every frame of every row
    clips = (PLAYED["t0"] + PLAYED["t1a"]) * 2 + PLAYED["t1b"] * 5 + PLAYED["t1b"] * 2 * 2
    rows = 2 * 2 * F * (9 * 2 + 2)  # two tracks x two channels: two sections, track gain and sum
    assert ops == clips + rows + 2 * F * 9
    b, ops_stems = roofline.count(d, "stems", KIND)
    assert b == (18000 * 2 + 6000) * 4 + 2 * 2 * F * 4
    assert ops_stems == clips + 2 * 2 * F * (9 * 2 + 1)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(3.35e9, 67e12) == pytest.approx(1.0)
