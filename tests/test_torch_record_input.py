"""The port's ``session/record.py`` and ``session/input.py`` against the JAX
package's (CPU, no rendering).

The cases of ``tests/test_record.py`` and ``tests/test_input_routing.py``
on the port: streaming takes ingest bit-exactly in fixed 256 KiB chunks,
truncate on stop, place the clip under a tempo map, refuse a channel
mismatch and a second finalize, and leave the session untouched when
cancelled; recording inputs pack to the reference's u32, armed tracks form
the same input groups, one capture stream fans out to every armed track,
and assignments round-trip through ``.wb`` projects (also read by the JAX
package). Each scenario runs in both packages and their records must be
equal; the port is also held to the JAX tests' own outcomes.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

RATE = 48000.0
PACKAGES = ("whitebox_tpu", "whitebox_tpu_torch")


def _pkg(name):
    imp = importlib.import_module
    return SimpleNamespace(Session=imp(f"{name}.session").Session, record=imp(f"{name}.session.record"),
                           input=imp(f"{name}.session.input"), project=imp(f"{name}.session.project"))


def _blocks(seed, channels, sizes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((channels, n)).astype(np.float32) * 0.5 for n in sizes]


def _clip(c):
    return None if c is None else (c.min_time, c.max_time, np.stack(c.audio.asset.sample.data))


def rec_finalize_equals_blocks(m):
    s = m.Session(bpm=120.0)
    take = s.start_recording(s.add_track("rec"), RATE, at_beat=2.0)
    blocks = _blocks(0, 2, [512] * 20 + [13, 999, 512, 7])
    for b in blocks:
        take.append(b)
    assert take.frames_written == sum(b.shape[1] for b in blocks)
    clip = take.finalize()
    np.testing.assert_array_equal(np.stack(clip.audio.asset.sample.data), np.concatenate(blocks, axis=1))
    assert clip.min_time == 2.0
    return [_clip(clip)]


def rec_chunked_growth_is_bounded(m):
    s = m.Session(bpm=120.0)
    take = s.start_recording(s.add_track("rec"), RATE, at_beat=0.0)
    chunk_frames = m.record.RECORD_CHUNK_BYTES // (4 * 2)
    for b in _blocks(1, 2, [512] * 300):
        take.append(b)
    assert len(take._chunks) == -(-take.frames_written // chunk_frames)
    assert all(c.shape == (2, chunk_frames) for c in take._chunks)
    return [take.frames_written, [c.shape for c in take._chunks]]


def rec_truncate_on_stop(m):
    s = m.Session(bpm=120.0)
    take = s.start_recording(s.add_track("rec"), RATE, at_beat=0.0)
    take.append(np.ones((2, 100), np.float32))
    clip = take.finalize()
    assert clip.audio.asset.sample.count == 100
    return [_clip(clip)]


def rec_empty_take_returns_none(m):
    s = m.Session(bpm=120.0)
    tr = s.add_track("rec")
    assert s.start_recording(tr, RATE).finalize() is None and not tr.clips
    return [len(tr.clips)]


def rec_cancel_leaves_session_untouched(m):
    s = m.Session(bpm=120.0)
    tr = s.add_track("rec")
    stamp = s.edit_stamp()
    take = s.start_recording(tr, RATE)
    take.append(np.ones((2, 4096), np.float32))
    take.cancel()
    assert not tr.clips and s.edit_stamp() == stamp
    with pytest.raises(RuntimeError):
        take.append(np.ones((2, 1), np.float32))
    return [len(tr.clips)]


def rec_rejects_bad_use(m):
    s = m.Session(bpm=120.0)
    tr = s.add_track("rec")
    with pytest.raises(ValueError, match="channels"):
        s.start_recording(tr, RATE, channels=2).append(np.ones((3, 64), np.float32))
    take = s.start_recording(tr, RATE)
    take.append(np.ones((2, 64), np.float32))
    take.finalize()
    with pytest.raises(RuntimeError):
        take.finalize()
    return [len(tr.clips)]


def rec_mono_and_tempo_map(m):
    s = m.Session(bpm=120.0)
    take = s.start_recording(s.add_track("mono"), RATE, channels=1)
    take.append(np.arange(777, dtype=np.float32)[None] / 1000.0)
    mono = take.finalize()
    assert np.stack(mono.audio.asset.sample.data).shape == (1, 777)
    s.set_tempo_point(0.0, 120.0)
    s.set_tempo_point(4.0, 60.0)
    take = s.start_recording(s.add_track("rec"), RATE, at_beat=4.0)
    take.append(np.ones((2, int(RATE)), np.float32))  # 1 s at 60 bpm = 1 beat
    clip = take.finalize()
    assert abs((clip.max_time - clip.min_time) - 1.0) < 1e-9
    return [_clip(mono), _clip(clip)]


def _five_tracks(m):
    s = m.Session(bpm=120.0)
    for i in range(5):
        s.add_track(f"t{i}")
    return s


def _groups(groups):
    return [(g.input.as_packed_u32(), g.track_indices) for g in groups]


def inp_packed_u32(m):
    T, TT = m.input.TrackInput, m.input.TrackInputType
    out = []
    for t in TT:
        for idx in (0, 1, 7, 0xFFFFFF):
            packed = T(t, idx).as_packed_u32()
            assert packed == (idx & 0xFFFFFF) | (int(t) << 24)  # track_input.h:20-22
            assert T.from_packed_u32(packed) == T(t, idx)
            out.append(packed)
    assert T.from_packed_u32(T(TT.EXTERNAL_MONO, 0x1FFFFFF).as_packed_u32()).index == 0xFFFFFF
    assert T(TT.EXTERNAL_STEREO, 0).channels == 2 and T(TT.EXTERNAL_MONO, 3).channels == 1
    return out


def inp_groups(m):
    s = _five_tracks(m)
    s.set_track_input(0, "external_stereo", 0, armed=True)
    s.set_track_input(1, "external_mono", 2, armed=False)  # not armed
    s.set_track_input(2, "midi", 0, armed=True)  # midi: no audio group
    s.set_track_input(3, "external_stereo", 0, armed=True)  # shares group 0
    first = _groups(m.input.build_input_groups(s))
    assert [g[1] for g in first] == [[0, 3]]
    s = _five_tracks(m)
    s.set_track_input(1, "external_mono", 1, armed=True)
    s.set_track_input(0, "external_stereo", 0, armed=True)
    s.set_track_input(4, "external_mono", 1, armed=True)
    second = _groups(s.input_groups())
    assert [g[1] for g in second] == [[0], [1, 4]]
    return [first, second]


def inp_arm_and_clear(m):
    s = _five_tracks(m)
    s.set_track_input(0, "external_mono", 0)
    seen = [_groups(s.input_groups())]
    s.arm_track(0)
    seen.append(_groups(s.input_groups()))
    s.arm_track(0, False)
    seen.append(_groups(s.input_groups()))
    s.set_track_input(0, "external_mono", 0, armed=True)
    s.set_track_input(0, "none", armed=True)
    assert s.tracks[0].input is None
    seen.append(_groups(s.input_groups()))
    assert [len(g) for g in seen] == [0, 1, 0, 0]
    return seen


def inp_three_takes_from_one_stream(m):
    s = m.Session(bpm=120.0)
    for i in range(3):
        s.add_track(f"t{i}")
    s.set_track_input(0, "external_stereo", 0, armed=True)  # ch [0,1]
    s.set_track_input(1, "external_stereo", 0, armed=True)  # ch [0,1] too
    s.set_track_input(2, "external_mono", 3, armed=True)    # ch [3]
    rec = s.record_armed(RATE, at_beat=1.0)
    assert rec.capture_channels_required == 4
    blocks = _blocks(7, 4, (512, 512, 300, 512, 64))
    for b in blocks:
        rec.record_block(b)
    clips = rec.finalize()
    full = np.concatenate(blocks, axis=1)
    for c, want in zip(clips, (full[0:2], full[0:2], full[3:4])):
        np.testing.assert_array_equal(np.stack(c.audio.asset.sample.data), want)
        assert c.min_time == 1.0
    assert not any(t.armed for t in s.tracks)  # stop_record disarms
    return [_clip(c) for c in clips]


def inp_errors_and_cancel(m):
    s = m.Session(bpm=120.0)
    s.add_track("a")
    with pytest.raises(ValueError, match="no armed track"):
        s.record_armed(RATE)
    s.set_track_input(0, "external_stereo", 1, armed=True)  # needs ch [2,3]
    with pytest.raises(ValueError, match="capture block has 2"):
        s.record_armed(RATE, at_beat=0.0).record_block(np.zeros((2, 64), np.float32))
    s.set_track_input(0, "external_mono", 0, armed=True)
    rec = s.record_armed(RATE, at_beat=0.0)
    rec.record_block(np.ones((1, 256), np.float32))
    stamp = s.edit_stamp()
    rec.cancel()
    assert s.edit_stamp() == stamp and not s.tracks[0].clips
    return [len(s.tracks[0].clips)]


SCENARIOS = {f.__name__: f for f in (
    rec_finalize_equals_blocks, rec_chunked_growth_is_bounded, rec_truncate_on_stop,
    rec_empty_take_returns_none, rec_cancel_leaves_session_untouched, rec_rejects_bad_use,
    rec_mono_and_tempo_map, inp_packed_u32, inp_groups, inp_arm_and_clear,
    inp_three_takes_from_one_stream, inp_errors_and_cancel)}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_record_and_input_match_jax(scenario):
    want, got = (SCENARIOS[scenario](_pkg(p)) for p in PACKAGES)
    assert _same(got, want)


def test_recording_types_are_the_ports():
    from whitebox_tpu_torch.session import RecordingTake, Session

    s = Session(bpm=120.0)
    s.add_track("a")
    assert isinstance(s.start_recording(s.tracks[0], RATE), RecordingTake)
    s.set_track_input(0, "external_mono", 0, armed=True)
    assert type(s.tracks[0].input).__module__ == "whitebox_tpu_torch.session.input"
    assert type(s.record_armed(RATE)).__module__ == "whitebox_tpu_torch.session.input"


@pytest.mark.parametrize("writer", PACKAGES)
def test_wb_round_trips_input_assignments(tmp_path, writer):
    """Assignments survive a ``.wb`` written by either package and read by
    the other; ``from_reference`` carries them across as well."""
    from whitebox_tpu_torch.session.convert import from_reference

    w = _pkg(writer)
    s = w.Session(bpm=120.0)
    for i in range(4):
        s.add_track(f"t{i}")
    s.set_track_input(0, "external_stereo", 2, armed=True)
    s.set_track_input(1, "external_mono", 5, armed=False)
    s.set_track_input(2, "midi", 1, armed=True)
    p = tmp_path / "inputs.wb"
    w.project.write_project(s, p)
    readers = [_pkg(pkg).project.read_project(p) for pkg in PACKAGES]
    if writer == "whitebox_tpu":
        readers.append(from_reference(s))
    want = [(0x02000002, True), (0x03000005, False), (0x01000001, True), (None, False)]
    for r in readers:
        got = [(None if t.input is None else t.input.as_packed_u32(), t.armed) for t in r.tracks]
        assert got == want
