"""The port's ``render/preview.py::PreviewStream`` against the port's own
``bounce``, the NumPy oracle and the JAX package's ``PreviewStream`` (CPU).

The preview cases of ``tests/test_aux.py`` and ``tests/test_record.py`` on
the port: joined blocks equal the bounce (bit-equal at speed 1; the
Catmull-Rom and oversampled-sinc forms within 3e-6 of ``bounce(...,
prerender=False)``), a seek serves the bounce at the new frame, the window
never exceeds the lookahead, an edit mid-playback re-carves from the
current position (bit-equal to the oracle of the edited session), and
note, parameter and lane edits move the edit stamp. With effects (the JAX
package's benchmark config 8 in small: a two-band EQ on every track, a
volume lane, a master highpass; a compressor chain; a routed session) the
joined blocks are within relative RMS 1e-5 of the port's bounce and, for
config 8, 5e-5 of the JAX package's preview (run once, in a module
fixture).
"""

import numpy as np
import pytest

from chip_smoke import rel_rms
from tests.test_carve import random_session
from tests.test_torch_routing import _jax_case
from whitebox_tpu import effects as jfx
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.ops.automation import AutomationLane as JaxLane
from whitebox_tpu.ops.automation import TrackAutomation as JaxAutomation
from whitebox_tpu.render.demo import make_demo_session
from whitebox_tpu.render.preview import PreviewStream as JaxPreview
from whitebox_tpu.session import Session as JaxSession
from whitebox_tpu.session.sample import Sample as JaxSample
from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.preview import PreviewStream
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.oracle import OracleRenderer


def make_session():
    """``tests/test_aux.py::make_session``: one ramp clip at 32768 Hz."""
    s = JaxSession(bpm=60.0)
    data = (np.arange(32768, dtype=np.float32) / 65536.0)[None]
    asset = s.sample_table.add_sample(JaxSample.from_planar(data, 32768, AudioFormat.F32), key="a")
    tr = s.add_track("t")
    s.add_audio_clip(tr, "c", 0.0, 0.9, asset=asset)
    return from_reference(s)


def _stream(s, rate=32768.0, **kw):
    return PreviewStream(s, rate, device="cpu", **{"buffer_size": 256, **kw})


def _joined(ps, frames):
    return np.concatenate(list(ps), axis=1)[:, :frames]


def config8_small(duration=2.0, n_tracks=4):
    """The JAX package's benchmark config 8 (``benchmarks/run_all.py:509-``)
    at a few tracks and seconds: a two-band EQ per track, a volume lane, a
    master highpass at 25 Hz."""
    s = make_demo_session(n_tracks=n_tracks, duration_seconds=duration, sample_rate=48000, seed=2, fades=True)
    beats = duration / s.beat_duration
    for i, tr in enumerate(s.tracks):
        tr.effects = jfx.EffectChain([jfx.ParametricEQ([
            ("lowshelf", 100.0, 0.707, 2.0), ("peak", 1000.0 + 37.0 * i, 1.0, -1.5)])])
        tr.automation = JaxAutomation(volume=JaxLane().add(0.0, 1.0).add(beats, 0.6))
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0)])
    return s


@pytest.fixture(scope="module")
def jax_config8():
    js = config8_small()
    return js, np.concatenate(list(JaxPreview(js, 48000.0, buffer_size=512, lookahead_blocks=8)), axis=1)


@pytest.mark.parametrize("lookahead", [64, 3])
def test_blocks_match_bounce(lookahead):
    s = make_session()
    full = bounce(s, 32768.0, buffer_size=256, device="cpu").audio
    blocks = list(_stream(s, lookahead_blocks=lookahead))
    assert len(blocks) == -(-full.shape[1] // 256)
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1)[:, :full.shape[1]], full)


def test_seek_serves_the_bounce_at_the_new_frame():
    s = make_session()
    ps = _stream(s, lookahead_blocks=4)
    ps.next_block()
    assert ps.window_frames > 0
    ps.seek(0.5)  # beat 0.5 @60bpm/32768 = frame 16384
    assert ps.position_frames == 16384 and ps.window_frames == 0
    b = ps.next_block()
    assert b.shape == (2, 256)
    full = bounce(s, 32768.0, buffer_size=256, device="cpu").audio
    np.testing.assert_array_equal(b, full[:, 16384:16384 + 256])
    assert ps.position_beats == pytest.approx((16384 + 256) / 32768.0)


def test_memory_bounded_by_lookahead():
    s = make_session()
    ps = _stream(s, lookahead_blocks=4)
    assert ps.window_frames == 0  # nothing rendered before the first pull
    assert all(ps.next_block() is not None for _ in range(8))
    assert ps.window_frames == 4 * 256  # the resident window never exceeds the lookahead
    assert ps.total_frames > 4 * 256 * 4


def test_lookahead_rounds_to_param_blocks():
    """Windows stay whole multiples of lcm(buffer_size, 512)."""
    s = make_session()
    assert _stream(s, buffer_size=384, lookahead_blocks=3).lookahead == 1536
    assert _stream(s, buffer_size=256, lookahead_blocks=3).lookahead == 1024


@pytest.mark.parametrize("mode", ["catmull", "sinc"])
def test_quality_interpolation_modes(mode):
    """The preview carries the Catmull-Rom and oversampled-sinc forms of
    ``bounce(prerender=False)``."""
    s = from_reference(random_session(71, rate=48000, bpm=120.0, n_tracks=2, n_clips=2,
                                      speeds=(44100.0 / 48000.0,), src_rates=(44100,)))
    full = bounce(s, 48000.0, buffer_size=512, interpolation=mode, prerender=False, device="cpu").audio
    joined = _joined(_stream(s, 48000.0, buffer_size=512, lookahead_blocks=8, interpolation=mode),
                     full.shape[1])
    assert np.abs(joined.astype(np.float64) - full).max() < 3e-6


def test_edit_during_preview_matches_fresh_render():
    s = make_session()
    ps = _stream(s, lookahead_blocks=4)
    [ps.next_block() for _ in range(6)]  # playing...
    # edit mid-playback: move the clip later and drop its gain
    s.tracks[0].clips[0].audio.gain = 0.5
    s.tracks[0].clips[0].min_time += 0.05
    s.tracks[0].clips[0].max_time += 0.05
    post = np.concatenate([ps.next_block() for _ in range(6)], axis=1)
    ref = OracleRenderer(s, 32768.0, buffer_size=256).render()
    start = 6 * 256
    n = min(post.shape[1], ref.shape[1] - start)
    np.testing.assert_array_equal(post[:, :n], ref[:, start:start + n])


def test_note_param_and_lane_edits_change_stamp():
    from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer

    s = make_session()
    stamps = [s.edit_stamp()]
    buf = MidiNoteBuffer([MidiNote(0.0, 0.25, key=60, velocity=0.5)])
    s.add_midi_clip(s.add_track("keys"), "m", 0.0, 0.5, asset=s.midi_table.create_midi(buf))
    stamps.append(s.edit_stamp())
    buf.add_note(MidiNote(0.25, 0.5, key=64, velocity=0.6))
    stamps.append(s.edit_stamp())
    s.tracks[0].volume_db = -6.0
    stamps.append(s.edit_stamp())
    s.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0))
    stamps.append(s.edit_stamp())
    s.tracks[0].automation.volume.add(0.5, 0.2)  # point edit, same object
    stamps.append(s.edit_stamp())
    assert len(set(stamps)) == len(stamps)


def test_config8_matches_bounce_and_jax_preview(jax_config8):
    """EQ chains, volume lanes and a master highpass: the linear finisher's
    state carries across windows (the cascade kernel on the card)."""
    js, jax_joined = jax_config8
    s = from_reference(js)
    full = bounce(s, 48000.0, device="cpu").audio
    joined = _joined(_stream(s, 48000.0, buffer_size=512, lookahead_blocks=8), full.shape[1])
    assert rel_rms(joined, full) < 1e-5
    assert rel_rms(joined, jax_joined[:, :full.shape[1]]) < 5e-5


def test_generic_chain_matches_bounce():
    js = random_session(44, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    js.tracks[1].effects = jfx.EffectChain([jfx.Biquad("lowpass", 5000.0), jfx.Delay(0.01, 0.3)])
    s = from_reference(js)
    full = bounce(s, 48000.0, device="cpu").audio
    joined = _joined(_stream(s, 48000.0, buffer_size=512, lookahead_blocks=16), full.shape[1])
    assert rel_rms(joined, full) < 1e-5


def test_routed_session_matches_bounce():
    s = from_reference(_jax_case())
    from tests.test_torch_routing import RATE as ROUTED_RATE

    full = bounce(s, ROUTED_RATE, device="cpu").audio
    joined = _joined(_stream(s, ROUTED_RATE, buffer_size=512, lookahead_blocks=16), full.shape[1])
    assert rel_rms(joined, full) < 1e-5


def test_record_while_preview_plays():
    """The punch-in flow of ``tests/test_record.py``: the finalized take
    moves the stamp and the next pull plays the session with it."""
    s = from_reference(random_session(5, rate=48000, bpm=120.0, n_tracks=2, n_clips=2))
    rec_track = s.add_track("rec", volume_db=0.0)
    ps = _stream(s, 48000.0, lookahead_blocks=4)
    take = s.start_recording(rec_track, 48000.0, at_beat=0.0)
    rng = np.random.default_rng(7)
    recorded = []
    for _ in range(24):  # interleave: play a block, record a block
        assert ps.next_block() is not None
        recorded.append(rng.standard_normal((2, 256)).astype(np.float32) * 0.25)
        take.append(recorded[-1])
    clip = take.finalize()
    np.testing.assert_array_equal(np.stack(clip.audio.asset.sample.data), np.concatenate(recorded, axis=1))
    pos = ps.position_frames
    blk = ps.next_block()
    assert ps._stamp == s.edit_stamp()
    full = bounce(s, 48000.0, buffer_size=256, device="cpu").audio
    np.testing.assert_array_equal(blk, full[:, pos:pos + 256])
