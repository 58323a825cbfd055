"""The port's ``render/stream_pool.py`` against the JAX package's and the
port's resident gather bounce (CPU).

The cases of ``tests/test_stream_pool.py`` on the port: the window plan is
the JAX package's, window for window (the host half is a copy); a cap far
below the pool renders bit-equal to ``bounce(engine="xla")`` at speed 1
and to the JAX package's ``bounce_streamed``; resampled rows within the
window re-basing contract (3e-6); effects, automation and a routed
session within relative RMS 1e-5 of the resident bounce (the EQ stream
within 5e-5 of the JAX package's); the sinc stream
rides the host prerender and matches the resident sinc bounce (4e-6). The
sub-pool written into a staging buffer equals the JAX package's padded
sub-pool over the window's ``pool_bytes``.
"""

import numpy as np
import pytest

from chip_smoke import rel_rms
from tests.test_carve import random_session
from tests.test_torch_routing import _jax_case
from whitebox_tpu import effects as jfx
from whitebox_tpu.ops.automation import AutomationLane as JaxLane
from whitebox_tpu.ops.automation import TrackAutomation as JaxAutomation
from whitebox_tpu.render import stream_pool as jsp
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu_torch.render import stream_pool as sp
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.clip import ClipMode
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.prerender import plan_prerender, resolve_sinc_host

RATE = 48000.0


def _cap_for(pool, frac):
    return max(int(pool.data.nbytes * frac), 1 << 16)


def _streamed(s, **kw):
    return sp.bounce_streamed(s, RATE, device="cpu", **{"window_frames": 8192, **kw})


def test_speed1_bit_exact_under_cap():
    """A cap far below the pool size renders bit-equal to the resident
    gather bounce and to the JAX package's stream."""
    js = random_session(40, rate=48000, bpm=120.0, n_tracks=6, n_clips=2)
    s = from_reference(js)
    _, pool = carve_session(s, RATE, buffer_size=512)
    cap = _cap_for(pool, 0.25)
    stats = {}
    got = _streamed(s, max_pool_bytes=cap, stats=stats)
    np.testing.assert_array_equal(got, bounce(s, RATE, engine="xla", device="cpu").audio)
    np.testing.assert_array_equal(got, jsp.bounce_streamed(js, RATE, max_pool_bytes=cap, window_frames=8192))
    assert stats["windows"] > 1 and stats["pool_bytes"] > 0 and stats["host_build_s"] > 0.0


def test_windows_match_jax_and_respect_cap():
    js = random_session(41, rate=48000, bpm=120.0, n_tracks=8, n_clips=2)
    table, pool = carve_session(from_reference(js), RATE, buffer_size=512)
    jtable, jpool = jax_carve(js, RATE, buffer_size=512)
    cap = _cap_for(pool, 0.3)
    windows = sp.plan_stream_windows(table, pool, 8192, 2, cap)
    want = jsp.plan_stream_windows(jtable, jpool, 8192, 2, cap)
    assert [(w.start, w.frames, w.spans, w.pool_bytes) for w in windows] == \
        [(w.start, w.frames, w.spans, w.pool_bytes) for w in want]
    assert all(np.array_equal(a.row_idx, b.row_idx) for a, b in zip(windows, want))
    assert len(windows) > 1 and all(w.pool_bytes <= cap for w in windows)
    assert pool.data.nbytes > cap  # the cap is a real constraint


def test_window_pool_into_a_staging_buffer_matches_jax():
    js = random_session(41, rate=48000, bpm=120.0, n_tracks=8, n_clips=2)
    table, pool = carve_session(from_reference(js), RATE, buffer_size=512)
    jtable, jpool = jax_carve(js, RATE, buffer_size=512)
    cap = _cap_for(pool, 0.3)
    elems = cap // 4
    for w, jw in zip(sp.plan_stream_windows(table, pool, 8192, 2, cap),
                     jsp.plan_stream_windows(jtable, jpool, 8192, 2, cap)):
        want, want_cb = jsp._window_pool(jpool, jw, elems, 2)
        staging = np.full(elems, np.nan, dtype=np.float32)  # stale contents must not leak
        got, cb = sp._window_pool(pool, w, elems, 2, out=staging)
        assert got.shape == (w.pool_bytes // 4,) and np.shares_memory(got, staging)
        np.testing.assert_array_equal(got, want[:got.shape[0]])
        assert not want[got.shape[0]:].any()
        np.testing.assert_array_equal(cb, want_cb)
        np.testing.assert_array_equal(sp._window_pool(pool, w, elems, 2)[0], want)


def test_window_too_small_cap_raises():
    s = from_reference(random_session(42, rate=48000, bpm=120.0, n_tracks=8, n_clips=2))
    table, pool = carve_session(s, RATE, buffer_size=512)
    with pytest.raises(ValueError, match="pool bytes"):
        sp.plan_stream_windows(table, pool, 1 << 20, 2, 1 << 12)
    with pytest.raises(ValueError, match="multiple of 512"):
        _streamed(s, window_frames=1000)


def test_resampled_matches_resident():
    s = from_reference(random_session(43, rate=48000, bpm=120.0, n_tracks=4, n_clips=2,
                                      speeds=(1.0, 0.5, 1.088435374149660), src_rates=(44100.0,)))
    _, pool = carve_session(s, RATE, buffer_size=512)
    got = _streamed(s, max_pool_bytes=_cap_for(pool, 0.4))
    ref = bounce(s, RATE, engine="xla", device="cpu").audio
    # window splits re-base closed-form phases by <= 1 f64 ulp
    np.testing.assert_allclose(got, ref, atol=3e-6, rtol=0)


def _fx_session():
    js = random_session(44, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 5000.0)])
    js.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    js.tracks[1].automation = JaxAutomation(volume=JaxLane().add(0.0, 1.0).add(3.0, 0.4))
    return js


def _eq_session():
    js = random_session(44, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    for i, tr in enumerate(js.tracks):
        tr.effects = jfx.EffectChain([jfx.ParametricEQ([("lowshelf", 100.0, 0.707, 2.0),
                                                        ("peak", 1000.0 + 37.0 * i, 1.0, -1.5)])])
    js.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0)])
    return js


@pytest.mark.parametrize("case", ["eq", "generic_and_lanes", "routed"])
def test_effects_match_resident(case):
    js = {"eq": _eq_session, "generic_and_lanes": _fx_session, "routed": _jax_case}[case]()
    s = from_reference(js)
    _, pool = carve_session(s, RATE, buffer_size=512)
    got = _streamed(s, max_pool_bytes=_cap_for(pool, 0.5))
    ref = bounce(s, RATE, engine="xla", chunk_frames=8192, device="cpu").audio
    assert got.shape == ref.shape and rel_rms(got, ref) < 1e-5
    if case == "eq":
        want = jsp.bounce_streamed(js, RATE, max_pool_bytes=_cap_for(pool, 0.5), window_frames=8192)
        assert rel_rms(got, want) < 5e-5


def test_sinc_streamed_matches_resident_prerender():
    """``interpolation="sinc"`` under a pool cap rides the host prerender
    rewrite and matches the resident sinc bounce."""
    s = from_reference(random_session(44, rate=48000, bpm=120.0, n_tracks=3, n_clips=2,
                                      speeds=(0.5, 2.0 ** (1.0 / 12.0)), src_rates=(48000.0,)))
    for c in s.tracks[0].clips:
        c.audio.mode = ClipMode.LOOP_BIDIRECTIONAL
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    assert not table.fast.all() and plan_prerender(table, pool, partial=True) is not None
    ref = bounce(s, RATE, interpolation="sinc", engine="pallas", device="cpu").audio
    got = _streamed(s, interpolation="sinc", max_pool_bytes=_cap_for(pool, 0.5))
    # device ext vs host ext render differ at f32 rounding
    np.testing.assert_allclose(got, ref, atol=4e-6, rtol=0)


def test_sinc_streamed_cap_counts_ext():
    s = from_reference(random_session(45, rate=48000, bpm=120.0, n_tracks=4, n_clips=2,
                                      speeds=(147.0 / 160.0,), src_rates=(48000.0,)))
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="blocks")
    t2, p2, interp = resolve_sinc_host(table, pool)
    assert t2 is not table and interp == "linear"
    cap = _cap_for(p2, 0.3)
    assert all(w.pool_bytes <= cap for w in sp.plan_stream_windows(t2, p2, 8192, 2, cap))
