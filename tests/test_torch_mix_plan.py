"""whitebox_tpu_torch.ops.mix_plan against whitebox_tpu.ops.mix_pallas's plan (CPU).

The port's plan, built from the port's own carve of the session carried
across by ``from_reference``, must equal the JAX plan of the JAX carve
field for field, with the TPU's aligned window pair collapsed to one
absolute pool index: ``src_start == row_al*128 + delta``. The session cases
here are shared by the other ``test_torch_*`` files.
"""

from typing import NamedTuple

import numpy as np
import pytest

from tests.test_carve import random_session
from tests.test_loop_modes import RATE as LOOP_RATE
from tests.test_loop_modes import _mode_session
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.ops import mix_pallas
from whitebox_tpu.render.demo import make_demo_session
from whitebox_tpu.session import Session
from whitebox_tpu.session.clip import ClipMode
from whitebox_tpu.session.sample import Sample
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu_torch.ops import mix_plan
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session

SPEED1_CASES = ["fast", "i16_i24_clamp", "fades"]
SLOW_CASES = ["mixed_speeds", "fades_resampled", "loop_reverse", "bidirectional"]
CASES = SPEED1_CASES + SLOW_CASES


def make_case(name):
    """-> (JAX-package session, sample_rate, tile) for a named small session."""
    if name == "fast":
        return random_session(3, rate=48000, bpm=133.7, n_tracks=3, n_clips=2), 48000.0, 1024
    if name == "i16_i24_clamp":
        return random_session(4, rate=48000, bpm=120.0, n_tracks=3, n_clips=2,
                              formats=(AudioFormat.I16, AudioFormat.I24)), 48000.0, 1024
    if name == "fades":
        return make_demo_session(n_tracks=3, duration_seconds=3.0, sample_seconds=1.0, seed=2,
                                 n_unique_samples=3, fades=True), 48000.0, 2048
    if name == "mixed_speeds":
        return random_session(21, rate=48000, bpm=120.0, n_tracks=3, n_clips=2,
                              speeds=(0.5, 1.0, 1.37), src_rates=(44100, 48000)), 48000.0, 2048
    if name == "fades_resampled":
        return make_demo_session(n_tracks=3, duration_seconds=3.0, sample_seconds=1.0, seed=3,
                                 n_unique_samples=3, fades=True,
                                 clip_speeds=(1.0, 44100 / 48000, 0.5, 1.37)), 48000.0, 2048
    if name == "loop_reverse":
        return _mode_session(ClipMode.LOOP_REVERSE, speed=0.75), LOOP_RATE, 1024
    if name == "bidirectional":
        return _mode_session(ClipMode.LOOP_BIDIRECTIONAL, speed=1.3, start_offset=700.0), LOOP_RATE, 1024
    raise KeyError(name)


class Case(NamedTuple):
    """A named session carved by both packages (``slow_emit="runs"``)."""

    s: object  # the port's session, from_reference(js)
    rate: float
    tile: int
    table: object  # the port's carve
    pool: object
    js: object  # the JAX package's session
    jtable: object  # the JAX package's carve
    jpool: object


def carve_case(name) -> Case:
    js, rate, tile = make_case(name)
    s = from_reference(js)
    table, pool = carve_session(s, rate, buffer_size=512, slow_emit="runs")
    jtable, jpool = jax_carve_session(js, rate, buffer_size=512, slow_emit="runs")
    return Case(s, rate, tile, table, pool, js, jtable, jpool)


def dense_session():
    """One track, 12 short clips at distinct speeds within ~1.2 s: runs
    cannot merge, so a 32768-frame tile needs 12 slots (the JAX package's
    tests/test_bounce.py::TestAutoTileBackoff session). A JAX-package
    session: ``from_reference`` carries it to the port."""
    rng = np.random.default_rng(42)
    s = Session(bpm=120.0)
    data = (rng.standard_normal((1, 4000)) * 0.3).astype(np.float32)
    asset = s.sample_table.add_sample(Sample.from_planar(data, 48000, AudioFormat.F32, name="d"), key="d")
    tr = s.add_track("t0")
    pos = 0.0
    for c in range(12):
        s.add_audio_clip(tr, f"c{c}", pos, pos + 0.08, start_offset=0.0, asset=asset,
                         speed=0.9 + 0.017 * c)
        pos += 0.1
    return s


def assert_plans_equal(a, b):
    for f in ("src_start", "track_gain") + mix_plan.SLOT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("n_tiles", "tile", "num_tracks", "channels", "total_frames"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", CASES)
def test_plan_matches_jax(name):
    c = carve_case(name)
    tile, pool = c.tile, c.pool
    assert c.table.fast.all() == (name in SPEED1_CASES)
    jp = mix_pallas.build_plan(c.jtable, c.jpool, c.js, tile=tile)
    tp = mix_plan.build_plan(c.table, pool, c.s, tile=tile)
    for f in mix_plan.SLOT_FIELDS + ("track_gain",):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
        assert getattr(tp, f).dtype == getattr(jp, f).dtype, f
    for f in ("n_tiles", "tile", "num_tracks", "channels", "total_frames"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.src_start, jp.row_al.astype(np.int64) * 128 + jp.delta)
    assert tp.src_start.dtype == np.int32
    mix_plan.check_pool_bounds(tp, pool.data.shape[0])
    # each case exercises what its name says
    act = tp.me > tp.ms
    feature = {"i16_i24_clamp": tp.clampf[act] == 1, "fades": tp.fin_inv[act] != 1,
               "fades_resampled": (tp.fout_inv[act] != 1) & (tp.is_slow[act] == 1),
               "loop_reverse": tp.sspeed_hi[act] < 0, "bidirectional": tp.sspeed_hi[act] < 0}
    assert feature.get(name, act[act]).any()


@pytest.mark.parametrize("name", CASES)
def test_plan_from_pallas_is_own_plan(name):
    c = carve_case(name)
    jp = mix_pallas.build_plan(c.jtable, c.jpool, c.js, tile=c.tile)
    assert_plans_equal(mix_plan.plan_from_pallas(jp),
                       mix_plan.build_plan(c.table, c.pool, c.s, tile=c.tile))


def test_reverse_slots_anchor_at_phase_origin():
    # the JAX plan aligns reverse windows at the lowest touched index; the
    # flat anchor must still be channel_base + src_i (the phase origin)
    s, _, tile, table, pool = carve_case("loop_reverse")[:5]
    tp = mix_plan.build_plan(table, pool, s, tile=tile)
    slow = (tp.is_slow == 1) & (tp.me > tp.ms)
    assert slow.any() and (tp.sspeed_hi[slow] < 0).all()
    runs = mix_plan._merge_slow_runs_soa(table)
    base = pool.channel_base[runs["sid"], 0].astype(np.int64)
    x0 = runs["x0"]
    # every reverse slot's anchor lies within its run's source span
    lo = (base + np.floor(x0 + (runs["end"] - runs["d0"]) * runs["speed"])).min() - 2
    hi = (base + np.ceil(x0)).max() + 2
    assert lo <= tp.src_start[slow][:, 0].min() and tp.src_start[slow][:, 0].max() <= hi


class TestTileBackoff:
    def test_backoff_resolves_overflow(self):
        js = dense_session()
        s = from_reference(js)
        table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
        with pytest.raises(mix_plan.SlotOverflow):
            mix_plan.build_plan(table, pool, s, tile=mix_plan.DEFAULT_TILE)
        plan = mix_plan.build_plan(table, pool, s, tile=None)
        assert plan.tile < mix_plan.DEFAULT_TILE
        assert plan.max_slots <= 8
        jtable, jpool = jax_carve_session(js, 48000.0, buffer_size=512, slow_emit="runs")
        assert_plans_equal(plan, mix_plan.plan_from_pallas(
            mix_pallas.build_plan(jtable, jpool, js, tile=None)))

    def test_backoff_plan_renders_parity(self):
        from whitebox_tpu.timeline.carve import render_segments_numpy
        from whitebox_tpu_torch.ops.mix_cuda import render_timeline_cuda

        js = dense_session()
        s = from_reference(js)
        table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
        jtable, jpool = jax_carve_session(js, 48000.0, buffer_size=512, slow_emit="runs")
        ref = render_segments_numpy(jtable, jpool, js)
        out = render_timeline_cuda(table, pool, s, tile=None, device="cpu")
        assert out.shape == ref.shape
        assert np.abs(out.astype(np.float64) - ref).max() < 2.4e-7

    def test_overflow_below_min_tile_raises(self):
        s = from_reference(dense_session())
        table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
        with pytest.raises(mix_plan.SlotOverflow):
            mix_plan.build_plan(table, pool, s, tile=None, max_slots=1)

    def test_tile_validation(self):
        s, _, _, table, pool = carve_case("fast")[:5]
        for bad in (1000, 65536):
            with pytest.raises(ValueError):
                mix_plan.build_plan(table, pool, s, tile=bad)


def test_check_pool_bounds_rejects_out_of_range():
    s, _, tile, table, pool = carve_case("mixed_speeds")[:5]
    plan = mix_plan.build_plan(table, pool, s, tile=tile)
    mix_plan.check_pool_bounds(plan, pool.data.shape[0])
    with pytest.raises(ValueError):
        mix_plan.check_pool_bounds(plan, int(plan.src_start.max()))
    act = np.argwhere(plan.me > plan.ms)[0]
    plan.src_start[tuple(act)] = -plan.tile
    with pytest.raises(ValueError):
        mix_plan.check_pool_bounds(plan, pool.data.shape[0])
