"""The Catmull-Rom and polynomial-tap modes of the port's mix (CPU).

``mix_reference(interp=...)`` is the plain PyTorch version of the CUDA
kernel's K2-catmull and K2-poly slots. Here it renders from the identical
plan (``plan_from_pallas``) as the JAX Pallas kernel run in interpret mode,
and is held to the NumPy segment reference; ``oversample_slow_rows`` and
``resolve_interpolation`` must give the JAX package's tables and pool
exactly.

Tolerances:
- port vs the JAX kernel and vs ``render_segments_numpy(interp=...)``:
  atol 3e-6, the JAX package's own bar (tests/test_catmull.py:28,
  tests/test_resample.py:208). The interpret-mode kernel on XLA:CPU fuses
  multiply-adds of the cubic and of the Horner chains, the port rounds
  each operation; the NumPy reference has the exact f64 phase, the port
  the double-single one;
- frames and tracks of speed-1 rows only: bit-equal in every mode;
- with an effect chain: relative RMS 1e-5 against the JAX bounce
  (tests/test_torch_bounce.py's bar for the scan finisher).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from chip_smoke import rel_rms, slow_frames
from tests.test_carve import random_session
from tests.test_torch_mix_plan import assert_plans_equal, carve_case
from whitebox_tpu.ops import mix_pallas
from whitebox_tpu.ops.automation import AutomationLane, CurveType, TrackAutomation
from whitebox_tpu.ops.resample import design_poly_interp as jax_design_poly_interp
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.render.effects_pipeline import prepare_automation_tables_host as jax_auto_tables
from whitebox_tpu.timeline import oversample as jax_oversample
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu.timeline.carve import render_segments_numpy, render_segments_per_track_numpy
from whitebox_tpu.timeline.oracle import OracleRenderer
from whitebox_tpu_torch.ops import mix_cuda, mix_plan
from whitebox_tpu_torch.ops.resample import design_poly_interp
from whitebox_tpu_torch.render.bounce import bounce as port_bounce
from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline import oversample
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.carve import render_segments_numpy as port_render_segments_numpy

ATOL = 3e-6
POLY = ("poly", design_poly_interp(4))


def resolved_case(name, mode):
    """-> (case, port table/pool, JAX table/pool, interp) with the resampled
    rows of case ``name`` resolved for ``mode`` by each package."""
    c = carve_case(name)
    if mode == "catmull":
        return c, c.table, c.pool, c.jtable, c.jpool, "catmull"
    t2, p2 = oversample.oversample_slow_rows(c.table, c.pool)
    jt2, jp2 = jax_oversample.oversample_slow_rows(c.jtable, c.jpool)
    return c, t2, p2, jt2, jp2, POLY


@pytest.mark.parametrize("name,mode", [
    ("mixed_speeds", "catmull"), ("fades_resampled", "catmull"), ("loop_reverse", "catmull"),
    ("bidirectional", "catmull"), ("mixed_speeds", "poly"), ("loop_reverse", "poly"),
    ("bidirectional", "poly")])
def test_plain_mix_matches_pallas_and_reference(name, mode):
    c, table, pool, jtable, jpool, interp = resolved_case(name, mode)
    slots = 16 if mode == "poly" else 8
    jp = mix_pallas.build_plan(jtable, jpool, c.js, tile=c.tile, max_slots=slots)
    plan = mix_plan.plan_from_pallas(jp)
    # the TPU plan rebases slow windows four samples early for the early
    # taps; the flat index it yields is still the port's own
    assert_plans_equal(plan, mix_plan.build_plan(table, pool, c.s, tile=c.tile, max_slots=slots))
    jax_out = mix_pallas.render_timeline_pallas(jtable, jpool, c.js, plan=jp, interpret=True,
                                                interp=interp)
    ref = render_segments_numpy(jtable, jpool, c.js, interp=interp)
    out = mix_cuda.render_timeline_cuda(table, pool, c.s, plan=plan, device="cpu", interp=interp)
    assert out.dtype == np.float32 and out.shape == ref.shape == jax_out.shape
    np.testing.assert_allclose(out, jax_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the port's own copy of the NumPy reference takes the same modes
    np.testing.assert_array_equal(port_render_segments_numpy(table, pool, c.s, interp=interp), ref)
    keep = ~slow_frames(table, out.shape[1])
    np.testing.assert_array_equal(out[:, keep], ref[:, keep])
    linear = mix_cuda.render_timeline_cuda(c.table, c.pool, c.s, tile=c.tile, device="cpu")
    assert np.abs(out - linear).max() > 1e-4  # the mode does change the resampled frames


@pytest.mark.parametrize("mode", ["catmull", "poly"])
def test_per_track_plain_matches_reference(mode):
    c, table, pool, jtable, jpool, interp = resolved_case("mixed_speeds", mode)
    r = mix_cuda.CudaMixRenderer(table, pool, c.s, tile=c.tile, device="cpu", interp=interp,
                                 plan=mix_plan.build_plan(table, pool, c.s, tile=c.tile, max_slots=16))
    out = r.render_device_per_track().numpy()
    ref = render_segments_per_track_numpy(jtable, jpool, interp=interp)
    np.testing.assert_allclose(out[..., : ref.shape[-1]], ref, atol=ATOL, rtol=0)
    speed1 = [t for t in range(ref.shape[0]) if table.fast[table.track == t].all()]
    for t in speed1:
        np.testing.assert_array_equal(out[t, :, : ref.shape[-1]], ref[t])


@pytest.mark.parametrize("mode", ["catmull", "poly"])
def test_automation_lanes_compose_with_interp(mode):
    # the kAuto variant's plain version takes interp too: against the JAX
    # kernel with in-kernel lanes in the same mode
    js = random_session(21, rate=48000, bpm=120.0, n_tracks=3, n_clips=2,
                        speeds=(0.5, 1.0, 1.37), src_rates=(44100, 48000))
    for i, tr in enumerate(js.tracks[:-1]):  # the last track keeps its constant gain
        vol = AutomationLane().add(0.0, 1.0).add(1.5, 0.3, curve=CurveType.EXP_SINGLE, tension=2.0)
        pan = AutomationLane().add(0.0, -0.8).add(4.0, 0.8) if i % 2 == 0 else None
        tr.automation = TrackAutomation(volume=vol.add(4.0, 0.9), pan=pan)
    s = from_reference(js)
    jtable, jpool = jax_carve_session(js, 48000.0, buffer_size=512, slow_emit="runs")
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
    assert not table.fast.all()
    interp = "catmull"
    if mode == "poly":
        table, pool = oversample.oversample_slow_rows(table, pool)
        jtable, jpool = jax_oversample.oversample_slow_rows(jtable, jpool)
        interp = POLY
    jp = mix_pallas.build_plan(jtable, jpool, js, tile=4096, max_slots=16)
    jr = mix_pallas.PallasMixRenderer(jtable, jpool, js, plan=jp, interpret=True, interp=interp,
                                      auto_tables=jax_auto_tables(js, 48000.0))
    r = mix_cuda.CudaMixRenderer(table, pool, s, plan=mix_plan.plan_from_pallas(jp), device="cpu",
                                 interp=interp, auto_tables=prepare_automation_tables_host(s, 48000.0))
    got = r.render()
    assert np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, jr.render(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("interpolation", ["catmull", "sinc"])
def test_eq_chain_composes_with_interp(interpolation):
    # the per-track mode and the scan finisher take the interpolation too
    from tests.test_torch_effects import _add_chains

    js = _add_chains(random_session(21, rate=48000, bpm=120.0, n_tracks=2, n_clips=2,
                                    speeds=(0.5, 1.0), src_rates=(44100, 48000)))
    kw = dict(interpolation=interpolation, prerender=False)
    got = port_bounce(from_reference(js), 48000.0, device="cpu", **kw).audio
    want = jax_bounce(js, 48000.0, engine="pallas", **kw).audio
    assert got.shape == want.shape
    assert rel_rms(got, want) < 1e-5
    assert rel_rms(got, port_bounce(from_reference(js), 48000.0, device="cpu").audio) > 1e-4


@pytest.mark.parametrize("interpolation", ["catmull", "sinc"])
@pytest.mark.parametrize("prerender", [None, False])
def test_speed_one_stays_bit_exact(interpolation, prerender):
    js = random_session(51, rate=48000, bpm=120.0, n_tracks=2, n_clips=2)
    oracle = OracleRenderer(js, 48000.0, buffer_size=512).render()
    res = port_bounce(from_reference(js), 48000.0, device="cpu", interpolation=interpolation,
                      prerender=prerender)
    np.testing.assert_array_equal(res.audio[:, : oracle.shape[1]], oracle)
    assert res.stats.prerender_seconds == 0.0


@pytest.mark.parametrize("name", ["mixed_speeds", "loop_reverse"])
def test_catmull_bounce_matches_jax_and_reference(name):
    c = carve_case(name)
    got = port_bounce(c.s, c.rate, device="cpu", interpolation="catmull").audio
    want = jax_bounce(c.js, c.rate, engine="pallas", interpolation="catmull").audio
    ref = render_segments_numpy(c.jtable, c.jpool, c.js, interp="catmull")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows", ["all", "some"])
@pytest.mark.parametrize("name", ["mixed_speeds", "bidirectional"])
def test_oversample_slow_rows_equals_jax(name, rows):
    c = carve_case(name)
    pick = None
    if rows == "some":
        pick = np.nonzero(~c.table.fast)[0][::2]
    t2, p2 = oversample.oversample_slow_rows(c.table, c.pool, rows=pick)
    jt2, jp2 = jax_oversample.oversample_slow_rows(c.jtable, c.jpool, rows=pick)
    for f in ("track", "dst_start", "length", "sample_id", "src_int", "src_frac", "speed", "gain",
              "fast", "clamp", "fin_start", "fin_inv", "fout_end", "fout_inv"):
        np.testing.assert_array_equal(getattr(t2, f), getattr(jt2, f), err_msg=f)
    np.testing.assert_array_equal(p2.data, jp2.data)
    for f in ("channel_base", "counts", "rates"):
        np.testing.assert_array_equal(getattr(p2, f), getattr(jp2, f), err_msg=f)
    assert p2.data.shape[0] > c.pool.data.shape[0] and c.pool.data.shape[0] == c.jpool.data.shape[0]


@pytest.mark.parametrize("interpolation", ["linear", "catmull", "sinc", "cubic"])
def test_resolve_interpolation_equals_jax(interpolation):
    c = carve_case("mixed_speeds")
    if interpolation == "cubic":
        with pytest.raises(ValueError, match="interpolation"):
            oversample.resolve_interpolation(c.table, c.pool, interpolation)
        return
    t2, p2, interp = oversample.resolve_interpolation(c.table, c.pool, interpolation)
    jt2, jp2, jinterp = jax_oversample.resolve_interpolation(c.jtable, c.jpool, interpolation)
    assert interp == jinterp
    np.testing.assert_array_equal(t2.speed, jt2.speed)
    np.testing.assert_array_equal(p2.data, jp2.data)
    if interpolation == "sinc":
        assert interp == ("poly", jax_design_poly_interp(4)) and p2 is not c.pool
    # a table of speed-1 rows keeps the linear kernel in every mode
    f = carve_case("fast")
    assert oversample.resolve_interpolation(f.table, f.pool, interpolation)[2] == "linear"


def test_device_pool_cache_is_keyed_by_content_and_device_and_bounded():
    c = carve_case("mixed_speeds")
    oversample._DEVICE_POOL_CACHE.clear()
    a = oversample.device_pool_cached(c.pool, torch.device("cpu"))
    assert a.dtype == torch.float32 and a.dim() == 1 and a.shape[0] == c.pool.data.shape[0]
    assert oversample.device_pool_cached(c.pool, "cpu") is a
    assert [k[2] for k in oversample._DEVICE_POOL_CACHE] == ["cpu"]
    _, p2 = oversample.oversample_slow_rows(c.table, c.pool)
    assert oversample.device_pool_cached(p2, "cpu") is not a
    for i in range(oversample._DEVICE_POOL_CACHE_MAX + 2):
        oversample.device_pool_cached(replace(c.pool, data=c.pool.data + np.float32(i + 1)), "cpu")
    assert len(oversample._DEVICE_POOL_CACHE) == oversample._DEVICE_POOL_CACHE_MAX
    assert oversample.device_pool_cached(c.pool, "cpu") is not a  # evicted, uploaded anew


def test_interp_is_validated():
    c = carve_case("mixed_speeds")
    nine_taps = ("poly", tuple((1.0, 0.0) for _ in range(9)))
    nine_coeffs = ("poly", tuple(tuple(0.1 for _ in range(9)) for _ in range(4)))
    ragged = ("poly", ((1.0, 0.0), (1.0,)))
    for bad in ("cubic", "sinc", ("poly",), ("spline", POLY[1]), nine_taps, nine_coeffs, ragged, None):
        with pytest.raises(ValueError, match="interp"):
            mix_cuda.CudaMixRenderer(c.table, c.pool, c.s, tile=c.tile, device="cpu", interp=bad)
    r = mix_cuda.CudaMixRenderer(c.table, c.pool, c.s, tile=c.tile, device="cpu")
    p = r.plan
    with pytest.raises(ValueError, match="interp"):
        mix_cuda.mix(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, interp="cubic")
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, interp="catmull")
    assert mix_plan.interp_taps("linear") == (0, 1) and mix_plan.interp_taps("catmull") == (-1, 2)
    assert mix_plan.interp_taps(POLY) == (-2, 3)
    assert mix_cuda.interp_launches == {"linear": 0, "catmull": 0, "poly": 0}  # no card here


def test_two_poly_tables_render_differently():
    # the coefficients are data of the launch, not a cached configuration
    c, table, pool, _, _, _ = resolved_case("mixed_speeds", "poly")
    plan = mix_plan.build_plan(table, pool, c.s, tile=c.tile, max_slots=16)
    other = ("poly", tuple(tuple(v * 0.5 for v in row) for row in POLY[1]))
    a = mix_cuda.render_timeline_cuda(table, pool, c.s, plan=plan, device="cpu", interp=POLY)
    b = mix_cuda.render_timeline_cuda(table, pool, c.s, plan=plan, device="cpu", interp=other)
    a2 = mix_cuda.render_timeline_cuda(table, pool, c.s, plan=plan, device="cpu", interp=POLY)
    np.testing.assert_array_equal(a, a2)
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("mode,margin", [("linear", 1), ("catmull", 2), ("poly", 3)])
def test_check_pool_bounds_widens_to_the_taps(mode, margin):
    # a forward slow slot whose phase starts at pool index `margin`: the
    # earliest tap (ix, ix-1, ix-2) and one sample of phase rounding are
    # in range, and one index lower they are not
    c = carve_case("mixed_speeds")
    plan = mix_plan.build_plan(c.table, c.pool, c.s, tile=c.tile)
    fwd = (plan.me > plan.ms) & (plan.is_slow == 1) & (plan.sspeed_hi > 0)
    assert fwd.any()
    interp = POLY if mode == "poly" else mode
    plan.me[~fwd] = plan.ms[~fwd]  # keep the forward resampled slots only
    plan.src_start[:] = plan.src_start - plan.src_start[fwd].min() + margin
    mix_plan.check_pool_bounds(plan, c.pool.data.shape[0], interp)
    plan.src_start[:] -= 1
    with pytest.raises(ValueError, match="outside"):
        mix_plan.check_pool_bounds(plan, c.pool.data.shape[0], interp)
