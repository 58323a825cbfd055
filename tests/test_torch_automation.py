"""The port's automation lanes (K3) against the JAX package's (CPU).

The lane tables the port packs must equal the JAX package's array for
array (``np.array_equal``), under a tempo map too, or every later
comparison drifts. The plain PyTorch lane sweep (``eval_lanes``) and the
plain automation mix (``mix_auto_reference``, the CUDA kernel's twin) are
held to the JAX package's automation-kernel contract, ``atol=3e-6,
rtol=1e-5`` (``tests/test_auto_kernel.py``): ``sin``/``exp``/``exp2``/
``pow`` differ by ulps between XLA, torch and CUDA, and XLA:CPU may fuse a
lerp into an FMA. Tracks without lanes stay bit-equal. Against the f64
host reference the bar is relative RMS < 1e-5
(``tests/test_fades_automation.py``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import rel_rms
from tests.test_auto_kernel import _auto_session
from whitebox_tpu.ops import automation as jax_automation
from whitebox_tpu.ops.automation import AutomationLane, CurveType, TrackAutomation
from whitebox_tpu.ops.mix_pallas import PallasMixRenderer
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.render.effects_pipeline import prepare_automation_tables_host as jax_tables_host
from whitebox_tpu.render.effects_pipeline import reference_finish_mix as jax_reference_finish_mix
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu.timeline.carve import render_segments_per_track_numpy
from whitebox_tpu_torch.ops import automation, mix_cuda
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.effects_pipeline import (
    prepare_automation_tables_host, reference_finish_mix,
)
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session

RATE = 48000.0
ATOL, RTOL = 3e-6, 1e-5


def tempo_auto_session():
    """Lanes under a piecewise tempo map (the JAX package's config 7 shape)."""
    s = _auto_session(seed=11, curves=True)
    s.set_tempo_point(1.0, 90.0, curve="linear", bpm_end=140.0)
    s.set_tempo_point(3.5, 128.0)
    return s


SESSIONS = {
    "linear": lambda: _auto_session(),
    "curves": lambda: _auto_session(curves=True),
    "fades": lambda: _auto_session(seed=5, fades=True),
    "tempo_mapped": tempo_auto_session,
}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_lane_tables_equal_jax(name):
    js = SESSIONS[name]()
    s = from_reference(js)
    assert (js.tempo_map is not None) == (name == "tempo_mapped")
    mine, theirs = automation.pack_session_automation(s, RATE), jax_automation.pack_session_automation(js, RATE)
    for a, b in zip(mine[:2], theirs[:2]):
        for k in ("xs", "ys", "cv", "tn"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert np.array_equal(mine[2], theirs[2])
    host, jhost = prepare_automation_tables_host(s, RATE), jax_tables_host(js, RATE)
    assert np.array_equal(host[3], jhost[3]) and host[3].dtype == jhost[3].dtype
    for a, b in zip(host[:2], jhost[:2]):
        assert all(np.array_equal(a[k], b[k]) for k in ("xs", "ys", "cv", "tn"))


def _curve_lane(curve: CurveType, tension: float) -> dict:
    """One lane per tension sign: a rise under ``curve`` then a fall, with
    a point before frame 0 and sentinel padding after the last point."""
    lanes = [AutomationLane().add(-0.25, 0.1).add(0.5, 0.9, curve=curve, tension=t).add(1.5, 0.2)
             .add(2.0, 0.6, curve=curve, tension=-t) for t in (tension, -tension)]
    lanes.append(AutomationLane().add(0.0, 0.5))
    return jax_automation.pack_lane_tables(lanes, [0.0] * len(lanes), RATE, 0.5)


@pytest.mark.parametrize("curve", list(CurveType), ids=[c.name for c in CurveType])
def test_eval_lanes_matches_jax_sweep(curve):
    import jax.numpy as jnp

    for tension in (0.0, 0.004, 0.7, 2.5):
        tables = _curve_lane(curve, tension)
        g = np.arange(-200, 2 * 24000 + 300, 7, dtype=np.int32)
        ref = np.asarray(jax_automation.eval_lanes_device({k: jnp.asarray(v) for k, v in tables.items()},
                                                          jnp.asarray(g)))
        got = automation.eval_lanes({k: torch.from_numpy(v) for k, v in tables.items()},
                                    torch.from_numpy(g)).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=f"tension {tension}")
        # past the last point the sweep holds the last segment's lerp at
        # u=1, ys[P-2] + (ys[P-1]-ys[P-2]) in f32, which need not be ys[P-1];
        # a one-point lane holds ys[0] (u=0 against the sentinel)
        ys = tables["ys"]
        np.testing.assert_array_equal(got[:2, -1], ys[:2, -2] + (ys[:2, -1] - ys[:2, -2]))
        assert got[2, -1] == ys[2, 0]


def test_pan_coef_is_the_constant_power_law():
    from whitebox_tpu.core.panning import PanningLaw, calculate_panning_coefs

    pans = np.linspace(-1, 1, 41).astype(np.float32)
    for ch in (0, 1):
        got = automation.pan_coef(torch.from_numpy(pans), ch).numpy()
        want = [float(calculate_panning_coefs(float(p), PanningLaw.CONSTANT_POWER_3DB)[ch]) for p in pans]
        np.testing.assert_allclose(got, want, atol=2e-6)
        np.testing.assert_allclose(got, jax_automation.pan_coef_f32(pans, ch), atol=ATOL, rtol=RTOL)


def _renderers(js, tile=2048):
    """The JAX Pallas renderer (interpret mode) and the port's renderer on
    the same session, each from its own carve and lane tables."""
    jt, jp = jax_carve_session(js, RATE, buffer_size=512, slow_emit="runs")
    jr = PallasMixRenderer(jt, jp, js, tile=tile, interpret=True, auto_tables=jax_tables_host(js, RATE))
    s = from_reference(js)
    t, p = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(t, p, s, device="cpu", tile=tile,
                                 auto_tables=prepare_automation_tables_host(s, RATE))
    return jr, r


@pytest.mark.parametrize("name", ["linear", "curves", "fades"])
def test_mix_auto_reference_matches_pallas(name):
    jr, r = _renderers(SESSIONS[name]())
    p = r.plan
    got = mix_cuda.mix_auto_reference(r.pool_device, r.tables, r.auto, p.n_tiles, p.tile, p.channels)
    ref = np.asarray(jr.render_device()).reshape(p.channels, -1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert np.abs(ref).max() > 0.05


def test_non_automated_tracks_stay_bit_exact():
    """test_auto_kernel.py's pattern on the port: muted automated tracks
    through the automation path leave the constant-gain track's render
    bit-equal to the plain path and to the JAX kernel's."""
    js = _auto_session(seed=7, n_tracks=3)
    for tr in js.tracks[:-1]:
        tr.mute = True
    plain = _auto_session(seed=7, n_tracks=3)
    for tr in plain.tracks[:-1]:
        tr.mute, tr.automation = True, None
    before = (mix_cuda.mix_kernel_launches, mix_cuda.mix_auto_launches)
    a = bounce(from_reference(js), RATE, device="cpu").audio
    b = bounce(from_reference(plain), RATE, device="cpu").audio
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jax_bounce(plain, RATE, engine="pallas", chunk_frames=8192).audio)
    assert np.abs(a).max() > 0.01
    assert (mix_cuda.mix_kernel_launches, mix_cuda.mix_auto_launches) == before  # no launch on the CPU


@pytest.mark.parametrize("name", list(SESSIONS))
def test_bounce_matches_jax_and_f64_reference(name):
    js = SESSIONS[name]()
    got = bounce(from_reference(js), RATE, device="cpu").audio
    ref = jax_bounce(js, RATE, engine="pallas", chunk_frames=8192).audio
    n = min(got.shape[1], ref.shape[1])
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    jt, jp = jax_carve_session(js, RATE, buffer_size=512)
    f64 = jax_reference_finish_mix(render_segments_per_track_numpy(jt, jp), js, RATE)
    assert got.shape == f64.shape and rel_rms(got, f64) < 1e-5


def test_reference_finish_mix_equals_jax():
    js = _auto_session(curves=True)
    jt, jp = jax_carve_session(js, RATE, buffer_size=512)
    per_track = render_segments_per_track_numpy(jt, jp)
    np.testing.assert_array_equal(reference_finish_mix(per_track, from_reference(js), RATE),
                                  jax_reference_finish_mix(per_track, js, RATE))


@pytest.mark.parametrize("what", ["effect_lane_only", "master_automation"])
def test_effect_and_master_lanes_still_raise(what):
    js = _auto_session()
    if what == "effect_lane_only":
        js.tracks[-1].automation = TrackAutomation(effects={(0, "gain_db"): AutomationLane().add(0.0, 0.5)})
    else:
        js.master_automation = {(0, "gain_db"): AutomationLane().add(0.0, 0.5)}
    # the time-varying biquad half and the generic pipeline are item 6
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 6"):
        bounce(from_reference(js), RATE, device="cpu")


def test_auto_dispatch_and_table_checks_on_cpu():
    _, r = _renderers(_auto_session(seed=9))
    p = r.plan
    args = (r.pool_device, r.tables, r.auto, p.n_tiles, p.tile, p.channels)
    np.testing.assert_array_equal(
        mix_cuda.mix(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, auto=r.auto).numpy(),
        mix_cuda.mix_auto_reference(*args).numpy())
    before = mix_cuda.mix_auto_launches
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_auto_cuda(*args)
    assert mix_cuda.mix_auto_launches == before
    for bad in (dict(r.auto, vys=r.auto["vys"].to(torch.float64)),
                dict(r.auto, use=r.auto["use"][:-1].contiguous()),
                dict(r.auto, pxs=r.auto["pxs"][:, :1].contiguous())):
        with pytest.raises(ValueError, match="lane table"):
            mix_cuda.mix_auto_reference(r.pool_device, r.tables, bad, p.n_tiles, p.tile, p.channels)
