"""whitebox_tpu_torch's roofline cost model, the card's peaks and the carve's
native switch (CPU).

``estimate_bounce_cost`` must give the JAX package's terms, term by term,
for the same session and carve: the port's ``RenderStats.cost`` holds the
bytes and operations a render needs, whatever the device. The peaks are
the card's own; off the card there are none and ``roofline_fraction`` is
NaN, never a fraction of a TPU figure.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
from tests.test_carve import random_session
from tests.test_torch_mix_plan import make_case
from whitebox_tpu.render.demo import make_demo_session as jax_demo
from whitebox_tpu.render.roofline import estimate_bounce_cost as jax_estimate
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu_torch.render import roofline
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline import carve as carve_mod
from whitebox_tpu_torch.timeline import carve_native

RATE = 48000.0


def _sessions():
    def headline():
        return jax_demo(n_tracks=4, duration_seconds=2.0, sample_rate=48000, seed=7, sample_seconds=1.0)

    def resampled():
        return jax_demo(n_tracks=4, duration_seconds=2.0, sample_rate=48000, seed=7, sample_seconds=1.0,
                        clip_speeds=(1.0, 44100 / 48000))

    def linear_fx():
        s = headline()
        for i, t in enumerate(s.tracks):
            t.effects = jfx.EffectChain([jfx.ParametricEQ([("peak", 1000.0 + 37.0 * i, 1.0, -1.5)])])
        s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0)])
        return s

    def generic_fx():
        s = headline()
        s.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-18.0, 3.0), jfx.Saturator(4.0)])
        s.tracks[1].effects = jfx.EffectChain([jfx.ConvolutionReverb(None, room_seconds=0.3),
                                               jfx.Delay(0.1, 0.3)])
        s.tracks[2].effects = jfx.EffectChain([jfx.LinearPhaseEQ([("peak", 900.0, 1.0, 3.0)], taps=255),
                                               jfx.Chorus()])
        s.master_effects = jfx.EffectChain([jfx.Limiter(-0.5)])
        return s

    return {"headline": headline, "resampled": resampled, "linear_fx": linear_fx, "generic_fx": generic_fx}


@pytest.mark.parametrize("name", list(_sessions()))
def test_estimate_bounce_cost_equals_jax(name):
    js = _sessions()[name]()
    s = from_reference(js)
    jt, _ = jax_carve(js, RATE, buffer_size=512, slow_emit="runs")
    pt, _ = carve_mod.carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    want = jax_estimate(jt, js, jt.total_frames, 2)
    got = roofline.estimate_bounce_cost(pt, s, pt.total_frames, 2)
    assert got.terms == want.terms
    assert (got.hbm_bytes, got.mxu_flops) == (want.hbm_bytes, want.mxu_flops)
    if name == "generic_fx":
        assert got.mxu_flops > 0 and {"fx.convreverb", "fx.linphase", "fx.compressor"} <= set(got.terms)


def test_bounce_cost_with_prerender_equals_jax():
    """A sinc bounce adds the prerender's banded products to the mix terms
    of the rewritten table: the term equals the JAX package's for the same
    host plan; on the CPU the fraction is NaN."""
    from whitebox_tpu.render.roofline import prerender_cost as jax_prerender_cost
    from whitebox_tpu.timeline.prerender import plan_prerender as jax_plan
    from whitebox_tpu_torch.timeline.prerender import plan_prerender

    js, rate, _ = make_case("mixed_speeds")
    s = from_reference(js)
    jt, jp = jax_carve(js, rate, buffer_size=512, slow_emit="runs")
    pt, pp = carve_mod.carve_session(s, rate, buffer_size=512, slow_emit="runs")
    want = jax_prerender_cost(jax_plan(jt, jp, partial=True)).terms
    assert roofline.prerender_cost(plan_prerender(pt, pp, partial=True)).terms == want
    got = bounce(s, rate, device="cpu", interpolation="sinc").stats
    assert got.cost.terms["prerender.einsum"] == want["prerender.einsum"]
    assert got.peaks is None and np.isnan(got.roofline_fraction)
    assert "roofline" not in got.summary()


def test_roofline_fraction_is_nan_off_the_card_and_uses_the_cards_peaks():
    res = bounce(from_reference(random_session(3, rate=48000, bpm=120.0, n_tracks=2)), RATE, device="cpu")
    assert res.stats.cost is not None and res.stats.cost.hbm_bytes > 0
    assert np.isnan(res.stats.roofline_fraction)
    assert roofline.device_peaks("cpu") is None
    st = res.stats
    st.peaks, st.device_seconds = (2e12, 50e12), 1e-3
    want = max(st.cost.hbm_bytes / 2e12, st.cost.mxu_flops / 50e12) / 1e-3
    assert st.roofline_fraction == pytest.approx(want)


def test_device_peaks_from_properties_or_the_data_sheet(monkeypatch):
    """The properties give the memory rate (2 x memory clock x bus width)
    and the f32 rate (2 x SM clock x SMs x 128 lanes on sm_90) where they
    have them; the data-sheet pair of the named card fills the rest; a card
    neither knows has no peaks."""
    props = {}
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props["p"])
    props["p"] = SimpleNamespace(name="NVIDIA H100 80GB HBM3", major=9, minor=0, multi_processor_count=132)
    assert roofline.device_peaks("cuda:0") == (3.35e12, 67e12) == (roofline.HBM_BYTES_PER_S,
                                                                  roofline.F32_OPS_PER_S)
    props["p"] = SimpleNamespace(name="NVIDIA H100 80GB HBM3", major=9, minor=0, multi_processor_count=132,
                                 memory_clock_rate=2619000, memory_bus_width=5120, clock_rate=1980000)
    bw, ops = roofline.device_peaks("cuda:0")
    assert bw == pytest.approx(2 * 2.619e9 * 640) and ops == pytest.approx(2 * 1.98e9 * 132 * 128)
    props["p"] = SimpleNamespace(name="Some Other Card", major=8, minor=6, multi_processor_count=80)
    assert roofline.device_peaks("cuda:0") is None


@pytest.mark.parametrize("var", ["WBTPU_NO_NATIVE_CARVE", "WBTPU_NO_NATIVE"])
def test_carve_native_switch_follows_the_environment(monkeypatch, var):
    """carve_session(native=None) takes the NumPy walk when either variable
    is set (the JAX package's rule, carve.py:512-514): the same table."""
    js, rate, _ = make_case("mixed_speeds")
    s = from_reference(js)
    native_t, _ = carve_mod.carve_session(s, rate, buffer_size=512, native=True)
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        raise AssertionError("the native carve ran")

    monkeypatch.setattr(carve_native, "carve_audio_tracks", spy)
    monkeypatch.setenv(var, "1")
    table, _ = carve_mod.carve_session(s, rate, buffer_size=512)
    assert not calls
    for f in ("track", "dst_start", "length", "src_int", "src_frac", "speed", "gain", "fast"):
        np.testing.assert_array_equal(getattr(table, f), getattr(native_t, f), err_msg=f)
    monkeypatch.delenv(var)
    with pytest.raises(AssertionError, match="native carve ran"):
        carve_mod.carve_session(s, rate, buffer_size=512)
