"""whitebox_tpu_torch's routed finisher (``render/routing.py``: buses,
sends, sidechain keys, bus lanes, bus PDC) and routed bounces (CPU).

Sessions are built with the JAX package and carried across by
``from_reference``; per-track buffers come from the NumPy per-track
reference of the carve, at 32768 Hz. Bars (the JAX package's own,
``tests/test_routing.py:106,121,277,466,592``, ``tests/test_pdc.py``):

- the routed finisher against the JAX ``make_routed_finisher`` and
  ``make_routed_stems_finisher``: relative RMS 1e-5 (one JAX compile for
  each form, shared by a module fixture);
- against the f64 ``reference_routed_finish``: relative RMS 2e-5 for
  chains the linear finishers could take, 5e-5 for the rest (dynamics,
  delays, sidechains, bus lanes, PDC);
- the chunked stream against one chunk: 1e-6 absolute;
- ``bounce`` on the K4 path and on the gather path against the JAX
  ``bounce``: relative RMS 1e-5, meters rtol 1e-5.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
from chip_smoke import rel_rms
from tests.test_carve import random_session
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu.render import routing as jrt
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.session.sample import Sample as JaxSample
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu.timeline.carve import render_segments_per_track_numpy
from whitebox_tpu_torch.effects import UnportedEffect
from whitebox_tpu_torch.ops.resample import full_f32_matmul
from whitebox_tpu_torch.render import routing as rt
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.effects_generic import reference_generic_finish
from whitebox_tpu_torch.render.finisher import make_finisher, run
from whitebox_tpu_torch.session.convert import from_reference

RATE = 32768.0


def _lane(*pts):
    lane = AutomationLane()
    for p in pts:
        lane.add(*p)
    return lane


def _base(seed, n_tracks, n_clips=2):
    return random_session(seed, rate=int(RATE), bpm=480.0, n_tracks=n_tracks, formats=(AudioFormat.F32,),
                          n_clips=n_clips)


def _routed(generic=False):
    """Tracks 0-1 grouped to bus 0 (EQ), track 2 post-sends to bus 1,
    track 3 pre-sends to bus 1, tracks 4-5 direct (``tests/test_routing.py``)."""
    s = _base(11, 6)
    drums = s.add_bus("drums", volume_db=-2.0, pan=0.2)
    fxb = s.add_bus("fx", volume_db=-6.0)
    drums.effects = jfx.EffectChain([jfx.ParametricEQ([("lowshelf", 120.0, 0.707, 2.5),
                                                       ("peak", 2500.0, 1.2, -2.0)])])
    if generic:
        fxb.effects = jfx.EffectChain([jfx.Delay(0.03, 0.35), jfx.Compressor(-18.0, 3.0)])
    else:
        fxb.effects = jfx.EffectChain([jfx.Biquad("highpass", 300.0), jfx.Gain(-1.5)])
    s.set_track_output(0, 0)
    s.set_track_output(1, 0)
    s.add_send(2, 1, gain_db=-3.0)
    s.add_send(3, 1, gain_db=-4.5, pre_fader=True)
    s.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 9000.0)])
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0)])
    return s


def _sidechain(gate=False, pre_fader=False):
    """Track 0 routed to a ducking bus, track 1 its key by a sidechain send."""
    s = _base(7, 2)
    duck = s.add_bus("duck")
    if gate:
        duck.effects = jfx.EffectChain([jfx.NoiseGate(-40.0, release_s=0.05, sidechain=True)])
    else:
        duck.effects = jfx.EffectChain([jfx.Compressor(-30.0, 8.0, attack_s=0.002, release_s=0.08,
                                                       sidechain=True)])
    s.set_track_output(0, 0)
    s.add_send(1, 0, gain_db=0.0, pre_fader=pre_fader, sidechain=True)
    return s


def _bus_lanes(fx_lane=False):
    """A bus fader riding volume and pan lanes (and a cutoff lane on its chain)."""
    s = _base(51, 3)
    b = s.add_bus("ride", volume_db=-2.0)
    b.effects = jfx.EffectChain([jfx.Biquad("lowpass", 4000.0)])
    s.set_track_output(0, 0)
    s.add_send(1, 0, gain_db=-3.0)
    lanes = TrackAutomation(volume=_lane((0.0, 1.0), (2.0, 0.1)), pan=_lane((0.0, -0.6), (2.0, 0.6)))
    if fx_lane:
        lanes.effects = {(0, "freq_hz"): _lane((0.0, 500.0), (2.0, 9000.0))}
    b.automation = lanes
    return s


def _fuzz(seed):
    """A random routing surface (``tests/test_routing.py::TestRoutingFuzz``)."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(3, 7))
    s = _base(seed, T)
    B = int(rng.integers(1, 4))
    for b in range(B):
        bus = s.add_bus(f"b{b}", volume_db=float(rng.uniform(-9, 3)), pan=float(rng.uniform(-0.8, 0.8)))
        kind = rng.integers(4)
        if kind == 1:
            bus.effects = jfx.EffectChain([jfx.Biquad("lowpass", float(rng.uniform(800, 12000)))])
        elif kind == 2:
            bus.effects = jfx.EffectChain([jfx.Gain(float(rng.uniform(-6, 3))),
                                           jfx.Biquad("highpass", float(rng.uniform(40, 400)))])
        elif kind == 3:
            bus.effects = jfx.EffectChain([jfx.Compressor(-25.0, 4.0, sidechain=bool(rng.random() < 0.5))])
        if rng.random() < 0.4:
            bus.automation = TrackAutomation(volume=_lane((0.0, float(rng.uniform(0.3, 1.0))),
                                                          (2.0, float(rng.uniform(0.1, 1.0)))))
    for t in range(T):
        if rng.random() < 0.5:
            s.set_track_output(t, int(rng.integers(B)))
        for _ in range(int(rng.integers(0, 3))):
            s.add_send(t, int(rng.integers(B)), gain_db=float(rng.uniform(-12, 0)),
                       pre_fader=bool(rng.random() < 0.3), sidechain=bool(rng.random() < 0.25))
    return s


def _kitchen():
    """Every routing feature at once: groups, post/pre/sidechain sends, a
    generic bus chain, a ducking bus, a bus fader lane and a bus chain
    lane, a track lane and a master chain."""
    s = _routed(generic=True)
    duck = s.add_bus("duck", volume_db=-1.0, pan=-0.3)
    duck.effects = jfx.EffectChain([jfx.Compressor(-28.0, 6.0, attack_s=0.002, release_s=0.06,
                                                   sidechain=True), jfx.Biquad("peak", 700.0, 1.0, 3.0)])
    duck.automation = TrackAutomation(volume=_lane((0.0, 0.9), (3.0, 0.4)),
                                      effects={(1, "gain_db"): _lane((0.0, -3.0), (3.0, 6.0))})
    s.set_track_output(4, 2)
    s.add_send(5, 2, gain_db=-2.0, sidechain=True)
    s.add_send(1, 2, gain_db=-6.0, pre_fader=True, sidechain=True)
    s.tracks[3].automation = TrackAutomation(volume=_lane((0.0, 1.0), (4.0, 0.3)))
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0), jfx.Limiter(-1.0, lookahead_s=0.001)])
    return s


def _jax_case():
    """The case held against the JAX package's programs (small, so that
    their compiles stay short): a ducking bus keyed by a sidechain send, a
    second bus with a lowpass, a fader lane and pan, pre- and post-fader
    sends into it, a master highpass."""
    s = _sidechain()
    ride = s.add_bus("ride", volume_db=-2.0, pan=0.25)
    ride.effects = jfx.EffectChain([jfx.Biquad("lowpass", 4000.0)])
    ride.automation = TrackAutomation(volume=_lane((0.0, 1.0), (2.0, 0.2)))
    s.add_send(0, 1, gain_db=-4.0, pre_fader=True)
    s.add_send(1, 1, gain_db=-2.0)
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0)])
    return s


SESSIONS = {
    "packable": lambda: _routed(False),
    "generic": lambda: _routed(True),
    "sidechain_compressor": _sidechain,
    "sidechain_gate": lambda: _sidechain(gate=True),
    "sidechain_pre_fader": lambda: _sidechain(pre_fader=True),
    "bus_fader_lanes": _bus_lanes,
    "bus_chain_lane": lambda: _bus_lanes(fx_lane=True),
    "fuzz101": lambda: _fuzz(101),
    "fuzz202": lambda: _fuzz(202),
    "fuzz303": lambda: _fuzz(303),
    "kitchen": _kitchen,
    "jax_case": _jax_case,
}
#: the JAX tests' bars against the f64 reference: 2e-5 for chains the
#: linear finishers take, 5e-5 otherwise
F64_BAR = {"packable": 2e-5}


def _per_track(js, channels=2):
    table, pool = jax_carve(js, RATE, buffer_size=512)
    pt = render_segments_per_track_numpy(table, pool)
    if channels > 2:
        pt = np.concatenate([pt] * (channels // 2), axis=1)
    return np.ascontiguousarray(pt, np.float32)


def _tg(s, C=2):
    return np.array([[np.float32((np.float32(0.0) if t.mute else t.volume_linear)
                                 * np.float32(t.pan_coeffs[c % 2])) for c in range(C)]
                     for t in s.tracks], np.float32)


def _auto(s):
    from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables

    return prepare_automation_tables(s, RATE)


def _finish(s, pt, chunk=4096, pdc=False, meters=False, C=2):
    fin = make_finisher("routed", s, RATE, torch.from_numpy(_tg(s, C)), chunk=chunk, pdc=pdc, meters=meters)
    res = run(fin, torch.from_numpy(pt), pt.shape[-1], valid_frames=pt.shape[-1])
    return (res.out, res.meters) if meters else res.out


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ preparation


@pytest.mark.parametrize("name", ["packable", "generic", "sidechain_compressor", "sidechain_gate",
                                  "bus_chain_lane", "fuzz101", "kitchen"])
def test_prepare_routed_fx_equals_jax(name):
    """Track and bus groups, their stage signatures and parameters, the
    routing matrices and the bus lane tables equal the JAX package's."""
    js = SESSIONS[name]()
    want = jrt.prepare_routed_fx(js, RATE, 2)
    got = rt.prepare_routed_fx(from_reference(js), RATE, 2)
    assert got.num_buses == want.num_buses and got.has_key == want.has_key
    for a in ("r_post", "r_pre", "bus_gain", "k_post", "k_pre"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a), err_msg=a)
    for gs, ws in ((got.fx.groups, want.fx.groups), (got.bus_groups, want.bus_groups),
                   ([got.fx.master] if got.fx.master else [], [want.fx.master] if want.fx.master else [])):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g.track_idx, w.track_idx)
            assert [(k, st) for k, st, _ in g.stages] == [(k, st) for k, st, _ in w.stages]
            for (_, _, gp), (_, _, wp) in zip(g.stages, w.stages):
                assert gp.keys() == wp.keys()
                for k in gp:
                    if k != "auto":
                        np.testing.assert_array_equal(gp[k], _np(wp[k]), err_msg=k)
                for n, tab in gp.get("auto", {}).items():
                    for kk, v in tab.items():
                        np.testing.assert_array_equal(v, _np(wp["auto"][n][kk]))
    if want.bus_auto is None:
        assert got.bus_auto is None
    else:
        for gd, wd in zip(got.bus_auto[:2], want.bus_auto[:2]):
            for k in wd:
                np.testing.assert_array_equal(gd[k].numpy(), _np(wd[k]), err_msg=k)
        for gt, wt in zip(got.bus_auto[2:], want.bus_auto[2:]):
            np.testing.assert_array_equal(gt.numpy(), _np(wt))


# ------------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def jax_case():
    """The JAX case's per-track buffers, the JAX routed finisher's mix and
    meters, and the JAX stems form's parts (one compile of each)."""
    js = _jax_case()
    pt = _per_track(js)
    T, C, F = pt.shape
    rfx = jrt.prepare_routed_fx(js, RATE, C)
    from whitebox_tpu.render.effects_pipeline import prepare_automation_tables as jauto

    tg = jnp.asarray(_tg(js, C))
    mixed, meters = jrt.make_routed_finisher(rfx, T, C, chunk=4096, with_meters=True, valid_frames=F)(
        jnp.asarray(pt), tg, jauto(js, RATE))
    direct, bus = jrt.make_routed_stems_finisher(rfx, T, C, chunk=4096)(jnp.asarray(pt), tg, jauto(js, RATE))
    return js, pt, _np(mixed), [_np(m) for m in meters], (_np(direct), _np(bus))


def test_routed_finisher_matches_jax(jax_case):
    js, pt, want, want_meters, _ = jax_case
    s = from_reference(js)
    got, meters = _finish(s, pt, meters=True)
    assert rel_rms(got.numpy(), want) < 1e-5 and float(np.abs(want).max()) > 0.01
    for g, w in zip(meters, want_meters):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


def test_routed_stems_finisher_matches_jax_and_sums_to_the_mix(jax_case):
    js, pt, _, _, (want_direct, want_bus) = jax_case
    s = from_reference(js)
    direct, bus = run(make_finisher("routed", s, RATE, torch.from_numpy(_tg(s)), form="stems", chunk=4096),
                      torch.from_numpy(pt), pt.shape[-1]).out
    assert bus.shape == want_bus.shape == (2, 2, pt.shape[-1])
    assert rel_rms(direct.numpy(), want_direct) < 1e-5
    assert rel_rms(bus.numpy(), want_bus) < 1e-5
    # direct + bus stems, through the master chain, is the mix (no PDC)
    from whitebox_tpu_torch.render.effects_generic import reference_run_chain
    from whitebox_tpu_torch.render.effects_pipeline import _chains_of

    total = (direct + bus[0] + bus[1]).double().numpy()
    recon = np.clip(reference_run_chain(_chains_of(s)[1], total, None, RATE, 2, s.time_base), -1, 1)
    assert rel_rms(recon, _finish(s, pt).numpy()) < 5e-5


# ----------------------------------------------------- against the f64 oracle


@pytest.mark.parametrize("name", list(SESSIONS))
def test_routed_finish_matches_f64_reference(name):
    js = SESSIONS[name]()
    s = from_reference(js)
    pt = _per_track(js)
    got = _finish(s, pt).numpy()
    ref = rt.reference_routed_finish(pt, s, RATE, 2)
    np.testing.assert_array_equal(ref, jrt.reference_routed_finish(pt, js, RATE, 2))
    assert rel_rms(got, ref) < F64_BAR.get(name, 5e-5) and float(np.abs(ref).max()) > 1e-3


def test_routed_four_channels_match_f64_reference():
    js = _routed(False)
    s = from_reference(js)
    pt = _per_track(js, channels=4)
    rfx = rt.prepare_routed_fx(s, RATE, 4)
    assert rfx.bus_gain.shape == (2, 4)
    got = _finish(s, pt, C=4).numpy()
    ref = rt.reference_routed_finish(pt, s, RATE, 4)
    assert got.shape[0] == ref.shape[0] == 4 and rel_rms(got, ref) < 2e-5


@pytest.mark.parametrize("name", ["generic", "sidechain_compressor", "bus_chain_lane"])
def test_routed_chunk_fn_equals_one_chunk(name):
    js = SESSIONS[name]()
    s = from_reference(js)
    pt = _per_track(js)
    Fc = 2048
    F = (pt.shape[-1] // Fc) * Fc
    pt = np.ascontiguousarray(pt[:, :, :F])
    tg = torch.from_numpy(_tg(s))
    one = run(make_finisher("routed", s, RATE, tg, chunk=F), torch.from_numpy(pt), F).out
    fin = make_finisher("routed", s, RATE, tg, chunk=Fc)
    states = fin.init()
    pieces = []
    for start in range(0, F, Fc):
        piece, states, _ = fin.step(torch.from_numpy(pt[:, :, start:start + Fc]), states, start)
        pieces.append(piece)
    assert float((torch.cat(pieces, dim=-1) - one).abs().max()) < 1e-6


def test_pre_fader_send_survives_mute():
    """A muted track is silent on its destination and post sends; a
    pre-fader send still feeds its bus."""
    js = _base(5, 1)
    js.tracks[0].mute = True
    js.add_bus("cue")
    pt = _per_track(js)
    assert float(np.abs(rt.reference_routed_finish(pt, from_reference(js), RATE, 2)).max()) == 0.0
    js.add_send(0, 0, gain_db=0.0, pre_fader=True)
    s = from_reference(js)
    ref = rt.reference_routed_finish(pt, s, RATE, 2)
    got = _finish(s, pt).numpy()
    assert float(np.abs(ref).max()) > 0.0 and rel_rms(got, ref) < 2e-5


@pytest.mark.parametrize("gate", [False, True], ids=["compressor", "gate"])
def test_sidechain_key_drives_the_bus(gate):
    """Removing the key send changes the bus: the detector heard the key."""
    js = _sidechain(gate=gate)
    pt = _per_track(js)
    keyed = _finish(from_reference(js), pt).numpy()
    js.tracks[1].sends = []
    unkeyed = _finish(from_reference(js), pt).numpy()
    assert rel_rms(unkeyed, keyed) > 1e-3


def test_unkeyed_sidechain_compressor_is_a_passthrough():
    """``sidechain=True`` with no key send: the detector hears silence and
    the bus passes its input (the f64 chain too)."""
    js = _base(3, 1)
    bus = js.add_bus("sc")
    bus.effects = jfx.EffectChain([jfx.Compressor(-30.0, 8.0, sidechain=True)])
    js.set_track_output(0, 0)
    s = from_reference(js)
    pt = _per_track(js)
    got = _finish(s, pt).numpy()
    flat = reference_generic_finish(pt, s, RATE, 2)  # the same session summed flat, no bus chain
    np.testing.assert_allclose(got, flat, atol=1e-7)
    assert rt.prepare_routed_fx(s, RATE, 2).has_key is False


def _click_bus_session(lookahead_s=0.004):
    """Two tracks of the same clicks, one direct and one through a bus
    whose lookahead limiter never limits (a pure delay)."""
    from whitebox_tpu.session import Session as JaxSession

    s = JaxSession(bpm=120.0)
    click = np.zeros((1, 24000), np.float32)
    for k in range(3):
        click[0, 7000 * k + 900] = 0.5
    a = s.sample_table.add_sample(JaxSample.from_planar(click, int(RATE), AudioFormat.F32, name="c"), key="c")
    t0, t1 = s.add_track("dry"), s.add_track("bused")
    s.add_audio_clip(t0, "c0", 0.0, 1.5, asset=a)
    s.add_audio_clip(t1, "c1", 0.0, 1.5, asset=a)
    bus = s.add_bus("lim")
    bus.effects = jfx.EffectChain([jfx.Limiter(12.0, lookahead_s=lookahead_s)])
    s.set_track_output(1, 0)
    return s


def test_bus_pdc_aligns_a_latent_bus():
    """Bus PDC: the latent bus path is delayed to align (here one bus, so
    the direct path waits for it) and the head trimmed; equals the f64
    reference, and the clicks sum coherently only with PDC on."""
    js = _click_bus_session()
    s = from_reference(js)
    pt = _per_track(js)
    L = int(round(0.004 * RATE))
    tg = torch.ones((2, 2))
    on, off = (run(make_finisher("routed", s, RATE, tg, chunk=4096, pdc=pdc), torch.from_numpy(pt),
                   pt.shape[-1]).out.numpy() for pdc in (True, False))
    ref = rt.reference_routed_finish(pt, s, RATE, 2, pdc=True)
    assert rel_rms(on, ref) < 5e-5
    assert abs(float(on[0, 900])) > 0.9 and abs(float(off[0, 900])) < 0.6 and abs(float(off[0, 900 + L])) > 0.4


def test_routed_pdc_with_track_and_master_latency():
    """Track-chain fetch-ahead and a master lookahead under routing."""
    js = _base(13, 3)
    js.add_bus("grp")
    js.set_track_output(0, 0)
    js.tracks[1].effects = jfx.EffectChain([jfx.Limiter(-8.0, lookahead_s=0.003)])
    js.master_effects = jfx.EffectChain([jfx.Limiter(-2.0, lookahead_s=0.001)])
    s = from_reference(js)
    pt = _per_track(js)
    got = _finish(s, pt, pdc=True).numpy()
    ref = rt.reference_routed_finish(pt, s, RATE, 2, pdc=True)
    np.testing.assert_array_equal(ref, jrt.reference_routed_finish(pt, js, RATE, 2, pdc=True))
    assert rel_rms(got, ref) < 5e-5


def test_gather_path_refuses_bus_latency_under_pdc():
    js = _click_bus_session(lookahead_s=0.002)
    with pytest.raises(ValueError, match="bus-chain latency"):
        bounce(from_reference(js), RATE, device="cpu", engine="xla", pdc=True)


# ----------------------------------------------------------------- bounce


@pytest.fixture(scope="module")
def jax_case_bounce():
    """The JAX package's metered bounce of the JAX case (its gather path,
    the shorter compile)."""
    js = _jax_case()
    return js, jax_bounce(js, RATE, engine="xla", meters=True, chunk_frames=8192)


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_routed_bounce_matches_jax(jax_case_bounce, engine):
    """The K4 path (routed finisher) and the gather path (streaming routed
    steps) against the JAX package's bounce, meters included."""
    js, want = jax_case_bounce
    got = bounce(from_reference(js), RATE, device="cpu", engine=engine, meters=True, chunk_frames=8192)
    assert got.stats.mix_path == {"auto": "kernel", "xla": "gather"}[engine]
    assert got.audio.shape == want.audio.shape and rel_rms(got.audio, want.audio) < 1e-5
    for f in ("track_peak", "track_rms", "output_peak", "output_rms"):
        np.testing.assert_allclose(getattr(got.stats, f), getattr(want.stats, f), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
    assert "route.matmul" in got.stats.cost.terms


def test_routed_chunk_and_effects_mode_keywords():
    """``routed_chunk`` sets the routed finisher's chunk (the stream
    carries exact states, so the mix moves by rounding only);
    ``effects_mode="routed"`` on a session without buses runs the routed
    finisher with none, against the f64 generic reference."""
    js = _routed(True)
    s = from_reference(js)
    a = bounce(s, RATE, device="cpu").audio
    b = bounce(s, RATE, device="cpu", routed_chunk=2048).audio
    assert float(np.abs(a - b).max()) < 1e-6
    flat = _base(23, 3)
    flat.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-20.0, 4.0)])
    fs = from_reference(flat)
    got = bounce(fs, RATE, device="cpu", effects_mode="routed")
    table, pool = jax_carve(flat, RATE, buffer_size=512)
    ref = reference_generic_finish(render_segments_per_track_numpy(table, pool), fs, RATE)
    assert rel_rms(got.audio, ref[:, :got.audio.shape[1]]) < 5e-5


def test_routed_chunk_length_by_device():
    """On the CPU the JAX package's compile-cost chunk (both packages chunk
    alike); on the card 2^20 unless asked for less."""
    for name in ("packable", "generic", "sidechain_compressor", "kitchen"):
        js = SESSIONS[name]()
        got = rt.prepare_routed_fx(from_reference(js), RATE, 2)
        assert rt.routed_auto_chunk_frames(got) == jrt.routed_auto_chunk_frames(jrt.prepare_routed_fx(js, RATE, 2))
        assert rt.routed_auto_chunk_frames(got, device="cuda") == rt.ROUTED_CUDA_CHUNK_CAP == 1 << 20
        assert rt.routed_auto_chunk_frames(got, 1 << 17, device="cuda") == 1 << 17


def test_sessions_without_routing_keep_the_ordered_sum():
    """An unused bus is no routing: the bounce stays bit-equal to the same
    session without it (the ordered track sum, not the routing product)."""
    js = _base(29, 3)
    js.tracks[0].effects = jfx.EffectChain([jfx.ParametricEQ([("peak", 900.0, 1.0, 4.0)])])
    plain = bounce(from_reference(js), RATE, device="cpu").audio
    js.add_bus("unused").effects = jfx.EffectChain([jfx.Gain(-6.0)])
    np.testing.assert_array_equal(bounce(from_reference(js), RATE, device="cpu").audio, plain)


def test_unported_effect_on_a_bus_is_refused():
    s = from_reference(_routed(False))
    s.buses[1].effects = [UnportedEffect("Fancy", "fancy", {})]
    with pytest.raises(NotImplementedError, match="Fancy"):
        bounce(s, RATE, device="cpu")


def test_full_f32_matmul_follows_the_callers_switch():
    """A caller who set the newer ``fp32_precision`` switch (through which
    reading ``allow_tf32`` raises) gets full f32 inside and its setting
    back after."""
    m = torch.backends.cuda.matmul
    if not hasattr(m, "fp32_precision"):
        pytest.skip("this PyTorch has only allow_tf32, which test_torch_resample.py holds")
    prev = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        with full_f32_matmul():
            assert m.fp32_precision == "ieee"
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = prev


def test_from_reference_carries_buses_sends_and_lanes():
    js = _kitchen()
    s = from_reference(copy.deepcopy(js))
    assert [b.name for b in s.buses] == [b.name for b in js.buses]
    for b, jb in zip(s.buses, js.buses):
        assert (b.volume_db, b.pan, b.mute) == (jb.volume_db, jb.pan, jb.mute)
        assert [type(e).__name__ for e in b.effects.effects] == [type(e).__name__ for e in jb.effects.effects]
    duck, jduck = s.buses[2], js.buses[2]
    assert duck.effects.effects[0].sidechain is True
    assert [(p.x, p.y) for p in duck.automation.volume.points] == [(p.x, p.y) for p in jduck.automation.volume.points]
    assert set(duck.automation.effects) == {(1, "gain_db")}
    for t, jt in zip(s.tracks, js.tracks):
        assert t.output_bus == jt.output_bus
        assert [(x.bus, x.gain_db, x.pre_fader, x.sidechain) for x in t.sends] == \
               [(x.bus, x.gain_db, x.pre_fader, x.sidechain) for x in jt.sends]
