"""whitebox_tpu_torch's generic effects finisher (``render/effects_generic.py``),
effect-parameter lanes, the registry and the persistence of the whole
effect family (CPU).

Sessions are made with the JAX package and carried across by
``from_reference``; per-track buffers are seeded NumPy noise. Bars:

- each stage kind against the JAX package's ``_apply_stage`` over two
  chunks with the states carried: relative RMS 1e-5;
- the generic finish against the f64 ``reference_generic_finish``:
  relative RMS 5e-5 (``tests/test_effects_family.py:295``,
  ``tests/test_pdc.py:119``), with PDC on and off; with effect lanes 2e-4
  (``tests/test_effect_automation.py:410``);
- a whole bounce against the JAX package's ``bounce(engine="pallas")`` at
  equal chunking: relative RMS 1e-5, meters rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
import whitebox_tpu_torch.effects as pfx
from chip_smoke import rel_rms
from tests.test_carve import random_session
from whitebox_tpu.ops import biquad as jbq
from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu.render import effects_generic as jgen
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.session.project import read_project as jax_read_project
from whitebox_tpu.session.project import write_project as jax_write_project
from whitebox_tpu_torch.ops import biquad as pbq
from whitebox_tpu_torch.render import effects_generic as gen
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.session.project import read_project, write_project

RATE = 48000.0
PB = pbq.PARAM_BLOCK


def _noise(shape, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _lane(*pts):
    lane = AutomationLane()
    for p in pts:
        lane.add(*p)
    return lane


_IR = (np.exp(-np.arange(700) / 150.0) * 0.25).astype(np.float32)

#: one chain per stage kind (the JAX package's constructors)
KINDS = {
    "compressor": lambda: [jfx.Compressor(-20.0, 4.0, attack_s=0.004, release_s=0.09)],
    "compressor_rms_sidechain": lambda: [jfx.Compressor(-30.0, 3.0, detector="rms", sidechain=True)],
    "limiter": lambda: [jfx.Limiter(-4.0, lookahead_s=0.002)],
    "gate": lambda: [jfx.NoiseGate(-30.0, hysteresis_db=2.0)],
    "delay": lambda: [jfx.Delay(0.03, 0.5, wet=0.5)],
    "pingpong": lambda: [jfx.Delay(0.02, 0.4, mode="pingpong")],
    "chorus": lambda: [jfx.Chorus(voices=3)],
    "flanger": lambda: [jfx.Flanger()],
    "convreverb": lambda: [jfx.ConvolutionReverb(_IR, wet=0.35)],
    "room": lambda: [jfx.ConvolutionReverb(None, room_seconds=0.03, room_seed=2)],
    "saturator": lambda: [jfx.Saturator(8.0), jfx.Biquad("lowpass", 5000.0)],
    "width": lambda: [jfx.StereoWidth(1.3), jfx.Gain(-2.0)],
    "linphase": lambda: [jfx.LinearPhaseEQ([("peak", 1000.0, 1.0, 6.0)], taps=255)],
    "eq": lambda: [jfx.ParametricEQ([("lowshelf", 90.0, 0.7, 1.5), ("peak", 900.0, 1.0, -2.0)]),
                   jfx.Saturator(3.0)],
}


def _kind_session(kind, n_tracks=2, master=True):
    js = random_session(40, rate=48000, bpm=120.0, n_tracks=n_tracks, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain(KINDS[kind]())
    if n_tracks > 2:
        js.tracks[2].effects = jfx.EffectChain(KINDS[kind]())  # same signature: one group of two
    if master:
        js.master_effects = jfx.EffectChain([jfx.Limiter(-1.0, lookahead_s=0.001)])
    return js


def _track_gain(s, C=2):
    return np.array([[np.float32((np.float32(0.0) if t.mute else t.volume_linear)
                                 * np.float32(t.pan_coeffs[c % 2])) for c in range(C)]
                     for t in s.tracks], np.float32)


def _finish(s, pt, chunk=2048, pdc=False, meters=False):
    fx = gen.prepare_generic_fx(s, RATE)
    T, C, F = pt.shape
    fin = gen.make_generic_finisher(fx, T, C, chunk=chunk, pdc=pdc, with_meters=meters,
                                    valid_frames=F)
    auto = None
    if any(t.automation is not None and t.automation.has_track_lanes() for t in s.tracks):
        from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables
        auto = prepare_automation_tables(s, RATE)
    return fin(torch.from_numpy(pt), torch.from_numpy(_track_gain(s, C)), auto)


def test_prepare_generic_fx_groups_equal_jax():
    """Grouping by chain signature, the stacked host params and the lane
    tables equal the JAX package's, array for array."""
    js = random_session(41, rate=48000, bpm=120.0, n_tracks=5, n_clips=1)
    for t in (0, 2, 3):
        js.tracks[t].effects = jfx.EffectChain([jfx.Compressor(-20.0 - t, 4.0), jfx.Delay(0.01, 0.3 + 0.1 * t)])
    js.tracks[1].effects = jfx.EffectChain([jfx.ParametricEQ([("peak", 900.0, 1.0, -2.0)]), jfx.Chorus()])
    js.tracks[3].automation = TrackAutomation(effects={(0, "threshold_db"): _lane((0.0, -6.0), (1.0, -30.0))})
    js.tracks[4].effects = jfx.EffectChain([jfx.Biquad("lowpass", 3000.0)])
    js.tracks[4].automation = TrackAutomation(effects={(0, "freq_hz"): _lane((0.0, 300.0), (1.0, 5000.0))})
    js.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0), jfx.Limiter(-0.5)])
    js.master_automation = {(1, "ceiling_db"): _lane((0.0, -0.5), (1.0, -6.0))}
    want = jgen.prepare_generic_fx(js, RATE)
    got = gen.prepare_generic_fx(from_reference(js), RATE)
    assert [g.track_idx.tolist() for g in got.groups] == [g.track_idx.tolist() for g in want.groups]
    assert [g.track_idx.tolist() for g in got.groups] == [[0, 2], [1], [3], [4]]

    def same(a, b):
        assert [(k, st) for k, st, _ in a.stages] == [(k, st) for k, st, _ in b.stages]
        for (_, _, pa), (_, _, pb) in zip(a.stages, b.stages):
            assert sorted(pa) == sorted(pb)
            for k in pa:
                if k == "auto":
                    for n in pb[k]:
                        for f in pb[k][n]:
                            np.testing.assert_array_equal(pa[k][n][f], pb[k][n][f])
                else:
                    np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)

    for a, b in zip(got.groups, want.groups):
        same(a, b)
    same(got.master, want.master)
    assert gen.fx_latencies(got) == jgen.fx_latencies(want)
    for req in (None, 1 << 12):
        assert gen.auto_chunk_frames(got, req or 1 << 16) == jgen.auto_chunk_frames(want, req or 1 << 16)


#: the stage kinds compared with the JAX package in the fast tier (each
#: first comparison pays JAX's compile of the stage's ops)
FAST_JAX_KINDS = ("compressor", "limiter", "delay", "eq")


@pytest.mark.parametrize("kind", [k if k in FAST_JAX_KINDS else pytest.param(k, marks=pytest.mark.slow)
                                  for k in list(KINDS) + ["tv_biquad", "tv_eq", "lanes"]])
def test_stage_matches_jax(kind):
    """Every stage of a group against the JAX package's stage over two
    chunks of 2048 frames, the states carried: relative RMS 1e-5."""
    if kind in ("tv_biquad", "tv_eq", "lanes"):
        js = random_session(42, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)
        if kind == "tv_biquad":
            js.tracks[0].effects = jfx.EffectChain([jfx.Biquad("peak", 800.0, 2.0, 6.0)])
            lanes = {(0, "freq_hz"): _lane((0.0, 200.0), (0.05, 6000.0)), (0, "q"): _lane((0.0, 0.6), (0.1, 3.0))}
        elif kind == "tv_eq":
            js.tracks[0].effects = jfx.EffectChain([jfx.ParametricEQ([("lowshelf", 120.0, 0.8, 3.0),
                                                                      ("peak", 2000.0, 1.4, -4.0)])])
            lanes = {(0, "b1.freq_hz"): _lane((0.0, 600.0), (0.08, 6000.0)),
                     (0, "b1.gain_db"): _lane((0.0, -12.0), (0.08, 6.0))}
        else:
            js.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-18.0, 4.0), jfx.Delay(0.01, 0.4),
                                                    jfx.Saturator(6.0), jfx.StereoWidth(1.0), jfx.Gain(0.0)])
            lanes = {(0, "threshold_db"): _lane((0.0, -6.0), (0.05, -30.0)),
                     (0, "attack_s"): _lane((0.0, 0.001), (0.05, 0.02)),
                     (1, "wet"): _lane((0.0, 0.0), (0.05, 0.8)), (2, "drive_db"): _lane((0.0, 0.0), (0.05, 14.0)),
                     (3, "width"): _lane((0.0, 0.0), (0.08, 1.8)), (4, "gain_db"): _lane((0.0, -80.0), (0.05, 0.0))}
        js.tracks[0].automation = TrackAutomation(effects=lanes)
    else:
        js = _kind_session(kind, master=False)
    jfxp = jgen.prepare_generic_fx(js, RATE)
    pfxp = gen.prepare_generic_fx(from_reference(js), RATE)
    (g,), (jg,) = pfxp.groups, jfxp.groups
    chunk, C = 2048, 2
    gp, _ = gen._with_ir_ffts(pfxp, *gen.device_params(pfxp), chunk)
    jgp, _ = jgen._with_ir_ffts(jfxp, *jgen.device_params(jfxp), chunk)
    x = _noise((len(g.track_idx), C, 2 * chunk), seed=43, scale=0.6)
    st = gen.init_generic_states(pfxp, C)[0][0]
    jst = jgen.init_generic_states(jfxp, C)[0][0]
    for start in (0, chunk):
        xc = x[..., start:start + chunk]
        y, st = gen._apply_group(g, gp[0], torch.from_numpy(xc), st, start, RATE)
        yj, jst = jgen._apply_group(jg, jgp[0], jnp.asarray(xc), jst, jnp.int32(start), RATE)
        assert rel_rms(y.numpy(), np.asarray(yj)) < 1e-5, start
    assert float(np.abs(np.asarray(yj)).max()) > 1e-3


@pytest.mark.parametrize("pdc", [False, True], ids=["pdc_off", "pdc_on"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_generic_finish_matches_f64_reference(kind, pdc):
    """Two tracks of the kind (one group) and a plain track, a lookahead
    limiter on the master: relative RMS 5e-5 of the f64 host reference,
    with and without latency compensation."""
    js = _kind_session(kind, n_tracks=3)
    s = from_reference(js)
    pt = _noise((3, 2, PB * 12), seed=44)
    got = _finish(s, pt, pdc=pdc).numpy()
    ref = gen.reference_generic_finish(pt, s, RATE, pdc=pdc)
    assert got.shape == ref.shape and rel_rms(got, ref) < 5e-5
    if kind in ("compressor", "linphase"):  # the port's oracle is the JAX package's
        np.testing.assert_array_equal(ref, jgen.reference_generic_finish(pt, js, RATE, pdc=pdc))


def test_lanes_on_tracks_and_master_match_f64_reference():
    """Effect-parameter lanes (a TV biquad sweep, a compressor threshold
    ride, an EQ band sweep) and a master lane: within 2e-4 of the f64
    reference, chunked at 1024 and 8192 alike."""
    js = random_session(45, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 8000.0, 1.2)])
    js.tracks[0].automation = TrackAutomation(effects={(0, "freq_hz"): _lane((0.0, 8000.0), (0.03, 300.0),
                                                                             (0.06, 6000.0))})
    js.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-18.0, 4.0)])
    js.tracks[1].automation = TrackAutomation(effects={(0, "threshold_db"): _lane((0.0, -6.0), (0.05, -30.0))})
    js.tracks[2].effects = jfx.EffectChain([jfx.ParametricEQ([("peak", 2000.0, 1.4, -4.0)])])
    js.tracks[2].automation = TrackAutomation(effects={(0, "b0.gain_db"): _lane((0.0, -12.0), (0.05, 6.0))})
    js.master_effects = jfx.EffectChain([jfx.Biquad("lowpass", 12000.0, 0.8)])
    js.master_automation = {(0, "freq_hz"): _lane((0.0, 12000.0), (0.05, 800.0))}
    s = from_reference(js)
    pt = _noise((3, 2, PB * 16), seed=46)
    ref = gen.reference_generic_finish(pt, s, RATE)
    a = _finish(s, pt, chunk=1024).numpy()
    b = _finish(s, pt, chunk=8192).numpy()
    assert rel_rms(a, ref) < 2e-4 and rel_rms(b, ref) < 2e-4
    np.testing.assert_allclose(a, b, atol=2e-5)
    assert not gen.session_fx_packable(s)


TV_CASES = {"lowpass": (200.0, 8000.0, 0.7071, 0.0), "highpass": (30.0, 2000.0, 2.0, 0.0),
            "peak": (500.0, 5000.0, 1.5, 9.0), "lowshelf": (100.0, 1000.0, 0.9, -6.0),
            "highshelf": (2000.0, 12000.0, 0.7, 7.5), "bandpass": (300.0, 3000.0, 0.3, 0.0),
            "notch": (100.0, 10000.0, 5.0, 0.0), "allpass": (40.0, 4000.0, 0.45, 0.0)}


def _tv_run(m, asarr, ftype, x, K):
    """design -> eigenbasis -> blocked TV scan with package ``m``."""
    C = x.shape[0]
    lo, hi, q, g = TV_CASES[ftype]
    freq = np.geomspace(lo, hi, K)
    if asarr is torch.as_tensor:
        def bc(a, tail=()):
            return torch.broadcast_to(a, (C, K) + tail)
    else:
        def bc(a, tail=()):
            return jnp.broadcast_to(a, (C, K) + tail)
    d = m.design_biquad_device(ftype, asarr(np.repeat(freq.astype(np.float32)[None], C, 0)),
                               asarr(np.float32(q)), asarr(np.float32(g)), RATE)
    p9, P, Pinv, aux = m.tv_section_params(d)
    return m.biquad_scan_blocked_tv(asarr(x), [bc(p) for p in p9], bc(P, (2, 2)), bc(Pinv, (2, 2)),
                                    asarr(np.zeros((C, 2), np.float32)), aux={k: bc(v) for k, v in aux.items()})


@pytest.mark.parametrize("ftype", list(TV_CASES))
def test_tv_biquad_matches_sequential(ftype):
    """The blocked time-varying scan against the f64 block-stepped host
    reference (1e-4, the JAX package's bar); the device design within
    5e-6 of the f64 RBJ design."""
    C, K = 2, 24
    x = _noise((C, K * PB), seed=7)
    y, z = _tv_run(pbq, torch.as_tensor, ftype, x, K)
    lo, hi, q, g = TV_CASES[ftype]
    y_ref, z_ref = pbq.biquad_sequential_tv(x, ftype, np.geomspace(lo, hi, K), np.full(K, q), np.full(K, g), RATE)
    assert np.max(np.abs(y.numpy() - y_ref)) / max(np.max(np.abs(y_ref)), 1e-9) < 1e-4
    assert np.max(np.abs(z.numpy() - z_ref)) < 1e-4
    for f, qq, gg in [(100.0, 0.7071, 3.0), (12000.0, 0.4, 6.0)]:
        c = pbq.design_biquad(ftype, f, RATE, qq, gg)
        d = pbq.design_biquad_device(ftype, torch.tensor(f), torch.tensor(qq), torch.tensor(gg), RATE)
        for k in ("b0", "b1", "b2", "a1", "a2"):
            assert abs(float(d[k]) - getattr(c, k)) < 5e-6 * max(abs(getattr(c, k)), 1.0), (f, k)


@pytest.mark.slow
def test_tv_biquad_matches_jax_op():
    """The port's TV scan against the JAX package's, every filter type:
    relative RMS 1e-5."""
    C, K = 2, 24
    x = _noise((C, K * PB), seed=7)
    for ftype in TV_CASES:
        y, _ = _tv_run(pbq, torch.as_tensor, ftype, x, K)
        yj, _ = _tv_run(jbq, jnp.asarray, ftype, x, K)
        assert rel_rms(y.numpy(), np.asarray(yj)) < 1e-5, ftype


def test_tv_injection_equals_entry_state():
    """return_injection + tv_inject from a zero entry equals the scan run
    from that entry state (the sharded handoff form)."""
    C, F = 2, PB * 6
    K = F // PB
    x = torch.from_numpy(_noise((C, F), seed=8))
    d = pbq.design_biquad_device("lowpass", torch.full((C, K), 1500.0), torch.tensor(0.9), torch.tensor(0.0),
                                 RATE)
    p9, P, Pinv, aux = pbq.tv_section_params(d)
    z_in = torch.tensor([[0.1, -0.05], [0.02, 0.3]])
    y, z = pbq.biquad_scan_blocked_tv(x, p9, P, Pinv, z_in, aux=aux)
    y0, z0, Tz, inj = pbq.biquad_scan_blocked_tv(x, p9, P, Pinv, torch.zeros((C, 2)), aux=aux,
                                                 return_injection=True)
    np.testing.assert_allclose(pbq.tv_inject(y0, z_in, inj).numpy(), y.numpy(), atol=1e-6)
    np.testing.assert_allclose((z0 + torch.einsum("rij,rj->ri", Tz, z_in)).numpy(), z.numpy(), atol=1e-6)


def test_bounce_generic_with_pdc_and_meters_matches_jax():
    """A compressor track, a ping-pong delay track and a lookahead limiter
    on the master, PDC and meters on: the port's bounce within relative
    RMS 1e-5 of the JAX package's (meters rtol 1e-5) and 5e-5 of the f64
    reference with PDC."""
    from whitebox_tpu.timeline.carve import carve_session as jax_carve
    from whitebox_tpu.timeline.carve import render_segments_per_track_numpy

    js = random_session(47, rate=48000, bpm=480.0, n_tracks=2, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-24.0, 4.0)])
    js.tracks[1].effects = jfx.EffectChain([jfx.Delay(0.013, 0.6, mode="pingpong")])
    js.master_effects = jfx.EffectChain([jfx.Limiter(-3.0, lookahead_s=0.002)])
    got = bounce(from_reference(js), RATE, device="cpu", pdc=True, meters=True)
    want = jax_bounce(js, RATE, engine="pallas", pdc=True, meters=True)
    assert got.stats.mix_path == "kernel" and got.audio.shape == want.audio.shape
    assert rel_rms(got.audio, want.audio) < 1e-5
    for f in ("track_peak", "track_rms", "output_peak", "output_rms"):
        np.testing.assert_allclose(getattr(got.stats, f), getattr(want.stats, f), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
    jt, jp = jax_carve(js, RATE, buffer_size=512)
    ref = jgen.reference_generic_finish(render_segments_per_track_numpy(jt, jp), js, RATE, pdc=True)
    assert rel_rms(got.audio, ref[:, :got.audio.shape[1]]) < 5e-5
    assert {"fx.compressor", "fx.delay", "fx.limiter"} <= set(got.stats.cost.terms)


def test_gather_path_pdc_renders_rows_ahead(monkeypatch):
    """The gather path's fetch-ahead (the latent chain's rows re-rendered
    lat frames ahead) and master latency: within 5e-5 of the f64
    reference with PDC, and of the kernel path's render."""
    from whitebox_tpu.timeline.carve import carve_session as jax_carve
    from whitebox_tpu.timeline.carve import render_segments_per_track_numpy

    js = random_session(48, rate=48000, bpm=480.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Limiter(-6.0, lookahead_s=0.004)])
    js.tracks[2].effects = jfx.EffectChain([jfx.LinearPhaseEQ([("peak", 900.0, 1.0, 4.0)], taps=101)])
    js.master_effects = jfx.EffectChain([jfx.Limiter(-1.0, lookahead_s=0.001)])
    s = from_reference(js)
    got = bounce(s, RATE, device="cpu", engine="xla", pdc=True, chunk_frames=4096)
    kern = bounce(s, RATE, device="cpu", pdc=True)
    assert got.stats.mix_path == "gather" and kern.stats.mix_path == "kernel"
    jt, jp = jax_carve(js, RATE, buffer_size=512)
    ref = jgen.reference_generic_finish(render_segments_per_track_numpy(jt, jp), js, RATE, pdc=True)
    assert rel_rms(got.audio, ref[:, :got.audio.shape[1]]) < 5e-5
    assert rel_rms(got.audio, kern.audio) < 5e-5


def test_stems_finisher_sums_to_the_premaster_mix():
    js = _kind_session("delay", n_tracks=3, master=False)
    s = from_reference(js)
    pt = _noise((3, 2, PB * 8), seed=49, scale=0.2)
    fx = gen.prepare_generic_fx(s, RATE)
    tg = torch.from_numpy(_track_gain(s))
    stems = gen.make_generic_stems_finisher(fx, 3, 2, chunk=1024)(torch.from_numpy(pt), tg)
    total = stems[0] + stems[1] + stems[2]
    mixed = gen.make_generic_finisher(fx, 3, 2, chunk=1024)(torch.from_numpy(pt), tg)
    np.testing.assert_allclose(torch.clamp(total, -1.0, 1.0).numpy(), mixed.numpy(), atol=1e-6)


# ------------------------------------------------------------------ registry


class _Tremolo:
    """A user effect with the stage protocol: y = x * (1 - depth + depth*|sin|)."""

    automatable = ("depth",)

    def __init__(self, depth=0.5):
        super().__init__()
        self.depth = float(depth)

    def param_arrays(self):
        return {"depth": self.depth}

    def as_dict(self):
        return {"depth": self.depth}

    @classmethod
    def from_dict(cls, d):
        return cls(float(d["depth"]))


class PortTremolo(_Tremolo, pfx.Effect):
    def process(self, x, state):
        n = torch.arange(x.shape[-1], dtype=torch.float32)
        return x * (1.0 - self.depth + self.depth * torch.abs(torch.sin(n * 0.01))), state

    def reference_process(self, x, lanes=None):
        n = np.arange(x.shape[-1], dtype=np.float64)
        d = self.depth if not lanes else lanes["depth"]
        return x * (1.0 - d + d * np.abs(np.sin(n * 0.01)))

    @classmethod
    def stage_init_state(cls, static, params, B, C):
        return ()

    @classmethod
    def stage_apply(cls, static, params, x, state, n0, sample_rate, key=None, lanes=None):
        n = n0 + torch.arange(x.shape[-1], dtype=torch.float32)
        d = lanes["depth"][:, None, :] if lanes and "depth" in lanes else params["depth"][:, None, None]
        return x * (1.0 - d + d * torch.abs(torch.sin(n * 0.01))), state


class JaxTremolo(_Tremolo, jfx.Effect):
    pass


def test_registry_with_a_port_registered_effect(tmp_path):
    """A user effect registered in the port (and by name in the JAX
    package) crosses from_reference and the .wb round trip as the port
    class, renders through the generic pipeline within 5e-5 of its own
    f64 reference (a lane on its param too), and a .wb type nobody
    registered reads as a bypass that writes back verbatim."""
    from whitebox_tpu.effects import registry as jreg
    from whitebox_tpu_torch.effects import registry as preg

    preg.register_effect("tremolo", PortTremolo)
    jreg.register_effect("tremolo", JaxTremolo)
    try:
        with pytest.raises(ValueError, match="built-in"):
            preg.register_effect("delay", PortTremolo)
        assert preg.lookup_effect("tremolo") is PortTremolo and preg.type_name_of(PortTremolo) == "tremolo"
        js = random_session(50, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)
        js.tracks[0].effects = jfx.EffectChain([JaxTremolo(0.7)])
        js.tracks[0].automation = TrackAutomation(effects={(0, "depth"): _lane((0.0, 0.2), (0.05, 0.9))})
        s = from_reference(js)
        (e,) = s.tracks[0].effects.effects
        assert isinstance(e, PortTremolo) and e.depth == 0.7
        pt = _noise((2, 2, PB * 8), seed=51)
        got = _finish(s, pt).numpy()
        assert rel_rms(got, gen.reference_generic_finish(pt, s, RATE)) < 5e-5
        jax_write_project(js, tmp_path / "t.wb")
        s2 = read_project(tmp_path / "t.wb")
        assert isinstance(s2.tracks[0].effects.effects[0], PortTremolo)
    finally:
        preg.unregister_effect("tremolo")
        jreg.unregister_effect("tremolo")
    assert preg.lookup_effect("tremolo") is None
    s3 = read_project(tmp_path / "t.wb")
    (u,) = s3.tracks[0].effects.effects
    assert isinstance(u, pfx.UnknownEffect) and u.type_name == "tremolo"
    write_project(s3, tmp_path / "t2.wb")
    from whitebox_tpu.session.project import _chain_to_doc as jax_chain_doc
    assert jax_chain_doc(jax_read_project(tmp_path / "t2.wb").tracks[0].effects)[0] == \
        {"type": "tremolo", "state": {"depth": 0.7}}


# ------------------------------------------------------------------ persistence and freezing


def test_every_type_round_trips_through_from_reference_and_wb(tmp_path):
    """Every built-in type: the port's documents equal the JAX package's
    (read from the JAX package's .wb; written back and read by it), the
    custom IR bit-exact."""
    from whitebox_tpu.session.project import _chain_to_doc as jax_doc
    from whitebox_tpu_torch.session.project import _chain_to_doc as port_doc

    js = random_session(52, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([
        jfx.Compressor(-17.5, 3.5, knee_db=4.0, attack_s=0.003, release_s=0.12, makeup_db=1.5,
                       detector="rms", rms_window_s=0.02, sidechain=True),
        jfx.Delay(0.125, 0.45, wet=0.3, dry=0.9, mode="pingpong"),
        jfx.LinearPhaseEQ([("peak", 1000.0, 1.0, 3.0)], taps=63)])
    js.tracks[1].effects = jfx.EffectChain([
        jfx.Chorus(rate_hz=0.9, depth_s=0.003, center_s=0.012, voices=3, wet=0.4), jfx.Saturator(7.0, mix=0.6),
        jfx.NoiseGate(-42.0, range_db=70.0, hysteresis_db=3.0), jfx.Flanger(rate_hz=0.3), jfx.StereoWidth(1.25)])
    js.tracks[2].effects = jfx.EffectChain([jfx.ConvolutionReverb(_IR, wet=0.25)])
    js.master_effects = jfx.EffectChain([
        jfx.ConvolutionReverb(None, wet=0.1, room_seconds=0.8, rt60_s=0.5, room_seed=3),
        jfx.Limiter(-0.5, attack_s=0.0008, release_s=0.04, lookahead_s=0.003)])
    carried = from_reference(js)
    jax_write_project(js, tmp_path / "a.wb")
    s = read_project(tmp_path / "a.wb")
    write_project(s, tmp_path / "b.wb")
    back = jax_read_project(tmp_path / "b.wb")
    for t in range(3):
        want = jax_doc(js.tracks[t].effects)
        assert port_doc(carried.tracks[t].effects) == want
        assert port_doc(s.tracks[t].effects) == want and jax_doc(back.tracks[t].effects) == want
    assert port_doc(s.master_effects) == jax_doc(js.master_effects) == jax_doc(back.master_effects)
    np.testing.assert_array_equal(s.tracks[2].effects.effects[0].ir_host, np.atleast_2d(_IR))


def test_freeze_track_through_a_compressor_chain():
    """freeze_track renders the compressor chain post-chain, pre-fader:
    the frozen sample within 5e-5 of the f64 chain on the track's
    per-track buffer; the chain moves to the frozen record."""
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    js = random_session(53, rate=48000, bpm=240.0, n_tracks=2, n_clips=1)
    js.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-24.0, 6.0), jfx.Gain(2.0)])
    s = from_reference(js)
    solo = from_reference(js)
    solo.tracks = [solo.tracks[1]]
    table, pool = carve_session(solo, RATE, buffer_size=512)
    pt = render_segments_per_track_numpy(table, pool)[0]
    chain = s.tracks[1].effects
    s.freeze_track(1, RATE, device="cpu")
    got = np.stack(s.tracks[1].clips[0].audio.asset.sample.data)
    ref = gen.reference_run_chain(chain, pt.astype(np.float64), None, RATE, 2, s.time_base)
    n = min(got.shape[1], ref.shape[1])
    assert rel_rms(got[:, :n], ref[:, :n]) < 5e-5 and float(np.abs(got).max()) > 0.01
    assert s.tracks[1].effects == [] and s.tracks[1].frozen["effects"] is chain


def test_cli_pdc_matches_jax_cli(tmp_path, capsys):
    """cli render --pdc on a project with a lookahead limiter against the
    JAX CLI: relative RMS 1e-5."""
    from tests.test_torch_bounce import _jax_and_port_cli

    js = random_session(54, rate=48000, bpm=480.0, n_tracks=2, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Limiter(-6.0, lookahead_s=0.003)])
    want, got, _, _ = _jax_and_port_cli(tmp_path, capsys, js, ["--pdc"])
    assert got.shape == want.shape and rel_rms(got, want) < 1e-5
