"""whitebox_tpu_torch's dynamics and delay primitives and the effect
classes built on them (CPU).

The same seeded NumPy inputs go through the JAX package's op and the
port's: within relative 1e-5 of the JAX op (max abs error over the max
abs output), and within the JAX package's bars of its f64 sequential
``*_ref`` oracles (``tests/test_effects_family.py:40-162``). Chunked
processing with carried state equals one-shot processing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
import whitebox_tpu_torch.effects as pfx
from chip_smoke import rel_rms
from whitebox_tpu.ops import delay as jdl
from whitebox_tpu.ops import dynamics as jdyn
from whitebox_tpu_torch.ops import delay as dl
from whitebox_tpu_torch.ops import dynamics as dyn

RATE = 48000.0
REL = 1e-5  # port vs JAX op, max abs error relative to the max abs output


def _noise(C=2, F=4000, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, F)) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _t(d):
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}


def _j(d):
    return {k: jnp.float32(v) for k, v in d.items()}


COMP = dict(threshold_db=-18.0, ratio=4.0, knee_db=6.0, attack=float(dyn.time_coef(0.005, RATE)),
            release=float(dyn.time_coef(0.1, RATE)), makeup_db=2.0)
COMP_RMS = dict(threshold_db=-20.0, ratio=8.0, knee_db=3.0, attack=float(dyn.time_coef(0.002, RATE)),
                release=float(dyn.time_coef(0.05, RATE)), makeup_db=0.0)
DET_AVG = float(dyn.time_coef(0.03, RATE))


def _zstate(**shapes):
    return ({k: torch.zeros(s) for k, s in shapes.items()}, {k: jnp.zeros(s) for k, s in shapes.items()})


@pytest.mark.parametrize("detector", ["peak", "rms"])
def test_compressor_matches_jax_and_reference(detector):
    x = _noise(seed=1 if detector == "peak" else 2)
    p = COMP if detector == "peak" else COMP_RMS
    pt, pj = _t(p), _j(p)
    pt["det_avg"], pj["det_avg"] = torch.tensor(DET_AVG), jnp.float32(DET_AVG)
    st, sj = _zstate(red=(), att=(), det=())
    y, _ = dyn.compressor_process(torch.from_numpy(x), pt, st, detector=detector)
    yj, _ = jdyn.compressor_process(x, pj, sj, detector=detector)
    assert _rel(y, yj) < REL
    ref = dyn.compressor_ref(x, detector=detector, det_avg=DET_AVG, **p)
    np.testing.assert_array_equal(ref, jdyn.compressor_ref(x, detector=detector, det_avg=DET_AVG, **p))
    assert _rel(y, ref) < (1e-5 if detector == "peak" else 2e-5)


def test_compressor_chunked_equals_oneshot():
    x = torch.from_numpy(_noise(seed=3))
    p = _t(dict(threshold_db=-15.0, ratio=3.0, knee_db=6.0, attack=float(dyn.time_coef(0.01, RATE)),
                release=float(dyn.time_coef(0.2, RATE)), makeup_db=0.0))
    y, _ = dyn.compressor_process(x, p, _zstate(red=(), att=(), det=())[0])
    st, chunks = _zstate(red=(), att=(), det=())[0], []
    for s in range(0, x.shape[1], 777):
        yc, st = dyn.compressor_process(x[:, s:s + 777], p, st)
        chunks.append(yc)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), y.numpy(), atol=1e-6)


def test_limiter_matches_jax_and_reference():
    x = _noise(seed=4, scale=1.5)
    L = 48
    p = dict(ceiling_db=-6.0, attack=float(dyn.time_coef(0.0005, RATE)),
             release=float(dyn.time_coef(0.05, RATE)))
    st, sj = _zstate(red=(), att=(), look=(L,), xdelay=(2, L))
    y, _ = dyn.limiter_process(torch.from_numpy(x), _t(p), st, lookahead=L)
    yj, _ = jdyn.limiter_process(x, _j(p), sj, lookahead=L)
    assert _rel(y, yj) < REL
    ref = dyn.limiter_ref(x, lookahead=L, **p)
    assert _rel(y, ref) < 2e-5
    assert float(y.abs().max()) < 10 ** (-6.0 / 20.0) * 1.6


def test_limiter_chunked_equals_oneshot():
    x = torch.from_numpy(_noise(seed=14, scale=1.2))
    L = 96
    p = _t(dict(ceiling_db=-3.0, attack=float(dyn.time_coef(0.001, RATE)),
                release=float(dyn.time_coef(0.05, RATE))))

    def z():
        return _zstate(red=(), att=(), look=(L,), xdelay=(2, L))[0]

    y, _ = dyn.limiter_process(x, p, z(), lookahead=L)
    st, chunks = z(), []
    for s in range(0, x.shape[1], 500):
        yc, st = dyn.limiter_process(x[:, s:s + 500], p, st, lookahead=L)
        chunks.append(yc)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), y.numpy(), atol=1e-6)


@pytest.mark.parametrize("hyst", [0.0, 4.0])
def test_gate_matches_jax_and_reference(hyst):
    F = 4000
    x = _noise(seed=5) * np.concatenate([np.ones(F // 2), np.zeros(F - F // 2)])[None, :].astype(np.float32)
    p = dict(threshold_db=-20.0, range_db=60.0, attack=float(dyn.time_coef(0.002, RATE)),
             release=float(dyn.time_coef(0.08, RATE)), hyst_db=hyst)
    st, sj = _zstate(open=(), att=())
    y, _ = dyn.gate_process(torch.from_numpy(x), _t(p), st)
    yj, _ = jdyn.gate_process(x, _j(p), sj)
    assert _rel(y, yj) < REL
    ref = dyn.gate_ref(x, threshold_db=-20.0, range_db=60.0, attack=p["attack"], release=p["release"],
                       hysteresis_db=hyst)
    assert np.max(np.abs(y.numpy() - ref)) < 1e-5


@pytest.mark.slow
def test_scans_match_jax_with_states():
    """onepole and maxdecay (and their transitions) from nonzero states."""
    rng = np.random.default_rng(15)
    x = np.abs(rng.standard_normal((3, 1500))).astype(np.float32)
    a = np.array([[0.9], [0.99], [0.5]], np.float32)
    y0 = np.array([0.3, -0.2, 1.0], np.float32)
    got = dyn.onepole_scan_t(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(y0))
    want = jdyn.onepole_scan_t(x, a, jnp.asarray(y0))
    for g, w in zip(got, want):
        assert _rel(g, w) < REL
    got = dyn.maxdecay_scan_t(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(np.abs(y0) * 3))
    want = jdyn.maxdecay_scan_t(x, a, jnp.asarray(np.abs(y0) * 3))
    for g, w in zip(got, want):
        assert _rel(g, w) < REL


# ------------------------------------------------------------------ delays


def _zeros(*s):
    return torch.zeros(s), jnp.zeros(s)


@pytest.mark.parametrize("mode,D,fb", [("comb", 137, 0.6), ("comb", 4000, 0.5), ("pingpong", 97, 0.55),
                                       ("pingpong", 333, 0.7)])
def test_combs_match_jax_and_reference(mode, D, fb):
    x = _noise(seed=6)
    (w0, w0j), (x0, x0j) = _zeros(2, D), _zeros(2, D)
    fn, jfn = ((dl.comb_feedback, jdl.comb_feedback) if mode == "comb"
               else (dl.comb_feedback_pingpong, jdl.comb_feedback_pingpong))
    w, wl, xl = fn(torch.from_numpy(x), torch.tensor(fb), w0, x0, D=D)
    wj, wlj, xlj = jfn(x, jnp.float32(fb), w0j, x0j, D=D)
    for g, wnt in ((w, wj), (wl, wlj), (xl, xlj)):
        assert _rel(g, wnt) < REL or float(np.abs(np.asarray(wnt)).max()) == 0.0
    ref = dl.comb_feedback_ref(x, fb, D) if mode == "comb" else dl.comb_pingpong_ref(x, fb, D)
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["comb", "pingpong"])
def test_comb_chunked_equals_oneshot(mode):
    x = torch.from_numpy(_noise(seed=7))
    D = 250
    fn = dl.comb_feedback if mode == "comb" else dl.comb_feedback_pingpong
    w, _, _ = fn(x, torch.tensor(0.7), torch.zeros((2, D)), torch.zeros((2, D)), D=D)
    w0, x0, chunks = torch.zeros((2, D)), torch.zeros((2, D)), []
    for s in range(0, x.shape[1], 600):  # chunks shorter and longer than D
        wc, w0, x0 = fn(x[:, s:s + 600], torch.tensor(0.7), w0, x0, D=D)
        chunks.append(wc)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), w.numpy(), atol=1e-6)


def test_pingpong_crosses_channels():
    F, D = 1000, 100
    x = torch.zeros((2, F))
    x[0, 0] = 1.0
    w, _, _ = dl.comb_feedback_pingpong(x, torch.tensor(0.5), torch.zeros((2, D)), torch.zeros((2, D)), D=D)
    assert float(w[0, D]) == pytest.approx(1.0)
    assert float(w[1, 2 * D]) == pytest.approx(0.5)
    assert float(w[0, 3 * D]) == pytest.approx(0.25)


def test_lfo_matches_jax_and_stays_phase_exact():
    """The digit-split phase: within 2e-5 cycles of the f64 LFO out to
    2^31 frames (delay error < 0.05 frames at depth 200), and equal to the
    JAX package's to f32 rounding; the rate splits are the same bits."""
    F = 2048
    for rate in (0.25, 0.8, 5.0):
        np.testing.assert_array_equal(dl.lfo_rate_splits(rate, RATE), jdl.lfo_rate_splits(rate, RATE))
        for n0 in (0, 1 << 24, (1 << 28) + 12345, (1 << 31) - F - 1):
            d = dl.lfo_delay_frames(n0, F, rate_hz=rate, depth_frames=200.0, center_frames=300.0,
                                    sample_rate=RATE).numpy()
            n = n0 + np.arange(F, dtype=np.float64)
            ref = 300.0 + 200.0 * np.sin(2.0 * np.pi * rate / RATE * n)
            assert np.max(np.abs(d - ref)) < 0.05, (n0, rate)
            dj = np.asarray(jdl.lfo_delay_frames(n0, F, rate_hz=rate, depth_frames=200.0,
                                                 center_frames=300.0, sample_rate=RATE))
            assert np.max(np.abs(d - dj)) < 1e-3


def test_modulated_tap_matches_jax_and_reference():
    x = _noise(seed=9)
    F = x.shape[1]
    d = dl.lfo_delay_frames(0, F, rate_hz=1.5, depth_frames=20.0, center_frames=64.0, sample_rate=RATE)
    tap, tail = dl.modulated_tap(torch.from_numpy(x), d, torch.zeros((2, 128)), max_delay=128)
    tapj, tailj = jdl.modulated_tap(x, jnp.asarray(d.numpy()), jnp.zeros((2, 128)), max_delay=128)
    assert _rel(tap, tapj) < REL  # XLA:CPU contracts the lerp into an FMA
    np.testing.assert_array_equal(tail.numpy(), np.asarray(tailj))
    np.testing.assert_allclose(tap.numpy(), dl.modulated_tap_ref(x, d.numpy()), atol=1e-6)


def test_modulated_tap_chunked_exact():
    x = torch.from_numpy(_noise(seed=10))
    F = x.shape[1]
    d = dl.lfo_delay_frames(0, F, rate_hz=0.8, depth_frames=30.0, center_frames=80.0, sample_rate=RATE)
    tap, _ = dl.modulated_tap(x, d, torch.zeros((2, 128)), max_delay=128)
    xt, chunks = torch.zeros((2, 128)), []
    for s in range(0, F, 700):
        tc, xt = dl.modulated_tap(x[:, s:s + 700], d[s:s + 700], xt, max_delay=128)
        chunks.append(tc)
    np.testing.assert_array_equal(torch.cat(chunks, 1).numpy(), tap.numpy())


# ------------------------------------------------------------------ effect classes

_IR = np.exp(-np.arange(900) / 200.0).astype(np.float32) * 0.2


def _cases(fx):
    return {
        "compressor": fx.Compressor(-18.0, 4.0),
        "compressor_rms": fx.Compressor(-24.0, 6.0, detector="rms"),
        "limiter": fx.Limiter(-3.0, lookahead_s=0.002),
        "gate": fx.NoiseGate(-30.0),
        "delay": fx.Delay(0.02, 0.5, wet=0.6),
        "pingpong": fx.Delay(0.013, 0.4, mode="pingpong"),
        "chorus": fx.Chorus(rate_hz=1.2, voices=3),
        "flanger": fx.Flanger(),
        "convreverb": fx.ConvolutionReverb(ir=_IR),
        "room": fx.ConvolutionReverb(None, room_seconds=0.05, room_seed=4),
        "saturator": fx.Saturator(9.0, mix=0.8),
        "width": fx.StereoWidth(1.4),
        "linphase": fx.LinearPhaseEQ([("peak", 1000.0, 1.0, 6.0), ("highshelf", 8000.0, 0.7, -3.0)], taps=127),
    }


CASES = list(_cases(pfx))


@pytest.mark.parametrize("name", CASES)
def test_effect_matches_jax_and_chunked_equals_oneshot(name):
    """process() against the JAX package's class (same settings, same
    input): within relative RMS 1e-5 (the LFO's phase sum, which XLA:CPU
    contracts into FMAs, moves the chorus taps by ~1e-5 at its peaks);
    chunks of 640 frames with carried state equal one call to 2e-6."""
    x = _noise(seed=11)
    eff, jeff = _cases(pfx)[name], _cases(jfx)[name]
    eff.prepare(RATE, 2)
    jeff.prepare(RATE, 2)
    y, _ = eff.process(torch.from_numpy(x), eff.init_state(2))
    yj, _ = jeff.process(jnp.asarray(x), jeff.init_state(2))
    assert rel_rms(y.numpy(), np.asarray(yj)) < REL
    st, chunks = eff.init_state(2), []
    for s in range(0, x.shape[1], 640):
        yc, st = eff.process(torch.from_numpy(x[:, s:s + 640]), st)
        chunks.append(yc)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), y.numpy(), atol=2e-6)
    assert eff.static_config() == jeff.static_config()
    assert eff.latency_frames() == jeff.latency_frames() and eff.tail_frames() == jeff.tail_frames()


def test_designs_equal_the_jax_packages():
    """The room IR generator and the linear-phase FIR design are the JAX
    package's host code: equal arrays; the linear-phase latency is
    (taps-1)/2 and the FIR is symmetric."""
    from whitebox_tpu.effects.eq import design_linear_phase_fir as jax_fir
    from whitebox_tpu.effects.reverb import design_room_ir as jax_room

    np.testing.assert_array_equal(pfx.design_room_ir(RATE, seconds=0.1, seed=3),
                                  jax_room(RATE, seconds=0.1, seed=3))
    bands = [("lowshelf", 120.0, 0.7, 3.0), ("peak", 2500.0, 1.5, -4.0)]
    h = pfx.design_linear_phase_fir(bands, RATE, 255)
    np.testing.assert_array_equal(h, jax_fir(bands, RATE, 255))
    np.testing.assert_allclose(h, h[::-1], atol=1e-15)
    eq = pfx.LinearPhaseEQ(bands, taps=255).prepare(RATE, 2)
    assert eq.latency_frames() == 127
    with pytest.raises(ValueError, match="odd"):
        pfx.LinearPhaseEQ(bands, taps=100)
