"""The port's linear effects and finishers against the JAX package's (CPU).

- Host design and packing (``design_biquad``, ``eig_section_params``,
  ``pack_chain_sections``, the FIR impulse-response tables) are NumPy in
  both packages and must be equal array for array (``np.array_equal``).
- The f32 scan and the finishers are held to tolerances: XLA:CPU contracts
  some of the scan's mul+add pairs into FMAs, so port vs JAX on the same
  per-track input is relative RMS < 1e-5. Against the f64 reference the
  JAX package's own bars hold: scan < 5e-5 (``tests/test_effects.py:83``),
  FIR < 2e-4 (``tests/test_effects_pipeline.py:91``); chunked vs one-shot
  atol 2e-5 (``tests/test_effects.py:102``); the identity row of a batched
  scan is exact (``tests/test_effects.py:119``).
- Part of the port's contract too: a session carried by ``from_reference``
  holds no object of the JAX package.
"""

import numpy as np
import pytest
import torch

from chip_smoke import rel_rms
from tests.test_auto_kernel import _auto_session
from tests.test_carve import random_session
from whitebox_tpu import effects as jfx
from whitebox_tpu.ops import biquad as jbq
from whitebox_tpu.render import effects_fir as jfir
from whitebox_tpu.render import effects_pipeline as jpipe
from whitebox_tpu_torch import effects as pfx
from whitebox_tpu_torch.ops import biquad as pbq
from whitebox_tpu_torch.ops.scan_util import hillis_scan
from whitebox_tpu_torch.render import effects_fir as pfir
from whitebox_tpu_torch.render import effects_pipeline as ppipe
from whitebox_tpu_torch.session.convert import from_reference

RATE = 48000.0
C = 2


def rms(x):
    return float(np.sqrt(np.mean(np.asarray(x, dtype=np.float64) ** 2)))


def _add_chains(s, master=True):
    """Chains of every linear kind (the JAX package's test shapes)."""
    s.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 2000.0), jfx.Gain(-3.0)])
    if len(s.tracks) > 1:
        s.tracks[1].effects = jfx.EffectChain([jfx.ParametricEQ(
            [("lowshelf", 120.0, 0.707, 4.0), ("peak", 1500.0, 1.2, -3.0)])])
    if master:
        s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0)])
    return s


def fx_pair(seed=10, n_tracks=3, lanes=False, master=True):
    """(JAX session, port session) with chains, optionally volume/pan lanes."""
    js = _auto_session(seed=seed) if lanes else random_session(
        seed, rate=48000, bpm=120.0, n_tracks=n_tracks, n_clips=2)
    _add_chains(js, master=master)
    return js, from_reference(js)


# ------------------------------------------------------------------ host tables


DESIGNS = [(t.value, f, q, g) for t in jbq.BiquadType
           for (f, q, g) in ((25.0, 0.7071067811865476, 0.0), (1500.0, 1.2, 6.0), (9000.0, 4.0, -9.0))]


@pytest.mark.parametrize("design", DESIGNS, ids=[f"{d[0]}_{d[1]:g}" for d in DESIGNS])
def test_design_and_section_params_equal_jax(design):
    t, f, q, g = design
    a, b = pbq.design_biquad(t, f, RATE, q, g), jbq.design_biquad(t, f, RATE, q, g)
    assert (a.b0, a.b1, a.b2, a.a1, a.a2) == (b.b0, b.b1, b.b2, b.a1, b.a2)
    np.testing.assert_array_equal(pbq.eig_section_params(a), jbq.eig_section_params(b))


def test_pack_chain_sections_equal_jax():
    js, s = fx_pair()
    jchains, jmaster = jpipe._chains_of(js)
    chains, master = ppipe._chains_of(s)
    for c in [*jchains, jmaster, *chains, master]:
        if c is not None:
            c.prepare(RATE, C)
    for jc, pc in ((jchains, chains), ([jmaster], [master]), ([None, None], [None, None])):
        jS, jcoeff = jbq.pack_chain_sections(jc, C)
        pS, pcoeff = pbq.pack_chain_sections(pc, C)
        assert jS == pS
        np.testing.assert_array_equal(pcoeff, jcoeff)


def test_fir_tables_equal_jax():
    js, s = fx_pair(seed=11, n_tracks=4)
    for jc, pc in zip([*jpipe._chains_of(js)[0], jpipe._chains_of(js)[1]],
                      [*ppipe._chains_of(s)[0], ppipe._chains_of(s)[1]]):
        if jc is not None:
            np.testing.assert_array_equal(
                pfir.chain_impulse_response(pc.prepare(RATE, C), RATE),
                jfir.chain_impulse_response(jc.prepare(RATE, C), RATE))
    jh, jm = jfir.prepare_fir_tables(js, RATE, C)
    ph, pm = pfir.prepare_fir_tables(s, RATE, C)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pm, jm)
    tg = np.random.default_rng(0).uniform(0.1, 1.2, (4, C)).astype(np.float32)
    np.testing.assert_array_equal(pfir.prepare_fir_tables_spectral(s, RATE, tg, C),
                                  jfir.prepare_fir_tables_spectral(js, RATE, tg, C))
    np.testing.assert_array_equal(pfir.prepare_fir_tables_spectral(s, RATE, torch.from_numpy(tg), C),
                                  jfir.prepare_fir_tables_spectral(js, RATE, tg, C))


def test_cascade_magnitude_equals_jax():
    bands = [("lowshelf", 100.0, 0.707, 2.0), ("peak", 1000.0, 1.0, -1.5), ("highshelf", 8000.0, 0.707, 1.0)]
    f = np.linspace(10.0, 20000.0, 257)
    np.testing.assert_array_equal(pfx.cascade_magnitude(bands, f, RATE),
                                  jfx.eq.cascade_magnitude(bands, f, RATE))


# ------------------------------------------------------------------ the scan


@pytest.mark.parametrize("ftype,kw", [
    ("lowpass", {}), ("highpass", {"q": 1.2}), ("peak", {"gain_db": 6.0}),
    ("lowshelf", {"gain_db": -9.0}), ("notch", {"q": 4.0}),
])
def test_scan_matches_sequential_and_jax(ftype, kw):
    import jax.numpy as jnp

    c = pbq.design_biquad(ftype, 1500.0, RATE, **kw)
    x = (np.random.default_rng(1).standard_normal((2, 16384)) * 0.3).astype(np.float32)
    ref, _ = pbq.biquad_sequential(x, c)
    got, _ = pbq.biquad_scan(torch.from_numpy(x), c)
    assert rms(got.numpy() - ref) / max(rms(ref), 1e-9) < 5e-5
    jgot, _ = jbq.biquad_scan(jnp.asarray(x), jbq.design_biquad(ftype, 1500.0, RATE, **kw))
    assert rel_rms(got.numpy(), np.asarray(jgot)) < 1e-5


def test_hillis_scan_is_an_inclusive_prefix():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 37)))
    (got,) = hillis_scan(lambda l, r: (l[0] + r[0],), (x,), (0.0,))
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy(), axis=-1), rtol=1e-12, atol=1e-12)


def test_near_unit_circle_highpass():
    # the master's 25 Hz highpass: the case eig_section_params exists for
    c = pbq.design_biquad("highpass", 25.0, RATE)
    x = (np.random.default_rng(5).standard_normal((2, 32768)) * 0.3).astype(np.float32)
    ref, _ = pbq.biquad_sequential(x, c)
    got, _ = pbq.biquad_scan(torch.from_numpy(x), c)
    assert rms(got.numpy() - ref) / rms(ref) < 5e-5


def test_scan_chunked_state_equivalence():
    c = pbq.design_biquad("peak", 800.0, RATE, gain_db=5.0)
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((2, 4096)) * 0.3).astype(np.float32))
    full, _ = pbq.biquad_scan(x, c)
    st, parts = None, []
    for i in range(0, 4096, 512):
        y, st = pbq.biquad_scan(x[:, i:i + 512], c, st)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), full.numpy(), atol=2e-5)


def test_batched_matches_individual_and_identity_row_is_exact():
    cs = [pbq.design_biquad("lowpass", 1000.0, RATE), pbq.design_biquad("highpass", 200.0, RATE),
          pbq.IDENTITY_COEFFS]
    x = (np.random.default_rng(3).standard_normal((3, 2048)) * 0.3).astype(np.float32)
    ca = torch.from_numpy(np.stack([pbq.coeffs_device_arrays(c) for c in cs], axis=1)[:, :, None])
    y, _ = pbq.biquad_scan_batched(torch.from_numpy(x), [ca[i] for i in range(9)], torch.zeros((3, 2)))
    for i, c in enumerate(cs):
        yi, _ = pbq.biquad_scan(torch.from_numpy(x[i:i + 1]), c)
        np.testing.assert_allclose(y[i].numpy(), yi[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(y[2].numpy(), x[2], atol=0)  # identity row


def test_effect_api_matches_jax():
    import jax.numpy as jnp

    x = (np.random.default_rng(6).standard_normal((2, 4096)) * 0.3).astype(np.float32)
    jc = jfx.EffectChain([jfx.Biquad("lowpass", 2000.0), jfx.Gain(-6.0),
                          jfx.ParametricEQ([("peak", 900.0, 1.0, 4.0), ("highshelf", 6000.0, 0.7, -2.0)])])
    pc = pfx.EffectChain([pfx.Biquad("lowpass", 2000.0), pfx.Gain(-6.0),
                          pfx.ParametricEQ([("peak", 900.0, 1.0, 4.0), ("highshelf", 6000.0, 0.7, -2.0)])])
    jy, _ = jc.prepare(RATE, 2).process(jnp.asarray(x), jc.init_state(2))
    py, st = pc.prepare(RATE, 2).process(torch.from_numpy(x), pc.init_state(2))
    assert rel_rms(py.numpy(), np.asarray(jy)) < 1e-5
    assert len(st) == 3 and pc.tail_frames() == 4096 * 3
    assert pfx.Gain(-6.0).gain_linear == jfx.Gain(-6.0).gain_linear


# ------------------------------------------------------------------ finishers


def _per_track(T, F, seed=7):
    return (np.random.default_rng(seed).standard_normal((T, C, F)) * 0.2).astype(np.float32)


def _gains(T, seed=8):
    return np.random.default_rng(seed).uniform(0.2, 1.3, (T, C)).astype(np.float32)


FINISH_CASES = ["plain", "lanes", "meters", "lanes_meters"]


@pytest.mark.parametrize("case", FINISH_CASES)
def test_finish_mix_matches_jax(case):
    import jax.numpy as jnp

    lanes, meters = "lanes" in case, "meters" in case
    js, s = fx_pair(seed=12, lanes=lanes)
    T, F = len(s.tracks), 20000
    x, tg = _per_track(T, F), _gains(T)
    (jS, jc), (jSm, jm) = jpipe.prepare_effect_tables(js, RATE, C)
    (S, pc), (Sm, pm) = ppipe.prepare_effect_tables(s, RATE, C)
    jauto = jpipe.prepare_automation_tables(js, RATE)
    pauto = ppipe.prepare_automation_tables(s, RATE)
    assert (jauto is None) == (pauto is None) == (not lanes)
    kw = dict(T=T, C=C, chunk=8192, with_meters=meters, valid_frames=F - 3000 if meters else None)
    want = jpipe.finish_mix(jnp.asarray(x), jc, jm, jnp.asarray(tg), jauto, S=jS, Sm=jSm, **kw)
    got = ppipe.finish_mix(torch.from_numpy(x), pc, pm, torch.from_numpy(tg), pauto, S=S, Sm=Sm, **kw)
    if meters:
        (want, wm), (got, gm) = want, got
        for a, b in zip(gm, wm):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert got.shape == (C, F) and got.dtype == torch.float32
    assert rel_rms(got.numpy(), np.asarray(want)) < 1e-5


def test_finish_mix_chunk_streams_like_finish_mix():
    js, s = fx_pair(seed=13)
    T, F, chunk = len(s.tracks), 16384, 4096
    x, tg = torch.from_numpy(_per_track(T, F)), torch.from_numpy(_gains(T))
    (S, pc), (Sm, pm) = ppipe.prepare_effect_tables(s, RATE, C)
    whole = ppipe.finish_mix(x, pc, pm, tg, T=T, C=C, S=S, Sm=Sm, chunk=chunk)
    states, mstates = ppipe.init_effect_states(T, C, S, Sm)
    parts = []
    for i in range(0, F, chunk):
        out, states, mstates, m = ppipe.finish_mix_chunk(x[..., i:i + chunk], pc, pm, tg, states, mstates,
                                                          i, T=T, C=C, S=S, Sm=Sm, with_meters=True)
        parts.append(out)
        assert m[0].shape == (T, C) and m[2].shape == (C,)
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0, atol=0)


@pytest.mark.parametrize("lanes", [False, True], ids=["constant_gains", "lanes"])
def test_fir_finishers_match_jax(lanes):
    import jax.numpy as jnp

    js, s = fx_pair(seed=14, lanes=lanes)
    T, F = len(s.tracks), 30000
    x, tg = _per_track(T, F), _gains(T)
    jauto = jpipe.prepare_automation_tables(js, RATE)
    want = jfir.prepare_fir_finish(js, RATE, jnp.asarray(tg), jauto, C)(jnp.asarray(x))
    got = pfir.prepare_fir_finish(s, RATE, torch.from_numpy(tg), ppipe.prepare_automation_tables(s, RATE),
                                  C)(torch.from_numpy(x))
    assert got.shape == (C, F)
    assert rel_rms(got.numpy(), np.asarray(want)) < 1e-5


def test_fir_general_and_spectral_agree():
    # both FIR finishers on constant gains: the general one with the master
    # convolved after the sum, the spectral one with it folded into the IRs
    js, s = fx_pair(seed=15)
    T, F = len(s.tracks), 30000
    x, tg = torch.from_numpy(_per_track(T, F)), torch.from_numpy(_gains(T))
    h_rows, master_h = pfir.prepare_fir_tables(s, RATE, C)
    general = pfir.finish_mix_fir(x, torch.from_numpy(h_rows), torch.from_numpy(master_h), tg,
                                  T=T, C=C, B=max(pfir._next_pow2(2 * h_rows.shape[1]), 4096),
                                  Bm=max(pfir._next_pow2(2 * master_h.shape[0]), 4096))
    spectral = pfir.prepare_fir_finish(s, RATE, tg, None, C)(x)
    assert rel_rms(spectral.numpy(), general.numpy()) < 1e-5


def test_reference_finish_mix_with_chains_equals_jax():
    for lanes in (False, True):
        js, s = fx_pair(seed=16, lanes=lanes)
        x = _per_track(len(s.tracks), 6000)
        np.testing.assert_array_equal(ppipe.reference_finish_mix(x, s, RATE),
                                      jpipe.reference_finish_mix(x, js, RATE))


def test_packable_predicates_equal_jax():
    from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu.render import effects_generic as jgen
    from whitebox_tpu_torch.render import effects_generic as pgen

    eq, _ = fx_pair(seed=18)
    comp, _ = fx_pair(seed=18)
    comp.tracks[2].effects = jfx.EffectChain([jfx.Compressor(-18.0, 4.0)])
    lane, _ = fx_pair(seed=18)
    lane.tracks[0].automation = TrackAutomation(effects={(0, "gain_db"): AutomationLane().add(0.0, 0.5)})
    bare = random_session(18, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)
    for js in (eq, comp, lane, bare):
        s = from_reference(js)
        assert pgen.session_fx_packable(s) == jgen.session_fx_packable(js)
        assert [pgen.chain_is_packable(c) for c in ppipe._chains_of(s)[0]] == \
            [jgen.chain_is_packable(c) for c in jpipe._chains_of(js)[0]]
    assert [pgen.session_fx_packable(from_reference(js)) for js in (eq, comp, lane, bare)] == \
        [True, False, False, True]


# ------------------------------------------------------------------ the carry


def _walk(obj, seen, found):
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool, type(None), np.ndarray,
                                           np.generic, torch.Tensor)):
        return
    seen.add(id(obj))
    mod = type(obj).__module__ or ""
    if mod.split(".")[0] in ("whitebox_tpu", "jax", "jaxlib"):
        found.append(f"{mod}.{type(obj).__name__}")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _walk(k, seen, found)
            _walk(v, seen, found)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _walk(v, seen, found)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            _walk(v, seen, found)


def _every_effect_session():
    js = random_session(17, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    js.tracks[0].effects = jfx.EffectChain([jfx.Gain(-2.0), jfx.Biquad("peak", 700.0, 1.0, 3.0),
                                            jfx.ParametricEQ([("lowshelf", 90.0, 0.7, 2.0)]),
                                            jfx.Compressor(-18.0, 4.0), jfx.Delay(0.25, 0.3),
                                            jfx.ConvolutionReverb(None, room_seconds=0.2),
                                            jfx.Saturator(6.0), jfx.StereoWidth(1.2),
                                            jfx.LinearPhaseEQ([("peak", 1000.0, 1.0, 3.0)], taps=63)])
    js.tracks[1].effects.extend([jfx.Chorus(), jfx.Flanger(), jfx.NoiseGate(-50.0)])
    js.master_effects = jfx.EffectChain([jfx.Limiter(-0.3), jfx.Biquad("highpass", 25.0)])
    js.tracks[0].effects.prepare(RATE, 2)  # prepared state must not cross either
    bus = js.add_bus("b")
    bus.effects = [jfx.Gain(-1.0)]
    js.tracks[2].frozen = {"clips": [c.clone() for c in js.tracks[2].clips],
                           "effects": jfx.EffectChain([jfx.Biquad("lowpass", 3000.0)]),
                           "eff_lanes": {}, "asset_key": ""}
    return js


def test_from_reference_carries_no_reference_object():
    """Every built-in effect crosses as its port class with the same
    settings (the generic pipeline renders them); no JAX-package object
    survives."""
    js = _every_effect_session()
    s = from_reference(js)
    found: list = []
    _walk(s, set(), found)
    assert not found, sorted(set(found))
    chain = s.tracks[0].effects
    assert [type(e).__name__ for e in chain.effects] == [
        "Gain", "Biquad", "ParametricEQ", "Compressor", "Delay", "ConvolutionReverb", "Saturator",
        "StereoWidth", "LinearPhaseEQ"]
    assert not any(isinstance(e, pfx.UnportedEffect) for e in chain.effects)
    comp = chain.effects[3]
    assert comp.name == "compressor" and comp.threshold_db == -18.0 and comp.ratio == 4.0
    assert chain.effects[8].taps == 63 and chain.effects[5].room_seconds == 0.2
    assert [type(e).__name__ for e in s.tracks[1].effects][-3:] == ["Chorus", "Flanger", "NoiseGate"]
    assert isinstance(s.master_effects, pfx.EffectChain)
    assert [e.name for e in s.master_effects.effects] == ["limiter", "biquad"]
    assert isinstance(s.tracks[2].frozen["effects"].effects[0], pfx.Biquad)
    assert isinstance(s.buses[0].effects[0], pfx.Gain)
    y, _ = comp.prepare(RATE, 2).process(torch.zeros((2, 8)), comp.init_state(2))
    assert y.shape == (2, 8)
