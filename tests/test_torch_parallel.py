"""whitebox_tpu_torch's sharded render (``parallel/``) on a world of four CPU
processes over gloo.

One world serves the module (``parallel/launch.py::run_world``, started
once by a fixture): every rank runs the same jobs (``tests/torch_parallel_worlds.py``)
on the same sessions and returns what it rendered; the ranks must agree
bit for bit. The sessions are built with the JAX package and carried
across by ``from_reference``; the JAX references run in this process on
``jax.devices()[:4]``, the mesh shapes the port's world has. Bars (the JAX
package's own, ``tests/test_sharded.py:40``, ``tests/test_mesh_smoke.py:48``):

- plain mixes on a frames-only mesh bit-equal to the port's single-device
  gather bounce (``bounce(engine="xla", device="cpu")``); on a 2-D mesh
  (the ordered track sum re-associates) within atol 2e-6, rtol 1e-5;
- chained, automated, routed and MIDI sessions within atol 3e-6, rtol 1e-4
  of the port's single-device bounce and of the JAX package's
  ``bounce_sharded`` on the same mesh shape;
- the frame-sharded biquad within atol 2e-5 of the single scan; the
  cascade's two passes (the card's form, the plain cascade on the CPU)
  within relative RMS 5e-6 a row of one pass over the whole signal.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
from tests.test_carve import random_session
from tests.torch_parallel_worlds import run_jobs, same_on_every_rank
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu.parallel import bounce_sharded as jax_bounce_sharded
from whitebox_tpu.parallel import make_render_mesh as jax_mesh
from whitebox_tpu_torch.ops import biquad as bq
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade_reference
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk
from whitebox_tpu_torch.parallel.launch import run_world
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session

RATE = 48000.0
WORLD = 4
PLAIN_ATOL, PLAIN_RTOL = 2e-6, 1e-5
FX_ATOL, FX_RTOL = 3e-6, 1e-4


def _tiny_session(seed, routed=False, lanes=False):
    """``tests/test_mesh_smoke.py::_tiny_session``."""
    s = random_session(seed, rate=RATE, bpm=160.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=1)
    if routed:
        bus = s.add_bus("b", volume_db=-3.0)
        bus.effects = jfx.EffectChain([jfx.Gain(-1.5)])
        s.set_track_output(0, 0)
        s.add_send(1, 0, gain_db=-6.0)
    if lanes:
        s.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 8000.0)])
        s.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(2.0, 0.4))
    return s


def _latent_bus_session():
    s = _tiny_session(9, routed=True)
    s.buses[0].effects = jfx.EffectChain([jfx.Limiter(-1.0)])
    return s


def _cascade_case():
    """Rows through a 25 Hz highpass and a two-band EQ (three sections),
    as the cascade kernel takes them: coefficients ``[9, 3, R, 1]``."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 4 * 3000)) * 0.3).astype(np.float32)
    secs = [bq.design_biquad("highpass", 25.0, RATE), bq.design_biquad("lowshelf", 120.0, RATE, 0.707, 3.0),
            bq.design_biquad("peak", 2000.0, RATE, 1.0, -2.0)]
    pa = np.stack([bq.eig_section_params(c) for c in secs], axis=1)  # [9, 3]
    coeffs = np.broadcast_to(pa[:, :, None, None], (9, 3, x.shape[0], 1)).astype(np.float32).copy()
    return x, coeffs


SESSIONS = {
    "plain": lambda: random_session(3, rate=48000, bpm=120.0, n_tracks=8, n_clips=2),
    "split": lambda: random_session(4, rate=48000, bpm=120.0, n_tracks=4, n_clips=1),
    "routed": lambda: _tiny_session(5, routed=True),
    "surface": lambda: _tiny_session(6, routed=True, lanes=True),
    "sinc": lambda: random_session(31, rate=RATE, bpm=160.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=1,
                                   speeds=(0.5, 2.0 ** (1.0 / 12.0)), src_rates=(48000.0,)),
    "pathological": lambda: random_session(33, rate=RATE, bpm=160.0, n_tracks=2, formats=(AudioFormat.F32,),
                                           n_clips=1, speeds=(9.3,), src_rates=(48000.0,)),
    "latent_bus": _latent_bus_session,
}


@pytest.fixture(scope="module")
def sessions():
    js = {k: f() for k, f in SESSIONS.items()}
    from whitebox_tpu.session.clip import ClipMode

    for c in js["sinc"].tracks[0].clips:
        c.audio.mode = ClipMode.LOOP_BIDIRECTIONAL
    return js, {k: from_reference(v) for k, v in js.items()}


@pytest.fixture(scope="module")
def world(sessions):
    """Every job of the module, run once on a world of four CPU ranks."""
    _, ps = sessions
    x_bq = (np.random.default_rng(0).standard_normal((2, 8192)) * 0.3).astype(np.float32)
    pa = bq.eig_section_params(bq.design_biquad("highpass", 30.0, RATE))
    x_casc, coeffs = _cascade_case()
    jobs = {
        "mesh_default": ("mesh", {}),
        "mesh_frames": ("mesh", {"fp": 4}),
        "mesh_bad": ("mesh", {"tp": 3}),
        "plain_1x4": ("bounce", {"session": ps["plain"], "tp": 1, "fp": 4}),
        "plain_2x2": ("bounce", {"session": ps["plain"], "tp": 2, "fp": 2}),
        "split_2x2": ("render_chunk", {"session": ps["split"], "tp": 2, "fp": 2, "pad_to": 8, "frames": 4096}),
        "biquad_1x4": ("biquad", {"x": x_bq, "pa": pa, "tp": 1, "fp": 4}),
        "cascade_1x4": ("cascade", {"x": x_casc, "coeffs": coeffs, "tp": 1, "fp": 4}),
        "routed_1x4": ("bounce", {"session": ps["routed"], "tp": 1, "fp": 4}),
        "surface_2x2": ("bounce", {"session": ps["surface"], "tp": 2, "fp": 2}),
        "sinc_1x4": ("bounce", {"session": ps["sinc"], "tp": 1, "fp": 4, "kw": {"interpolation": "sinc"}}),
        "pathological_1x4": ("bounce", {"session": ps["pathological"], "tp": 1, "fp": 4,
                                        "kw": {"interpolation": "sinc"}}),
        "catmull_1x4": ("bounce", {"session": ps["plain"], "tp": 1, "fp": 4, "kw": {"interpolation": "catmull"}}),
        "latent_bus_pdc_2x2": ("bounce", {"session": ps["latent_bus"], "tp": 2, "fp": 2, "kw": {"pdc": True}}),
    }
    res = same_on_every_rank(run_world(run_jobs, WORLD, device="cpu", timeout=240,
                                       args=(list(jobs.values()),)))
    return dict(zip(jobs, res))


def _ok(world, name):
    r = world[name]
    assert r[0] == "ok", f"{name}: {r}"
    return r[1]


def _jax_sharded(js, tp, fp, **kw):
    return jax_bounce_sharded(js, RATE, jax_mesh(tp, fp, devices=jax.devices()[:WORLD]), **kw)


def test_mesh_defaults(world):
    """``make_render_mesh()`` on four ranks prefers a tracks axis of 2 (the
    JAX rule); ``frames_parallel`` alone fills the tracks axis; a mesh
    that does not match the world raises the JAX package's ValueError."""
    shape, coords = _ok(world, "mesh_default")
    assert shape == {"tracks": 2, "frames": 2} and coords == {"tracks": 0, "frames": 0}
    assert _ok(world, "mesh_frames")[0] == {"tracks": 1, "frames": 4}
    assert world["mesh_bad"][:2] == ("error", "ValueError") and "3x1 != 4 devices" in world["mesh_bad"][2]
    jm = jax_mesh(devices=jax.devices()[:WORLD])
    assert dict(jm.shape) == shape


def test_plain_mix_frames_only_bit_equal(world, sessions):
    """1x4: the sharded gather is the single-device gather bounce, bit for bit."""
    _, ps = sessions
    ref = bounce(ps["plain"], RATE, engine="xla", device="cpu").audio
    got = _ok(world, "plain_1x4")
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_plain_mix_2d_mesh(world, sessions):
    """2x2: the ordered track sum over two track shards, within the JAX
    package's psum bar of the single-device bounce and of its own 2x2."""
    js, ps = sessions
    got = _ok(world, "plain_2x2")
    np.testing.assert_allclose(got, bounce(ps["plain"], RATE, engine="xla", device="cpu").audio,
                               atol=PLAIN_ATOL, rtol=PLAIN_RTOL)
    np.testing.assert_allclose(got, _jax_sharded(js["plain"], 2, 2), atol=PLAIN_ATOL, rtol=PLAIN_RTOL)


def test_output_frame_split(world, sessions):
    """``render_chunk_sharded`` returns each rank's frame shard: shard
    ``fi`` holds frames ``[fi * 2048, (fi + 1) * 2048)`` of the mix (tables
    padded to 8 tracks over the tracks axis, as the JAX test pads them)."""
    _, ps = sessions
    s = ps["split"]
    table, pool = carve_session(s, RATE, buffer_size=512)
    jt = pack_device_tables(table, pool, s, pad_tracks_to=8).as_torch()
    single = render_chunk(torch.from_numpy(pool.data), jt, 0, 4096).numpy()
    coords, local = _ok(world, "split_2x2")
    assert local.shape == (2, 2048) and coords == {"tracks": 0, "frames": 0}
    np.testing.assert_allclose(local, single[:, :2048], atol=PLAIN_ATOL, rtol=PLAIN_RTOL)


def test_frame_sharded_biquad_matches_single_scan(world):
    """``biquad_shard_framewise`` (the Hillis-scan injection) over four
    frame shards against one scan of the whole signal (atol 2e-5, the
    JAX test's bar)."""
    x = (np.random.default_rng(0).standard_normal((2, 8192)) * 0.3).astype(np.float32)
    ref, _ = bq.biquad_scan(torch.from_numpy(x), bq.design_biquad("highpass", 30.0, RATE))
    np.testing.assert_allclose(_ok(world, "biquad_1x4"), ref.numpy(), atol=2e-5)


def test_cascade_two_pass_matches_one_pass(world):
    """``cascade_shard_framewise``: the cascade from zero, the f64 fold of
    the predecessors' end states through ``Phi`` over a 3000-frame shard
    (not a power of two), the cascade again from the folded state; against
    one pass over the whole signal, relative RMS 5e-6 a row."""
    x, coeffs = _cascade_case()
    ref, _ = biquad_cascade_reference(torch.from_numpy(x), torch.from_numpy(coeffs),
                                      [torch.zeros((x.shape[0], 2)) for _ in range(3)])
    got = torch.from_numpy(_ok(world, "cascade_1x4")).double()
    d = (got - ref.double()).pow(2).mean(dim=1).sqrt() / ref.double().pow(2).mean(dim=1).sqrt()
    assert float(d.max()) < 5e-6, d


@pytest.mark.parametrize("name,case,tp,fp", [("routed_1x4", "routed", 1, 4), ("surface_2x2", "surface", 2, 2)])
def test_fx_smoke_against_port_and_jax(world, sessions, name, case, tp, fp):
    """``tests/test_mesh_smoke.py:39,51``: the routed finisher on a
    frames-only mesh, and chains + lanes + routing on a 2-D mesh, within
    atol 3e-6 / rtol 1e-4 of the port's single-device bounce and of the JAX
    package's ``bounce_sharded`` on the same mesh shape."""
    js, ps = sessions
    got = _ok(world, name)
    single = bounce(ps[case], RATE, engine="xla", chunk_frames=4096, device="cpu").audio
    n = min(single.shape[1], got.shape[1])
    np.testing.assert_allclose(got[:, :n], single[:, :n], atol=FX_ATOL, rtol=FX_RTOL)
    ref = _jax_sharded(js[case], tp, fp)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, atol=FX_ATOL, rtol=FX_RTOL)


def test_sinc_host_rewrite(world, sessions):
    """``interpolation="sinc"``: the host prerender rewrite plays resampled
    clips (forward rational, irrational, reverse) through the linear
    sharded mix; reference the single-device host mirror of the same
    rewrite (``tests/test_mesh_smoke.py:123``)."""
    from whitebox_tpu_torch.timeline.carve import render_segments_per_track_numpy
    from whitebox_tpu_torch.timeline.prerender import apply_prerender_host, plan_prerender

    _, ps = sessions
    s = ps["sinc"]
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    assert not table.fast.all()
    plan = plan_prerender(table, pool, partial=True)
    assert plan is not None and plan.uncovered_rows is None
    pt = render_segments_per_track_numpy(*apply_prerender_host(table, pool, plan))
    ref = np.zeros((2, pt.shape[2]))
    for t, tr in enumerate(s.tracks):
        vol = np.float32(0.0) if tr.mute else tr.volume_linear
        for ch in range(2):
            ref[ch] += pt[t][ch] * float(np.float32(vol * np.float32(tr.pan_coeffs[ch])))
    ref = np.clip(ref, -1, 1).astype(np.float32)
    got = _ok(world, "sinc_1x4")
    n = min(ref.shape[1], got.shape[1])
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=FX_ATOL, rtol=FX_RTOL)


def test_sinc_pathological_and_catmull_contract(world, sessions):
    """Speeds the host prerender cannot cover (|speed| > 8) raise
    ``NotImplementedError`` naming the single-chip route, and Catmull-Rom
    is a single-chip kernel mode (``tests/test_mesh_smoke.py:161``); the
    same session renders single-device through the oversample fallback."""
    _, ps = sessions
    kind, name, msg = world["pathological_1x4"]
    assert (kind, name) == ("error", "NotImplementedError") and "single-chip" in msg
    kind, name, msg = world["catmull_1x4"]
    assert (kind, name) == ("error", "NotImplementedError") and "catmull is a single-chip" in msg
    res = bounce(ps["pathological"], RATE, interpolation="sinc", prerender=False, device="cpu")
    assert np.isfinite(res.audio).all()


def test_pdc_refuses_latent_bus_chains(world):
    """Sharded PDC does not carry bus-chain latency: a lookahead limiter on
    a bus raises the JAX package's ValueError."""
    kind, name, msg = world["latent_bus_pdc_2x2"]
    assert (kind, name) == ("error", "ValueError") and "bus-chain latency" in msg


# ---------------------------------------------------------------------------
# deep cases (the JAX package's slow tier: tests/test_sharded.py)
# ---------------------------------------------------------------------------


def _chains_session():
    s = random_session(8, rate=48000, bpm=120.0, n_tracks=4, n_clips=2)
    s.tracks[0].effects = jfx.EffectChain([jfx.Gain(-2.0), jfx.Biquad("lowpass", 5000.0)])
    s.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    s.tracks[2].effects = jfx.EffectChain([jfx.Gain(-2.0), jfx.Biquad("lowpass", 6500.0)])
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0)])
    return s


def _automation_midi_session():
    from whitebox_tpu.midi.notes import MidiNote, MidiNoteBuffer

    s = random_session(21, rate=48000, bpm=120.0, n_tracks=4, n_clips=1)
    s.tracks[0].effects = jfx.EffectChain([jfx.Gain(-2.0), jfx.Biquad("lowpass", 5000.0)])
    s.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    s.tracks[1].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(4.0, 0.3))
    s.tracks[3].effects = jfx.EffectChain([jfx.Biquad("lowpass", 7000.0, 1.0)])
    s.tracks[3].automation = TrackAutomation(
        effects={(0, "freq_hz"): AutomationLane().add(0.0, 7000.0).add(2.0, 500.0)})
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0)])
    asset = s.midi_table.create_midi(MidiNoteBuffer([MidiNote(0.0, 1.0, key=60, velocity=0.7),
                                                     MidiNote(1.0, 2.0, key=64, velocity=0.6)]))
    tr = s.add_track("midi")  # 5 tracks on a tracks axis of 2: a padded track row
    s.add_midi_clip(tr, "m", 0.0, 2.0, asset=asset)
    return s


def _scale_session():
    s = random_session(77, rate=48000, bpm=120.0, n_tracks=32, n_clips=2)
    chains = [[jfx.Compressor(-18.0, 4.0)], [jfx.Biquad("lowpass", 6000.0)],
              [jfx.Gain(-2.0), jfx.Saturator(6.0, mix=0.5)], [jfx.NoiseGate(-45.0)],
              [jfx.Delay(0.05, 0.4, wet=0.3)], None]
    for i, t in enumerate(s.tracks):
        c = chains[i % len(chains)]
        if c is not None:
            t.effects = jfx.EffectChain(copy.deepcopy(c))
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 25.0)])
    return s


def _pdc_session():
    s = _tiny_session(9, routed=True)
    s.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 9000.0), jfx.Limiter(-1.0)])
    s.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0), jfx.Limiter(-0.5)])
    return s


def _master_chain_session():
    s = random_session(6, rate=48000, bpm=120.0, n_tracks=8, n_clips=2)
    s.master_effects = jfx.EffectChain([jfx.NoiseGate(-50.0), jfx.Compressor(-18.0, 4.0)])
    return s


DEEP = [  # name, session, mesh shapes, bounce_sharded keywords, single-device bounce keywords
    ("chains", _chains_session, ((1, 4), (2, 2)), {}, {}),
    ("automation_midi", _automation_midi_session, ((1, 4), (2, 2), (4, 1)), {}, {}),
    ("scale_32trk", _scale_session, ((1, 4),), {}, {}),
    ("pdc", _pdc_session, ((1, 4), (2, 2)), {"pdc": True}, {"pdc": True}),
]


@pytest.fixture(scope="module")
def deep_world():
    cases = {name: (from_reference(f()), f(), shapes, kw, skw) for name, f, shapes, kw, skw in DEEP}
    jobs, keys = [], []
    for name, (ps, _, shapes, kw, _) in cases.items():
        for tp, fp in shapes:
            jobs.append(("bounce", {"session": ps, "tp": tp, "fp": fp, "kw": kw}))
            keys.append((name, tp, fp))
    master = _master_chain_session()
    jobs.append(("bounce", {"session": from_reference(master), "tp": 2, "fp": 2}))
    keys.append(("master_chain", 2, 2))
    res = same_on_every_rank(run_world(run_jobs, WORLD, device="cpu", timeout=900, args=(jobs,)))
    cases["master_chain"] = (None, master, ((2, 2),), {}, None)
    return cases, dict(zip(keys, res))


@pytest.mark.slow
@pytest.mark.parametrize("name", [d[0] for d in DEEP])
def test_deep_sharded_against_port_and_jax(deep_world, name):
    """Chains (``test_sharded.py:76``), automation + TV biquad lanes + MIDI
    on every mesh shape (``:117,209``), 32 tracks of mixed chains
    (``:232``) and PDC (``test_mesh_smoke.py:85``): within atol 3e-6 /
    rtol 1e-4 of the port's single-device bounce and of the JAX package's
    ``bounce_sharded`` on the same mesh shape."""
    cases, res = deep_world
    ps, js, shapes, kw, skw = cases[name]
    single = bounce(ps, RATE, engine="xla", chunk_frames=4096, device="cpu", **skw).audio
    for tp, fp in shapes:
        r = res[(name, tp, fp)]
        assert r[0] == "ok", r
        got = r[1]
        n = min(single.shape[1], got.shape[1])
        np.testing.assert_allclose(got[:, :n], single[:, :n], atol=FX_ATOL, rtol=FX_RTOL,
                                   err_msg=f"{name} {tp}x{fp} vs the port's bounce")
        np.testing.assert_allclose(got, _jax_sharded(js, tp, fp, **kw), atol=FX_ATOL, rtol=FX_RTOL,
                                   err_msg=f"{name} {tp}x{fp} vs the JAX bounce_sharded")


@pytest.mark.slow
def test_plain_mix_master_chain_against_jax(deep_world):
    """A plain mix with a master chain (``test_sharded.py:46``): the chain
    follows the clipped mix, frame-sharded, as in the JAX package; within
    atol 3e-6 / rtol 1e-4 of its ``bounce_sharded`` on 2x2."""
    cases, res = deep_world
    r = res[("master_chain", 2, 2)]
    assert r[0] == "ok", r
    np.testing.assert_allclose(r[1], _jax_sharded(cases["master_chain"][1], 2, 2), atol=FX_ATOL, rtol=FX_RTOL)
