"""whitebox_tpu_torch's bounce, demo builder and CLI (CPU).

The port's ``bounce(device="cpu")`` renders with the plain PyTorch mix,
the CUDA kernel's twin; at speed 1 it must be bit-equal to the JAX
package's ``bounce(engine="pallas")`` (interpret mode here) and to the
NumPy oracle. With effect chains it runs the per-track mode's twin and the
finishers: within relative RMS 1e-5 of the JAX bounce, and within the JAX
package's bars of the f64 reference (scan 5e-5, FIR 2e-4). Sessions are
made with the JAX package's session functions and carried to the port by
``from_reference``.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from tests.test_carve import random_session
from chip_smoke import rel_rms
from tests.test_torch_mix import assert_ulp_contract
from tests.test_torch_mix_plan import dense_session, make_case
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.io import wav
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.render.demo import make_demo_session as jax_make_demo_session
from whitebox_tpu.session.project import write_project
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu.timeline.carve import render_segments_numpy, render_segments_per_track_numpy
from whitebox_tpu.timeline.oracle import OracleRenderer
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import mix_cuda
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow
bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")
from whitebox_tpu_torch.render.bounce import bounce as port_bounce
from whitebox_tpu_torch.render.demo import make_demo_session
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session


def bounce(session, *args, **kw):
    """The port's bounce of a JAX-package session, carried across."""
    return port_bounce(from_reference(session), *args, **kw)


def test_bounce_speed1_matches_jax_pallas_and_oracle(tmp_path):
    s = random_session(1, rate=48000, bpm=120.0, n_tracks=4)
    oracle = OracleRenderer(s, 48000.0, buffer_size=512).render()
    p = tmp_path / "mix.wav"
    res = bounce(s, 48000.0, device="cpu", out_path=p)
    np.testing.assert_array_equal(res.audio[:, : oracle.shape[1]], oracle)
    np.testing.assert_array_equal(res.audio, jax_bounce(s, 48000.0, engine="pallas").audio)
    back, info = wav.read_wav(p)
    assert info.format == AudioFormat.F32
    np.testing.assert_array_equal(back, res.audio)
    st = res.stats
    assert st.device == "cpu" and st.frames == res.frames and st.rtf > 0
    assert "on cpu" in st.summary()


@pytest.mark.parametrize("name", ["mixed_speeds", "loop_reverse"])
def test_bounce_resampled_meets_contract(name):
    s, rate, _ = make_case(name)
    res = bounce(s, rate, device="cpu")
    table, pool = jax_carve_session(s, rate, buffer_size=512, slow_emit="runs")
    assert not table.fast.all()
    assert_ulp_contract(res.audio, render_segments_numpy(table, pool, s))


def test_bounce_i16_export_and_trim(tmp_path):
    s = random_session(4, rate=48000, bpm=120.0, n_tracks=2, formats=(AudioFormat.I16,), n_clips=1)
    p = tmp_path / "mix16.wav"
    res = bounce(s, 48000.0, device="cpu", trim_frames=20000, out_path=p, out_format=AudioFormat.I16)
    assert res.audio.shape == (2, 20000)
    back, info = wav.read_wav(p)
    assert info.format == AudioFormat.I16 and back.shape == res.audio.shape
    assert np.abs(back.astype(np.float64) - res.audio).max() <= 1.0 / 32768


def test_bounce_tail_extends_render():
    s = random_session(5, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)
    plain = bounce(s, 48000.0, device="cpu")
    tail = bounce(s, 48000.0, device="cpu", tail_seconds=0.5)
    assert tail.frames >= plain.frames + 24000 - 512
    np.testing.assert_array_equal(tail.audio[:, : plain.frames], plain.audio)
    assert not tail.audio[:, plain.frames:].any()


def test_demo_session_matches_jax_builder():
    kw = dict(n_tracks=4, duration_seconds=3.0, sample_rate=48000, seed=7, sample_seconds=1.0,
              clip_speeds=(1.0, 44100 / 48000), fades=True)
    a, b = make_demo_session(**kw), jax_make_demo_session(**kw)
    ta, _ = carve_session(a, 48000.0, buffer_size=512)
    tb, _ = jax_carve_session(b, 48000.0, buffer_size=512)
    # edit_stamp() hashes each clip's asset by object identity, so two
    # builds can only share a stamp once their clips share asset objects:
    # check the samples are equal, then point b's clips at a's assets
    # (the stamp reads enums by value, so the two packages' stamps agree)
    clips_a = [c for t in a.tracks for c in t.clips]
    clips_b = [c for t in b.tracks for c in t.clips]
    assert len(clips_a) == len(clips_b) > 0
    for ca, cb in zip(clips_a, clips_b):
        sa, sb = ca.audio.asset.sample, cb.audio.asset.sample
        assert (sa.channels, sa.sample_rate, sa.count, sa.format) == (sb.channels, sb.sample_rate, sb.count, sb.format)
        for da, db in zip(sa.data, sb.data):
            np.testing.assert_array_equal(da, db)
        cb.audio.asset = ca.audio.asset
    assert a.edit_stamp() == b.edit_stamp()
    for f in ("track", "dst_start", "length", "sample_id", "src_int", "src_frac", "speed", "gain",
              "fast", "clamp", "fin_start", "fin_inv", "fout_end", "fout_inv"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f), err_msg=f)
    assert (ta.total_frames, ta.num_tracks) == (tb.total_frames, tb.num_tracks)


def _unsupported_sessions():
    from whitebox_tpu.effects import Compressor, Gain, Limiter
    from whitebox_tpu.midi.notes import MidiNote, MidiNoteBuffer
    from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation

    def base():
        return random_session(6, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)

    # dynamics on a track and on the master and an effect-parameter lane
    # finish in the generic pipeline
    s_fx = base()
    s_fx.tracks[0].effects.append(Compressor(-18.0, 4.0))
    s_master = base()
    s_master.master_effects.append(Limiter(-0.3))
    s_lane = base()  # an effect-parameter lane on a gain (volume/pan lanes render, K3)
    s_lane.tracks[0].effects.append(Gain(0.0))
    s_lane.tracks[0].automation = TrackAutomation(effects={(0, "gain_db"): AutomationLane().add(0.0, 1.0)
                                                                           .add(2.0, -9.0)})
    s_midi = base()
    tr = s_midi.add_track("m")
    s_midi.add_midi_clip(tr, "c", 0.0, 2.0, asset=s_midi.midi_table.create_midi(MidiNoteBuffer(
        [MidiNote(0.0, 1.0, key=69, velocity=0.8), MidiNote(0.5, 1.5, key=76, velocity=0.5)])))
    s_bus = base()
    s_bus.add_bus("b")
    s_bus.set_track_output(0, 0)
    # the 16 slots of the oversampled sinc form overflow at the smallest
    # tile: the gather path takes the session, as in the JAX package
    s_dense = dense_session()
    for i, c in enumerate(s_dense.tracks[0].clips):  # twice 12 runs within one 1024-frame tile
        c.min_time, c.max_time = i * 0.0015, i * 0.0015 + 0.0012
    for i in range(12):
        s_dense.add_audio_clip(s_dense.tracks[0], f"e{i}", 0.02 + i * 0.0015, 0.02 + i * 0.0015 + 0.0012,
                               start_offset=0.0, asset=s_dense.tracks[0].clips[0].audio.asset,
                               speed=1.1 + 0.017 * i)
    return {"effects": (s_fx, {}), "master_effects": (s_master, {}),
            "effect_lane": (s_lane, {}), "midi": (s_midi, {}), "routing": (s_bus, {}),
            "sinc_slot_overflow": (s_dense, {"interpolation": "sinc", "prerender": False}),
            "unknown_interpolation": (base(), {"interpolation": "cubic"})}


@pytest.mark.parametrize("feature", ["effects", "master_effects", "effect_lane", "midi",
                                     "routing", "sinc_slot_overflow", "unknown_interpolation"])
def test_unsupported_features_raise(feature):
    """Features once unported now render: dynamics and an effect lane
    through the generic finisher, within 5e-5 (the lane 2e-4) of the JAX
    package's f64 reference_generic_finish; a sinc slot overflow through
    the gather path, within 3e-6 of the JAX bounce; a MIDI track through
    the synth, within 1e-6 of the NumPy synth summed by the f64 reference;
    a bus through the routed finisher, within 2e-5 of the f64
    reference_routed_finish. An unknown interpolation still raises."""
    s, kw = _unsupported_sessions()[feature]
    if feature == "unknown_interpolation":
        with pytest.raises(ValueError, match="interpolation must be"):
            bounce(s, 48000.0, device="cpu", **kw)
        return
    got = bounce(s, 48000.0, device="cpu", **kw)
    if feature in ("midi", "routing"):
        from whitebox_tpu.render.routing import reference_routed_finish

        table, pool = jax_carve_session(s, 48000.0, buffer_size=512)
        pt = render_segments_per_track_numpy(table, pool)
        if feature == "midi":
            from tests.test_torch_midi import synth_rows

            pt = pt + synth_rows(s, 48000.0, pt.shape[-1])
            ref = _generic_reference(s, pt)
            np.testing.assert_allclose(got.audio, ref, atol=1e-6)
        else:
            ref = reference_routed_finish(pt, s, 48000.0)
            assert rel_rms(got.audio, ref) < 2e-5
        assert got.stats.mix_path == "kernel" and float(np.abs(ref).max()) > 0.01
        return
    if feature == "sinc_slot_overflow":
        want = jax_bounce(s, 48000.0, **kw).audio
        assert got.stats.mix_path == "gather" and got.audio.shape == want.shape
        np.testing.assert_allclose(got.audio, want, atol=3e-6)
        return
    ref = _generic_reference(s)
    assert got.stats.mix_path == "kernel" and got.audio.shape == ref.shape
    assert float(np.abs(ref).max()) > 0.01
    assert rel_rms(got.audio, ref) < (2e-4 if feature == "effect_lane" else 5e-5)


def _generic_reference(js, per_track=None):
    """The JAX package's f64 generic finish of a JAX-package session (of
    its carve's per-track buffers unless given)."""
    from whitebox_tpu.render.effects_generic import reference_generic_finish

    if per_track is None:
        table, pool = jax_carve_session(js, 48000.0, buffer_size=512)
        per_track = render_segments_per_track_numpy(table, pool)
    return reference_generic_finish(per_track, js, 48000.0)


def test_unported_effects_name_their_item():
    """An effect class registered only in the JAX package crosses as an
    UnportedEffect, which bounce names; routed mode on a session without
    buses, effects or lanes is the plain mix, bit for bit."""
    from whitebox_tpu.effects import registry as jax_registry
    from whitebox_tpu.effects.base import Effect as JaxEffect

    class JaxOnlyFx(JaxEffect):
        def __init__(self, amount=0.5):
            super().__init__()
            self.amount = amount

        def as_dict(self):
            return {"amount": self.amount}

        @classmethod
        def from_dict(cls, d):
            return cls(d["amount"])

    jax_registry.register_effect("jaxonlyfx", JaxOnlyFx)
    try:
        s, _ = _unsupported_sessions()["effects"]
        s.tracks[1].effects.append(JaxOnlyFx())
        with pytest.raises(NotImplementedError, match="JaxOnlyFx.*register a port class"):
            bounce(s, 48000.0, device="cpu")
    finally:
        jax_registry.unregister_effect("jaxonlyfx")
    plain = random_session(6, rate=48000, bpm=120.0, n_tracks=1, n_clips=1)
    np.testing.assert_array_equal(bounce(plain, 48000.0, device="cpu", effects_mode="routed").audio,
                                  bounce(plain, 48000.0, device="cpu").audio)
    with pytest.raises(ValueError, match="effects_mode"):
        bounce(random_session(6, rate=48000, bpm=120.0, n_tracks=1, n_clips=1), 48000.0,
               device="cpu", effects_mode="bogus")


def _eq_session(seed=10, n_tracks=3):
    from tests.test_torch_effects import _add_chains

    return _add_chains(random_session(seed, rate=48000, bpm=120.0, n_tracks=n_tracks, n_clips=2))


def _f64_reference(js):
    from whitebox_tpu.render.effects_pipeline import reference_finish_mix

    table, pool = jax_carve_session(js, 48000.0, buffer_size=512)
    return reference_finish_mix(render_segments_per_track_numpy(table, pool), js, 48000.0)


@pytest.fixture(scope="module")
def eq_case():
    js = _eq_session()
    return js, _f64_reference(js)


@pytest.fixture(scope="module")
def eq_jax_bounces(eq_case):
    """The JAX package's bounce of the EQ session in each effects mode
    (computed once: its Pallas interpret-mode compile is the cost)."""
    return {mode: jax_bounce(eq_case[0], 48000.0, engine="pallas", effects_mode=mode).audio
            for mode in ("scan", "fir")}


@pytest.mark.parametrize("mode,bar", [("scan", 5e-5), ("fir", 2e-4)])
def test_eq_bounce_matches_jax_pallas_and_f64_reference(eq_case, eq_jax_bounces, mode, bar):
    js, ref = eq_case
    before = mix_cuda.mix_per_track_launches
    got = bounce(js, 48000.0, device="cpu", effects_mode=mode)
    assert mix_cuda.mix_per_track_launches == before  # the CPU takes the plain twin
    want = eq_jax_bounces[mode]
    assert got.audio.shape == want.shape == ref.shape
    assert rel_rms(got.audio, want) < 1e-5
    assert rel_rms(got.audio, ref) < bar
    assert got.stats.finish_seconds > 0 and got.stats.track_peak is None


def test_eq_bounce_scan_and_fir_agree(eq_case):
    js, _ = eq_case
    a = bounce(js, 48000.0, device="cpu", effects_mode="scan").audio
    b = bounce(js, 48000.0, device="cpu", effects_mode="fir").audio
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_eq_bounce_meters_match_jax(eq_case):
    js, _ = eq_case
    got = bounce(js, 48000.0, device="cpu", meters=True, effects_mode="fir").stats
    want = jax_bounce(js, 48000.0, engine="pallas", meters=True).stats
    for f in ("track_peak", "track_rms", "output_peak", "output_rms"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-7, err_msg=f)
    assert got.track_peak.shape == (3, 2)


def test_eq_bounce_with_lanes_and_plain_tracks():
    # lanes evaluate in the finisher's gains; a track without a chain passes
    # the identity sections
    from tests.test_auto_kernel import _auto_session
    from tests.test_torch_effects import _add_chains

    js = _add_chains(_auto_session(seed=3), master=False)
    got = bounce(js, 48000.0, device="cpu").audio
    assert rel_rms(got, _f64_reference(js)) < 5e-5


def test_eq_project_round_trips(tmp_path):
    from whitebox_tpu_torch.effects import Biquad, EffectChain, Gain, ParametricEQ
    from whitebox_tpu_torch.session.project import read_project
    from whitebox_tpu_torch.session.project import write_project as port_write_project

    js = _eq_session(seed=8)
    wb = tmp_path / "eq.wb"
    write_project(js, wb)
    s = read_project(wb)
    t0, t1 = s.tracks[0].effects, s.tracks[1].effects
    assert isinstance(t0, EffectChain) and [type(e) for e in t0.effects] == [Biquad, Gain]
    assert (t0.effects[0].ftype.value, t0.effects[0].freq_hz, t0.effects[1].gain_db) == ("lowpass", 2000.0, -3.0)
    assert isinstance(t1.effects[0], ParametricEQ)
    assert [(t.value, f, q, g) for (t, f, q, g) in t1.effects[0].bands] == \
        [(t.value, f, q, g) for (t, f, q, g) in js.tracks[1].effects.effects[0].bands]
    assert isinstance(s.master_effects.effects[0], Biquad)
    # the port writes what it read, and renders it like the session itself
    wb2 = tmp_path / "eq2.wb"
    port_write_project(s, wb2)
    s2 = read_project(wb2)
    assert [type(e) for e in s2.tracks[0].effects.effects] == [Biquad, Gain]
    np.testing.assert_array_equal(port_bounce(s2, 48000.0, device="cpu").audio,
                                  bounce(js, 48000.0, device="cpu").audio)


def test_cli_renders_eq_project(tmp_path, eq_case):
    js, ref = eq_case
    wb, out = tmp_path / "eq.wb", tmp_path / "eq.wav"
    write_project(js, wb)
    assert cli.main(["render", str(wb), str(out), "--device", "cpu", "--effects-mode", "fir"]) == 0
    audio, _ = wav.read_wav(out)
    assert rel_rms(audio, ref) < 2e-4


def test_unported_effect_in_project_raises(tmp_path):
    """A project holding a compressor reads into the port and renders
    within 5e-5 of the f64 generic finish of the JAX package's read of it."""
    from whitebox_tpu.session.project import read_project as jax_read_project
    from whitebox_tpu_torch.effects import Compressor
    from whitebox_tpu_torch.session.project import read_project

    js = _unsupported_sessions()["effects"][0]
    write_project(js, tmp_path / "c.wb")
    s = read_project(tmp_path / "c.wb")
    assert isinstance(s.tracks[0].effects.effects[-1], Compressor)
    got = port_bounce(s, 48000.0, device="cpu").audio
    want = _generic_reference(jax_read_project(tmp_path / "c.wb"))
    assert got.shape == want.shape and rel_rms(got, want) < 5e-5


def test_freeze_track_renders_its_chain():
    from whitebox_tpu_torch.effects import EffectChain

    js = _eq_session(seed=9, n_tracks=2)
    s = from_reference(js)
    s.freeze_track(1, 48000.0, device="cpu")
    js.freeze_track(1, 48000.0)
    got = np.stack(s.tracks[1].clips[0].audio.asset.sample.data)
    want = np.stack(js.tracks[1].clips[0].audio.asset.sample.data)
    assert got.shape == want.shape and np.abs(got).max() > 0.01
    assert rel_rms(got, want) < 1e-5
    assert s.tracks[1].effects == [] and isinstance(s.tracks[1].frozen["effects"], EffectChain)


def test_freeze_track_takes_the_engine_keyword():
    """``freeze_track(engine=)`` reaches the bounce, as in the JAX package:
    the gather path's render equals the kernel path's (speed 1, an EQ
    chain: within the finishers' chunking, 1e-6)."""
    js = _eq_session(seed=9, n_tracks=2)
    s_auto, s_xla = from_reference(js), from_reference(js)
    s_auto.freeze_track(1, 48000.0, device="cpu")
    s_xla.freeze_track(1, 48000.0, engine="xla", device="cpu")
    a = np.stack(s_auto.tracks[1].clips[0].audio.asset.sample.data)
    x = np.stack(s_xla.tracks[1].clips[0].audio.asset.sample.data)
    assert a.shape == x.shape and np.abs(a).max() > 0.01 and rel_rms(x, a) < 1e-6


def test_cli_freeze_matches_jax_cli(tmp_path, capsys):
    """``freeze`` then ``freeze --unfreeze`` on the same .wb in both CLIs:
    the same printouts, the frozen render within 1e-5 of the JAX package's,
    the unfrozen project's chain back."""
    from whitebox_tpu import cli as jax_cli
    from whitebox_tpu_torch.session.project import read_project

    wb, want_wb, got_wb = tmp_path / "p.wb", tmp_path / "jax.wb", tmp_path / "port.wb"
    write_project(_eq_session(seed=9, n_tracks=2), wb)
    assert jax_cli.main(["freeze", str(wb), "--track", "1", "--out", str(want_wb)]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["freeze", str(wb), "--track", "1", "--out", str(got_wb), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jout
    from whitebox_tpu.session.project import read_project as jax_read_project

    want, got = jax_read_project(want_wb).tracks[1], read_project(got_wb).tracks[1]
    a, b = np.stack(got.clips[0].audio.asset.sample.data), np.stack(want.clips[0].audio.asset.sample.data)
    assert got.frozen is not None and a.shape == b.shape and rel_rms(a, b) < 1e-5
    assert cli.main(["freeze", str(got_wb), "--track", "1", "--unfreeze"]) == 0
    assert "unfroze track 1" in capsys.readouterr().out
    assert read_project(got_wb).tracks[1].effects


def test_per_track_guard_raises_naming_item_1(monkeypatch, eq_case, eq_jax_bounces):
    """Per-track buffers above the guard take the gather path with the
    streaming scan finisher: within relative RMS 1e-5 of the JAX package's
    bounce of the session and 5e-5 of the f64 reference."""
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    js, ref = eq_case
    monkeypatch.setattr(bounce_mod, "PER_TRACK_LIMIT_BYTES", 1 << 10)
    got = bounce(js, 48000.0, device="cpu", chunk_frames=4096)
    assert got.stats.mix_path == "gather"
    want = eq_jax_bounces["scan"]
    assert got.audio.shape == want.shape == ref.shape
    assert rel_rms(got.audio, want) < 1e-5 and rel_rms(got.audio, ref) < 5e-5


def test_slot_overflow_raises_instead_of_switching():
    """engine="pallas" still raises on a slot overflow; "auto" switches to
    the gather path (as the JAX package does) and stays within the
    resampling contract of the NumPy reference."""
    s = from_reference(dense_session())
    # halve every clip and squeeze them into one 1024-frame tile: 12 runs
    for i, c in enumerate(s.tracks[0].clips):
        c.min_time, c.max_time = i * 0.003, i * 0.003 + 0.0025
    with pytest.raises(SlotOverflow, match="engine='pallas' has no gather fallback"):
        port_bounce(s, 48000.0, device="cpu", engine="pallas")
    res = port_bounce(s, 48000.0, device="cpu")
    assert res.stats.mix_path == "gather"
    table, pool = carve_session(s, 48000.0, buffer_size=512)
    from whitebox_tpu_torch.timeline.carve import render_segments_numpy as port_segments
    assert_ulp_contract(res.audio, port_segments(table, pool, s))


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = from_reference(random_session(1, rate=48000, bpm=120.0, n_tracks=1, n_clips=1))
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_bounce(s, 48000.0, device=dev)
        table, pool = carve_session(s, 48000.0, buffer_size=512)
        with pytest.raises(RuntimeError, match="CUDA"):
            mix_cuda.CudaMixRenderer(table, pool, s, device=dev)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_render_matches_oracle(tmp_path, capsys):
    s = random_session(8, rate=48000, bpm=120.0, n_tracks=3, n_clips=2)
    wb = tmp_path / "p.wb"
    write_project(s, wb)
    out = tmp_path / "out.wav"
    assert cli.main(["render", str(wb), str(out), "--device", "cpu", "--json"]) == 0
    blob = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert blob["device"] == "cpu" and blob["frames"] > 0
    audio, _ = wav.read_wav(out)
    ref = OracleRenderer(s, 48000.0, buffer_size=512).render()
    n = min(ref.shape[1], audio.shape[1])
    np.testing.assert_array_equal(audio[:, :n], ref[:, :n])
    # a bus renders now (routed finisher), as the port's bounce of the project
    from whitebox_tpu_torch.session.project import read_project

    s.add_bus("b")
    s.set_track_output(0, 0)
    write_project(s, wb)
    assert cli.main(["render", str(wb), str(out), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(wav.read_wav(out)[0], port_bounce(read_project(wb), 48000.0, device="cpu").audio)
    # a recording input is an assignment, not audio: the project renders as before
    s.set_track_input(1, "external_mono")
    write_project(s, wb)
    assert read_project(wb).tracks[1].input is not None
    assert cli.main(["render", str(wb), str(out), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(wav.read_wav(out)[0], port_bounce(read_project(wb), 48000.0, device="cpu").audio)
    # an unreadable project is an error message, not a traceback
    wb.write_bytes(b"not a project")
    capsys.readouterr()
    assert cli.main(["render", str(wb), str(out), "--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("flags,kw", [
    (["--interpolation", "catmull"], {"interpolation": "catmull"}),
    (["--interpolation", "sinc"], {"interpolation": "sinc"}),
    (["--interpolation", "sinc", "--no-prerender"], {"interpolation": "sinc", "prerender": False})])
def test_cli_renders_with_interpolation(tmp_path, flags, kw):
    from whitebox_tpu_torch.session.project import read_project

    js, rate, _ = make_case("mixed_speeds")
    wb, out = tmp_path / "r.wb", tmp_path / "r.wav"
    write_project(js, wb)
    assert cli.main(["render", str(wb), str(out), "--device", "cpu", *flags]) == 0
    audio, _ = wav.read_wav(out)
    want = port_bounce(read_project(wb), rate, device="cpu", **kw).audio
    np.testing.assert_array_equal(audio, want)
    assert np.abs(want - port_bounce(read_project(wb), rate, device="cpu").audio).max() > 1e-5


# ------------------------------------------------------ the reference's other keywords


@pytest.mark.parametrize("kw,item", [
    ({"chunk_frames": 4096}, "item 1"), ({"strict_order": False}, "item 1"),
    ({"engine": "xla"}, "item 1"), ({"routed_chunk": 1024}, "item 6"), ({"pdc": True}, "item 6"),
    ({"loudness": True}, "item 9"), ({"normalize": ("lufs", -14.0)}, "item 9"),
    ({"out_encode": {"flac_compression_level": 5, "title": "keywords"}}, "item 14")],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else None)
def test_reference_keywords_raise_naming_their_item(kw, item, tmp_path):
    """The keywords items 1, 6(a) and 6(b) ported render (speed 1, no chains:
    bit-equal to the NumPy oracle; the relaxed sum within 1e-6); item 9's
    measure and normalize as the JAX package's f64 measurement says; item
    14's ``out_encode`` writes the file the JAX package's codec writes from
    the same audio, byte for byte, and leaves the audio as it was."""
    js = random_session(6, rate=48000, bpm=120.0, n_tracks=1, n_clips=1)
    s = from_reference(js)
    (name, value), = kw.items()
    if name in ("loudness", "normalize"):
        from whitebox_tpu.ops.loudness import measure_loudness as jax_measure

        raw = port_bounce(s, 48000.0, device="cpu").audio
        got = port_bounce(s, 48000.0, device="cpu", **{"loudness": True, **kw})
        if name == "normalize":
            gain = 10.0 ** ((value[1] - jax_measure(raw, 48000.0, device=False).integrated_lufs) / 20.0)
            np.testing.assert_allclose(got.audio, np.clip(raw * np.float32(gain), -1.0, 1.0), rtol=2e-5)
        else:
            np.testing.assert_array_equal(got.audio, raw)
        want = jax_measure(got.audio, 48000.0, device=False)
        assert abs(got.stats.loudness.integrated_lufs - want.integrated_lufs) < 0.02
        assert abs(got.stats.loudness.true_peak_dbtp - want.true_peak_dbtp) < 0.05
        return
    if name in ("chunk_frames", "strict_order", "engine", "pdc", "routed_chunk"):
        kws = {"engine": "auto" if name in ("pdc", "routed_chunk") else "xla", **kw}
        got = port_bounce(s, 48000.0, device="cpu", **kws)
        oracle = OracleRenderer(js, 48000.0, buffer_size=512).render()
        n = min(oracle.shape[1], got.frames)
        np.testing.assert_allclose(got.audio[:, :n], oracle[:, :n], atol=1e-6 if name == "strict_order" else 0,
                                   rtol=0)
        assert got.stats.mix_path == ("kernel" if name in ("pdc", "routed_chunk") else "gather")
        return
    from whitebox_tpu.io import codec as jax_codec
    from whitebox_tpu_torch.io import codec
    from whitebox_tpu_torch.io.codec import EncodeOptions, read_compressed

    if codec.load() is None:  # no libav to build the runtime against: the error names it
        with pytest.raises(RuntimeError, match="libavformat"):
            port_bounce(s, 48000.0, device="cpu", out_path=tmp_path / "port.flac", out_encode=EncodeOptions(**value))
        return
    got = port_bounce(s, 48000.0, device="cpu", out_path=tmp_path / "port.flac",
                      out_encode=EncodeOptions(**value))
    np.testing.assert_array_equal(got.audio, port_bounce(s, 48000.0, device="cpu").audio)
    jax_codec.write_compressed(tmp_path / "jax.flac", got.audio, 48000, options=jax_codec.EncodeOptions(**value))
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    assert b"keywords" in (tmp_path / "port.flac").read_bytes()
    assert np.abs(read_compressed(tmp_path / "port.flac")[0] - got.audio).max() < 1.5 / 32768


# ------------------------------------------------------ cli render against the JAX CLI


def _jax_and_port_cli(tmp_path, capsys, js, flags):
    """Render ``js`` (written as a .wb) with the JAX package's CLI and the
    port's (``--device cpu``) under the same flags -> (jax audio, port
    audio, jax stdout, port stdout)."""
    from whitebox_tpu import cli as jax_cli

    wb, want, got = tmp_path / "p.wb", tmp_path / "jax.wav", tmp_path / "port.wav"
    write_project(js, wb)
    assert jax_cli.main(["render", str(wb), str(want), *flags]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["render", str(wb), str(got), "--device", "cpu", *flags]) == 0
    pout = capsys.readouterr().out
    return wav.read_wav(want)[0], wav.read_wav(got)[0], jout, pout


CLI_RANGES = {
    "tail": ["--tail", "0.5"],
    "beat_range_with_tail": ["--from-beat", "1.0", "--to-beat", "5.0", "--tail", "0.25"],
    "bar_range": ["--from-bar", "0.5", "--to-bar", "1.5"],
    "dither_i16": ["--format", "i16", "--dither", "tpdf-hp"],
}


@pytest.mark.parametrize("name", list(CLI_RANGES))
def test_cli_range_tail_and_dither_match_jax_cli(tmp_path, capsys, name):
    js = random_session(21, rate=48000, bpm=120.0, n_tracks=2, n_clips=2)
    want, got, _, _ = _jax_and_port_cli(tmp_path, capsys, js, CLI_RANGES[name])
    assert got.shape == want.shape and float(np.abs(want).max()) > 0.01
    np.testing.assert_array_equal(got, want)  # speed 1, no chains: bit-equal


def test_cli_meters_match_jax_cli(tmp_path, capsys):
    js = _eq_session(seed=22, n_tracks=2)
    want, got, jout, pout = _jax_and_port_cli(tmp_path, capsys, js, ["--meters"])
    assert got.shape == want.shape and rel_rms(got, want) < 1e-5

    def meter_lines(out):
        return [line for line in out.splitlines() if line.startswith(("  track", "  output"))]

    assert len(meter_lines(pout)) == 3 and meter_lines(pout) == meter_lines(jout)
