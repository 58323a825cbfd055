"""whitebox_tpu_torch's MIDI path (``midi/{voice,synth,smf,cc}.py`` and the
synth in ``bounce``) and the ``inspect``/``tempo`` CLI commands (CPU).

Sessions are built with the JAX package and carried across by
``from_reference``, at 32768 Hz (an exact beat grid). Bars:

- the voice carve, slot segments, slot tables, SMF bytes and CC lanes:
  equal to the JAX package's;
- the torch ``render_synth_chunk``: bit-equal to ``render_synth_numpy``
  (also in pieces), and within 1 ulp or 1e-6 of the JAX one
  (``tests/test_midi.py:146-151``; XLA fuses its multiply-adds);
- a MIDI bounce against the JAX ``bounce``: 1e-6, on the K4 and the
  gather paths (one JAX compile), and in every finisher mode against the
  NumPy synth through the f64 finishers.
"""

import json

import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
from chip_smoke import rel_rms
from tests.test_carve import random_session
from whitebox_tpu import cli as jax_cli
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.midi import cc as jcc
from whitebox_tpu.midi import smf as jsmf
from whitebox_tpu.midi import synth as jsynth
from whitebox_tpu.midi import voice as jvoice
from whitebox_tpu.midi.notes import MidiCCEvent, MidiNote, MidiNoteBuffer, MidiNoteFlags
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.render.effects_generic import reference_generic_finish
from whitebox_tpu.render.routing import reference_routed_finish
from whitebox_tpu.session import Session as JaxSession
from whitebox_tpu.session.project import write_project as jax_write_project
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu.timeline.carve import render_segments_per_track_numpy
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.io import wav
from whitebox_tpu_torch.midi import cc, smf, synth, voice
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session import Session
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.session.project import read_project

RATE = 32768.0


def synth_rows(js, rate: float, frames: int, buffer_size: int = 512) -> np.ndarray:
    """The NumPy synth of each MIDI track of the JAX session ``js`` as
    ``[T, 2, frames]`` rows (zeros elsewhere), carved on the JAX package's
    grid of ``frames // buffer_size`` blocks, as ``bounce`` carves it."""
    out = np.zeros((len(js.tracks), 2, frames), np.float32)
    for t, evs in jvoice.carve_midi_events(js, rate, buffer_size, frames // buffer_size).items():
        ns, segs = jsynth.build_slot_segments(evs)
        if segs is not None:
            out[t] += jsynth.render_synth_numpy(segs, rate, frames, ns)[None, :]
    return out


def midi_session(notes, *, bpm=60.0, transpose=0, rate=1, clip_span=(0.0, 8.0), start_offset=0.0):
    s = JaxSession(bpm=bpm)
    asset = s.midi_table.create_midi(MidiNoteBuffer(notes))
    tr = s.add_track("m")
    s.add_midi_clip(tr, "c", clip_span[0], clip_span[1], start_offset=start_offset, asset=asset,
                    transpose=transpose, rate=rate)
    return s


def _chords(seed, n, beat=0.25, length=0.7, voices=3, keys=(36, 96)):
    rng = np.random.default_rng(seed)
    return [MidiNote(beat * i, beat * i + length, key=int(rng.integers(*keys)), velocity=float(rng.uniform(0.3, 1.0)))
            for i in range(n) for _ in range(voices)]


def _arrangement(seed=3, bpm=240.0):
    """Two audio tracks and two MIDI tracks (chords; a transposed, double
    rate clip with a start offset and a muted note) on a 240 bpm grid."""
    js = random_session(seed, rate=int(RATE), bpm=bpm, n_tracks=2, formats=(AudioFormat.F32,), n_clips=2)
    notes = _chords(seed, 10)
    notes[4] = MidiNote(notes[4].min_time, notes[4].max_time, key=notes[4].key, velocity=0.9,
                        flags=int(MidiNoteFlags.MUTED))
    a = js.midi_table.create_midi(MidiNoteBuffer(notes))
    t2 = js.add_track("keys", volume_db=-4.0, pan=-0.4)
    js.add_midi_clip(t2, "k", 0.5, 3.5, asset=a)
    t3 = js.add_track("lead", volume_db=-2.0, pan=0.5)
    js.add_midi_clip(t3, "l", 1.0, 4.0, start_offset=0.5, asset=a, transpose=7, rate=2)
    return js


CARVES = {
    "basic": lambda: midi_session([MidiNote(1.0, 2.0, key=69, velocity=0.8)]),
    "transpose_muted": lambda: midi_session([MidiNote(0.0, 1.0, key=60, velocity=1.0),
                                             MidiNote(1.0, 2.0, key=62, velocity=1.0, flags=int(MidiNoteFlags.MUTED))],
                                            transpose=12),
    "rate": lambda: midi_session([MidiNote(2.0, 4.0, key=60, velocity=1.0)], rate=2),
    "clip_end_caps": lambda: midi_session([MidiNote(0.0, 10.0, key=60, velocity=1.0)], clip_span=(0.0, 2.0)),
    "start_offset": lambda: midi_session([MidiNote(0.0, 1.0, key=60, velocity=1.0),
                                          MidiNote(2.0, 3.0, key=64, velocity=1.0)], start_offset=1.5),
    "voice_overflow": lambda: midi_session([MidiNote(0.01 * i, 3.0, key=30 + i % 60, velocity=0.5)
                                            for i in range(70)]),
    "chords": lambda: midi_session(_chords(5, 24), bpm=120.0),
    "arrangement": _arrangement,
}


def test_voice_state_allocates_and_releases_like_the_reference():
    st = voice.MidiVoiceState()
    a, b = st.add_voice(2.0, 1.0, 60), st.add_voice(1.0, 1.0, 62)
    st.add_voice(3.0, 1.0, 64)
    assert (a.slot, b.slot) == (0, 1)
    assert st.release_voice(5.0).key == 62 and st.release_voice(0.5) is None
    assert st.add_voice(3.0, 1.0, 65).slot == 1  # the lowest free slot
    full = voice.MidiVoiceState()
    assert all(full.add_voice(10.0, 1.0, i) is not None for i in range(voice.MAX_VOICES))
    assert full.add_voice(10.0, 1.0, 99) is None


@pytest.mark.parametrize("name", list(CARVES))
def test_carve_and_slot_tables_equal_jax(name):
    js = CARVES[name]()
    s = from_reference(js)
    want = jvoice.carve_midi_events(js, RATE, buffer_size=256)
    got = voice.carve_midi_events(s, RATE, buffer_size=256)
    assert got.keys() == want.keys() and got
    for t in want:
        assert [vars(e) for e in got[t]] == [vars(e) for e in want[t]]
        ns, segs = synth.build_slot_segments(got[t])
        wns, wsegs = jsynth.build_slot_segments(want[t])
        assert ns == wns
        for k in wsegs:
            np.testing.assert_array_equal(segs[k], wsegs[k], err_msg=k)
        tab, wtab = synth.pack_slot_tables(segs, RATE, ns), jsynth.pack_slot_tables(wsegs, RATE, wns)
        for k in wtab:
            assert tab[k].dtype == wtab[k].dtype
            np.testing.assert_array_equal(tab[k], wtab[k], err_msg=k)


def _random_segments(seed, slots=5, F=40000):
    rng = np.random.default_rng(seed)
    rows = []
    for sl in range(slots):
        pos = int(rng.integers(0, 300))
        while pos < F - 100:
            end = pos + int(rng.integers(50, 6000))
            if rng.random() < 0.08:
                end = 2**31 - 1  # unterminated: rings to the end
            rows.append((sl, pos, end, int(rng.integers(24, 108)), float(rng.uniform(0.2, 1.0))))
            if end == 2**31 - 1:
                break
            pos = end + int(rng.integers(0, 400))
    cols = list(zip(*rows))
    segs = {"slot": np.asarray(cols[0], np.int32), "start": np.asarray(cols[1], np.int32),
            "end": np.asarray(cols[2], np.int32), "key": np.asarray(cols[3], np.int32),
            "vel": np.asarray(cols[4], np.float32)}
    return segs, slots, F


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_chunk_bit_equal_to_numpy_in_any_pieces(seed, monkeypatch):
    segs, slots, F = _random_segments(seed)
    ref = synth.render_synth_numpy(segs, 48000.0, F, slots)
    np.testing.assert_array_equal(ref, jsynth.render_synth_numpy(segs, 48000.0, F, slots))
    tables = synth.synth_device_tables([synth.pack_slot_tables(segs, 48000.0, slots)])
    np.testing.assert_array_equal(synth.render_synth_chunk(tables, 0, F)[0].numpy(), ref)
    monkeypatch.setattr(synth, "SYNTH_PIECE_ELEMENTS", 4096 * slots)  # pieces of 4096 frames
    pieces = torch.cat([synth.render_synth_chunk(tables, a, 7001)[0] for a in range(0, F, 7001)])[:F]
    np.testing.assert_array_equal(pieces.numpy(), ref)
    # stacked with another track of more slots and segments (padding both)
    other, oslots, _ = _random_segments(seed + 10, slots=7, F=F)
    both = synth.synth_device_tables([synth.pack_slot_tables(segs, 48000.0, slots),
                                      synth.pack_slot_tables(other, 48000.0, oslots)])
    got = synth.render_synth_chunk(both, 0, F).numpy()
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(got[1], synth.render_synth_numpy(other, 48000.0, F, oslots))


def test_synth_chunk_within_one_ulp_of_jax():
    import jax.numpy as jnp

    segs, slots, F = _random_segments(7, slots=8, F=16384)
    host = jsynth.pack_slot_tables(segs, 48000.0, slots)
    want = np.asarray(jsynth.render_synth_chunk({k: jnp.asarray(v) for k, v in host.items()}, jnp.int32(0),
                                                frames=F))
    got = synth.render_synth_chunk(synth.synth_device_tables([host]), 0, F)[0].numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    absd = np.abs(got.astype(np.float64) - want)
    assert not ((ulps > 1) & (absd > 1e-6)).any(), f"max ulp {ulps.max()} max abs {absd.max()}"
    assert synth.ENV_SPEED.dtype == np.float32 and synth.ENV_SPEED == jsynth.ENV_SPEED


def test_smf_bytes_and_parse_equal_jax(tmp_path):
    """Writes are byte-equal, each package parses the other's file, the
    tempo and time-signature metas come back, and ``load_from_file``
    reads a ``.mid`` into an asset (None for a file that is not one)."""
    notes = MidiNoteBuffer([MidiNote(0.0, 1.0, key=60, velocity=100 / 127.0),
                            MidiNote(0.5, 2.0, key=64, velocity=80 / 127.0),
                            MidiNote(2.0, 2.25, key=67, velocity=1.0)],
                           cc=[MidiCCEvent(0.25, 1, 0.5), MidiCCEvent(1.5, 7, 1.0, 2)])
    kw = {"tempo": [(0.0, 120.0), (4.0, 90.0)], "meter": [(0.0, 3, 4), (6.0, 7, 8)]}
    jsmf.write_smf(notes, tmp_path / "j.mid", **kw)
    smf.write_smf(from_reference(_asset_session(notes)).midi_table.midi_assets[0].notes, tmp_path / "p.mid", **kw)
    assert (tmp_path / "j.mid").read_bytes() == (tmp_path / "p.mid").read_bytes()
    want, got = jsmf.load_notes_from_file(tmp_path / "j.mid"), smf.load_notes_from_file(tmp_path / "j.mid")
    assert [vars(n) for n in got] == [vars(n) for n in want]
    assert [vars(e) for e in got.cc] == [vars(e) for e in want.cc]
    assert (got.tempo, got.meter) == (want.tempo, want.meter)
    assert smf.tempo_map_from_smf(got).as_dict() == jsmf.tempo_map_from_smf(want).as_dict()
    assert smf.meter_map_from_smf(got).as_dict() == jsmf.meter_map_from_smf(want).as_dict()
    # running status, a velocity-0 note-off and a Set-Tempo meta, by hand
    import struct

    body = b"\x00\xff\x51\x03\x07\xa1\x20\x00\x90\x3c\x64\x60\x3c\x00\x00\xff\x2f\x00"
    blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96) + b"MTrk" + struct.pack(">I", len(body)) + body
    hand, jhand = smf.parse_smf(blob), jsmf.parse_smf(blob)
    assert [vars(n) for n in hand] == [vars(n) for n in jhand] and hand.tempo == jhand.tempo == [(0.0, 120.0)]
    s = Session()
    asset = s.midi_table.load_from_file(tmp_path / "j.mid")
    assert [vars(n) for n in asset.notes] == [vars(n) for n in want] and len(s.midi_table) == 1
    (tmp_path / "bad.mid").write_bytes(b"RIFF....")
    assert s.midi_table.load_from_file(tmp_path / "bad.mid") is None


def _asset_session(notes):
    js = JaxSession(bpm=120.0)
    js.midi_table.create_midi(notes)
    return js


def test_from_reference_carries_midi_clips_and_smf_metas(tmp_path):
    """A clip's transpose, rate and start offset cross over, and so do the
    tempo and time-signature metas a parsed SMF buffer holds (the copy
    once dropped them, so a re-export lost the file's tempo)."""
    js = _arrangement()
    jsmf.write_smf(MidiNoteBuffer([MidiNote(0.0, 1.0, key=60, velocity=0.5)]), tmp_path / "t.mid",
                   tempo=[(0.0, 100.0), (2.0, 140.0)], meter=[(0.0, 6, 8)])
    js.midi_table.load_from_file(tmp_path / "t.mid")
    s = from_reference(js)
    for t, jt in zip(s.tracks, js.tracks):
        for c, jc in zip(t.clips, jt.clips):
            if jc.midi is not None:
                assert (c.midi.transpose, c.midi.rate, c.start_offset, c.min_time, c.max_time) == \
                       (jc.midi.transpose, jc.midi.rate, jc.start_offset, jc.min_time, jc.max_time)
    parsed, jparsed = s.midi_table.midi_assets[-1].notes, js.midi_table.midi_assets[-1].notes
    assert (parsed.tempo, parsed.meter) == (jparsed.tempo, jparsed.meter) and len(parsed.tempo) == 2
    smf.write_smf(parsed, tmp_path / "again.mid")
    assert smf.load_notes_from_file(tmp_path / "again.mid").tempo == parsed.tempo


def test_cc_lanes_equal_jax():
    events = [MidiCCEvent(0.1, 1, 0.2), MidiCCEvent(0.8, 1, 0.9), MidiCCEvent(1.2, 7, 0.4),
              MidiCCEvent(2.6, 1, 0.1), MidiCCEvent(3.4, 1, 0.7)]
    js = midi_session([MidiNote(0.0, 1.0, key=60, velocity=0.5)], clip_span=(1.0, 4.0), start_offset=0.5)
    js.tracks[0].clips[0].midi.asset.notes.cc = list(events)
    js.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 2000.0), jfx.Gain(-3.0)])
    s = from_reference(js)
    for curve in (None, "LINEAR"):
        kw = {} if curve is None else {"curve": getattr(jcc.CurveType, curve)}
        pkw = {} if curve is None else {"curve": getattr(cc.CurveType, curve)}
        want = jcc.cc_lane_for_track(js.tracks[0], 1, lo=200.0, hi=8000.0, **kw)
        got = cc.cc_lane_for_track(s.tracks[0], 1, lo=200.0, hi=8000.0, **pkw)
        assert [(p.x, p.y, int(p.curve)) for p in got.points] == [(p.x, p.y, int(p.curve)) for p in want.points]
    mapping = {1: (0, "freq_hz", 200.0, 8000.0), 7: (1, "gain_db", -12.0, 0.0), 11: (0, "q", 0.5, 2.0)}
    assert cc.apply_cc_map(s, 0, mapping) == jcc.apply_cc_map(js, 0, mapping)
    for key, lane in js.tracks[0].automation.effects.items():
        assert [(p.x, p.y) for p in s.tracks[0].automation.effects[key].points] == [(p.x, p.y) for p in lane.points]


# ----------------------------------------------------------------- bounce


def _per_track_with_synth(js, buffer_size=512):
    table, pool = jax_carve(js, RATE, buffer_size=buffer_size)
    pt = render_segments_per_track_numpy(table, pool)
    return pt + synth_rows(js, RATE, pt.shape[-1], buffer_size)


@pytest.fixture(scope="module")
def arrangement_jax_bounce():
    js = _arrangement()
    return js, jax_bounce(js, RATE, engine="xla", chunk_frames=8192)


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_midi_bounce_matches_jax(arrangement_jax_bounce, engine):
    """The K4 path (synth added to the per-track buffers) and the gather
    path (synth added chunk by chunk) within 1e-6 of the JAX bounce."""
    js, want = arrangement_jax_bounce
    got = bounce(from_reference(js), RATE, device="cpu", engine=engine, chunk_frames=8192)
    assert got.stats.mix_path == {"auto": "kernel", "xla": "gather"}[engine]
    assert got.audio.shape == want.audio.shape and float(np.abs(want.audio).max()) > 0.1
    np.testing.assert_allclose(got.audio, want.audio, atol=1e-6, rtol=0)


def _with_chains(js):
    js.tracks[2].effects = jfx.EffectChain([jfx.ParametricEQ([("peak", 800.0, 1.0, 4.0)])])
    js.tracks[3].effects = jfx.EffectChain([jfx.Biquad("lowpass", 3000.0)])
    js.master_effects = jfx.EffectChain([jfx.Biquad("highpass", 30.0)])
    return js


@pytest.mark.parametrize("mode", ["scan", "fir", "generic"])
def test_midi_in_every_finisher_mode(mode):
    """The synth rides the K4 buffers into each finisher: within the
    finishers' own bars (5e-5 scan and generic, 2e-4 FIR) of the NumPy
    synth through the f64 finish; a K4 buffer handed to the finisher
    twice gives the same mix (the synth is added to a copy)."""
    js = _with_chains(_arrangement())
    s = from_reference(js)
    got = bounce(s, RATE, device="cpu", effects_mode=mode)
    ref = reference_generic_finish(_per_track_with_synth(js), js, RATE)
    assert got.stats.mix_path == "kernel"
    assert rel_rms(got.audio, ref[:, :got.frames]) < (2e-4 if mode == "fir" else 5e-5)
    from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
    from whitebox_tpu_torch.render.bounce import _effects_finisher
    from whitebox_tpu_torch.timeline.carve import carve_session

    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    r = CudaMixRenderer(table, pool, s, device="cpu")
    finish = _effects_finisher(s, r, r.plan, RATE, mode, False, torch.device("cpu"))
    pt = r.render_device_per_track()
    before = pt.clone()
    a, b = finish(pt).out, finish(pt).out
    assert torch.equal(pt, before) and torch.equal(a, b)


def test_midi_gather_path_with_pdc_renders_synth_ahead():
    """Under PDC the gather path renders a latent MIDI track's rows (synth
    included) ahead: within 5e-5 of the f64 reference with PDC."""
    js = _arrangement()
    js.tracks[2].effects = jfx.EffectChain([jfx.Limiter(-9.0, lookahead_s=0.004)])
    got = bounce(from_reference(js), RATE, device="cpu", engine="xla", pdc=True, chunk_frames=4096)
    ref = reference_generic_finish(_per_track_with_synth(js), js, RATE, pdc=True)
    assert got.stats.mix_path == "gather" and rel_rms(got.audio, ref[:, :got.frames]) < 5e-5


def test_midi_track_on_a_routed_bus():
    """A MIDI track grouped to a compressed bus and sending to a sidechain:
    both paths within 5e-5 of the f64 routed reference."""
    js = _arrangement()
    bus = js.add_bus("keys", volume_db=-1.0)
    bus.effects = jfx.EffectChain([jfx.Compressor(-24.0, 4.0, sidechain=True), jfx.Biquad("highpass", 120.0)])
    js.set_track_output(2, 0)
    js.add_send(0, 0, gain_db=-3.0, sidechain=True)
    js.add_send(3, 0, gain_db=-6.0, pre_fader=True)
    s = from_reference(js)
    ref = reference_routed_finish(_per_track_with_synth(js), js, RATE)
    for engine in ("auto", "xla"):
        got = bounce(s, RATE, device="cpu", engine=engine, chunk_frames=8192)
        assert rel_rms(got.audio, ref[:, :got.frames]) < 5e-5, engine


# -------------------------------------------------------------------- cli


def _project(tmp_path, js, name="p.wb"):
    for k, a in js.sample_table.samples.items():
        p = tmp_path / f"{k}.wav"
        wav.write_wav(p, np.stack(a.sample.data), a.sample.sample_rate, AudioFormat.F32)
        a.sample.path = str(p)
    wb = tmp_path / name
    jax_write_project(js, wb)
    return wb


def _routed_midi_session():
    js = _arrangement()
    js.add_bus("grp", volume_db=-2.0).effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    js.set_track_output(0, 0)
    js.add_send(2, 0, gain_db=-4.0, sidechain=True)
    js.add_send(3, 0, gain_db=-6.0)
    js.set_tempo_point(2.0, 200.0)
    js.set_meter(1, 3, 4)
    return js


def test_cli_inspect_matches_jax_cli(tmp_path, capsys):
    wb = _project(tmp_path, _routed_midi_session())
    assert jax_cli.main(["inspect", str(wb)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["inspect", str(wb)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want and got["buses"] and any("sends" in t for t in got["tracks"])


@pytest.mark.parametrize("flags", [["--from-smf"], ["--set-bpm", "96", "--point", "3:150:linear:120",
                                                    "--meter", "2:5/4", "--remove-meter", "1"]],
                         ids=["from_smf", "points_and_meters"])
def test_cli_tempo_matches_jax_cli(tmp_path, capsys, flags):
    """``tempo`` writes the same project and prints the same maps as the
    JAX CLI; ``--from-smf`` imports a file's Set-Tempo and Time-Signature
    metas."""
    js = _routed_midi_session()
    wb = _project(tmp_path, js)
    if flags == ["--from-smf"]:
        jsmf.write_smf(MidiNoteBuffer([MidiNote(0.0, 1.0, key=60, velocity=0.5)]), tmp_path / "t.mid",
                       tempo=[(0.0, 100.0), (4.0, 140.0)], meter=[(0.0, 6, 8)])
        flags = ["--from-smf", str(tmp_path / "t.mid")]
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        assert main(["tempo", str(wb), "--out", str(tmp_path / f"{name}.wb"), *flags]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["port"] == outs["jax"] and outs["port"]["tempo_map"]
    assert (tmp_path / "port.wb").read_bytes() == (tmp_path / "jax.wb").read_bytes()


def test_cli_render_of_a_routed_midi_project(tmp_path):
    """``cli render`` of a project with buses, sends and MIDI tracks under a
    tempo map writes the port's bounce of the same project."""
    wb = _project(tmp_path, _routed_midi_session())
    out = tmp_path / "out.wav"
    assert cli.main(["render", str(wb), str(out), "--device", "cpu", "--rate", str(RATE)]) == 0
    audio, _ = wav.read_wav(out)
    want = bounce(read_project(wb), RATE, device="cpu").audio
    np.testing.assert_array_equal(audio, want)
    assert float(np.abs(want).max()) > 0.05
