"""The port's own host layer against the JAX package's (CPU).

``whitebox_tpu_torch`` keeps copies of the JAX-free host modules (session
model, carve, pool, oracle, WAV, projects) and builds its own native carve
from ``csrc/host``. Sessions built with the JAX package's builders cross
over with ``from_reference``; the port's carve must then give the JAX
carve's ``SegmentTable`` and ``SamplePool`` exactly, with the native walk
and with the NumPy walk. Projects and WAV files cross between the two
packages unchanged, and the port imports neither JAX nor the JAX package.
"""

import ast
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_carve_native import _assert_tables_equal, _rand_session
from tests.test_loop_modes import RATE as LOOP_RATE
from tests.test_loop_modes import _mode_session
from tests.test_torch_mix_plan import CASES, make_case
from whitebox_tpu.core.formats import AudioFormat as JaxAudioFormat
from whitebox_tpu.io import wav as jax_wav
from whitebox_tpu.ops.automation import AutomationLane, CurveType, TrackAutomation
from whitebox_tpu.render.demo import make_demo_session
from whitebox_tpu.session.clip import ClipMode
from whitebox_tpu.session.project import read_project as jax_read_project
from whitebox_tpu.session.project import write_project as jax_write_project
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu_torch import buildlib
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io import native, wav
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.session.project import read_project, write_project
from whitebox_tpu_torch.timeline.carve import carve_session

REPO = Path(__file__).resolve().parent.parent
RATE = 48000.0


def tempo_session():
    """A tempo-mapped session with a step and a linear ramp (the shape of
    the JAX package's benchmark config 7), fades and two speeds."""
    s = make_demo_session(n_tracks=3, duration_seconds=4.0, sample_seconds=1.0, seed=11,
                          n_unique_samples=3, fades=True, clip_speeds=(1.0, 44100 / 48000))
    s.set_tempo_point(1.5, 90.0, curve="linear", bpm_end=140.0)
    s.set_tempo_point(5.0, 128.0)
    return s


def named_session(name):
    """-> (JAX-package session, rate) for the carve cases."""
    if name in CASES:
        s, rate, _ = make_case(name)
        return s, rate
    if name == "tempo_mapped":
        return tempo_session(), RATE
    mode = ClipMode[name.removeprefix("mode_").upper()]
    return _mode_session(mode, speed=0.8 if mode != ClipMode.ONE_SHOT else 1.0,
                         start_offset=300.0), LOOP_RATE


CARVE_CASES = CASES + ["tempo_mapped"] + [f"mode_{m.name.lower()}" for m in ClipMode]


def assert_pools_equal(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    for f in ("channel_base", "counts", "rates"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert sorted(a.index_of.values()) == sorted(b.index_of.values())


def assert_carves_equal(js, rate, *, native_walk=True, **kw):
    jt, jp = jax_carve_session(js, rate, **kw)
    pt, pp = carve_session(from_reference(js), rate, native=native_walk, **kw)
    _assert_tables_equal(pt, jt, f"native={native_walk} {kw}")
    assert pt.buffer_size == jt.buffer_size
    assert_pools_equal(pp, jp)
    return pt


@pytest.mark.parametrize("native_walk", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", CARVE_CASES)
def test_carve_matches_jax(name, native_walk):
    js, rate = named_session(name)
    pt = assert_carves_equal(js, rate, native_walk=native_walk, buffer_size=512)
    assert len(pt) > 0
    if name == "tempo_mapped":
        assert js.tempo_map is not None and not pt.fast.all()


@pytest.mark.parametrize("mapped", [False, True], ids=["unmapped", "mapped"])
@pytest.mark.parametrize("seed", range(4))
def test_carve_fuzz_matches_jax(seed, mapped):
    """The JAX package's native-carve fuzz sessions (every loop mode, speed,
    fade and playhead) through both of the port's walks and both row forms."""
    rng = np.random.default_rng((20_000 if mapped else 0) + seed)
    js = _rand_session(rng)
    if mapped:
        js.set_tempo_point(float(rng.uniform(0.1, 4.0)), float(rng.uniform(60, 180)),
                           curve="linear", bpm_end=float(rng.uniform(60, 180)))
    js.playhead_start = float(rng.choice([0.0, rng.uniform(0.0, 1.5)]))
    bs = int(rng.choice([256, 512]))
    for native_walk in (True, False):
        for emit in ("runs", "blocks"):
            assert_carves_equal(js, 48000.0, native_walk=native_walk, buffer_size=bs, slow_emit=emit)


def test_native_host_library_builds_by_content():
    if native.load() is None:
        pytest.skip("no g++: the NumPy walk is the path (covered by the numpy cases)")
    srcs = sorted(native.HOST_DIR.glob("*.cpp"))
    d = buildlib.content_dir("host", native.CXX_FLAGS, srcs)
    assert (d / native.LIB_NAME).is_file()
    assert "-march=native" not in native.CXX_FLAGS and "-ffp-contract=off" in native.CXX_FLAGS
    assert buildlib.content_dir("host", native.CXX_FLAGS[1:], srcs) != d
    so, seconds = buildlib.build_shared("g++", native.CXX_FLAGS, srcs, "host", native.LIB_NAME)
    assert so == d / native.LIB_NAME and seconds == 0.0  # reused, not rebuilt


def _automated_tempo_session():
    s = tempo_session()
    s.set_meter(2, 3, 4)
    s.tracks[0].automation = TrackAutomation(
        volume=AutomationLane().add(0.0, 1.0).add(3.0, 0.2, curve=CurveType.EXP_DUAL, tension=1.5),
        pan=AutomationLane().add(0.0, -0.5).add(6.0, 0.5))
    s.tracks[1].clips[0].audio.mode = ClipMode.LOOP_BIDIRECTIONAL
    s.add_bus("b", volume_db=-2.0)
    return s


@pytest.mark.parametrize("kind", ["plain", "automated_tempo"])
def test_project_from_jax_carves_identically(tmp_path, kind):
    js = make_demo_session(n_tracks=3, duration_seconds=3.0, sample_seconds=1.0, seed=4,
                           fades=True) if kind == "plain" else _automated_tempo_session()
    path = tmp_path / "p.wb"
    jax_write_project(js, path)
    ps = read_project(path)
    jr = jax_read_project(path)
    a, pa = carve_session(ps, RATE, buffer_size=512)
    b, pb = jax_carve_session(jr, RATE, buffer_size=512)
    _assert_tables_equal(a, b, kind)
    assert_pools_equal(pa, pb)
    assert ps.tempo_map == from_reference(jr).tempo_map
    meters = [[(p.bar, p.num, p.den) for p in m.points] if m else None
              for m in (ps.meter_map, jr.meter_map)]
    assert meters[0] == meters[1]
    for pt, jt in zip(ps.tracks, jr.tracks):
        assert (pt.automation is None) == (jt.automation is None)
        if pt.automation is not None:
            assert [(p.x, p.y, int(p.curve), p.tension) for p in pt.automation.volume.points] == \
                [(p.x, p.y, int(p.curve), p.tension) for p in jt.automation.volume.points]


def test_project_from_port_reads_in_jax(tmp_path):
    js = _automated_tempo_session()
    path = tmp_path / "q.wb"
    write_project(from_reference(js), path)
    jr = jax_read_project(path)
    a, _ = jax_carve_session(js, RATE, buffer_size=512)
    b, _ = jax_carve_session(jr, RATE, buffer_size=512)
    _assert_tables_equal(b, a, "port-written project")
    assert jr.tracks[0].automation.pan.points[1].y == 0.5 and len(jr.buses) == 1


@pytest.mark.parametrize("fmt", ["F32", "I16", "I24", "I32"])
def test_wav_bytes_equal_jax(fmt):
    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal((2, 3001)) * 0.5, -1.2, 1.2).astype(np.float32)
    x[0, :4] = (1.0, -1.0, 0.0, -0.0)
    ours, theirs = io.BytesIO(), io.BytesIO()
    wav.write_wav(ours, x, 48000, AudioFormat[fmt])
    jax_wav.write_wav(theirs, x, 48000, JaxAudioFormat[fmt])
    assert ours.getvalue() == theirs.getvalue()
    got, info = wav.read_wav(ours.getvalue())
    ref, jinfo = jax_wav.read_wav(theirs.getvalue())
    np.testing.assert_array_equal(got, ref)
    assert (info.channels, info.count, int(info.format)) == (jinfo.channels, jinfo.count, int(jinfo.format))


def test_from_reference_carries_the_session():
    from whitebox_tpu.midi.notes import MidiNote, MidiNoteBuffer

    js = _automated_tempo_session()
    js.add_send(0, 0, gain_db=-6.0, pre_fader=True)
    js.set_track_output(1, 0)
    js.master_automation = {(0, "gain_db"): AutomationLane().add(0.0, 0.5)}
    tr = js.add_track("m")
    js.add_midi_clip(tr, "mc", 0.0, 2.0, asset=js.midi_table.create_midi(
        MidiNoteBuffer([MidiNote(0.0, 1.0, key=64, velocity=0.7)])))
    s = from_reference(js)
    assert (s.bpm, s.beat_duration, s.ppq) == (js.bpm, js.beat_duration, js.ppq)
    assert s.tempo_map.points == tuple(type(s.tempo_map.points[0])(p.beat, p.bpm, p.curve, p.bpm_end)
                                       for p in js.tempo_map.points)
    assert s.buses[0].volume_db == -2.0 and s.tracks[1].output_bus == 0
    assert (s.tracks[0].sends[0].gain_db, s.tracks[0].sends[0].pre_fader) == (-6.0, True)
    assert list(s.master_automation) == [(0, "gain_db")]
    assert s.tracks[0].automation.volume.points[1].curve == CurveType.EXP_DUAL
    notes = s.tracks[-1].clips[0].midi.asset.notes.notes
    assert [(n.key, n.velocity) for n in notes] == [(64, 0.7)]
    # clips that shared an asset share its copy; the copy owns its data
    ja = [c.audio.asset for t in js.tracks for c in t.clips if c.audio is not None]
    pa = [c.audio.asset for t in s.tracks for c in t.clips if c.audio is not None]
    assert len({id(a) for a in pa}) == len({id(a) for a in ja})
    assert pa[0].sample.data[0] is not ja[0].sample.data[0]
    np.testing.assert_array_equal(pa[0].sample.data[0], ja[0].sample.data[0])
    assert type(s).__module__.startswith("whitebox_tpu_torch.")


def _aiff_bytes(planar_i16) -> bytes:
    """A big-endian 16-bit AIFF at 44.1 kHz holding ``planar_i16`` [C, N]."""
    import struct

    C, N = planar_i16.shape
    comm = struct.pack(">hLh", C, N, 16) + bytes.fromhex("400EAC44000000000000")
    ssnd = struct.pack(">LL", 0, 0) + np.ascontiguousarray(planar_i16.T).astype(">i2").tobytes()
    body = b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


def _unported_calls(tmp_path):
    from whitebox_tpu_torch.session import Session

    s = from_reference(make_demo_session(n_tracks=1, duration_seconds=2.0, sample_seconds=1.0, seed=1))
    aif = tmp_path / "x.aiff"
    aif.write_bytes(_aiff_bytes(np.random.default_rng(5).integers(-32768, 32768, (2, 777)).astype(np.int16)))
    return {
        "stretch_preserving_pitch": lambda: s.stretch_clip(0, 0, 1.5, preserve_pitch=True, device="cpu"),
        "start_recording": lambda: s.start_recording(s.tracks[0], 48000.0),
        "set_track_input": lambda: s.set_track_input(0, "external_mono"),
        "aiff_decode": lambda: Session().sample_table.load_from_file(aif),
        "midi_file": lambda: s.midi_table.load_from_file(tmp_path / "x.mid"),
        "session": lambda: s,
    }


@pytest.mark.parametrize("call", ["stretch_preserving_pitch", "start_recording", "set_track_input",
                                  "aiff_decode", "midi_file"])
def test_unported_session_methods_raise(tmp_path, call):
    if call == "midi_file":  # ported (midi/smf.py): a missing file reads as None, as in the reference
        assert _unported_calls(tmp_path)[call]() is None
        return
    if call == "stretch_preserving_pitch":
        _check_stretch_preserving_pitch(tmp_path)
        return
    {"start_recording": _check_start_recording, "set_track_input": _check_set_track_input,
     "aiff_decode": _check_aiff_decode}[call](tmp_path)


def _check_start_recording(tmp_path):
    """Ported (session/record.py): the take lands as the JAX package's does,
    the same span and the same samples."""
    take = _unported_calls(tmp_path)["start_recording"]()
    js = make_demo_session(n_tracks=1, duration_seconds=2.0, sample_seconds=1.0, seed=1)
    jtake = js.start_recording(js.tracks[0], 48000.0)
    blocks = [np.random.default_rng(3).standard_normal((2, n)).astype(np.float32) for n in (512, 77, 4096)]
    for b in blocks:
        take.append(b)
        jtake.append(b)
    got, want = take.finalize(), jtake.finalize()
    assert (got.min_time, got.max_time) == (want.min_time, want.max_time)
    np.testing.assert_array_equal(np.stack(got.audio.asset.sample.data), np.stack(want.audio.asset.sample.data))
    assert [(c.min_time, c.max_time) for c in take.track.clips] == [(c.min_time, c.max_time) for c in js.tracks[0].clips]


def _check_set_track_input(tmp_path):
    """Ported (session/input.py): the assignment packs to the JAX package's
    u32 and forms the same input groups."""
    from whitebox_tpu.session import Session as JaxSession

    calls = _unported_calls(tmp_path)
    calls["set_track_input"]()
    port = calls["session"]()
    js = JaxSession(bpm=120.0)
    js.add_track("t")
    js.set_track_input(0, "external_mono")
    assert port.tracks[0].input.as_packed_u32() == js.tracks[0].input.as_packed_u32()
    for ses in (port, js):
        ses.arm_track(0)
    assert [(g.input.as_packed_u32(), g.track_indices) for g in port.input_groups()] == \
        [(g.input.as_packed_u32(), g.track_indices) for g in js.input_groups()]


def _check_aiff_decode(tmp_path):
    """Ported (io/aiff.py): the sample decodes as the JAX package's does."""
    from whitebox_tpu.session.sample import Sample as JaxSample

    asset = _unported_calls(tmp_path)["aiff_decode"]()
    want = JaxSample.load_file(tmp_path / "x.aiff")
    assert (asset.sample.sample_rate, asset.sample.format.name) == (want.sample_rate, want.format.name)
    np.testing.assert_array_equal(np.stack(asset.sample.data), np.stack(want.data))


def _check_stretch_preserving_pitch(tmp_path):
    """Ported (ops/stretch.py): the clip plays the phase vocoder's render of
    its source, on the span the JAX package's ``stretch_clip`` gives it."""
    from whitebox_tpu_torch.ops.stretch import time_stretch

    js = make_demo_session(n_tracks=1, duration_seconds=2.0, sample_seconds=1.0, seed=1)
    s = from_reference(js)
    src = np.stack(s.tracks[0].clips[0].audio.asset.sample.data)
    js.stretch_clip(0, 0, 1.5, preserve_pitch=False)  # the span; the JAX vocoder's audio is held elsewhere
    assert _unported_calls(tmp_path)["stretch_preserving_pitch"]() is None
    s.stretch_clip(0, 0, 1.5, preserve_pitch=True, device="cpu")
    got, want = s.tracks[0].clips[0], js.tracks[0].clips[0]
    assert (got.min_time, got.max_time, got.start_offset) == (want.min_time, want.max_time, want.start_offset)
    assert got.audio.speed == 1.0
    np.testing.assert_array_equal(np.stack(got.audio.asset.sample.data), time_stretch(src, 1.5, device="cpu"))


def test_resample_stretch_still_works():
    js = make_demo_session(n_tracks=1, duration_seconds=2.0, sample_seconds=1.0, seed=1)
    s = from_reference(js)
    js.stretch_clip(0, 0, 1.25, preserve_pitch=False)
    s.stretch_clip(0, 0, 1.25, preserve_pitch=False)
    a, _ = carve_session(s, RATE, buffer_size=512)
    b, _ = jax_carve_session(js, RATE, buffer_size=512)
    _assert_tables_equal(a, b, "stretched")


def _imports_of(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


_PORT_FILES = (sorted((REPO / "whitebox_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
               + sorted((REPO / "examples").glob("torch_*.py")))
_IMPORT_ALL = ("import importlib, pkgutil, sys, whitebox_tpu_torch\n"
               "for m in pkgutil.walk_packages(whitebox_tpu_torch.__path__, 'whitebox_tpu_torch.'):\n"
               "    importlib.import_module(m.name)\n"
               "import chip_smoke\n")
_BOUNCE_AUTOMATED = (
    "import sys\n"
    "from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation\n"
    "from whitebox_tpu_torch.render.bounce import bounce\n"
    "from whitebox_tpu_torch.render.demo import make_demo_session\n"
    "s = make_demo_session(n_tracks=2, duration_seconds=2.0, sample_seconds=1.0, seed=1)\n"
    "s.set_tempo_point(1.0, 90.0)\n"
    "s.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(2.0, 0.3))\n"
    "assert bounce(s, 48000.0, device='cpu').audio.any()\n")


_BOUNCE_EQ = (
    "import sys\n"
    "from whitebox_tpu_torch.effects import Biquad, EffectChain, ParametricEQ\n"
    "from whitebox_tpu_torch.render.bounce import bounce\n"
    "from whitebox_tpu_torch.render.demo import make_demo_session\n"
    "s = make_demo_session(n_tracks=2, duration_seconds=2.0, sample_seconds=1.0, seed=1)\n"
    "s.tracks[0].effects = EffectChain([ParametricEQ([('peak', 1000.0, 1.0, -3.0)])])\n"
    "s.master_effects = EffectChain([Biquad('highpass', 25.0)])\n"
    "for mode in ('scan', 'fir'):\n"
    "    assert bounce(s, 48000.0, device='cpu', effects_mode=mode).audio.any()\n")


_BOUNCE_SINC = (
    "import sys\n"
    "from whitebox_tpu_torch.render.bounce import bounce\n"
    "from whitebox_tpu_torch.render.demo import make_demo_session\n"
    "s = make_demo_session(n_tracks=2, duration_seconds=2.0, sample_seconds=1.0, seed=1,\n"
    "                      clip_speeds=(1.0, 44100 / 48000, 2 ** (1 / 12)))\n"
    "for kw in ({'interpolation': 'sinc'}, {'interpolation': 'sinc', 'prerender': False},\n"
    "           {'interpolation': 'catmull'}):\n"
    "    res = bounce(s, 48000.0, device='cpu', **kw)\n"
    "    assert res.audio.any()\n"
    "    assert (res.stats.prerender_seconds > 0) == (kw == {'interpolation': 'sinc'})\n")


_BANNED = {"jax": ("jax", "jaxlib"), "whitebox_tpu": ("whitebox_tpu",), "tests": ("tests",)}


@pytest.mark.parametrize("case", ["sources_jax", "sources_whitebox_tpu", "sources_tests", "modules_import",
                                  "modules_after_automated_bounce", "modules_after_eq_bounce",
                                  "modules_after_sinc_bounce"])
def test_port_import_guard(case):
    """The port stands alone: no source of ``whitebox_tpu_torch/``,
    ``chip_smoke.py`` or ``examples/torch_*.py`` imports JAX, the JAX
    package or a module of the test suite (by AST), and neither
    is loaded after importing every module or after a CPU bounce of an
    automated session, of an EQ session in both effects modes, or of a
    resampled session in the sinc (prerendered and oversampled) and
    Catmull-Rom modes (a fresh process each)."""
    if case.startswith("sources_"):
        roots = _BANNED[case.removeprefix("sources_")]
        bad = [f"{p.relative_to(REPO)}: {m}" for p in _PORT_FILES for m in _imports_of(p)
               if m.split(".")[0] in roots]
        assert not bad, bad
        return
    code = {"modules_import": _IMPORT_ALL, "modules_after_automated_bounce": _BOUNCE_AUTOMATED,
            "modules_after_eq_bounce": _BOUNCE_EQ, "modules_after_sinc_bounce": _BOUNCE_SINC}[case]
    code += ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'whitebox_tpu'))\nprint('loaded:', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "loaded: []", r.stdout


_SURFACE = {  # the names the reference's package __init__s import (``whitebox_tpu/*/__init__.py``)
    "whitebox_tpu": ("formats", "math", "panning"),
    "whitebox_tpu.core": ("buffers", "formats", "math", "panning"),
    "whitebox_tpu.io": ("wav",),
    "whitebox_tpu.render": ("bounce", "RenderStats"),
}


@pytest.mark.parametrize("pkg", sorted(_SURFACE))
def test_package_surface_matches_reference(pkg):
    """Every name a reference package's ``__init__`` imports is an
    attribute of the port's package of the same sub-path, of the same kind
    (a module where the reference has a module)."""
    import importlib

    ref = importlib.import_module(pkg)
    port = importlib.import_module(pkg.replace("whitebox_tpu", "whitebox_tpu_torch", 1))
    for name in _SURFACE[pkg]:
        assert hasattr(port, name), f"{port.__name__} lacks {name}"
        assert isinstance(getattr(port, name), type(sys)) == isinstance(getattr(ref, name), type(sys)), name


def test_render_package_bounce_is_the_function():
    """``from whitebox_tpu_torch.render import bounce`` is the bounce function
    (it shadows its module, as in the reference) and renders bit-equal to
    the module's ``bounce``; ``RenderStats`` comes with it."""
    import importlib

    from whitebox_tpu_torch.render import RenderStats, bounce

    mod = importlib.import_module("whitebox_tpu_torch.render.bounce")
    assert callable(bounce) and bounce is mod.bounce and RenderStats is mod.RenderStats
    s = from_reference(make_demo_session(n_tracks=3, duration_seconds=1.0, seed=5))
    np.testing.assert_array_equal(bounce(s, RATE, device="cpu").audio, mod.bounce(s, RATE, device="cpu").audio)


def test_duty_cycle_matches_reference():
    """``RenderStats.duty_cycle`` (``whitebox_tpu/render/metrics.py:55-58``,
    the PerformanceMeasurer's share of the realtime budget): ``1 / rtf``,
    equal to the JAX package's for one render's stats."""
    from whitebox_tpu.render.metrics import RenderStats as JaxStats
    from whitebox_tpu_torch.render import bounce

    s = from_reference(make_demo_session(n_tracks=3, duration_seconds=1.0, seed=5))
    st = bounce(s, RATE, device="cpu").stats
    js = JaxStats(frames=st.frames, channels=st.channels, tracks=st.tracks, sample_rate=st.sample_rate,
                  wall_seconds=st.wall_seconds)
    assert st.wall_seconds > 0 and st.duty_cycle == js.duty_cycle == 1.0 / st.rtf
