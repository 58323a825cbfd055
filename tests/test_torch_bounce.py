"""whitebox_tpu_torch's bounce, demo builder, CLI and import hygiene (CPU).

The port's ``bounce(device="cpu")`` renders with the plain PyTorch mix,
the CUDA kernel's twin; at speed 1 it must be bit-equal to the JAX
package's ``bounce(engine="pallas")`` (interpret mode here) and to the
NumPy oracle.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_carve import random_session
from tests.test_torch_mix import assert_ulp_contract
from tests.test_torch_mix_plan import dense_session, make_case
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.io import wav
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.render.demo import make_demo_session as jax_make_demo_session
from whitebox_tpu.session.project import write_project
from whitebox_tpu.timeline.carve import carve_session, render_segments_numpy
from whitebox_tpu.timeline.oracle import OracleRenderer
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import mix_cuda
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.demo import make_demo_session

REPO = Path(__file__).resolve().parent.parent


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
    table, pool = carve_session(s, rate, buffer_size=512, slow_emit="runs")
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
    tb, _ = carve_session(b, 48000.0, buffer_size=512)
    # edit_stamp() hashes each clip's asset by object identity, so two
    # builds can only share a stamp once their clips share asset objects:
    # check the samples are equal, then point b's clips at a's assets
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
    from whitebox_tpu.effects.gain import Gain
    from whitebox_tpu.midi.notes import MidiNoteBuffer
    from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation

    def base():
        return random_session(6, rate=48000, bpm=120.0, n_tracks=2, n_clips=1)

    s_fx = base()
    s_fx.tracks[0].effects.append(Gain(-3.0))
    s_master = base()
    s_master.master_effects.append(Gain(-1.0))
    s_auto = base()
    s_auto.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0))
    s_midi = base()
    tr = s_midi.add_track("m")
    s_midi.add_midi_clip(tr, "c", 0.0, 2.0, asset=s_midi.midi_table.create_midi(MidiNoteBuffer([])))
    s_bus = base()
    s_bus.add_bus("b")
    s_bus.set_track_output(0, 0)
    return {"effects": (s_fx, {}), "master_effects": (s_master, {}),
            "automation": (s_auto, {}), "midi": (s_midi, {}), "routing": (s_bus, {}),
            "catmull": (base(), {"interpolation": "catmull"}),
            "sinc": (base(), {"interpolation": "sinc"})}


@pytest.mark.parametrize("feature", ["effects", "master_effects", "automation", "midi",
                                     "routing", "catmull", "sinc"])
def test_unsupported_features_raise(feature):
    s, kw = _unsupported_sessions()[feature]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        bounce(s, 48000.0, device="cpu", **kw)


def test_slot_overflow_raises_instead_of_switching():
    s = dense_session()
    # halve every clip and squeeze them into one 1024-frame tile: 12 runs
    for i, c in enumerate(s.tracks[0].clips):
        c.min_time, c.max_time = i * 0.003, i * 0.003 + 0.0025
    with pytest.raises(SlotOverflow, match="ROADMAP.md queue 1, item 1"):
        bounce(s, 48000.0, device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = random_session(1, rate=48000, bpm=120.0, n_tracks=1, n_clips=1)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            bounce(s, 48000.0, device=dev)
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
    # an unsupported session is an error message, not a traceback
    s.tracks[0].automation = _unsupported_sessions()["automation"][0].tracks[0].automation
    write_project(s, wb)
    assert cli.main(["render", str(wb), str(out), "--device", "cpu"]) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_port_imports_no_jax():
    code = ("import sys, whitebox_tpu_torch, whitebox_tpu_torch.render.bounce, "
            "whitebox_tpu_torch.ops.mix_cuda, whitebox_tpu_torch.ops.cuda_build, "
            "whitebox_tpu_torch.cli, whitebox_tpu_torch.render.demo; "
            "assert 'jax' not in sys.modules, 'jax loaded'; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_never_import_jax():
    for p in (REPO / "whitebox_tpu_torch").rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), f"{p}: {s}"
