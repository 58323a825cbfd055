"""The port's stems export (``render/stems.py``) and ``cli stems`` against
the JAX package's on the CPU.

Per-track stems are bit-equal to the JAX package's ``render_stems`` at
speed 1 with no chain, within relative RMS 1e-5 of it with an EQ chain and
with a generic (compressor) chain; bus stems within 1e-5 of its
``render_bus_stems``. The stems sum to the port's own pre-master bounce
(atol 5e-5, the JAX package's bar), and the gather path (``engine="xla"``,
per-track buffers above the limit, a slot overflow) gives what K4 gives.
The JAX exports run once each, in a module fixture (the Pallas
interpret-mode mix and the JAX finishers compile per session shape).
"""

import importlib

import numpy as np
import pytest

from chip_smoke import midi_small, rel_rms
from tests.test_carve import random_session
from tests.test_effects_pipeline import add_effects
from tests.test_torch_mix_plan import dense_session
from tests.test_torch_routing import RATE as ROUTED_RATE
from tests.test_torch_routing import _jax_case
from whitebox_tpu import effects as jfx
from whitebox_tpu.io import wav
from whitebox_tpu.render.stems import render_bus_stems as jax_bus_stems
from whitebox_tpu.render.stems import render_stems as jax_stems
from whitebox_tpu.session.project import write_project
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow
bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")
from whitebox_tpu_torch.render import stems as stems_mod
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.effects_generic import reference_run_chain
from whitebox_tpu_torch.render.effects_pipeline import _chains_of
from whitebox_tpu_torch.render.stems import render_bus_stems, render_stems
from whitebox_tpu_torch.session.convert import from_reference

RATE = 48000.0


def _plain():
    return random_session(20, rate=48000, bpm=120.0, n_tracks=3, n_clips=2)


def _eq():
    return add_effects(random_session(20, rate=48000, bpm=120.0, n_tracks=3, n_clips=2), master=False)


def _generic():
    s = random_session(20, rate=48000, bpm=120.0, n_tracks=3, n_clips=2)
    s.tracks[0].effects = jfx.EffectChain([jfx.Compressor(-24.0, 4.0, attack_s=0.002, release_s=0.05)])
    s.tracks[2].effects = jfx.EffectChain([jfx.Biquad("lowpass", 3000.0), jfx.Delay(0.01, 0.3)])
    return s


SESSIONS = {"plain": _plain, "eq": _eq, "generic": _generic}


@pytest.fixture(scope="module")
def jax_exports():
    """The JAX package's stems of each session and bus stems of the routed case."""
    out = {name: jax_stems(make(), RATE) for name, make in SESSIONS.items()}
    out["bus"] = jax_bus_stems(_jax_case(), ROUTED_RATE)
    return out


def test_stems_bit_equal_to_jax_at_speed_1(jax_exports):
    got, names = render_stems(from_reference(_plain()), RATE, device="cpu")
    want, want_names = jax_exports["plain"]
    assert names == want_names and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["eq", "generic"])
def test_stems_with_chains_match_jax(jax_exports, name):
    got, names = render_stems(from_reference(SESSIONS[name]()), RATE, device="cpu")
    want, want_names = jax_exports[name]
    assert names == want_names and got.shape == want.shape
    for t in range(got.shape[0]):
        assert rel_rms(got[t], want[t]) < 1e-5, t


def test_bus_stems_match_jax_and_rebuild_the_mix(jax_exports):
    """``direct + sum(bus)`` through the master chain is the routed bounce."""
    s = from_reference(_jax_case())
    direct, bus, names = render_bus_stems(s, ROUTED_RATE, device="cpu")
    want_direct, want_bus, want_names = jax_exports["bus"]
    assert names == want_names and bus.shape == want_bus.shape and direct.shape == want_direct.shape
    assert rel_rms(direct, want_direct) < 1e-5 and rel_rms(bus, want_bus) < 1e-5
    total = direct.astype(np.float64) + bus.astype(np.float64).sum(axis=0)
    recon = np.clip(reference_run_chain(_chains_of(s)[1], total, None, ROUTED_RATE, 2, s.time_base), -1, 1)
    mix = bounce(s, ROUTED_RATE, device="cpu").audio
    assert rel_rms(recon, mix[:, :recon.shape[1]]) < 5e-5


@pytest.mark.parametrize("name", ["plain", "eq"])
def test_stems_sum_to_the_premaster_mix(name):
    """``tests/test_stems.py``'s bar: the clipped stem sum within 5e-5 of
    the bounce (no master chain in these sessions)."""
    s = from_reference(SESSIONS[name]())
    stems, _ = render_stems(s, RATE, device="cpu")
    mix = bounce(s, RATE, device="cpu").audio
    total = np.clip(stems.astype(np.float64).sum(axis=0), -1.0, 1.0)
    n = min(total.shape[1], mix.shape[1])
    np.testing.assert_allclose(total[:, :n], mix[:, :n], atol=5e-5)


def _limit_zero(monkeypatch):
    monkeypatch.setattr(bounce_mod, "per_track_limit_bytes", lambda dev: 0)


@pytest.mark.parametrize("name,route", [("plain", "xla"), ("eq", "xla"), ("eq", "limit"),
                                        ("generic", "limit")])
def test_gather_path_gives_what_k4_gives(monkeypatch, name, route):
    """The gather path renders the per-track chunks with torch ops into the
    same finishers: at speed 1 the same stems (the finishers' chunks differ,
    so chains agree to 1e-6)."""
    s = from_reference(SESSIONS[name]())
    k4, _ = render_stems(s, RATE, device="cpu")
    if route == "limit":
        _limit_zero(monkeypatch)
    got, _ = render_stems(s, RATE, device="cpu", engine="xla" if route == "xla" else "auto")
    assert got.shape == k4.shape
    if name == "plain":
        np.testing.assert_array_equal(got, k4)
    else:
        assert rel_rms(got, k4) < 1e-6


def test_bus_stems_gather_path_gives_what_k4_gives(monkeypatch):
    s = from_reference(_jax_case())
    direct, bus, _ = render_bus_stems(s, ROUTED_RATE, device="cpu")
    _limit_zero(monkeypatch)
    gdirect, gbus, _ = render_bus_stems(s, ROUTED_RATE, device="cpu")
    assert rel_rms(gdirect, direct) < 1e-6 and rel_rms(gbus, bus) < 1e-6


def test_slot_overflow_takes_the_gather_path_unless_pallas():
    """12 runs squeezed into one 1024-frame tile overflow the 8 slots
    (``tests/test_torch_bounce.py``'s case)."""
    s = from_reference(dense_session())
    for i, c in enumerate(s.tracks[0].clips):
        c.min_time, c.max_time = i * 0.003, i * 0.003 + 0.0025
    got, _ = render_stems(s, RATE, device="cpu")
    want, _ = render_stems(s, RATE, device="cpu", engine="xla")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SlotOverflow, match="engine='pallas'"):
        render_stems(s, RATE, device="cpu", engine="pallas")
    with pytest.raises(ValueError, match="engine"):
        render_stems(s, RATE, device="cpu", engine="fast")


def test_midi_tracks_stem_their_synth():
    """MIDI tracks' stems carry the synth (added to a copy of K4's buffer):
    the stems sum to the bounce; the gather path gives the same bits."""
    s = midi_small()
    stems, _ = render_stems(s, RATE, device="cpu")
    mix = bounce(s, RATE, device="cpu").audio
    total = np.clip(stems.astype(np.float64).sum(axis=0), -1.0, 1.0)
    n = min(total.shape[1], mix.shape[1])
    np.testing.assert_allclose(total[:, :n], mix[:, :n], atol=5e-5)
    assert float(np.abs(stems[-1]).max()) > 0.01
    np.testing.assert_array_equal(render_stems(s, RATE, device="cpu", engine="xla")[0], stems)


@pytest.mark.parametrize("mode", ["catmull", "sinc"])
def test_stems_play_the_bounce_interpolation(mode):
    """A resampled track's stem is its solo bounce in the same mode."""
    js = random_session(82, rate=48000, bpm=120.0, n_tracks=2, n_clips=2,
                        speeds=(44100.0 / 48000.0,), src_rates=(44100,))
    s = from_reference(js)
    stems, _ = render_stems(s, RATE, device="cpu", interpolation=mode)
    lin, _ = render_stems(s, RATE, device="cpu")
    assert np.abs(stems - lin).max() > 0
    for t in range(2):
        for i, tr in enumerate(s.tracks):
            tr.mute = i != t
        solo = bounce(s, RATE, device="cpu", interpolation=mode).audio
        n = min(stems.shape[2], solo.shape[1])
        np.testing.assert_allclose(np.clip(stems[t][:, :n], -1.0, 1.0), solo[:, :n], atol=5e-5)


def test_bus_stems_need_routing():
    with pytest.raises(ValueError, match="buses"):
        render_bus_stems(from_reference(_plain()), RATE, device="cpu")


# --------------------------------------------------------------------- CLI


def _cli_pair(tmp_path, capsys, js, flags):
    """``stems`` of ``js`` (as a .wb) by the JAX CLI and the port's ->
    {file name: (jax audio, port audio)}, after checking the printouts."""
    from whitebox_tpu import cli as jax_cli

    wb = tmp_path / "p.wb"
    write_project(js, wb)
    want_d, got_d = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(["stems", str(wb), str(want_d), *flags]) == 0
    jout = capsys.readouterr().out.replace(str(want_d), "DIR")
    assert cli.main(["stems", str(wb), str(got_d), *flags, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.replace(str(got_d), "DIR") == jout
    names = sorted(p.name for p in want_d.iterdir())
    assert names == sorted(p.name for p in got_d.iterdir()) and names
    return {n: (wav.read_wav(want_d / n)[0], wav.read_wav(got_d / n)[0]) for n in names}


def test_cli_stems_match_jax_cli(tmp_path, capsys, jax_exports):
    files = _cli_pair(tmp_path, capsys, _plain(), [])
    assert len(files) == 3
    for want, got in files.values():
        np.testing.assert_array_equal(got, want)


def test_cli_bus_stems_match_jax_cli(tmp_path, capsys, jax_exports):
    files = _cli_pair(tmp_path, capsys, _jax_case(), ["--buses", "--rate", str(ROUTED_RATE)])
    assert len(files) == 3 and "00_direct.wav" in files
    for want, got in files.values():
        assert got.shape == want.shape and rel_rms(got, want) < 1e-5


def test_cli_stems_compressed_ext_raises_naming_item_14(tmp_path, capsys):
    """Item 14 ported the codec: ``--ext flac`` writes each stem through it,
    the JAX CLI's file byte for byte (speed 1, no chain); without the libav
    libraries to build it against, the error names them."""
    from whitebox_tpu import cli as jax_cli
    from whitebox_tpu_torch.io import codec

    write_project(_plain(), tmp_path / "p.wb")
    flags = ["--ext", "flac", "--flac-level", "5", "--tag-title", "stems"]
    rc = cli.main(["stems", str(tmp_path / "p.wb"), str(tmp_path / "o"), *flags, "--device", "cpu"])
    if codec.load() is None:
        assert rc == 2 and "libavformat" in capsys.readouterr().err
        return
    assert rc == 0
    assert jax_cli.main(["stems", str(tmp_path / "p.wb"), str(tmp_path / "j"), *flags]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "o").iterdir()) and len(names) == 3
    for n in names:
        assert (tmp_path / "o" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_stems_default_to_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(stems_mod, "resolve_device", lambda d: calls.append(d) or bounce_mod.resolve_device("cpu"))
    render_stems(from_reference(_plain()), RATE)
    assert calls == [None]
