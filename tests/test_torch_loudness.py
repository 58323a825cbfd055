"""The port's EBU R128 loudness (``ops/loudness.py``), ``bounce(loudness=,
normalize=)`` and ``cli loudness`` / ``render --loudness --normalize-*``
against the JAX package's on the CPU.

The K-weighting coefficients are bit-equal (the same f64 Python). The
port's ``measure_loudness(device="cpu")`` (the cascade's plain version,
``torch.fft`` for the true peak) is held within 0.02 LU (integrated,
momentary, short-term), 0.05 LU (LRA) and 0.05 dB (true peak) of both the
JAX device path and the f64 host reference; the port's f64 reference
equals the JAX package's ``device=False`` branch exactly. The JAX device
path compiles once per signal shape, so its results are shared by a
module fixture.
"""

import functools
import json

import numpy as np
import pytest

from tests.test_carve import random_session
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.io import wav
from whitebox_tpu.ops import loudness as jl
from whitebox_tpu.session.project import write_project
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.ops import loudness as pl
from whitebox_tpu_torch.render.bounce import _finalize_output, bounce
from whitebox_tpu_torch.render.metrics import RenderStats
from whitebox_tpu_torch.session.convert import from_reference

RATE = 48000.0
#: the bars: LU for the three loudness readings, LU for LRA, dB for the true peak
BARS = {"integrated_lufs": 0.02, "momentary_max_lufs": 0.02, "shortterm_max_lufs": 0.02,
        "lra_lu": 0.05, "true_peak_dbtp": 0.05}


def program(seed=0, seconds=3.5, C=2, rate=RATE):
    """A modulated tone with noise, its level moving (so that LRA > 0)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 0.3 * t))
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x * (0.9 ** c) for c in range(C)]).astype(np.float32)


def sine(freq, seconds, amp_db, C=2):
    t = np.arange(int(seconds * RATE)) / RATE
    return np.broadcast_to(10.0 ** (amp_db / 20.0) * np.sin(2 * np.pi * freq * t), (C, t.size)).astype(np.float32)


SIGNALS = {
    "program_stereo": lambda: program(),
    "program_5ch": lambda: program(seed=1, seconds=1.5, C=5),
    "sine_997_-23": lambda: sine(997.0, 3.0, -23.0),
    "short_2s": lambda: program(seed=2, seconds=2.0),
    "silence": lambda: np.zeros((2, 24000), np.float32),
}


def assert_close(got, want, bars=BARS):
    """``got`` and ``want`` (LoudnessStats or their ``as_dict``) within the
    bars; a reading that is not finite (None in a dict) must be so in both."""
    g = got if isinstance(got, dict) else got.as_dict()
    w = want if isinstance(want, dict) else want.as_dict()
    for k, bar in bars.items():
        assert (g[k] is None) == (w[k] is None), (k, g[k], w[k])
        if w[k] is not None:
            assert abs(g[k] - w[k]) <= bar, (k, g[k], w[k])


@pytest.fixture(scope="module")
def jax_device():
    """The JAX package's device path on the stereo programme."""
    return jl.measure_loudness(SIGNALS["program_stereo"](), RATE, device=True)


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """The JAX package's f64 host branch on ``SIGNALS[name]`` (once each)."""
    return jl.measure_loudness(SIGNALS[name](), RATE, device=False)


@pytest.mark.parametrize("rate", [44100.0, 48000.0, 96000.0, 32768.0])
def test_k_weighting_coeffs_bit_equal_to_jax(rate):
    for got, want in zip(pl.k_weighting_coeffs(rate), jl.k_weighting_coeffs(rate)):
        assert (got.b0, got.b1, got.b2, got.a1, got.a2) == (want.b0, want.b1, want.b2, want.a1, want.a2)


def test_channel_weights_and_true_peak_ir_equal_jax():
    for C in (1, 2, 5, 6):
        np.testing.assert_array_equal(pl.channel_weights(C), jl.channel_weights(C))
    np.testing.assert_array_equal(pl._true_peak_ir(), jl._true_peak_ir())


@pytest.mark.parametrize("name", list(SIGNALS))
def test_reference_equals_jax_host_branch(name):
    """The port's f64 oracle is the JAX package's device=False branch."""
    assert pl.measure_loudness_reference(SIGNALS[name](), RATE).as_dict() == jax_reference(name).as_dict()


@pytest.mark.parametrize("name", list(SIGNALS))
def test_device_path_on_cpu_matches_the_f64_reference(name):
    assert_close(pl.measure_loudness(SIGNALS[name](), RATE, device="cpu"), jax_reference(name))


def test_device_path_on_cpu_matches_jax_device_path(jax_device):
    got = pl.measure_loudness(SIGNALS["program_stereo"](), RATE, device="cpu")
    assert_close(got, jax_device)
    assert got.lra_lu > 0.1 and got.integrated_lufs > -30


def test_sine_reads_its_level_and_true_peak_floor():
    """997 Hz at -23 dBFS reads -23 LUFS; an impulse on a sample reads a
    true peak of at least its sample peak (BS.1770)."""
    st = pl.measure_loudness(sine(997.0, 3.0, -23.0), RATE, device="cpu")
    assert abs(st.integrated_lufs + 23.0) < 0.1
    x = np.zeros((2, 48000), np.float32)
    x[:, 24000] = 1.0
    assert pl.measure_loudness(x, RATE, device="cpu").true_peak_dbtp >= -1e-6


def test_silence_is_json_safe():
    st = pl.measure_loudness(np.zeros((2, 4800), np.float32), RATE, device="cpu")
    d = json.loads(json.dumps(st.as_dict(), allow_nan=False))
    assert d["integrated_lufs"] is None and d["lra_lu"] == 0.0


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal off the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.measure_loudness(program(), RATE)


# ------------------------------------------------------------------ bounce


def _session(seed):
    return random_session(seed, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=2)


@pytest.mark.parametrize("normalize,reading,target,bar", [
    (("lufs", -20.0), "integrated_lufs", -20.0, 0.2), (("peak", -3.0), "true_peak_dbtp", -3.0, 0.15)],
    ids=["lufs", "peak"])
def test_bounce_normalize_hits_the_target_as_jax_would(normalize, reading, target, bar):
    """The normalized output is the raw bounce times the gain the JAX
    package's measurement gives (clipped to ±1), and its reading hits the
    target (``tests/test_loudness.py``'s bars)."""
    js = _session(37 if normalize[0] == "lufs" else 38)
    s = from_reference(js)
    raw = bounce(s, RATE, device="cpu").audio
    res = bounce(s, RATE, device="cpu", loudness=True, normalize=normalize)
    pre = jl.measure_loudness(raw, RATE, device=False)
    ref = getattr(pre, reading)
    want = np.clip(raw * np.float32(10.0 ** ((target - ref) / 20.0)), -1.0, 1.0)
    np.testing.assert_allclose(res.audio, want, rtol=2e-5, atol=1e-7)
    assert abs(getattr(res.stats.loudness, reading) - target) < bar
    assert_close(res.stats.loudness, jl.measure_loudness(res.audio, RATE, device=False))


def test_finalize_silence_noop_and_bad_mode():
    silent = np.zeros((2, 48000), np.float32)
    out = _finalize_output(silent, RenderStats(), RATE, False, ("lufs", -14.0), "cpu")
    assert not out.any()
    with pytest.raises(ValueError):
        _finalize_output(silent, RenderStats(), RATE, False, ("bogus", -1.0), "cpu")


# --------------------------------------------------------------------- CLI


def test_cli_loudness_matches_jax_cli(tmp_path, capsys):
    """``loudness --host`` prints what the JAX CLI prints; the device path's
    JSON is within the bars of the JAX CLI's."""
    from whitebox_tpu import cli as jax_cli

    p = tmp_path / "a.wav"
    wav.write_wav(p, program(seconds=3.1), int(RATE), AudioFormat.F32)
    assert jax_cli.main(["loudness", str(p), "--host"]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["loudness", str(p), "--host"]) == 0
    assert capsys.readouterr().out == jout and "LUFS" in jout
    assert jax_cli.main(["loudness", str(p), "--host", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["loudness", str(p), "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() and got["file"] == want["file"]
    assert_close(got, want)


@pytest.mark.parametrize("flags", [["--normalize-lufs", "-18"], ["--normalize-peak", "-2"]],
                         ids=["lufs", "peak"])
def test_cli_render_loudness_and_normalize_match_jax_cli(tmp_path, capsys, flags):
    from whitebox_tpu import cli as jax_cli

    wb, want_p, got_p = tmp_path / "p.wb", tmp_path / "jax.wav", tmp_path / "port.wav"
    write_project(_session(39), wb)
    assert jax_cli.main(["render", str(wb), str(want_p), "--engine", "xla", "--loudness", "--json", *flags]) == 0
    jblob = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert cli.main(["render", str(wb), str(got_p), "--device", "cpu", "--loudness", "--json", *flags]) == 0
    pout = capsys.readouterr().out
    assert "  loudness: I " in pout
    pblob = json.loads(pout.splitlines()[-1])
    want, got = wav.read_wav(want_p)[0], wav.read_wav(got_p)[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    assert_close(pblob["loudness"], jblob["loudness"])
