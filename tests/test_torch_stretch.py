"""The port's phase vocoder (``ops/stretch.py``), ``Session.stretch_clip(
preserve_pitch=True)`` and ``cli stretch`` against the JAX package's on
the CPU.

The port runs the vocoder's device part in f64 where the JAX package runs
f32. The two agree to relative RMS 1e-4 on steady material (tones with a
fade in and out, as the JAX package's own tests use) at ratios 0.75, 1.0
and 1.5, and for pitch shifts. Where a bin's heterodyne deviation sits
within an f32 rounding of ±pi (noise, onsets, a signal cut off), the
principal-value wrap of the two f32 programs can fall on different sides
and that bin's phase parts for the rest of the clip; the f64 port does
not part from itself that way (``chip_smoke.py`` holds the card to the CPU
at 1e-5 on 60 s with noise). The JAX results are computed once, in a
module fixture (each JAX call compiles its eager ops, ~3.5 s).
"""

import numpy as np
import pytest
import torch

from chip_smoke import rel_rms
from whitebox_tpu.core.formats import AudioFormat as JaxAudioFormat
from whitebox_tpu.ops import stretch as js
from whitebox_tpu.session import Session as JaxSession
from whitebox_tpu.session.project import read_project as jax_read_project
from whitebox_tpu.session.project import write_project
from whitebox_tpu.session.sample import Sample as JaxSample
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.ops import stretch as ps
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.session.project import read_project

RATE = 48000.0
RATIOS = (0.75, 1.0, 1.5)
SEMITONES = (3.0,)


def tones(seconds=1.0, seed=None):
    """Stereo steady tones with a 0.1 s squared fade in and out; with a
    seed, plus white noise at -34 dBFS."""
    t = np.arange(int(seconds * RATE)) / RATE
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.1) ** 2
    x = np.stack([0.3 * np.sin(2 * np.pi * 330 * t) + 0.3 * np.sin(2 * np.pi * 880 * t)
                  + 0.1 * np.sin(2 * np.pi * 3150.7 * t),
                  0.2 * np.sin(2 * np.pi * 523.3 * t) + 0.1 * np.sin(2 * np.pi * 1244.5 * t + 1.0)]) * env
    if seed is not None:
        x = x + 0.02 * np.random.default_rng(seed).standard_normal(x.shape)
    return x.astype(np.float32)


def dominant_freq(x, skip=8000, n=32768):
    n = min(n, x.shape[1] - skip - 2048)
    seg = np.asarray(x[0, skip:skip + n], np.float64) * np.hanning(n)
    return float(np.argmax(np.abs(np.fft.rfft(seg))) * RATE / n)


@pytest.fixture(scope="module")
def jax_out():
    x = tones()
    return ({r: js.time_stretch(x, r) for r in RATIOS},
            {st: js.pitch_shift(x, st, RATE) for st in SEMITONES})


@pytest.mark.parametrize("ratio", RATIOS)
def test_time_stretch_matches_jax(jax_out, ratio):
    got = ps.time_stretch(tones(), ratio, device="cpu")
    want = jax_out[0][ratio]
    assert got.shape == want.shape == (2, int(round(RATE * ratio)))
    assert rel_rms(got, want) < 1e-4


@pytest.mark.parametrize("semitones", SEMITONES)
def test_pitch_shift_matches_jax(jax_out, semitones):
    got = ps.pitch_shift(tones(), semitones, RATE, device="cpu")
    want = jax_out[1][semitones]
    assert got.shape == want.shape == (2, int(RATE))
    assert rel_rms(got, want) < 1e-4


@pytest.mark.parametrize("ratio", [0.5, 1.25, 2.0])
def test_duration_scales_pitch_stays(ratio):
    """``tests/test_stretch.py``'s checks: the length scales, the pitch
    and the steady-state level stay."""
    t = np.arange(int(RATE)) / RATE
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None]
    y = ps.time_stretch(x, ratio, device="cpu")
    assert y.shape[1] == int(round(x.shape[1] * ratio))
    assert abs(dominant_freq(y) - 440.0) < 3.0
    mid = y[0, 4096:y.shape[1] - 4096].astype(np.float64)
    assert abs(np.sqrt(np.mean(mid ** 2)) - 0.5 / np.sqrt(2)) < 0.04


def test_ratio_one_reconstructs_and_bad_ratio_raises():
    x = tones(seed=4)
    y = ps.time_stretch(x, 1.0, device="cpu")
    assert np.max(np.abs(y[:, 2048:-2048] - x[:, 2048:-2048])) < 1e-3
    with pytest.raises(ValueError):
        ps.time_stretch(x, 0.0, device="cpu")
    assert ps.pitch_shift(x, 0.0, RATE, device="cpu") is not x
    np.testing.assert_array_equal(ps.pitch_shift(x, 0.0, RATE, device="cpu"), x)


def test_overlap_add_is_a_fixed_order_sum():
    """``fold`` adds the frames as a plain loop over the frames does, and
    two runs on noisy material give the same bits."""
    segs = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, 64)))
    want = torch.zeros((2, 8 * 16 + 64), dtype=torch.float64)
    for t in range(9):
        want[:, t * 16:t * 16 + 64] += segs[:, t]
    torch.testing.assert_close(ps._overlap_add(segs, 16, want.shape[1]), want, rtol=0, atol=1e-15)
    x = tones(seed=5)
    np.testing.assert_array_equal(ps.time_stretch(x, 1.25, device="cpu"),
                                  ps.time_stretch(x, 1.25, device="cpu"))


def test_hop_that_does_not_divide_the_frame():
    x = tones()
    y = ps.time_stretch(x, 1.5, hop=500, device="cpu")
    assert y.shape == (2, int(1.5 * RATE)) and np.isfinite(y).all()
    assert dominant_freq(y) == dominant_freq(ps.time_stretch(x, 1.5, device="cpu"))


# --------------------------------------------------------- clip and CLI


def _tone_session():
    s = JaxSession(bpm=120.0)
    a = s.sample_table.add_sample(JaxSample.from_planar(tones(), int(RATE), JaxAudioFormat.F32, name="tone"),
                                  key="tone")
    tr = s.add_track("t")
    s.add_audio_clip(tr, "c", 0.0, 2.0, asset=a)  # 1 s at 120 bpm
    return s


def test_stretch_clip_preserving_pitch_renders_through_the_vocoder():
    s = from_reference(_tone_session())
    src = np.stack(s.tracks[0].clips[0].audio.asset.sample.data)
    s.stretch_clip(0, 0, 1.5, device="cpu")
    c = s.tracks[0].clips[0]
    assert c.max_time == pytest.approx(3.0) and c.audio.speed == 1.0
    np.testing.assert_array_equal(np.stack(c.audio.asset.sample.data),
                                  ps.time_stretch(src, 1.5, device="cpu"))


def test_cli_stretch_matches_jax_cli(tmp_path, capsys, jax_out):
    """``cli stretch`` on the same .wb in both CLIs: the same clip span and
    speed, the stretched asset within 1e-4 of the JAX package's (the
    fixture's compiles serve the JAX CLI's ratio 1.5)."""
    from whitebox_tpu import cli as jax_cli

    wb, want_wb, got_wb = tmp_path / "p.wb", tmp_path / "jax.wb", tmp_path / "port.wb"
    write_project(_tone_session(), wb)
    args = ["--track", "0", "--clip", "0", "--ratio", "1.5"]
    assert jax_cli.main(["stretch", str(wb), *args, "--out", str(want_wb)]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["stretch", str(wb), *args, "--out", str(got_wb), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jout
    want, got = jax_read_project(want_wb).tracks[0].clips[0], read_project(got_wb).tracks[0].clips[0]
    assert (got.min_time, got.max_time, got.start_offset, got.audio.speed) == \
        (want.min_time, want.max_time, want.start_offset, want.audio.speed)
    a, b = np.stack(got.audio.asset.sample.data), np.stack(want.audio.asset.sample.data)
    assert a.shape == b.shape and rel_rms(a, b) < 1e-4
