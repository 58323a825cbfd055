"""The port's peak mipmaps (``ops/peaks.py``), the C++ scalar walk
(``io/native.py::peaks_level``) and ``cli peaks`` against the JAX
package's on the CPU: the torch pyramid on the CPU and the C++ walk
bit-identical to the JAX package's ``reference_mipmaps`` (the scalar
oracle) and ``build_mipmaps`` for F32/I16/I24 in both qualities, with odd
and even tails, ties and several channels. JAX's ``build_mipmaps`` compiles
once per call, so it runs on one length per format and quality.
"""

import numpy as np
import pytest
import torch

from whitebox_tpu.core.formats import AudioFormat as JaxAudioFormat
from whitebox_tpu.io import wav
from whitebox_tpu.ops import peaks as jp
from whitebox_tpu.session.sample import Sample as JaxSample
from whitebox_tpu_torch import cli
from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io import native
from whitebox_tpu_torch.ops import peaks as pp
from whitebox_tpu_torch.session.sample import Sample

GEN = {
    "F32": lambda rng, c, n: (rng.standard_normal((c, n)) * 0.5).astype(np.float32),
    "I16": lambda rng, c, n: rng.integers(-32768, 32768, (c, n)).astype(np.int16),
    "I24": lambda rng, c, n: rng.integers(-(1 << 23), 1 << 23, (c, n)).astype(np.int32),
}
#: lengths: 65 (one level), 602 (mip 3 drops an even tail), 1001 and 4097
#: (partial last chunks of odd counts), 20001 (six levels)
LENGTHS = (65, 602, 1001, 4097, 20001)


def samples(fmt: str, n: int, channels: int = 2, seed: int = 0):
    """The same seeded data as a port Sample and a JAX-package Sample, with
    a run of ties (a plateau) and repeated extremes."""
    rng = np.random.default_rng(seed + n)
    d = GEN[fmt](rng, channels, n)
    d[:, 10:40] = d[:, 10:11]
    d[:, 50:60:2] = d[:, 50:51]
    return (Sample.from_planar(d, 48000, AudioFormat[fmt]),
            JaxSample.from_planar(d, 48000, JaxAudioFormat[fmt]))


def assert_levels_equal(got, want):
    assert [lv.mip_level for lv in got.levels] == [lv.mip_level for lv in want.levels]
    for a, b in zip(got.levels, want.levels):
        assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
        np.testing.assert_array_equal(a.data, b.data, err_msg=f"mip {a.mip_level}")


@pytest.mark.parametrize("quality", ["low", "high"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("fmt", list(GEN))
def test_pyramid_and_cpp_walk_match_jax_reference(fmt, n, quality):
    s, js = samples(fmt, n)
    want = jp.reference_mipmaps(js, quality)
    got = pp.build_mipmaps(s, quality, device="cpu")
    assert_levels_equal(got, want)
    assert (got.sample_count, got.channels, got.quality) == (n, 2, quality)
    for c in range(2):
        codes = pp.quantize_codes(s.data[c], s.format, quality)
        for lv in want.levels:
            walk = native.peaks_level(codes, lv.mip_level, pp.level_out_count(n, lv.mip_level))
            np.testing.assert_array_equal(walk.astype(lv.data.dtype), lv.data[c])


@pytest.mark.parametrize("quality", ["low", "high"])
@pytest.mark.parametrize("fmt", list(GEN))
def test_pyramid_matches_jax_build_mipmaps(fmt, quality):
    s, js = samples(fmt, 4097, channels=3, seed=7)
    assert_levels_equal(pp.build_mipmaps(s, quality, device="cpu"), jp.build_mipmaps(js, quality))


def test_quantize_codes_torch_equals_numpy_and_jax():
    """Every source format, full scale and just below, both qualities."""
    edges = {
        AudioFormat.F32: np.array([1.0, -1.0, 0.5, 0.9999, -0.9999, 0.0, 1.5, -1.5], np.float32),
        AudioFormat.I8: np.array([127, -128, 0, 1, -1], np.int8),
        AudioFormat.I16: np.array([32767, -32768, 0, 16383, -16384], np.int16),
        AudioFormat.I24: np.array([(1 << 23) - 1, -(1 << 23), 0, 12345], np.int32),
        AudioFormat.I24_X8: np.array([(1 << 23) - 1, -(1 << 23), 0, -777], np.int32),
        AudioFormat.I32: np.array([2**31 - 1, -(2**31), 0, 2**30, -(2**30) - 7], np.int32),
    }
    for fmt, x in edges.items():
        for q in ("low", "high"):
            want = jp.quantize_codes(x, JaxAudioFormat[fmt.name], q)
            np.testing.assert_array_equal(pp.quantize_codes(x, fmt, q), want)
            np.testing.assert_array_equal(pp.quantize_codes_torch(torch.from_numpy(x), fmt, q).numpy(), want)


def test_level_rules_and_peaks_f32_equal_jax():
    for count in (0, 64, 65, 602, 1024, 100000, 28_800_000):
        assert pp.mip_levels_for(count) == jp.mip_levels_for(count)
        for mip in pp.mip_levels_for(count):
            assert pp.level_out_count(count, mip) == jp.level_out_count(count, mip)
    x = np.random.default_rng(1).standard_normal((2, 1001)).astype(np.float32)
    np.testing.assert_array_equal(pp.peaks_f32(x, 64), jp.peaks_f32(x, 64))


def test_short_sample_has_no_levels_and_bad_quality_raises():
    s, _ = samples("F32", 64)
    assert pp.build_mipmaps(s, device="cpu").levels == []
    with pytest.raises(ValueError):
        pp.build_mipmaps(samples("F32", 65)[0], "medium", device="cpu")
    with pytest.raises(ValueError):
        native.peaks_level(np.zeros(10, np.int32), 1, 3)


def test_cli_peaks_matches_jax_cli(tmp_path, capsys):
    from whitebox_tpu import cli as jax_cli

    _, js = samples("I16", 4097, channels=3, seed=7)
    src = tmp_path / "a.wav"
    wav.write_wav(src, np.stack(js.data), 48000, JaxAudioFormat.I16)
    want_p, got_p = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert jax_cli.main(["peaks", str(src), str(want_p), "--quality", "low"]) == 0
    jout = capsys.readouterr().out.replace(str(want_p), "OUT")
    assert cli.main(["peaks", str(src), str(got_p), "--quality", "low", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.replace(str(got_p), "OUT") == jout
    want, got = np.load(want_p), np.load(got_p)
    assert sorted(got.files) == sorted(want.files) and len(want.files) == 3
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
