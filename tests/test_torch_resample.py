"""whitebox_tpu_torch.ops.resample against whitebox_tpu.ops.resample (CPU).

The design half is a NumPy copy: every table must be ``array_equal`` to the
JAX package's. The device half is torch ops; the same seeded signal goes
through both packages' ``resample_audio``.

Tolerances:
- port vs JAX, both in f32 with their own summation order over 32 taps (or
  a banded row): atol 1e-6 (measured 1.2e-7 gather, 2.4e-7 matmul);
- port vs the f64 host references: atol 5e-6, the JAX package's own bar
  (tests/test_resample.py:93,103); matmul vs gather 2e-4 (its :126).
"""

import numpy as np
import pytest

from whitebox_tpu.ops import resample as jax_rs
from whitebox_tpu_torch.ops import resample as rs

RATIOS = [1.0, 44100 / 48000, 2.0, 1.37]


def noise(seed, channels, n):
    return (np.random.default_rng(seed).standard_normal((channels, n)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("ratio", RATIOS)
def test_design_rows_and_bank_equal_jax(ratio):
    fracs = np.linspace(0.0, 1.0, 37)
    np.testing.assert_array_equal(rs._design_rows(fracs, ratio, 32, 90.0),
                                  jax_rs._design_rows(fracs, ratio, 32, 90.0))
    np.testing.assert_array_equal(rs._design_rows(fracs, ratio, 32, 90.0, cutoff=0.4),
                                  jax_rs._design_rows(fracs, ratio, 32, 90.0, cutoff=0.4))
    for a, b in zip(rs._design_rows_d012(fracs, ratio, 32, 90.0),
                    jax_rs._design_rows_d012(fracs, ratio, 32, 90.0)):
        np.testing.assert_array_equal(a, b)
    bank = rs.design_sinc_bank(ratio)
    assert bank.dtype == np.float32 and bank.shape == (rs.DEFAULT_PHASES + 1, rs.DEFAULT_TAPS)
    np.testing.assert_array_equal(bank, jax_rs.design_sinc_bank(ratio))


@pytest.mark.parametrize("U", [2, 4])
def test_design_poly_interp_equals_jax(U):
    a, b = rs.design_poly_interp(U), jax_rs.design_poly_interp(U)
    assert a == b and len(a) == 6 and len(a[0]) == 6
    np.testing.assert_array_equal(rs.poly_interp_offsets(a), [-2, -1, 0, 1, 2, 3])
    np.testing.assert_array_equal(rs.poly_interp_offsets(a), jax_rs.poly_interp_offsets(b))


@pytest.mark.parametrize("pq,cutoff", [((147, 160), None), ((160, 147), None), ((1, 4), 0.5), ((2, 1), None)])
def test_design_sinc_matrix_equals_jax(pq, cutoff):
    got = rs.design_sinc_matrix(*pq, cutoff=cutoff)
    want = jax_rs.design_sinc_matrix(*pq, cutoff=cutoff)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[0].dtype == np.float32


def test_rationalize_equals_jax():
    for ratio in (44100 / 48000, 48000 / 44100, 2.0, 0.5, 1.000301, 2 ** (1 / 12)):
        assert rs._rationalize(ratio) == jax_rs._rationalize(ratio)
    assert rs._rationalize(44100 / 48000) == (147, 160) and rs._rationalize(1.000301) is None


@pytest.mark.parametrize("rates", [(44100, 48000), (96000, 48000), (48000, 48000)])
@pytest.mark.parametrize("method", ["gather", "matmul", "auto"])
def test_resample_audio_matches_jax(method, rates):
    x = noise(0, 2, 5000)
    got = rs.resample_audio(x, *rates, method=method, device="cpu")
    want = jax_rs.resample_audio(x, *rates, method=method)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_gather_matches_f64_reference():
    x = noise(0, 2, 5000)
    got = rs.resample_audio(x, 44100, 48000, method="gather", device="cpu")
    ref = rs.resample_reference(x, 44100, 48000)
    np.testing.assert_array_equal(ref, jax_rs.resample_reference(x, 44100, 48000))
    np.testing.assert_allclose(got, ref, atol=5e-6)


def test_matmul_matches_f64_reference():
    x = noise(1, 2, 5000)
    got = rs.resample_audio(x, 44100, 48000, method="matmul", device="cpu")
    ref = rs.resample_matmul_reference(x, 44100, 48000)
    np.testing.assert_array_equal(ref, jax_rs.resample_matmul_reference(x, 44100, 48000))
    np.testing.assert_allclose(got, ref, atol=5e-6)


def test_matmul_slabbing_is_seamless():
    # tiny slabs vs one shot: a slab cut is a row boundary, so the same
    # products are summed; the CPU's sgemm picks its blocking by shape, so
    # the sums may round apart by an ulp or two (atol 5e-7), never more
    x = noise(2, 1, 20000)
    one = rs.resample_audio(x, 44100, 48000, method="matmul", device="cpu")
    slabbed = rs._resample_matmul(x, 147, 160, 32, 90.0, one.shape[1], q_slab=7, device="cpu")
    assert slabbed.shape == one.shape
    np.testing.assert_allclose(slabbed.numpy(), one, atol=5e-7, rtol=0)


def test_matmul_tracks_gather():
    x = noise(3, 1, 8000)
    a = rs.resample_audio(x, 44100, 48000, method="matmul", device="cpu")
    b = rs.resample_audio(x, 44100, 48000, method="gather", device="cpu")
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_irrational_ratio_takes_the_gather_form():
    x = noise(4, 1, 4000)
    y = rs.resample_audio(x, 48000, 48000 * 1.0003001, method="auto", device="cpu")
    np.testing.assert_allclose(y, jax_rs.resample_audio(x, 48000, 48000 * 1.0003001), atol=1e-6)
    with pytest.raises(ValueError, match="rational"):
        rs.resample_audio(x, 48000, 48000 * 1.0003001, method="matmul", device="cpu")


def test_sine_quality_44k1_to_48k():
    # the JAX package's quality bar (tests/test_resample.py:40-45): > 80 dB
    from tests.test_resample import sine, snr_db

    y = rs.resample_audio(sine(1000.0, 44100, 44100)[None], 44100, 48000, device="cpu")[0]
    assert snr_db(y[2000:-2000], 48000, 1000.0) > 80.0


def test_device_default_is_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.resample_audio(noise(5, 1, 100), 44100, 48000)


def test_full_f32_matmul_restores_the_setting():
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with rs.full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
