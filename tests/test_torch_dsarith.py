"""whitebox_tpu_torch.ops.dsarith against whitebox_tpu.ops.dsarith (CPU).

The double-single phase must match the JAX version bit for bit: the CUDA
kernel evaluates the same op tree, and a one-ulp phase difference moves a
resampled sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whitebox_tpu.ops import dsarith as jds
from whitebox_tpu_torch.ops import dsarith as tds

N = 20000


def _speeds(kind, rng):
    if kind == "forward":
        return rng.uniform(0.25, 4.0, N)
    if kind == "reverse":
        return -rng.uniform(0.25, 4.0, N)
    if kind == "sub_half":
        return rng.uniform(-0.5, 0.5, N)
    if kind == "rate_ratios":
        return rng.choice([44100 / 48000, 48000 / 44100, 0.91875, 1.37, 0.5, -1.0, 22050 / 96000], N)
    # near unity: long phase drift, the case double-single exists for
    return 1.0 + rng.uniform(-1e-6, 1e-6, N)


KINDS = ["forward", "reverse", "rate_ratios", "near_unity", "sub_half"]


# the phase's domain: |j * speed| < 2^24, where f32 still holds integers
# (a plan slot spans at most ~tile + 1 k frames of source)
@pytest.mark.parametrize("kind,j_max", [(k, 1 << 12) for k in KINDS]
                         + [(k, 1 << 22) for k in KINDS[:4]] + [("sub_half", 1 << 24)])
def test_phase_eval_bit_equal(kind, j_max):
    rng = np.random.default_rng([KINDS.index(kind), j_max])
    j = rng.integers(0, j_max, N).astype(np.int32)
    j[:4] = [0, 1, j_max - 1, j_max // 2]
    frac = rng.random(N)
    frac[:3] = [0.0, np.nextafter(1.0, 0.0), 0.5]
    fh, fl = jds.split_f64(frac)
    sh, sl = jds.split_f64(_speeds(kind, rng))

    ix_j, fx_j = jds.phase_eval(jnp.asarray(j), jnp.asarray(fh), jnp.asarray(fl),
                                jnp.asarray(sh), jnp.asarray(sl))
    ix_t, fx_t = tds.phase_eval(torch.from_numpy(j), torch.from_numpy(fh), torch.from_numpy(fl),
                                torch.from_numpy(sh), torch.from_numpy(sl))
    assert ix_t.dtype == torch.int32 and fx_t.dtype == torch.float32
    np.testing.assert_array_equal(ix_t.numpy(), np.asarray(ix_j))
    np.testing.assert_array_equal(fx_t.numpy().view(np.int32), np.asarray(fx_j).view(np.int32))
    # r + 1 of a tiny negative r may round to 1.0 in f32: [0, 1], as in JAX
    assert ((fx_t >= 0) & (fx_t <= 1)).all()


def test_phase_eval_tracks_f64():
    # x = frac + j*speed to well under one f32 ulp of the fraction
    rng = np.random.default_rng(5)
    j = rng.integers(0, 1 << 20, N).astype(np.int32)
    frac, speed = rng.random(N), rng.uniform(-3.0, 3.0, N)
    fh, fl = tds.split_f64(frac)
    sh, sl = tds.split_f64(speed)
    ix, fx = tds.phase_eval(torch.from_numpy(j), torch.from_numpy(fh), torch.from_numpy(fl),
                            torch.from_numpy(sh), torch.from_numpy(sl))
    x = (fh.astype(np.float64) + fl) + j * (sh.astype(np.float64) + sl)
    err = np.abs(ix.numpy() + fx.numpy().astype(np.float64) - x)
    assert err.max() < 1e-7


def test_split_f64_equal():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.random(1000), rng.uniform(-1e6, 1e6, 1000), [0.0, 1.0, -0.5, 44100 / 48000]])
    for a, b in zip(tds.split_f64(x), jds.split_f64(x)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
