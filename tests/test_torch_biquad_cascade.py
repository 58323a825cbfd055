"""The biquad cascade's blocked recurrence, modelled on the host (CPU).

The CUDA kernel ``whitebox_tpu_torch/csrc/biquad_cascade.cu`` runs the
finisher's section cascade in three phases: blocks of ``L`` frames from a
zero state (end states ``e_b``), the carry ``s_{b+1} = Phi_L s_b + e_b`` in
f64, the blocks again from their true starts. ``ops/biquad_cuda.py::
biquad_cascade_blocked`` is that algorithm in torch. Here, on small rows of
identity, FIR, real-pole, complex-pole and near-unit-circle sections, with
ragged last blocks and states carried in and out:

- the f64 model equals the sequential cascade in f64 on the same
  parameters to 1e-12 relative, and ``Phi_L`` (one step, then squaring)
  equals ``L`` single steps;
- the f32 model is within relative RMS 5e-6 per row of the plain version
  ``biquad_cascade_reference`` (the per-section Hillis scan), the bar the
  kernel is held to on the card: both round in f32, in different orders;
- identity rows pass their input exactly, and a stream may hand states
  between the model and the plain version (same eigen coordinates);
- on the CPU ``biquad_cascade`` is the plain version, and it refuses
  malformed arguments. The kernel's constants match the wrapper's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from whitebox_tpu_torch.ops import biquad as pbq
from whitebox_tpu_torch.ops import biquad_cuda as bc

RATE = 48000.0
REL_RMS = 5e-6  # kernel (and its model) vs the plain scan, per row


#: one chain of three sections per row: EQ bands (real and complex poles),
#: the 25 Hz highpass (poles at radius 0.9977), identity padding, FIR and
#: gain sections (companion form)
CHAINS = [
    [pbq.design_biquad("lowshelf", 100.0, RATE, 0.707, 2.0), pbq.design_biquad("peak", 1000.0, RATE, 1.0, -1.5),
     pbq.design_biquad("highshelf", 8000.0, RATE, 0.707, 1.0)],
    [pbq.design_biquad("highpass", 25.0, RATE), pbq.design_biquad("lowpass", 200.0, RATE, 4.0),
     pbq.IDENTITY_COEFFS],
    [pbq.IDENTITY_COEFFS] * 3,
    [pbq.BiquadCoeffs(0.5, 0.0, 0.0, 0.0, 0.0), pbq.BiquadCoeffs(0.3, 0.2, 0.1, 0.0, 0.0),
     pbq.design_biquad("notch", 3000.0, RATE, 4.0)],
    [pbq.BiquadCoeffs(1.0, 0.0, 0.0, -1.2, 0.35), pbq.design_biquad("bandpass", 5000.0, RATE, 2.0),
     pbq.design_biquad("allpass", 40.0, RATE, 0.6)],
]


def _coeffs(chains=CHAINS) -> torch.Tensor:
    S = len(chains[0])
    c = np.zeros((9, S, len(chains), 1), np.float32)
    for r, secs in enumerate(chains):
        for s, sec in enumerate(secs):
            c[:, s, r, 0] = pbq.eig_section_params(sec)
    return torch.from_numpy(c)


def _x(F, seed=1, B=len(CHAINS)):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((B, F)) * 0.3).astype(np.float32))


def _states(S, B, seed=None, dtype=torch.float32):
    if seed is None:
        return [torch.zeros((B, 2), dtype=dtype) for _ in range(S)]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, 2)) * 0.1).to(dtype) for _ in range(S)]


def sequential(x, coeffs, states):
    """The cascade one frame at a time (``cascade_step``) in x's dtype."""
    p = [a.to(x.dtype) for a in coeffs[..., 0].unbind(0)]
    S = coeffs.shape[1]
    z = torch.stack([s.to(x.dtype) for s in states], dim=1).reshape(x.shape[0], 2 * S)
    y = torch.empty_like(x)
    for n in range(x.shape[1]):
        y[:, n], z = bc.cascade_step(p, z, x[:, n])
    return y, list(z.reshape(-1, S, 2).unbind(1))


def row_rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).mean(axis=1)) / np.maximum(np.sqrt((b ** 2).mean(axis=1)), 1e-30)


@pytest.mark.parametrize("F,L,seed", [(2000, 256, None), (1500, 128, 3), (96, 32, 4)],
                         ids=["ragged_zero_states", "ragged_carried_states", "three_blocks"])
def test_f64_model_equals_the_sequential_cascade(F, L, seed):
    coeffs = _coeffs()
    x = _x(F).double()
    states = _states(3, len(CHAINS), seed, torch.float64)
    got, got_st = bc.biquad_cascade_blocked(x, coeffs, states, L)
    want, want_st = sequential(x, coeffs, states)
    assert got.dtype == torch.float64
    assert (row_rel_rms(got, want) < 1e-12).all()
    for a, b in zip(got_st, want_st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)


def test_transition_equals_single_steps():
    coeffs = _coeffs()
    L, B, S = 256, len(CHAINS), 3
    phi = bc.cascade_transition(coeffs, L)
    assert phi.shape == (B, 2 * S, 2 * S) and phi.dtype == torch.float64
    z0 = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 2 * S)))
    z = z0.clone()
    p = [a.double() for a in coeffs[..., 0].unbind(0)]
    for _ in range(L):
        _, z = bc.cascade_step(p, z, torch.zeros(B, dtype=torch.float64))
    np.testing.assert_allclose((phi @ z0[:, :, None])[..., 0].numpy(), z.numpy(), rtol=1e-9, atol=1e-13)
    # the 25 Hz highpass decays slowly: its rows of Phi are far from 0 at L
    assert float(phi[1].abs().max()) > 0.1
    with pytest.raises(ValueError):
        bc.cascade_transition(coeffs, 100)


@pytest.mark.parametrize("F,L,seed", [(3000, 256, None), (2100, 512, 7)],
                         ids=["ragged_zero_states", "carried_states"])
def test_f32_model_is_within_the_kernel_bar_of_the_plain_scan(F, L, seed):
    coeffs = _coeffs()
    x = _x(F, seed=2)
    states = _states(3, len(CHAINS), seed)
    got, got_st = bc.biquad_cascade_blocked(x, coeffs, states, L)
    want, want_st = bc.biquad_cascade_reference(x, coeffs, states)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (row_rel_rms(got, want) < REL_RMS).all()
    for a, b in zip(got_st, want_st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    # the identity row (index 2) passes its input exactly from zero states
    if seed is None:
        np.testing.assert_array_equal(got[2].numpy(), x[2].numpy())
        np.testing.assert_array_equal(want[2].numpy(), x[2].numpy())


def test_states_hand_over_between_model_and_plain_scan():
    coeffs = _coeffs()
    x = _x(4096, seed=8)
    whole, whole_st = bc.biquad_cascade_reference(x, coeffs, _states(3, len(CHAINS)))
    y1, st = bc.biquad_cascade_blocked(x[:, :1500], coeffs, _states(3, len(CHAINS)), 256)
    y2, st = bc.biquad_cascade_reference(x[:, 1500:3000], coeffs, st)
    y3, st = bc.biquad_cascade_blocked(x[:, 3000:], coeffs, st, 128)
    assert (row_rel_rms(torch.cat([y1, y2, y3], dim=1), whole) < REL_RMS).all()
    for a, b in zip(st, whole_st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_cpu_cascade_is_the_plain_version_and_refuses_bad_arguments():
    coeffs = _coeffs()
    x = _x(700, seed=9)
    states = _states(3, len(CHAINS), 10)
    before = bc.biquad_cascade_launches
    y, st = bc.biquad_cascade(x, coeffs, states)
    want, want_st = bc.biquad_cascade_reference(x, coeffs, states)
    assert bc.biquad_cascade_launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    for a, b in zip(st, want_st):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a chunk of a longer buffer (a row-strided view) is taken as it is
    y_view, _ = bc.biquad_cascade(x[:, 100:400], coeffs, states)
    np.testing.assert_array_equal(y_view.numpy(), bc.biquad_cascade_reference(
        x[:, 100:400].contiguous(), coeffs, states)[0].numpy())
    with pytest.raises(ValueError, match="coeffs"):
        bc.biquad_cascade(x, coeffs[:, :, :2], states)
    with pytest.raises(ValueError, match="states"):
        bc.biquad_cascade(x, coeffs, states[:2])
    with pytest.raises(ValueError, match="x must be"):
        bc.biquad_cascade(x.double(), coeffs, states)
    with pytest.raises(ValueError, match="device"):
        bc.biquad_cascade(x.to("meta"), coeffs.to("meta"), [s.to("meta") for s in states])


def test_kernel_constants_are_the_wrappers():
    src = (Path(bc.__file__).parent.parent / "csrc" / "biquad_cascade.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSections = (\d+);", src)[1]) == bc.MAX_SECTIONS
    tile = int(re.search(r"constexpr int kTile = (\d+);", src)[1])
    L = bc.BLOCK_FRAMES
    assert L % tile == 0 and L & (L - 1) == 0
