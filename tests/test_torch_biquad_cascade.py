"""The biquad cascade's single-pass blocked recurrence, modelled on the host (CPU).

The CUDA kernel ``whitebox_tpu_torch/csrc/biquad_cascade.cu`` runs the
finisher's section cascade in one pass: sub-blocks of ``l`` frames walked
from a zero state, a Kogge-Stone scan over each tile's 32 sub-blocks in
f64 with the powers ``Phi_l^(2^i)``, the tiles' prefixes ``s_{k+1} = Phi_W
s_k + E_k`` in f64 (the decoupled look-back computes exactly these), each
sub-block's output corrected by the zero-input response to its start.
``ops/biquad_cuda.py::biquad_cascade_blocked`` is that algorithm in torch.
Here, on small rows of identity, FIR, real-pole, complex-pole and
near-unit-circle sections, with ragged last sub-blocks, many tiles a row
and states carried in and out:

- the f64 model equals the sequential cascade in f64 on the same
  parameters to 1e-12 relative, ``Phi_L`` (one step, then squaring)
  equals ``L`` single steps, and the kernel's tables (the powers and the
  zero-input response) equal single steps;
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


# the sub-block lengths here are short, so that a row spans several tiles
# of 32 sub-blocks: 2000 frames of 8 are 8 tiles, 1500 of 4 twelve, 96 of 1
# three, 4096 of 16 eight (the last sub-block full)
@pytest.mark.parametrize("F,L,seed", [(2000, 8, None), (1500, 4, 3), (96, 1, 4), (4096, 16, 5), (33, 64, 6)],
                         ids=["ragged_zero_states", "ragged_carried_states", "three_blocks", "whole_last_block",
                              "one_short_block"])
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


@pytest.mark.parametrize("F,L,seed", [(3000, 16, None), (2100, 32, 7)],
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
    y1, st = bc.biquad_cascade_blocked(x[:, :1500], coeffs, _states(3, len(CHAINS)), 16)
    y2, st = bc.biquad_cascade_reference(x[:, 1500:3000], coeffs, st)
    y3, st = bc.biquad_cascade_blocked(x[:, 3000:], coeffs, st, 8)
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
    assert int(re.search(r"constexpr int kLanes = (\d+);", src)[1]) == bc.TILE_LANES
    assert int(re.search(r"constexpr int kPowers = (\d+);", src)[1]) == bc.N_POWERS
    assert int(re.search(r"constexpr int kMaxBlock = (\d+);", src)[1]) == max(bc.BLOCK_CHOICES)
    # the entry point takes every sub-block length the wrapper may choose
    taken = {int(v) for v in re.findall(r"l != (\d+)", src)} | {max(bc.BLOCK_CHOICES)}
    assert set(bc.BLOCK_CHOICES) <= taken
    for B, F in ((1, 1), (2, 1 << 20), (15, 2880000), (16, 32768), (256, 1 << 20)):
        L = bc.block_frames(B, F)
        assert L in bc.BLOCK_CHOICES and L % 32 == 0 and L & (L - 1) == 0


@pytest.mark.parametrize("B,F,want", [(2, 1 << 20, 256), (15, 2880000, 256), (16, 1 << 17, 128),
                                      (256, 1 << 20, 128)], ids=["master", "few_rows", "window", "tracks"])
def test_block_length_follows_the_rows(B, F, want):
    assert bc.block_frames(B, F) == want


@pytest.mark.parametrize("l", [1, 4, 32])
def test_tables_equal_single_steps(l):
    """``cascade_tables``: the powers ``Phi_l^(2^i)`` and the output's
    zero-input response to each unit state, frame by frame."""
    coeffs = _coeffs()
    B, S = len(CHAINS), 3
    phis, resp = bc.cascade_tables(coeffs, l, dtype=torch.float64)
    assert phis.shape == (B, bc.N_POWERS, 2 * S, 2 * S) and resp.shape == (B, l, 8)
    p = [a.double() for a in coeffs[..., 0].unbind(0)]
    z = torch.eye(2 * S, dtype=torch.float64).expand(B, 2 * S, 2 * S)
    zero = torch.zeros((B, 2 * S), dtype=torch.float64)
    for n in range(l):
        y, z = bc.cascade_step(p, z, zero)
        np.testing.assert_allclose(resp[:, n, :2 * S].numpy(), y.numpy(), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(phis[:, 0].numpy(), z.numpy(), rtol=1e-9, atol=1e-13)
    for i in range(1, bc.N_POWERS):
        np.testing.assert_allclose(phis[:, i].numpy(), (phis[:, i - 1] @ phis[:, i - 1]).numpy(), rtol=1e-12)
    assert float(resp[:, :, 2 * S:].abs().max()) == 0.0
    # the identity row (index 2, companion form): a state reaches its output
    # for two frames, then none (nilpotent)
    assert not resp[2, 2:].any()


def test_tables_are_computed_once_per_coefficient_tensor():
    coeffs = _coeffs()
    bc._TABLES.clear()
    first = bc._tables(coeffs, 0, 3, 32)
    again = bc._tables(coeffs, 0, 3, 32)
    assert all(a is b for a, b in zip(first, again)) and len(bc._TABLES) == 1
    # another group, another length: their own entries
    bc._tables(coeffs, 1, 3, 32)
    bc._tables(coeffs, 0, 3, 64)
    assert len(bc._TABLES) == 3
    # an in-place edit of the coefficients is seen
    coeffs[8, 0, 0, 0] = 0.5
    edited = bc._tables(coeffs, 0, 3, 32)
    assert edited[1] is not first[1] and float(edited[0][8, 0, 0]) == 0.5
    bc._TABLES.clear()
