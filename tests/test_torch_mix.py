"""whitebox_tpu_torch.ops.mix_cuda's plain mix against the JAX Pallas kernel (CPU).

``mix_reference`` is the CUDA kernel's function in plain PyTorch; here it
is held against the JAX kernel run in interpret mode on the same carve,
against the NumPy segment reference, and against itself fed the JAX plan.

Tolerances:
- speed-1 sessions: bit-equal (``np.array_equal``) to both the JAX kernel
  and ``render_segments_numpy``;
- resampled and reverse slots: the JAX package's contract of
  tests/test_bounce.py (<= 2 ulp or <= 2.4e-7 absolute per sample) against
  both the JAX kernel and ``render_segments_numpy`` (exact f64 phase).
  Against the JAX kernel the port was expected bit-equal (same
  double-single phase op for op, same lerp order). It is on some cases,
  but XLA:CPU compiles the interpret-mode kernel of others (fades with
  resampling, bidirectional loops) with the lerp ``a + fx*(b-a)``
  contracted into an FMA: the lerp moves by 1 ulp, the mixed sample by up
  to 3e-8. The port keeps the unfused order of sampler.cpp:55, and
  ``test_resampled_port_tracks_f64_reference`` shows it agrees with the
  NumPy reference where the interpret-mode kernel does not.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mix_plan import CASES, SPEED1_CASES, carve_case
from whitebox_tpu.ops import mix_pallas
from whitebox_tpu.timeline.carve import render_segments_numpy
from whitebox_tpu_torch.ops import mix_cuda, mix_plan


def assert_ulp_contract(got, ref, max_ulps=2, abs_tol=2.4e-7):
    assert got.shape == ref.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    absd = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    bad = (ulps > max_ulps) & (absd > abs_tol)
    assert not bad.any(), f"{bad.sum()} samples off (max ulp {ulps.max()}, max abs {absd.max()})"


@pytest.mark.parametrize("name", CASES)
def test_plain_mix_matches_pallas_and_reference(name):
    s, _, tile, table, pool = carve_case(name)
    jax_out = mix_pallas.render_timeline_pallas(table, pool, s, tile=tile, interpret=True)
    ref = render_segments_numpy(table, pool, s)
    out = mix_cuda.render_timeline_cuda(table, pool, s, tile=tile, device="cpu")
    assert out.dtype == np.float32 and out.shape == ref.shape
    if name in SPEED1_CASES:
        np.testing.assert_array_equal(out, jax_out)
        np.testing.assert_array_equal(out, ref)
    else:
        assert_ulp_contract(out, jax_out)
        assert_ulp_contract(out, ref)
    assert np.abs(out).max() > 0.01


@pytest.mark.parametrize("name", ["mixed_speeds", "fades_resampled", "bidirectional"])
def test_resampled_port_tracks_f64_reference(name):
    # the unfused lerp: no more samples off the exact-phase NumPy reference
    # than the JAX kernel has, and at most one ulp anywhere
    s, _, tile, table, pool = carve_case(name)
    ref = render_segments_numpy(table, pool, s)
    out = mix_cuda.render_timeline_cuda(table, pool, s, tile=tile, device="cpu")
    jax_out = mix_pallas.render_timeline_pallas(table, pool, s, tile=tile, interpret=True)
    assert (out != ref).sum() <= (jax_out != ref).sum()
    assert_ulp_contract(out, ref, max_ulps=1, abs_tol=0.0)


@pytest.mark.parametrize("name", ["fast", "mixed_speeds", "loop_reverse"])
def test_plan_from_pallas_renders_the_same(name):
    s, _, tile, table, pool = carve_case(name)
    jp = mix_pallas.build_plan(table, pool, s, tile=tile)
    own = mix_cuda.render_timeline_cuda(table, pool, s, tile=tile, device="cpu")
    via_jax = mix_cuda.render_timeline_cuda(table, pool, s, plan=mix_plan.plan_from_pallas(jp), device="cpu")
    np.testing.assert_array_equal(via_jax, own)


def test_renderer_keeps_pool_resident_and_clips():
    s, _, tile, table, pool = carve_case("fast")
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    dev = r.render_device()
    assert dev.shape == (2, r.plan.n_tiles * tile) and dev.dtype == torch.float32
    assert dev.abs().max() <= 1.0
    # the padding past total_frames is silent
    assert not dev[:, r.plan.total_frames:].any()
    r2 = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile, pool_device=r.pool_device)
    assert r2.pool_device is r.pool_device
    np.testing.assert_array_equal(r2.render(), r.render())


def test_hard_clip_and_gain_order():
    # a loud session: the ordered sum passes +-1 and must clip exactly there
    s, _, tile, table, pool = carve_case("fast")
    for t in s.tracks:
        t.volume_db, t.mute = 18.0, False
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    out = r.render()
    assert (np.abs(out) == 1.0).any() and np.abs(out).max() == 1.0
    np.testing.assert_array_equal(out, render_segments_numpy(table, pool, s))


def test_dispatch_never_launches_on_cpu():
    s, _, tile, table, pool = carve_case("mixed_speeds")
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    before = mix_cuda.mix_kernel_launches
    p = r.plan
    np.testing.assert_array_equal(
        mix_cuda.mix(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels).numpy(),
        mix_cuda.mix_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels)
    assert mix_cuda.mix_kernel_launches == before


def test_table_checks():
    s, _, tile, table, pool = carve_case("fast")
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    p = r.plan
    bad = dict(r.tables, gain=r.tables["gain"].to(torch.float64))
    with pytest.raises(ValueError, match="gain"):
        mix_cuda.mix_reference(r.pool_device, bad, p.n_tiles, p.tile, p.channels)
    bad = dict(r.tables, src_start=r.tables["src_start"][..., :1].contiguous())
    with pytest.raises(ValueError, match="src_start"):
        mix_cuda.mix_reference(r.pool_device, bad, p.n_tiles, p.tile, p.channels)
    with pytest.raises(ValueError):
        mix_cuda.mix_reference(r.pool_device, r.tables, p.n_tiles + 1, p.tile, p.channels)
    with pytest.raises(ValueError):
        mix_cuda.mix_reference(r.pool_device.to(torch.float64), r.tables, p.n_tiles, p.tile, p.channels)
