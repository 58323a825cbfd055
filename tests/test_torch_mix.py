"""whitebox_tpu_torch.ops.mix_cuda's plain mix against the JAX Pallas kernel (CPU).

``mix_reference`` is the CUDA kernel's function in plain PyTorch, and
``mix_per_track_reference`` that of its per-track mode (K4, ``[T, C, F]``
pre-gain buffers); here each is held against the JAX kernel (with
``per_track=True`` for K4) run in interpret mode on the same session
(each package carving its own copy), against the JAX package's NumPy
segment reference, and against itself fed the JAX plan.

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
from whitebox_tpu.timeline.carve import render_segments_numpy, render_segments_per_track_numpy
from whitebox_tpu_torch.ops import mix_cuda, mix_plan


def assert_ulp_contract(got, ref, max_ulps=2, abs_tol=2.4e-7):
    assert got.shape == ref.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    absd = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    bad = (ulps > max_ulps) & (absd > abs_tol)
    assert not bad.any(), f"{bad.sum()} samples off (max ulp {ulps.max()}, max abs {absd.max()})"


@pytest.mark.parametrize("name", CASES)
def test_plain_mix_matches_pallas_and_reference(name):
    c = carve_case(name)
    jax_out = mix_pallas.render_timeline_pallas(c.jtable, c.jpool, c.js, tile=c.tile, interpret=True)
    ref = render_segments_numpy(c.jtable, c.jpool, c.js)
    out = mix_cuda.render_timeline_cuda(c.table, c.pool, c.s, tile=c.tile, device="cpu")
    assert out.dtype == np.float32 and out.shape == ref.shape
    if name in SPEED1_CASES:
        np.testing.assert_array_equal(out, jax_out)
        np.testing.assert_array_equal(out, ref)
    else:
        assert_ulp_contract(out, jax_out)
        assert_ulp_contract(out, ref)
    assert np.abs(out).max() > 0.01


@pytest.mark.parametrize("name", CASES)
def test_per_track_plain_matches_pallas_and_reference(name):
    # K4's plain twin against the JAX kernel's per_track=True mode and the
    # NumPy per-track reference: [T, C, n_tiles*tile], pre-gain, no clip
    c = carve_case(name)
    jr = mix_pallas.PallasMixRenderer(c.jtable, c.jpool, c.js, tile=c.tile, interpret=True)
    jax_out = np.asarray(jr.render_device_per_track())
    jax_out = jax_out.reshape(jax_out.shape[0], 2, -1)
    r = mix_cuda.CudaMixRenderer(c.table, c.pool, c.s, tile=c.tile, device="cpu")
    out = r.render_device_per_track().numpy()
    assert out.shape == jax_out.shape == (len(c.s.tracks), 2, r.plan.n_tiles * r.plan.tile)
    ref = render_segments_per_track_numpy(c.jtable, c.jpool)
    F = ref.shape[-1]
    assert not out[..., F:].any()
    if name in SPEED1_CASES:
        np.testing.assert_array_equal(out, jax_out)
        np.testing.assert_array_equal(out[..., :F], ref)
    else:
        assert_ulp_contract(out, jax_out)
        assert_ulp_contract(out[..., :F], ref)
    assert np.abs(out).max() > 0.01


@pytest.mark.parametrize("name", ["mixed_speeds", "fades_resampled", "bidirectional"])
def test_resampled_port_tracks_f64_reference(name):
    # the unfused lerp: no more samples off the exact-phase NumPy reference
    # than the JAX kernel has, and at most one ulp anywhere
    c = carve_case(name)
    ref = render_segments_numpy(c.jtable, c.jpool, c.js)
    out = mix_cuda.render_timeline_cuda(c.table, c.pool, c.s, tile=c.tile, device="cpu")
    jax_out = mix_pallas.render_timeline_pallas(c.jtable, c.jpool, c.js, tile=c.tile, interpret=True)
    assert (out != ref).sum() <= (jax_out != ref).sum()
    assert_ulp_contract(out, ref, max_ulps=1, abs_tol=0.0)


@pytest.mark.parametrize("name", ["fast", "mixed_speeds", "loop_reverse"])
def test_plan_from_pallas_renders_the_same(name):
    s, _, tile, table, pool, js, jtable, jpool = carve_case(name)
    jp = mix_pallas.build_plan(jtable, jpool, js, tile=tile)
    own = mix_cuda.render_timeline_cuda(table, pool, s, tile=tile, device="cpu")
    via_jax = mix_cuda.render_timeline_cuda(table, pool, s, plan=mix_plan.plan_from_pallas(jp), device="cpu")
    np.testing.assert_array_equal(via_jax, own)


def test_renderer_keeps_pool_resident_and_clips():
    s, _, tile, table, pool = carve_case("fast")[:5]
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
    s, _, tile, table, pool, js, jtable, jpool = carve_case("fast")
    for t in s.tracks + js.tracks:
        t.volume_db, t.mute = 18.0, False
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    out = r.render()
    assert (np.abs(out) == 1.0).any() and np.abs(out).max() == 1.0
    np.testing.assert_array_equal(out, render_segments_numpy(jtable, jpool, js))


def test_dispatch_never_launches_on_cpu():
    s, _, tile, table, pool = carve_case("mixed_speeds")[:5]
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    before = (mix_cuda.mix_kernel_launches, mix_cuda.mix_per_track_launches)
    p = r.plan
    args = (r.pool_device, r.tables, p.n_tiles, p.tile, p.channels)
    np.testing.assert_array_equal(mix_cuda.mix(*args).numpy(), mix_cuda.mix_reference(*args).numpy())
    np.testing.assert_array_equal(mix_cuda.mix(*args, per_track=True).numpy(),
                                  mix_cuda.mix_per_track_reference(*args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_per_track_cuda(*args)
    with pytest.raises(ValueError, match="lane tables"):
        mix_cuda.mix(*args, auto={}, per_track=True)
    assert (mix_cuda.mix_kernel_launches, mix_cuda.mix_per_track_launches) == before


def test_per_track_sum_is_the_mix():
    # the per-track buffers times the track gains, summed in track order and
    # clipped, are the summing kernel's mix (bit-equal at speed 1 where one
    # slot of a track covers each frame, as here)
    s, _, tile, table, pool = carve_case("fades")[:5]
    r = mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile)
    pt = r.render_device_per_track()
    acc = torch.zeros(pt.shape[1:])
    for t in range(pt.shape[0]):
        acc = acc + pt[t] * r.tables["track_gain"][t][:, None]
    acc = torch.clamp(acc, -1.0, 1.0)
    np.testing.assert_array_equal(acc.numpy(), r.render_device().numpy())


def test_table_checks():
    s, _, tile, table, pool = carve_case("fast")[:5]
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
