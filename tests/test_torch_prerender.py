"""whitebox_tpu_torch.timeline.prerender against whitebox_tpu.timeline.prerender (CPU).

The host half (``plan_prerender``, ``_rewrite``, ``apply_prerender_host``,
``resolve_sinc_host``) is a NumPy copy: plans, rewritten tables and the host
extension must equal the JAX package's exactly. The device half is torch
ops; here it runs on the CPU. Sessions are made with the JAX package's
session functions from a seed and carried across by ``from_reference``.

Tolerances:
- the extension built by torch ops vs the JAX package's device extension
  and vs the host twin: < 1e-6, the JAX package's own bar
  (tests/test_prerender.py:129,506): f32 banded products summed in another
  order;
- forced slabs vs unchunked: atol 5e-7 on the CPU, where sgemm picks its
  blocking by the batch's shape (the products summed are the same);
- ``bounce(interpolation="sinc", device="cpu")`` vs the JAX bounce and vs
  the NumPy mix of the host-prerendered table: < 3e-6
  (tests/test_prerender.py:142,258);
- a 1 kHz sine through the exact and the Taylor path: SNR > 90 dB
  (tests/test_prerender.py:163-192,324-368).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from chip_smoke import slow_frames
from tests.test_carve import random_session
from tests.test_prerender import _long_clip_session, _mix_reference
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.session.clip import ClipMode
from whitebox_tpu.timeline import prerender as jax_pre
from whitebox_tpu.timeline.carve import carve_session as jax_carve_session
from whitebox_tpu_torch.ops import mix_cuda
from whitebox_tpu_torch.ops.mix_plan import build_plan
from whitebox_tpu_torch.render.bounce import bounce as port_bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline import prerender as pre
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.pool import _GUARD, SamplePool

RATE = 48000.0
RATIONAL = (1.0, 0.5, 1.088435374149660)  # 44.1k clips in a 48k session
IRR = 2.0 ** (1.0 / 12.0)
BAD = 0.7500000001  # a hair off 3/4: no exact ramp, and too coarse a Taylor anchor grid
TABLE_FIELDS = ("track", "dst_start", "length", "sample_id", "src_int", "src_frac", "speed", "gain",
                "fast", "clamp", "clip_id", "fin_start", "fin_inv", "fout_end", "fout_inv")


def session(name):
    """A JAX-package session for a named prerender case."""
    rs = lambda seed, speeds, src=(48000.0,), **kw: random_session(
        seed, rate=48000, bpm=120.0, speeds=speeds, src_rates=src,
        **{"n_tracks": 2, "n_clips": 2, **kw})
    if name == "rational":
        return rs(7, RATIONAL, (44100.0,), n_tracks=3)
    if name == "taylor":
        return rs(8, (0.9183746519,), n_tracks=1, n_clips=1)
    if name == "mixed":
        return rs(11, (IRR, 147.0 / 160.0))
    if name == "slabs":
        return rs(13, (IRR, 147.0 / 160.0, 1.6180339887498949), n_tracks=3, n_clips=3)
    if name == "reverse":
        s = rs(15, RATIONAL, (44100.0,))
        for c in s.tracks[0].clips:
            c.audio.mode = ClipMode.LOOP_BIDIRECTIONAL
        return s
    if name == "partial":
        return rs(22, (0.5, BAD), n_tracks=4)
    if name == "pathological":
        return rs(8, (BAD,), n_tracks=1, n_clips=1)
    if name == "golden_long":
        return _long_clip_session(1.6180339887498949, beats=8.0)
    if name == "all_fast":
        return random_session(9, rate=48000, bpm=120.0, n_tracks=1, n_clips=1)
    raise KeyError(name)


def carved(name, offgrid=False):
    js = session(name)
    s = from_reference(js)
    jtable, jpool = jax_carve_session(js, RATE, buffer_size=512, slow_emit="runs")
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    if offgrid:  # every slow row's phase uniformly off the 1/Q grid
        shift = lambda t: replace(t, src_frac=np.where(t.fast, t.src_frac, t.src_frac + 0.3333))
        table, jtable = shift(table), shift(jtable)
    return js, s, table, pool, jtable, jpool


def assert_tables_equal(a, b):
    for f in TABLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.num_tracks, a.total_frames, a.buffer_size) == (b.num_tracks, b.total_frames, b.buffer_size)


def assert_plans_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.groups == b.groups and (a.ext_len, a.guard, a.taps, a.atten_db) == \
        (b.ext_len, b.guard, b.taps, b.atten_db)
    assert [vars(r) for r in a.runs] == [vars(r) for r in b.runs]
    assert (a.uncovered_rows is None) == (b.uncovered_rows is None)
    if a.uncovered_rows is not None:
        np.testing.assert_array_equal(a.uncovered_rows, b.uncovered_rows)


PLAN_CASES = [("rational", False, "exact"), ("taylor", False, "taylor"), ("mixed", False, "exact+taylor"),
              ("rational", True, "taylor"), ("reverse", False, "exact"), ("golden_long", False, "taylor"),
              ("partial", False, "residue"), ("pathological", False, "none"), ("all_fast", False, "none")]


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("name,offgrid,kind", PLAN_CASES)
def test_plan_prerender_equals_jax(name, offgrid, kind, partial):
    _, _, table, pool, jtable, jpool = carved(name, offgrid)
    plan = pre.plan_prerender(table, pool, partial=partial)
    assert_plans_equal(plan, jax_pre.plan_prerender(jtable, jpool, partial=partial))
    if kind == "none" or (kind == "residue" and not partial):
        assert plan is None
        return
    kinds = {g[0] for g in plan.groups}
    if kind == "residue":
        assert plan.uncovered_rows is not None and len(plan.uncovered_rows) > 0
    else:
        assert plan.uncovered_rows is None and kinds == set(kind.split("+"))
    if name == "reverse":
        assert any(p.rev for p in plan.runs)
    if name == "golden_long":
        assert len(plan.runs) > 1  # segmented and re-anchored
        for p in plan.runs:
            assert abs(p.e0) + p.L * abs(p.eps) <= pre._TAYLOR_EBUDGET + 1e-9


@pytest.mark.parametrize("name", ["rational", "mixed", "reverse", "partial"])
def test_rewrite_and_host_extension_equal_jax(name):
    _, _, table, pool, jtable, jpool = carved(name)
    plan = pre.plan_prerender(table, pool, partial=True)
    jplan = jax_pre.plan_prerender(jtable, jpool, partial=True)
    t2, p2 = pre.apply_prerender_host(table, pool, plan)
    jt2, jp2 = jax_pre.apply_prerender_host(jtable, jpool, jplan)
    assert_tables_equal(t2, jt2)
    for f in ("data", "channel_base", "counts", "rates"):
        np.testing.assert_array_equal(getattr(p2, f), getattr(jp2, f), err_msg=f)
    if name == "reverse":  # mirrored runs read their buffer backward at integer phases
        new = t2.sample_id >= pool.num_samples
        assert (t2.speed[new & ~t2.fast] == -1.0).all() and (t2.src_frac[new] == 0.0).all()
    if name == "partial":  # the residue stays slow in the rewritten table
        assert (~t2.fast).sum() == len(plan.uncovered_rows)
    # the metadata-only rewrite of the fused path gives the same table
    t3, p3 = pre.prerender_tables(table, pool, pre.plan_prerender(table, pool, partial=True),
                                 torch.zeros(pool.data.shape[0]))
    assert_tables_equal(t3, t2)
    np.testing.assert_array_equal(p3.channel_base, p2.channel_base)
    assert p3.data is pool.data


@pytest.mark.parametrize("name", ["rational", "mixed", "reverse", "taylor"])
def test_device_extension_matches_jax_and_host(name):
    _, _, table, pool, jtable, jpool = carved(name)
    plan = pre.plan_prerender(table, pool)
    t2, p2 = pre.apply_prerender_host(table, pool, plan)
    td, pd, full = pre.apply_prerender_device(table, pool, plan, device="cpu")
    assert_tables_equal(td, t2)
    np.testing.assert_array_equal(pd.channel_base, p2.channel_base)
    assert pd.data is pool.data and plan.ext_seconds > 0
    full = full.numpy()
    assert full.dtype == np.float32 and full.shape == p2.data.shape
    np.testing.assert_array_equal(full[: pool.data.shape[0]], pool.data)  # the base pool, untouched
    assert np.abs(full - p2.data).max() < 1e-6
    assert not full[-_GUARD:].any() and np.abs(full[pool.data.shape[0]:]).max() > 0.01
    _, _, jfull = jax_pre.apply_prerender_device(jtable, jpool, jax_pre.plan_prerender(jtable, jpool))
    jfull = np.asarray(jfull).reshape(-1)
    assert np.abs(jfull[: full.shape[0]] - full).max() < 1e-6


def test_f64_host_extension_bounds_the_f32_one():
    _, _, table, pool, _, _ = carved("mixed")
    plan = pre.plan_prerender(table, pool)
    _, p64 = pre.apply_prerender_host(table, pool, plan, f64=True)
    _, _, full = pre.apply_prerender_device(table, pool, plan, device="cpu")
    assert np.abs(full.numpy() - p64.data).max() < 1e-6


def test_forced_slabs_equal_unchunked(monkeypatch):
    _, _, table, pool, _, _ = carved("slabs")
    plan = pre.plan_prerender(table, pool)
    assert {g[0] for g in plan.groups} == {"exact", "taylor"}
    _, _, whole = pre.apply_prerender_device(table, pool, plan, device="cpu")
    monkeypatch.setattr(pre, "_EXT_SLAB_BYTES", 1 << 12)  # one sub-run per slab
    assert all(pre._ext_chunk(g[-1], 1 << 14) == 1 for g in plan.groups)
    assert max(g[-1] for g in plan.groups) > 3
    _, _, slabbed = pre.apply_prerender_device(table, pool, plan, device="cpu")
    np.testing.assert_allclose(slabbed.numpy(), whole.numpy(), atol=5e-7, rtol=0)
    n = pool.data.shape[0]
    np.testing.assert_array_equal(slabbed.numpy()[:n], whole.numpy()[:n])


def test_restricted_plan_renders_the_same_buffers():
    # the smoke test's sampled f64 reference: a plan cut to some runs lays
    # them out anew and renders each buffer as the whole plan does
    _, _, table, pool, _, _ = carved("slabs")
    plan = pre.plan_prerender(table, pool)
    sub = pre.restrict_plan(plan, lambda r: r.trk < 1, 2)
    kept = [r for r in plan.runs if r.trk < 1]
    assert 0 < len(sub.runs) == len(kept) < len(plan.runs) and sub.ext_len < plan.ext_len
    assert all(a is not b for a, b in zip(kept, sub.runs))
    _, whole = pre.apply_prerender_host(table, pool, plan)
    _, part = pre.apply_prerender_host(table, pool, sub)
    origin = pool.data.shape[0]
    for a, b in zip(kept, sub.runs):
        n = a.nsub * (a.Qp if a.taylor else pre._QF * a.Qp)
        for ch in range(2):
            np.testing.assert_array_equal(whole.data[origin + a.ext_base + ch * a.stride_group:][:n],
                                          part.data[origin + b.ext_base + ch * b.stride_group:][:n])


def test_windows_before_and_past_the_pool_read_zeros():
    # a pool without guard bands: the first run's window starts before
    # sample 0 and the last one's ends past the pool; an index gather would
    # wrap a negative start, so the device path pads, as the host twin does
    _, _, table, pool, _, _ = carved("rational")
    lo = int(pool.channel_base.min())
    hi = int((pool.channel_base.max(axis=1) + pool.counts).max())
    bare = SamplePool(data=np.ascontiguousarray(pool.data[lo:hi]), channel_base=pool.channel_base - lo,
                      counts=pool.counts, rates=pool.rates, index_of=pool.index_of)
    slow = ~table.fast
    table = replace(table, src_int=np.where(slow, 0, table.src_int).astype(np.int32),
                    src_frac=np.where(slow, 0.0, table.src_frac))
    plan = pre.plan_prerender(table, bare)
    starts = np.concatenate([s for s, _ in pre._group_starts(plan, bare)])
    need = max((pre._QF + 1) * g[1] for g in plan.groups)
    assert starts.min() < 0 and starts.max() + need > bare.data.shape[0]
    _, p2 = pre.apply_prerender_host(table, bare, plan)
    _, _, full = pre.apply_prerender_device(table, bare, plan, device="cpu")
    assert np.abs(full.numpy() - p2.data).max() < 1e-6


def test_extension_refuses_int32_overflow():
    _, _, table, pool, _, _ = carved("rational")
    plan = pre.plan_prerender(table, pool)
    with pytest.raises(ValueError, match="int32"):
        pre._rewrite(table, pool, plan, ext_origin=2**31 - plan.ext_len)
    with pytest.raises(ValueError, match="1-D float32"):
        pre.apply_prerender_device(table, pool, plan, pool_device=torch.zeros(4, 128))


def test_device_matrices_are_cached_by_device_and_bounded():
    pre._DEVICE_MAT_CACHE.clear()
    _, _, table, pool, _, _ = carved("mixed")
    plan = pre.plan_prerender(table, pool)
    a = pre._device_group_args(plan, pool, torch.device("cpu"))
    b = pre._device_group_args(plan, pool, torch.device("cpu"))
    assert all(x[1][1] is y[1][1] for x, y in zip(a, b))  # the same tensors, not re-uploaded
    assert {k[-1] for k in pre._DEVICE_MAT_CACHE} == {"cpu"} and len(pre._DEVICE_MAT_CACHE) == len(plan.groups)
    for q in range(pre._DEVICE_MAT_CACHE_MAX + 3):
        pre._device_matrix("exact", 147 * (q + 2), 160, 32, 90.0, (147, 160), torch.device("cpu"))
    assert len(pre._DEVICE_MAT_CACHE) == pre._DEVICE_MAT_CACHE_MAX


BOUNCE_CASES = ["rational", "mixed", "reverse", "partial", "taylor"]


@pytest.mark.parametrize("name", BOUNCE_CASES)
def test_sinc_bounce_matches_jax_and_reference(name):
    js, s, table, pool, _, _ = carved(name)
    before = dict(mix_cuda.interp_launches), mix_cuda.mix_kernel_launches
    res = port_bounce(s, RATE, device="cpu", interpolation="sinc")
    assert (dict(mix_cuda.interp_launches), mix_cuda.mix_kernel_launches) == before  # no card here
    want = jax_bounce(js, RATE, interpolation="sinc", engine="pallas").audio
    assert res.audio.shape == want.shape and res.stats.prerender_seconds > 0
    assert np.abs(res.audio - want).max() < 3e-6
    # the NumPy mix of the host-prerendered table (resolve_sinc_host)
    t2, p2, interp = pre.resolve_sinc_host(table, pool)
    assert (interp == "linear") == (name != "partial")
    if interp == "linear":
        ref = _mix_reference(js, t2, p2)
        n = min(ref.shape[1], res.audio.shape[1])
        assert np.abs(res.audio[:, :n] - ref[:, :n]).max() < 3e-6
    # speed-1 rows are untouched: frames that no resampled row covers are
    # the linear bounce's, bit for bit
    lin = port_bounce(s, RATE, device="cpu").audio
    keep = ~slow_frames(table, lin.shape[1])
    np.testing.assert_array_equal(res.audio[:, keep], lin[:, keep])
    assert np.abs(res.audio - lin).max() > 1e-4


def test_sinc_without_prerender_matches_jax():
    js, s, table, pool, _, _ = carved("rational")
    res = port_bounce(s, RATE, device="cpu", interpolation="sinc", prerender=False)
    want = jax_bounce(js, RATE, interpolation="sinc", engine="pallas", prerender=False).audio
    assert np.abs(res.audio - want).max() < 3e-6 and res.stats.prerender_seconds == 0.0
    # another form than the exact polyphase one (its shared 4x copies take
    # the anti-alias cutoff of the fastest clip that reads them)
    exact = port_bounce(s, RATE, device="cpu", interpolation="sinc").audio
    assert np.abs(res.audio - exact).max() > 1e-4


def test_fused_render_is_the_bounce():
    js, s, table, pool, _, _ = carved("mixed")
    plan = pre.plan_prerender(table, pool, partial=True)
    base = torch.from_numpy(pool.data)
    t2, p2 = pre.prerender_tables(table, pool, plan, base)
    r = mix_cuda.CudaMixRenderer(t2, p2, s, device="cpu", plan=build_plan(t2, p2, s),
                                 pool_device=pre.apply_prerender_device(table, pool, plan, device="cpu")[2])
    out = pre.render_prerendered_fused(plan, pool, r, base)
    np.testing.assert_array_equal(out.numpy(), r.render_device().numpy())
    got = port_bounce(s, RATE, device="cpu", interpolation="sinc").audio
    np.testing.assert_array_equal(out.numpy()[:, : got.shape[1]], got)
    # a plan that points past the extended pool is refused, not read
    with pytest.raises(ValueError, match="outside"):
        mix_cuda.CudaMixRenderer(t2, p2, s, device="cpu", plan=r.plan, pool_device=base)


def test_sine_snr_exact_and_taylor_paths():
    """One sine clip at a rational speed (the exact polyphase path, hard
    left) and one at a semitone (the Taylor path, hard right): each must
    reconstruct its ideal resampled sine above 90 dB in one bounce."""
    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.sample import Sample

    t = np.arange(48000 * 2) / 48000
    x = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    s = Session(bpm=120.0)
    a = s.sample_table.add_sample(Sample.from_planar(x[None], 48000, AudioFormat.F32, name="sine"),
                                  key="sine")
    s.add_audio_clip(s.add_track("rational", volume_db=0.0, pan=-1.0), "r", 0.0, 6.0, asset=a, speed=0.5)
    s.add_audio_clip(s.add_track("irrational", volume_db=0.0, pan=1.0), "i", 0.0, 3.0, asset=a, speed=IRR)
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    plan = pre.plan_prerender(table, pool, partial=True)
    assert plan.uncovered_rows is None and {g[0] for g in plan.groups} == {"exact", "taylor"}
    out = port_bounce(s, RATE, device="cpu", interpolation="sinc").audio
    m = np.arange(out.shape[1]) / RATE
    amp = 0.5 * float(np.sqrt(2.0))  # the -3 dB pan law on the hard side
    lo, hi = 2000, int(1.5 * RATE)
    for ch, speed in ((0, 0.5), (1, IRR)):
        ideal = amp * np.sin(2 * np.pi * 1000.0 * speed * m)
        noise = out[ch, lo:hi] - ideal[lo:hi]
        snr = 10 * np.log10(np.mean(ideal[lo:hi] ** 2) / max(np.mean(noise ** 2), 1e-30))
        assert snr > 90.0, f"ch{ch} speed {speed}: SNR {snr:.1f} dB"
