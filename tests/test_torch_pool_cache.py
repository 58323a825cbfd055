"""The sample pool's cache (``timeline/pool.py::build_sample_pool``) and its
resident device copy (``ops/mix_cuda.py::resident_pool``) on the CPU.

The pool is keyed by the set of assets it holds and the layout arguments,
not by the session's edit stamp: a fader or clip move keeps the pool, a
change of the asset set flattens anew, and a freed asset's id never aliases
a new one's. The device copy is keyed by the ``SamplePool`` object: an edit
that keeps the pool uploads nothing, a new pool replaces the device's one
entry. Each render here is compared bit for bit with a render whose pool
was flattened from an empty cache, or uploaded anew.
"""

import gc
import weakref

import numpy as np
import pytest

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.effects import Biquad, EffectChain, ParametricEQ
from whitebox_tpu_torch.ops import mix_cuda
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.stems import render_stems
from whitebox_tpu_torch.session import Session
from whitebox_tpu_torch.session.sample import Sample
from whitebox_tpu_torch.timeline import pool

RATE = 48000.0


@pytest.fixture(autouse=True)
def _fresh_pool_cache(monkeypatch):
    monkeypatch.setattr(pool, "_POOL_CACHE", {})
    monkeypatch.setattr(pool, "pool_cache_hits", 0)
    monkeypatch.setattr(pool, "pool_cache_misses", 0)
    monkeypatch.setattr(mix_cuda, "_RESIDENT_POOLS", {})
    monkeypatch.setattr(mix_cuda, "resident_pool_hits", 0)
    monkeypatch.setattr(mix_cuda, "resident_pool_misses", 0)


def _asset(s, i, seed):
    rng = np.random.default_rng(seed)
    ch = 2 if i % 2 == 0 else 1
    data = (rng.standard_normal((ch, 6000)) * 0.1).astype(np.float32)
    return s.sample_table.add_sample(Sample.from_planar(data, 48000, AudioFormat.F32, name=f"a{i}"), key=f"a{i}")


def _session(seed=1, n_assets=3, eq=False):
    """Two tracks; track 0 plays asset 0 then asset 1, track 1 plays asset
    2 (when there is one) then asset 0. Beats are 0.5 s at 120 bpm."""
    s = Session(bpm=120.0)
    assets = [_asset(s, i, seed * 100 + i) for i in range(n_assets)]
    t0 = s.add_track("t0", volume_db=-3.0, pan=-0.2)
    s.add_audio_clip(t0, "c0", 0.0, 0.2, asset=assets[0], fade_start=0.05)
    s.add_audio_clip(t0, "c1", 0.3, 0.5, asset=assets[1], gain=0.8)
    t1 = s.add_track("t1", volume_db=-6.0, pan=0.3)
    s.add_audio_clip(t1, "c2", 0.1, 0.3, asset=assets[-1])
    s.add_audio_clip(t1, "c3", 0.4, 0.6, asset=assets[0], fade_end=0.05)
    if eq:
        for t in s.tracks:
            t.effects = EffectChain([ParametricEQ([("lowshelf", 120.0, 0.707, 4.0), ("peak", 1500.0, 1.2, -3.0)])])
        s.master_effects = EffectChain([Biquad("highpass", 30.0)])
    return s, assets


def _cleared_bounce(s):
    """The bounce of ``s`` with its pool flattened from an empty cache."""
    pool._POOL_CACHE.clear()
    return bounce(s, RATE, device="cpu")


def _fader_and_move(s):
    s.tracks[0].volume_db = 1.5
    s.move_clip(s.tracks[1], s.tracks[1].clips[0], 0.05)


def test_fader_and_move_hit_and_mix_bit_equal():
    s, _ = _session()
    first = bounce(s, RATE, device="cpu")
    assert "wb.pool.flatten" in first.stats.host_legs
    built = pool.build_sample_pool(s)
    _fader_and_move(s)
    hits = pool.pool_cache_hits
    res = bounce(s, RATE, device="cpu")
    assert pool.pool_cache_hits == hits + 1
    assert "wb.pool.flatten" not in res.stats.host_legs
    assert pool.build_sample_pool(s) is built
    ref = _cleared_bounce(s)
    assert pool.build_sample_pool(s) is not built
    np.testing.assert_array_equal(res.audio, ref.audio)
    assert not np.array_equal(res.audio, first.audio)  # the edit reached the mix


def test_move_that_reorders_first_seen_assets_hits():
    s, assets = _session()
    built = pool.build_sample_pool(s)
    assert list(built.index_of) == [id(assets[0]), id(assets[1]), id(assets[2])]
    # asset 0's clip moves past asset 1's on track 0: now first seen 1, 0, 2
    t0 = s.tracks[0]
    s.move_clip(t0, t0.clips[0], 0.6)
    assert [c.audio.asset for c in t0.clips] == [assets[1], assets[0]]
    misses = pool.pool_cache_misses
    res = bounce(s, RATE, device="cpu")
    assert pool.pool_cache_misses == misses
    assert pool.build_sample_pool(s) is built
    ref = _cleared_bounce(s)
    assert list(pool.build_sample_pool(s).index_of) == [id(assets[1]), id(assets[0]), id(assets[2])]
    np.testing.assert_array_equal(res.audio, ref.audio)


@pytest.mark.parametrize("change", ["add_new_asset", "delete_last_clip", "replace_sample"])
def test_a_changed_asset_set_misses(change):
    """The host pool is flattened anew, and its device copy replaces the
    old one: one resident entry a device, the old tensor freed."""
    s, assets = _session()
    bounce(s, RATE, device="cpu")
    built = pool.build_sample_pool(s)
    old = weakref.ref(mix_cuda._RESIDENT_POOLS["cpu"][1])
    if change == "add_new_asset":
        extra = _asset(s, 3, 7)
        s.add_audio_clip(s.tracks[1], "c4", 0.7, 0.9, asset=extra)
        want = {id(a) for a in assets} | {id(extra)}
    elif change == "replace_sample":
        assets[1].sample = _asset(Session(), 1, 9).sample
        want = {id(a) for a in assets}
    else:
        t1 = s.tracks[1]
        s.delete_clip(t1, t1.clips[0])  # asset 2's only clip
        want = {id(assets[0]), id(assets[1])}
    misses = pool.pool_cache_misses
    got = pool.build_sample_pool(s)
    assert pool.pool_cache_misses == misses + 1
    assert got is not built and set(got.index_of) == want and got.num_samples == len(want)
    resident_misses = mix_cuda.resident_pool_misses
    res = bounce(s, RATE, device="cpu")
    assert mix_cuda.resident_pool_misses == resident_misses + 1
    assert list(mix_cuda._RESIDENT_POOLS) == ["cpu"] and mix_cuda._RESIDENT_POOLS["cpu"][0] is got
    assert old() is None
    np.testing.assert_array_equal(res.audio, _cleared_bounce(s).audio)


def test_fresh_assets_after_a_freed_session_never_hit():
    s, _ = _session(seed=1)
    bounce(s, RATE, device="cpu")
    del s
    gc.collect()
    # the cache keeps the freed session's assets alive, so no new object can
    # take their ids; and a key over new ids finds no entry
    s2, _ = _session(seed=2)
    hits, resident_hits = pool.pool_cache_hits, mix_cuda.resident_pool_hits
    res = bounce(s2, RATE, device="cpu")
    assert (pool.pool_cache_hits, mix_cuda.resident_pool_hits) == (hits, resident_hits)
    np.testing.assert_array_equal(res.audio, _cleared_bounce(s2).audio)


RENDERS = {
    "bounce": lambda s, engine: bounce(s, RATE, device="cpu", engine=engine).audio,
    "stems": lambda s, engine: render_stems(s, RATE, device="cpu", engine=engine)[0],
}


@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("render", list(RENDERS))
def test_resident_pool_hit_after_an_edit_bit_equal_to_a_fresh_upload(render, engine):
    """A fader and clip move keep the ``SamplePool``, so the render takes
    the same device tensor (the kernel path's ``CudaMixRenderer`` under
    ``"auto"``, the gather path under ``"xla"``) and equals, bit for bit,
    a render after the resident entry is cleared."""
    s, _ = _session(eq=render == "stems")
    first = RENDERS[render](s, engine)
    held = mix_cuda._RESIDENT_POOLS["cpu"]
    assert held[0] is pool.build_sample_pool(s)
    _fader_and_move(s)
    hits, misses = mix_cuda.resident_pool_hits, mix_cuda.resident_pool_misses
    got = RENDERS[render](s, engine)
    assert (mix_cuda.resident_pool_hits, mix_cuda.resident_pool_misses) == (hits + 1, misses)
    assert mix_cuda._RESIDENT_POOLS["cpu"][1] is held[1]
    mix_cuda._RESIDENT_POOLS.clear()
    ref = RENDERS[render](s, engine)
    assert mix_cuda.resident_pool_misses == misses + 1
    assert mix_cuda._RESIDENT_POOLS["cpu"][1] is not held[1]
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, first)  # the edit reached the render


def test_stems_eq_hit_after_an_edit():
    s, _ = _session(eq=True)
    render_stems(s, RATE, device="cpu")
    built = pool.build_sample_pool(s)
    _fader_and_move(s)
    hits, misses = pool.pool_cache_hits, pool.pool_cache_misses
    stems, names = render_stems(s, RATE, device="cpu")
    assert (pool.pool_cache_hits, pool.pool_cache_misses) == (hits + 1, misses)
    assert pool.build_sample_pool(s) is built
    pool._POOL_CACHE.clear()
    ref, ref_names = render_stems(s, RATE, device="cpu")
    assert names == ref_names
    np.testing.assert_array_equal(stems, ref)


def test_sessions_sharing_assets_share_the_pool_and_layout_args_key():
    s, assets = _session()
    built = pool.build_sample_pool(s)
    other = Session(bpm=100.0)
    tr = other.add_track("x")
    for i, a in enumerate(reversed(assets)):
        other.add_audio_clip(tr, f"o{i}", float(i), i + 0.5, asset=a)
    assert pool.build_sample_pool(other) is built
    assert pool.build_sample_pool(s, out_channels=1) is not built
    assert pool.build_sample_pool(s, lane_align=256) is not built
