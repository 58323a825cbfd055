"""The CUDA summing kernel's staged slot walk, modelled on the host (CPU).

The kernel (``whitebox_tpu_torch/csrc/mix_kernel.cu``) gives each block of
``FRAMES_PER_BLOCK`` frames a compacted list of the slots that meet its
frames, in ``(track, slot)`` order, and its threads add only those.
``mix_plan.block_slot_mask`` / ``block_slot_lists`` are the host model of
that list, ``mix_plan.lane_segment_range`` of the per-block lane segment
range the automation variant starts its search from. Here:

- the lists keep the order, hold every slot that covers a frame of the
  block and no other;
- :func:`staged_mix`, the plain PyTorch arithmetic of ``mix_cuda`` applied
  to the kept slots only, per block from ``+0.0``, equals ``mix_reference``
  (``mix_auto_reference`` with lanes) bit for bit, compared as int32 words,
  so a NaN equals itself: on the small sessions the port shares with the JAX
  package's tests (speed 1, int formats, fades, mixed speeds, reverse,
  tiles of 1024 and 2048), at more than 8 slots with polynomial taps, with a ragged
  last block, with ``-0.0``, NaN and infinite samples, and for 1, 2 and 3
  channels;
- the lane segment range brackets the segment ``eval_lanes`` picks at every
  frame of the block, including a lane whose first breakpoint is negative;
- the per-track kernel's (K4) staging, ``mix_plan.per_track_block_slots``
  (one track, ``PER_TRACK_FRAMES_PER_BLOCK`` frames a block): the per-track
  arithmetic over the staged slots only equals ``mix_per_track_reference``
  bit for bit, and a (block, track) that stages nothing is silent there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_auto_kernel import _auto_session
from tests.test_torch_interp import POLY
from tests.test_torch_mix_plan import CASES, carve_case, dense_session
from whitebox_tpu_torch.ops import automation, mix_cuda, mix_plan
from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline import oversample
from whitebox_tpu_torch.timeline.carve import carve_session

BLOCK = mix_plan.FRAMES_PER_BLOCK


def renderer(name, tile=None, channels=2):
    c = carve_case(name)
    table, pool = c.table, c.pool
    if channels != 2:
        table, pool = carve_session(c.s, c.rate, buffer_size=512, slow_emit="runs",
                                    out_channels=channels)
    return mix_cuda.CudaMixRenderer(table, pool, c.s, device="cpu", tile=tile or c.tile,
                                    channels=channels)


def poly_renderer():
    """Twelve short clips at distinct speeds on one track, over a 4x
    oversampled pool: six taps, and a (tile, track) cell of more than 8
    slots, which only the 16-slot plan of the oversampled form holds."""
    s = from_reference(dense_session())
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
    t2, p2 = oversample.oversample_slow_rows(table, pool)
    plan = mix_plan.build_plan(t2, p2, s, tile=mix_plan.DEFAULT_TILE, max_slots=16)
    return mix_cuda.CudaMixRenderer(t2, p2, s, device="cpu", plan=plan, interp=POLY)


def staged_mix(r, block=BLOCK, pool=None):
    """The staged walk in plain PyTorch -> ``[C, n_tiles*tile]``: per (tile,
    block) an accumulator from +0.0 that takes only the block's kept slots,
    in list order; each slot's ``((v*gain)*env)*g`` is ``mix_cuda``'s own."""
    p, tables = r.plan, r.tables
    pool = r.pool_device if pool is None else pool
    nt, T, K = p.ms.shape
    use = [0] * T if r.auto is None else r.auto["use"].tolist()
    g = torch.arange(nt, dtype=torch.int64)[:, None] * p.tile + torch.arange(p.tile, dtype=torch.int64)
    contrib = []
    for t in range(T):
        scaled, mask = mix_cuda._slot_samples(pool, tables, t, p.tile, r.interp)
        tg = (mix_cuda.auto_gains(r.auto, t, g, p.channels)[:, None] if use[t]
              else tables["track_gain"][t][:, None])
        contrib.append(torch.where(mask[:, :, None, :], scaled * tg, 0.0))  # [nt, K, C, tile]
    out = torch.zeros((nt, p.channels, p.tile), dtype=torch.float32)
    for ti, blocks in enumerate(mix_plan.block_slot_lists(p, block)):
        for b, kept in enumerate(blocks):
            b0, b1 = b * block, min((b + 1) * block, p.tile)
            acc = torch.zeros((p.channels, b1 - b0), dtype=torch.float32)
            for slot in kept.tolist():
                acc += contrib[slot // K][ti, slot % K, :, b0:b1]
            out[ti, :, b0:b1] = acc
    out = torch.where(out > 1.0, 1.0, out)
    out = torch.where(out < -1.0, -1.0, out)
    return out.permute(1, 0, 2).reshape(p.channels, nt * p.tile)


def reference(r, pool=None):
    p = r.plan
    args = (r.pool_device if pool is None else pool, r.tables)
    if r.auto is not None:
        return mix_cuda.mix_auto_reference(*args, r.auto, p.n_tiles, p.tile, p.channels, interp=r.interp)
    return mix_cuda.mix_reference(*args, p.n_tiles, p.tile, p.channels, interp=r.interp)


def assert_same_bits(a: torch.Tensor, b: torch.Tensor):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def test_block_size_is_the_kernels():
    src = (Path(mix_plan.__file__).parent.parent / "csrc" / "mix_kernel.cu").read_text()
    assert int(re.search(r"constexpr int kFramesPerBlock = (\d+);", src).group(1)) == BLOCK
    group = int(re.search(r"constexpr int kFrameGroup = (\d+);", src).group(1))
    assert "kPerTrackFrames = kFramesPerBlock * kFrameGroup" in src
    assert BLOCK * group == mix_plan.PER_TRACK_FRAMES_PER_BLOCK


@pytest.mark.parametrize("block", [128, BLOCK])
@pytest.mark.parametrize("name", CASES)
def test_kept_lists_hold_the_covering_slots_in_order(name, block):
    p = renderer(name).plan
    nt, T, K = p.ms.shape
    ms, me = p.ms.reshape(nt, T * K), p.me.reshape(nt, T * K)
    lists = mix_plan.block_slot_lists(p, block)
    assert len(lists) == nt and all(len(b) == -(-p.tile // block) for b in lists)
    frames = np.arange(p.tile)
    kept_any = 0
    for ti, blocks in enumerate(lists):
        covers = (frames >= ms[ti][:, None]) & (frames < me[ti][:, None])  # [T*K, tile]
        for b, kept in enumerate(blocks):
            assert (np.diff(kept) > 0).all()  # ascending raw index == (t, k) order
            want = np.nonzero(covers[:, b * block:(b + 1) * block].any(axis=1))[0]
            np.testing.assert_array_equal(kept, want)
            assert (me[ti][kept] > ms[ti][kept]).all()
            kept_any += len(kept)
    assert kept_any > 0


@pytest.mark.parametrize("name", CASES)
def test_staged_walk_equals_plain_mix(name):
    r = renderer(name)
    assert_same_bits(staged_mix(r), reference(r))


@pytest.mark.parametrize("name", ["fades", "mixed_speeds"])
def test_staged_walk_at_tile_1024_and_block_128(name):
    r = renderer(name, tile=1024)
    assert_same_bits(staged_mix(r, block=128), reference(r))


def test_staged_walk_with_sixteen_poly_slots():
    r = poly_renderer()
    p = r.plan
    assert p.max_slots > 8 and ((p.is_slow == 1) & (p.me > p.ms)).any()
    assert_same_bits(staged_mix(r), reference(r))


def test_staged_walk_with_a_ragged_last_block():
    # 1152 = 4.5 blocks: the last block of every tile holds 128 frames
    r = renderer("fades_resampled", tile=1152)
    mask = mix_plan.block_slot_mask(r.plan)
    assert mask.shape[1] == 5 and mask[:, 4].any()
    assert_same_bits(staged_mix(r), reference(r))


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_staged_walk_for_one_two_and_three_channels(channels):
    r = renderer("mixed_speeds", channels=channels)
    out = staged_mix(r)
    assert out.shape[0] == channels and float(out.abs().max()) > 0.01
    assert_same_bits(out, reference(r))


@pytest.mark.parametrize("value", [-0.0, float("nan"), float("inf"), float("-inf")],
                         ids=["negative_zero", "nan", "inf", "negative_inf"])
def test_special_samples_enter_only_where_their_slot_covers(value):
    # a stretch of the first active slot's source becomes `value`; frames the
    # slot does not cover must not see it, frames it covers must
    r = renderer("fades")
    p = r.plan
    ti, t, k = np.argwhere(p.me > p.ms)[0]
    pool = r.pool_device.clone()
    start = int(p.src_start[ti, t, k, 0]) + int(p.ms[ti, t, k])
    pool[start:start + 64] = value
    got, ref = staged_mix(r, pool=pool), reference(r, pool=pool)
    assert_same_bits(got, ref)
    clean = reference(r)
    touched = (got.numpy().view(np.int32) != clean.numpy().view(np.int32)).any(axis=0)
    lo = ti * p.tile + int(p.ms[ti, t, k])
    # a sum that starts at +0.0 and only grows by adds never reads -0.0
    assert not (got.numpy().view(np.int32) == np.int32(-2**31)).any()
    if value != 0.0:
        assert touched[lo:lo + 64].any()
        assert np.isfinite(got[:, ~torch.from_numpy(touched)].numpy()).all()


def test_a_block_no_slot_covers_stays_silent():
    r = renderer("fast")
    p = r.plan
    empty = ~mix_plan.block_slot_mask(p).any(axis=2)  # [n_tiles, n_blocks]
    assert empty.any() and not empty.all()
    out = staged_mix(r).reshape(p.channels, p.n_tiles, -1, BLOCK)
    assert not out[:, torch.from_numpy(empty)].any()
    assert_same_bits(staged_mix(r), reference(r))


def test_mask_counts_what_the_walk_shrank_to():
    p = renderer("mixed_speeds").plan
    mask = mix_plan.block_slot_mask(p)
    raw = p.num_tracks * p.max_slots
    assert mask.shape == (p.n_tiles, p.tile // BLOCK, raw)
    per_block = mask.sum(axis=2)
    assert 0 < per_block.mean() < raw and per_block.max() <= int((p.me > p.ms).reshape(p.n_tiles, -1).sum(1).max())
    with pytest.raises(ValueError):
        mix_plan.block_slot_mask(p, 0)


# ---------------------------------------------------------------- lanes


def auto_renderer(tile=2048, **kw):
    s = from_reference(_auto_session(**kw))
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
    return mix_cuda.CudaMixRenderer(table, pool, s, device="cpu", tile=tile,
                                    auto_tables=prepare_automation_tables_host(s, 48000.0))


@pytest.mark.parametrize("kw", [{}, {"curves": True}, {"seed": 5, "fades": True}],
                         ids=["linear", "curves", "fades"])
def test_staged_walk_with_lanes_equals_plain_mix(kw):
    r = auto_renderer(**kw)
    assert int(r.auto["use"].sum()) > 0
    assert_same_bits(staged_mix(r), reference(r))


def picked_segment(xs: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The segment the lane sweep ends on at frames ``g``: the last i in
    0..P-2 with g >= xs[i], -1 for none (``eval_lanes`` keeps ys[0] there)."""
    hit = g[:, None] >= xs[None, :-1].astype(np.int64)
    return np.where(hit, np.arange(xs.shape[0] - 1), -1).max(axis=1, initial=-1)


def negative_first_breakpoint_lane():
    """Lane rows whose first breakpoint lies before frame 0 (a point at a
    negative beat), the ``sub_wrap`` case, one of them unsorted."""
    sent = int(automation._SENTINEL)
    return np.array([[-5000, 300, 1500, sent, sent],
                     [-(1 << 30), 10, 11, 4000, sent],
                     [-7, 2600, 900, 5000, sent],  # out of order: the sweep's last hit still wins
                     [sent, sent, sent, sent, sent]], dtype=np.int32)


@pytest.mark.parametrize("source", ["session_curves", "negative_first_breakpoint"])
def test_lane_segment_range_brackets_the_picked_segment(source):
    if source == "session_curves":
        r = auto_renderer(tile=1024, curves=True)
        rows = np.concatenate([r.auto["vxs"].numpy(), r.auto["pxs"].numpy()])
        plan = r.plan
    else:
        rows = negative_first_breakpoint_lane()
        plan = renderer("fast").plan
    g0, g1 = mix_plan.block_frame_range(plan)
    assert g0.shape == g1.shape == (plan.n_tiles, plan.tile // BLOCK)
    lo, hi = mix_plan.lane_segment_range(rows[:, None, None, :], g0, g1)  # [rows, n_tiles, n_blocks]
    assert lo.shape == (rows.shape[0],) + g0.shape and (lo <= hi).all() and lo.min() >= -1
    narrow = 0
    for i, xs in enumerate(rows):
        for ti in range(min(plan.n_tiles, 8)):
            for b in range(g0.shape[1]):
                g = np.arange(g0[ti, b], g1[ti, b] + 1)
                seg = picked_segment(xs, g)
                assert (seg >= lo[i, ti, b]).all() and (seg <= hi[i, ti, b]).all()
                # the kernel's search: from lo, over lo+1..hi only
                found = np.full(g.shape, lo[i, ti, b])
                for j in range(lo[i, ti, b] + 1, hi[i, ti, b] + 1):
                    found = np.where(g >= int(xs[j]), j, found)
                np.testing.assert_array_equal(found, seg)
                narrow += lo[i, ti, b] == hi[i, ti, b]
    assert narrow > 0  # most blocks touch one segment: no search at all


def test_eval_lanes_takes_the_bracketed_segment():
    # the value eval_lanes gives equals the one segment's own curve, for a
    # lane with a negative first breakpoint
    xs = torch.tensor([-5000, 300, 1500, int(automation._SENTINEL)], dtype=torch.int32)
    lane = {"xs": xs, "ys": torch.tensor([0.2, 0.9, 0.4, 0.4]),
            "cv": torch.tensor([1, 2, 1, 1], dtype=torch.int32), "tn": torch.tensor([0.0, 1.5, 0.0, 0.0])}
    g = torch.arange(0, 2048, dtype=torch.int64)
    val = automation.eval_lanes(lane, g)
    seg = picked_segment(xs.numpy(), g.numpy())
    lo, hi = mix_plan.lane_segment_range(xs.numpy(), 0, 2047)
    assert (lo, hi) == (0, 2) and seg.min() == 0 and seg.max() == 2
    for i in range(3):
        only = {k: v[i:i + 2] for k, v in lane.items()}
        only["xs"] = torch.stack([xs[i], xs[i + 1]])
        sel = torch.from_numpy(seg == i)
        assert_same_bits(automation.eval_lanes(only, g)[sel], val[sel])


def test_a_held_lane_has_one_value_over_its_block():
    # where the model says a lane is held, every frame of the block
    # evaluates to the bits of the block's first frame; elsewhere a lane
    # with a ramp is not held
    r = auto_renderer(tile=1024, curves=True)
    plan = r.plan
    g0, g1 = mix_plan.block_frame_range(plan)
    held_blocks = ramp_blocks = 0
    for lane in ("v", "p"):
        tabs = {k: r.auto[lane + k] for k in ("xs", "ys", "cv", "tn")}
        xs = tabs["xs"].numpy()
        lo, hi = mix_plan.lane_segment_range(xs[:, None, None, :], g0, g1)
        held = mix_plan.lane_held(xs[:, None, None, :], lo, hi)  # [T, n_tiles, n_blocks]
        assert held.shape == lo.shape
        for t in range(xs.shape[0]):
            row = {k: v[t] for k, v in tabs.items()}
            for ti in range(plan.n_tiles):
                g = torch.arange(ti * plan.tile, (ti + 1) * plan.tile, dtype=torch.int64)
                val = automation.eval_lanes(row, g).reshape(-1, BLOCK).numpy().view(np.int32)
                same = (val == val[:, :1]).all(axis=1)
                assert same[held[t, ti]].all()
                held_blocks += int(held[t, ti].sum())
                ramp_blocks += int((~same).sum())
    assert held_blocks > 0 and ramp_blocks > 0
    # a row of sentinels only (a track without that lane) is held everywhere
    none = np.full((1, 4), mix_plan.LANE_SENTINEL, dtype=np.int32)
    lo, hi = mix_plan.lane_segment_range(none, 0, 255)
    assert lo[0] == hi[0] == -1 and mix_plan.lane_held(none, lo, hi)[0]
    assert mix_plan.LANE_SENTINEL == int(automation._SENTINEL)


# ---------------------------------------------------------------- per track (K4)


def staged_per_track_mix(r):
    """K4's staging in plain PyTorch -> ``[T, C, n_tiles*tile]``: per (tile,
    block, track) an accumulator from +0.0 that takes only the slots
    ``per_track_block_slots`` stages, in slot order; zeros where it stages
    none."""
    p, tables = r.plan, r.tables
    nt, T, K = p.ms.shape
    block = mix_plan.PER_TRACK_FRAMES_PER_BLOCK
    staged = mix_plan.per_track_block_slots(p)  # [nt, n_blocks, T, K]
    out = torch.zeros((T, p.channels, nt, p.tile), dtype=torch.float32)
    for t in range(T):
        scaled, mask = mix_cuda._slot_samples(r.pool_device, tables, t, p.tile, r.interp)
        contrib = torch.where(mask[:, :, None, :], scaled, 0.0)  # [nt, K, C, tile]
        for ti in range(nt):
            for b in range(staged.shape[1]):
                b0, b1 = b * block, min((b + 1) * block, p.tile)
                acc = torch.zeros((p.channels, b1 - b0), dtype=torch.float32)
                for k in np.nonzero(staged[ti, b, t])[0].tolist():
                    acc += contrib[ti, k, :, b0:b1]
                out[t, :, ti, b0:b1] = acc
    return out.reshape(T, p.channels, nt * p.tile)


def per_track_reference(r):
    p = r.plan
    return mix_cuda.mix_per_track_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels,
                                            interp=r.interp)


@pytest.mark.parametrize("case", ["fast", "fades", "mixed_speeds", "ragged_tile_1152",
                                  "three_channels", "sixteen_poly_slots"])
def test_per_track_staging_equals_plain_per_track_mix(case):
    r = {"ragged_tile_1152": lambda: renderer("fades_resampled", tile=1152),
         "three_channels": lambda: renderer("mixed_speeds", channels=3),
         "sixteen_poly_slots": poly_renderer}.get(case, lambda: renderer(case))()
    got, want = staged_per_track_mix(r), per_track_reference(r)
    assert float(want.abs().max()) > 0.01
    assert_same_bits(got, want)


def test_per_track_blocks_that_stage_nothing_are_silent():
    r = renderer("fast")
    p = r.plan
    block = mix_plan.PER_TRACK_FRAMES_PER_BLOCK
    empty = ~mix_plan.per_track_block_slots(p).any(axis=3)  # [nt, n_blocks, T]
    assert empty.any() and not empty.all()
    want = per_track_reference(r).reshape(p.num_tracks, p.channels, p.n_tiles, -1)
    for ti, b, t in zip(*np.nonzero(empty)):
        assert not want[t, :, ti, b * block:(b + 1) * block].any()
