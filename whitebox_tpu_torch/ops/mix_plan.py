"""Host plan for the GPU timeline mix: per-(tile, track) segment slots.

Counterpart of the plan half of ``whitebox_tpu/ops/mix_pallas.py:36-381``
(``PallasMixPlan``, ``SlotOverflow``, ``_merge_slow_runs_soa``, the tile
backoff and ``build_plan``). Pure NumPy, as there.

What differs from the TPU plan: a TPU DMA window had to start on a
1024-element boundary, so each slot carried an aligned row ``row_al`` plus a
residual shift ``delta`` (and ``sqhi`` bounded the in-window search). A GPU
thread reads the pool at any offset, so a slot carries one flat
``src_start[ti, t, k, ch]`` — the absolute pool index of the slot's anchor,
equal to ``row_al*128 + delta`` of the TPU plan:

- fast slot: ``channel_base + src_int + (tile_start - dst_start)``; the
  kernel reads ``pool[src_start + pos]`` at tile-relative frame ``pos``;
- slow slot: ``channel_base + src_i``; the kernel reads its taps around
  ``src_start + ix`` with ``ix`` from the slot's phase: ``ix, ix+1``
  (linear), ``ix-1 .. ix+2`` (Catmull-Rom) or ``ix-2 .. ix+3`` (six
  polynomial taps). The TPU plan rebased slow windows four samples early
  for those early taps (``mix_pallas.py:365-371``); ``row_al*128 + delta``
  is the same absolute index either way, so no rebase is needed here.

Slot splitting, slot order and every other field are the TPU plan's, so a
render from this plan is bit-identical to the JAX kernel's.

The module also models, in NumPy, how the CUDA summing kernel walks the
plan (``csrc/mix_kernel.cu``): :func:`block_slot_mask` and
:func:`block_slot_lists` give the compacted slot list each block of
``FRAMES_PER_BLOCK`` frames stages, :func:`lane_segment_range` and
:func:`lane_held` what it finds out once per block about a track's
automation lanes. The tests hold the model to the plain mix, and
``chip_smoke.py`` prints from it what the walk shrank to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.io import native
from whitebox_tpu_torch.ops.dsarith import split_f64
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import SegmentTable
from whitebox_tpu_torch.timeline.pool import MAX_TILE_FRAMES, SamplePool

DEFAULT_TILE = 32768  # largest tile; halved on slot overflow (build_plan tile=None)
MIN_TILE = 1024       # slot-overflow backoff floor
DEFAULT_K = 8
#: the lane tables' padding breakpoint (``ops/automation.py`` ``_SENTINEL``)
LANE_SENTINEL = 2**31 - 1
#: frames (and threads) of one block of the CUDA summing kernel
#: (``csrc/mix_kernel.cu`` ``kFramesPerBlock``): the unit of its staged walk
FRAMES_PER_BLOCK = 256

#: per-slot tables, each [n_tiles, T, K] (``src_start`` adds a channel axis)
SLOT_FIELDS = ("ms", "me", "gain", "clampf", "fin_start", "fin_inv", "fout_end",
               "fout_inv", "is_slow", "sfrac_hi", "sfrac_lo", "sspeed_hi", "sspeed_lo")


@dataclass
class MixPlan:
    """Host-precompiled per-(tile, track) slot metadata for the GPU mix."""

    src_start: np.ndarray  # [n_tiles, T, K, C] i32 absolute pool index of the slot anchor
    ms: np.ndarray  # [n_tiles, T, K] i32 mask start (tile-relative)
    me: np.ndarray  # [n_tiles, T, K] i32 mask end; me <= ms == inactive slot
    gain: np.ndarray  # [n_tiles, T, K] f32
    clampf: np.ndarray  # [n_tiles, T, K] i32 (1 = clamp normalize)
    fin_start: np.ndarray  # [n_tiles, T, K] i32 fade-in ramp start, tile-relative
    fin_inv: np.ndarray  # [n_tiles, T, K] f32
    fout_end: np.ndarray  # [n_tiles, T, K] i32 fade-out ramp end, tile-relative
    fout_inv: np.ndarray  # [n_tiles, T, K] f32
    # resampled (slow) slots: double-single phase at the slot's start (ms)
    is_slow: np.ndarray  # [n_tiles, T, K] i32
    sfrac_hi: np.ndarray  # [n_tiles, T, K] f32
    sfrac_lo: np.ndarray  # [n_tiles, T, K] f32
    sspeed_hi: np.ndarray  # [n_tiles, T, K] f32
    sspeed_lo: np.ndarray  # [n_tiles, T, K] f32
    track_gain: np.ndarray  # [T, C] f32 track volume * pan
    n_tiles: int
    tile: int
    num_tracks: int
    channels: int
    total_frames: int

    @property
    def max_slots(self) -> int:
        return self.ms.shape[2]


class SlotOverflow(ValueError):
    """A (tile, track) cell needs more than max_slots segment slots."""


def _merge_slow_runs_soa(table: SegmentTable):
    """Group consecutive per-block resampled rows into maximal runs.

    A copy of ``whitebox_tpu/ops/mix_pallas.py::_merge_slow_runs_soa``: a run
    re-bases the phase at each tile with the f64 closed form
    ``x0 + (g - dst0)*speed``; it breaks at any change of
    track/sample/speed/gain/fades, a dst gap, or a phase discontinuity.
    Returns a dict of per-run column arrays, or None without slow rows.
    """
    idx = np.nonzero(~table.fast)[0]
    if idx.size == 0:
        return None
    trk = table.track[idx]
    d0 = table.dst_start[idx].astype(np.int64)
    ln = table.length[idx].astype(np.int64)
    sid = table.sample_id[idx]
    x0 = table.src_int[idx].astype(np.float64) + table.src_frac[idx]
    sp = table.speed[idx]
    gn = table.gain[idx]
    fis = table.fin_start[idx]
    fii = table.fin_inv[idx]
    foe = table.fout_end[idx]
    foi = table.fout_inv[idx]

    brk = np.ones(idx.size, dtype=bool)
    if idx.size > 1:
        # phase-continuity tolerance scales with the f64 spacing at the
        # phase magnitude (per-block accumulation rounds a few ulps/block)
        x1 = x0[:-1] + ln[:-1] * sp[:-1]
        tol = np.maximum(16.0 * np.spacing(np.maximum(np.abs(x1), np.abs(x0[1:]))), 1e-9)
        cont = (
            (trk[1:] == trk[:-1]) & (sid[1:] == sid[:-1]) & (sp[1:] == sp[:-1])
            & (gn[1:] == gn[:-1]) & (fis[1:] == fis[:-1]) & (fii[1:] == fii[:-1])
            & (foe[1:] == foe[:-1]) & (foi[1:] == foi[:-1])
            & (d0[1:] == d0[:-1] + ln[:-1])
            & (np.abs(x1 - x0[1:]) < tol)
        )
        brk[1:] = ~cont
    starts = np.nonzero(brk)[0]
    ends = np.append(starts[1:], idx.size) - 1
    return {
        "trk": trk[starts].astype(np.int64), "d0": d0[starts],
        "end": d0[ends] + ln[ends], "sid": sid[starts].astype(np.int64),
        "x0": x0[starts], "speed": sp[starts], "gain": gn[starts],
        "fis": fis[starts].astype(np.int64), "fii": fii[starts],
        "foe": foe[starts].astype(np.int64), "foi": foi[starts],
        # original-table row bounds of each run: the slow rows in
        # [row_lo, row_hi] are exactly the run's rows (idx is sorted), so a
        # partial prerender maps uncovered runs back to the rows it leaves
        "row_lo": idx[starts], "row_hi": idx[ends],
    }


def _expand(reps: np.ndarray):
    """(parent, offset) for each of ``reps[i]`` repeats of item i."""
    tot = int(reps.sum())
    parent = np.repeat(np.arange(reps.shape[0]), reps)
    offs = np.arange(tot) - np.repeat(np.cumsum(reps) - reps, reps)
    return parent, offs


def _track_gain(session: Session, T: int, channels: int) -> np.ndarray:
    tg = np.zeros((T, channels), dtype=np.float32)
    for t, track in enumerate(session.tracks):
        vol = np.float32(0.0) if track.mute else track.volume_linear
        pan = track.pan_coeffs
        for ch in range(channels):
            tg[t, ch] = vol * np.float32(pan[ch % 2])
    return tg


def build_plan(
    table: SegmentTable,
    pool: SamplePool,
    session: Session,
    channels: int = 2,
    tile: int | None = None,
    max_slots: int = DEFAULT_K,
) -> MixPlan:
    """Slot tables for ``table``; ``tile=None`` starts at DEFAULT_TILE and
    halves on :class:`SlotOverflow` down to MIN_TILE (then raises)."""
    if tile is None:
        t = DEFAULT_TILE
        while True:
            try:
                return build_plan(table, pool, session, channels, t, max_slots)
            except SlotOverflow:
                if t // 2 < MIN_TILE:
                    raise
                t //= 2
    if tile > MAX_TILE_FRAMES or tile % 128:
        raise ValueError(f"tile must be a multiple of 128 and <= {MAX_TILE_FRAMES}")

    T = table.num_tracks
    n_tiles = -(-table.total_frames // tile)
    R = tile // 128
    # the TPU plan's source-span bound per slot (its DMA window held R+16
    # rows); kept so slow runs split into the same sub-slots, which keeps
    # the slot-local frame index j small and the render identical to the
    # JAX kernel's
    span_limit = (R + 16) * 128 - 1024 - 10

    fast_mask = table.fast if len(table) else np.zeros(0, dtype=bool)
    any_slow = bool((~fast_mask).any()) if len(table) else False

    # ---- slow slots: merged runs split per tile and per span limit ----
    slow = None
    if any_slow:
        soa = _merge_slow_runs_soa(table)
        trk_r, d0_r, end_r, sid_r = soa["trk"], soa["d0"], soa["end"], soa["sid"]
        x0_r, sp_r = soa["x0"], soa["speed"]
        # reverse rows (negative speed) span the same source width per
        # output frame; bound by |speed|
        maxlen_r = np.maximum(((span_limit - 2) / np.abs(sp_r)).astype(np.int64), 1)

        t0_r = d0_r // tile
        t1_r = (end_r - 1) // tile
        seg_parent, seg_off = _expand(t1_r - t0_r + 1)
        ti_s = t0_r[seg_parent] + seg_off
        gs_s = np.maximum(d0_r[seg_parent], ti_s * tile)
        ge_s = np.minimum(end_r[seg_parent], (ti_s + 1) * tile)
        nsub = -(-(ge_s - gs_s) // maxlen_r[seg_parent])
        sub_parent, sub_off = _expand(nsub)
        run_of = seg_parent[sub_parent]
        g = gs_s[sub_parent] + sub_off * maxlen_r[run_of]
        ge = np.minimum(g + maxlen_r[run_of], ge_s[sub_parent])
        ti_v = ti_s[sub_parent]

        x_at = x0_r[run_of] + (g - d0_r[run_of]) * sp_r[run_of]
        src_i = np.floor(x_at)
        slow = {
            "ti": ti_v, "trk": trk_r[run_of], "ms": (g - ti_v * tile).astype(np.int64),
            "me": (ge - ti_v * tile).astype(np.int64), "sid": sid_r[run_of],
            "src_i": src_i.astype(np.int64), "frac": x_at - src_i, "speed": sp_r[run_of],
            "gain": soa["gain"][run_of], "fis": soa["fis"][run_of], "fii": soa["fii"][run_of],
            "foe": soa["foe"][run_of], "foi": soa["foi"][run_of],
        }

    # ---- count slots per (tile, track) to size K ----
    counts = np.zeros((n_tiles, T), dtype=np.int64)
    if fast_mask.any():
        fr = np.nonzero(fast_mask)[0]
        t0s = table.dst_start[fr] // tile
        t1s = (table.dst_start[fr] + table.length[fr] - 1) // tile
        parent, offs = _expand((t1s - t0s + 1).astype(np.int64))
        np.add.at(counts, (t0s[parent] + offs, table.track[fr[parent]]), 1)
    if slow is not None:
        np.add.at(counts, (slow["ti"], slow["trk"]), 1)
    K = max(int(counts.max()) if counts.size else 1, 1)
    if K > max_slots:
        raise SlotOverflow(f"needs {K} slots per (tile, track), max {max_slots}; lower tile size")

    common = dict(track_gain=_track_gain(session, T, channels), n_tiles=n_tiles, tile=tile,
                  num_tracks=T, channels=channels, total_frames=table.total_frames)

    # ---- fast-only tables: the native row expansion (io/native.py) ----
    nat = None
    if len(table) and not any_slow:
        nat = native.build_mix_plan(table, pool, channels, tile, n_tiles, T, K)
    if nat is not None:
        row_al, delta, ms, me, gain, clampf, fin_start, fin_inv, fout_end, fout_inv = nat
        zl = np.zeros((n_tiles, T, K), dtype=np.int32)
        zf = np.zeros((n_tiles, T, K), dtype=np.float32)
        return MixPlan(
            src_start=_flat_start(row_al, delta), ms=ms, me=me, gain=gain, clampf=clampf,
            fin_start=fin_start, fin_inv=fin_inv, fout_end=fout_end, fout_inv=fout_inv,
            is_slow=zl, sfrac_hi=zf, sfrac_lo=zf.copy(),
            sspeed_hi=np.ones_like(zf), sspeed_lo=zf.copy(), **common,
        )

    src_start = np.zeros((n_tiles, T, K, channels), dtype=np.int32)
    ms = np.zeros((n_tiles, T, K), dtype=np.int32)
    me = np.zeros((n_tiles, T, K), dtype=np.int32)
    gain = np.zeros((n_tiles, T, K), dtype=np.float32)
    clampf = np.zeros((n_tiles, T, K), dtype=np.int32)
    fin_start = np.full((n_tiles, T, K), -(1 << 30), dtype=np.int32)
    fin_inv = np.ones((n_tiles, T, K), dtype=np.float32)
    fout_end = np.full((n_tiles, T, K), 1 << 30, dtype=np.int32)
    fout_inv = np.ones((n_tiles, T, K), dtype=np.float32)
    is_slow = np.zeros((n_tiles, T, K), dtype=np.int32)
    sfrac_hi = np.zeros((n_tiles, T, K), dtype=np.float32)
    sfrac_lo = np.zeros((n_tiles, T, K), dtype=np.float32)
    sspeed_hi = np.ones((n_tiles, T, K), dtype=np.float32)
    sspeed_lo = np.zeros((n_tiles, T, K), dtype=np.float32)
    cursor = np.zeros((n_tiles, T), dtype=np.int32)

    # fast rows with slow rows present: the reference's per-row loop
    # (mix_pallas.py:299-320), slots in row order
    for r in np.nonzero(fast_mask)[0]:
        trk = int(table.track[r])
        dst0 = int(table.dst_start[r])
        dend = dst0 + int(table.length[r])
        sid = int(table.sample_id[r])
        for ti in range(dst0 // tile, (dend - 1) // tile + 1):
            g0 = ti * tile
            k = int(cursor[ti, trk])
            cursor[ti, trk] += 1
            for ch in range(channels):
                src_start[ti, trk, k, ch] = (int(pool.channel_base[sid, ch])
                                             + int(table.src_int[r]) + g0 - dst0)
            ms[ti, trk, k] = max(dst0, g0) - g0
            me[ti, trk, k] = min(dend, g0 + tile) - g0
            gain[ti, trk, k] = table.gain[r]
            clampf[ti, trk, k] = 1 if table.clamp[r] else 0
            fin_start[ti, trk, k] = max(int(table.fin_start[r]) - g0, -(1 << 30))
            fin_inv[ti, trk, k] = table.fin_inv[r]
            fout_end[ti, trk, k] = min(int(table.fout_end[r]) - g0, 1 << 30)
            fout_inv[ti, trk, k] = table.fout_inv[r]

    if slow is not None:
        ti_v, trk_v = slow["ti"], slow["trk"]
        # slot index: fast cursor base + rank within each (tile, track)
        key = ti_v * T + trk_v
        order = np.argsort(key, kind="stable")
        ks = key[order]
        rank = np.empty(ks.shape[0], dtype=np.int64)
        rank[order] = np.arange(ks.shape[0]) - np.searchsorted(ks, ks, side="left")
        k_v = cursor[ti_v, trk_v].astype(np.int64) + rank

        g0_v = ti_v * tile
        fh, fl = split_f64(slow["frac"])
        sh, sl = split_f64(slow["speed"])
        idx = (ti_v, trk_v, k_v)
        ms[idx] = slow["ms"]
        me[idx] = slow["me"]
        gain[idx] = slow["gain"]
        clampf[idx] = 0  # the linear resample path never clamps
        is_slow[idx] = 1
        sfrac_hi[idx] = fh
        sfrac_lo[idx] = fl
        sspeed_hi[idx] = sh
        sspeed_lo[idx] = sl
        fin_start[idx] = np.maximum(slow["fis"] - g0_v, -(1 << 30))
        fin_inv[idx] = slow["fii"]
        fout_end[idx] = np.minimum(slow["foe"] - g0_v, 1 << 30)
        fout_inv[idx] = slow["foi"]
        # forward and reverse slots alike anchor at the phase origin: the
        # kernel reads src_start + ix with ix < 0 for reverse slots
        for ch in range(channels):
            src_start[ti_v, trk_v, k_v, ch] = (
                pool.channel_base[slow["sid"], ch].astype(np.int64) + slow["src_i"])

    return MixPlan(
        src_start=src_start, ms=ms, me=me, gain=gain, clampf=clampf,
        fin_start=fin_start, fin_inv=fin_inv, fout_end=fout_end, fout_inv=fout_inv,
        is_slow=is_slow, sfrac_hi=sfrac_hi, sfrac_lo=sfrac_lo,
        sspeed_hi=sspeed_hi, sspeed_lo=sspeed_lo, **common,
    )


def _flat_start(row_al: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """TPU window pair -> absolute pool index (``row_al*128 + delta``)."""
    return (row_al.astype(np.int64) * 128 + delta).astype(np.int32)


def plan_from_pallas(p) -> MixPlan:
    """The port's plan from a JAX ``PallasMixPlan`` (duck-typed on its
    NumPy fields; the JAX module is never imported). Lets both packages
    render from the identical plan."""
    return MixPlan(
        src_start=_flat_start(np.asarray(p.row_al), np.asarray(p.delta)),
        **{f: np.array(getattr(p, f)) for f in SLOT_FIELDS},
        track_gain=np.array(p.track_gain), n_tiles=int(p.n_tiles), tile=int(p.tile),
        num_tracks=int(p.num_tracks), channels=int(p.channels),
        total_frames=int(p.total_frames),
    )


#: the most taps and coefficients per tap a ``("poly", coeffs)`` table may
#: hold (the kernel takes the table by value in a fixed 8 x 8 argument)
MAX_POLY_TAPS = 8
MAX_POLY_COEFFS = 8


def interp_taps(interp) -> tuple[int, int]:
    """The tap offsets ``(lo, hi)`` around ``ix`` that a slow slot reads in
    interpolation mode ``interp``: ``"linear"`` (0, 1), ``"catmull"``
    (-1, 2), ``("poly", coeffs)`` with n taps ``(-(n//2 - 1), n//2)``.
    Raises ValueError for anything else (``mix_pallas.py:685-688``)."""
    if isinstance(interp, str):
        if interp == "linear":
            return 0, 1
        if interp == "catmull":
            return -1, 2
    elif isinstance(interp, tuple) and len(interp) == 2 and interp[0] == "poly":
        coeffs = interp[1]
        n = len(coeffs)
        widths = {len(r) for r in coeffs}
        if not 2 <= n <= MAX_POLY_TAPS or len(widths) != 1 or not 1 <= min(widths) <= MAX_POLY_COEFFS:
            raise ValueError(f"poly interp takes 2..{MAX_POLY_TAPS} taps of one width of "
                             f"1..{MAX_POLY_COEFFS} coefficients, got {n} taps of widths {sorted(widths)}")
        return -(n // 2 - 1), n // 2
    raise ValueError(f"mix interp must be linear, catmull, or ('poly', coeffs); got {interp!r}")


def check_pool_bounds(plan: MixPlan, pool_len: int, interp="linear") -> None:
    """Raise if an active slot could read outside ``[0, pool_len)``.

    The kernel reads the pool without clamping (the carve's guard bands
    keep every read in range); this host check turns a malformed plan into
    a ValueError instead of an illegal device address. Slow-slot bounds
    come from the f64 phase at the slot's ends, widened to the taps of
    ``interp`` (:func:`interp_taps`) and by one more sample either way for
    the double-single phase's rounding at an integer boundary.
    """
    tap_lo, tap_hi = interp_taps(interp)
    act = plan.me > plan.ms
    if not act.any():
        return
    ss = plan.src_start.astype(np.int64)[act]  # [n, C]
    ms = plan.ms[act].astype(np.int64)
    me = plan.me[act].astype(np.int64)
    slow = plan.is_slow[act] == 1
    frac = plan.sfrac_hi[act].astype(np.float64) + plan.sfrac_lo[act]
    speed = plan.sspeed_hi[act].astype(np.float64) + plan.sspeed_lo[act]
    x_end = frac + (me - ms - 1) * speed
    lo_off = np.where(slow, np.floor(np.minimum(frac, x_end)) + tap_lo - 1, ms).astype(np.int64)
    hi_off = np.where(slow, np.floor(np.maximum(frac, x_end)) + tap_hi + 1, me - 1).astype(np.int64)
    lo = (ss + lo_off[:, None]).min()
    hi = (ss + hi_off[:, None]).max()
    if lo < 0 or hi >= pool_len:
        raise ValueError(f"plan reads pool[{lo}..{hi}] outside [0, {pool_len})")


def block_slot_mask(plan: MixPlan, block: int = FRAMES_PER_BLOCK) -> np.ndarray:
    """Host model of the CUDA summing kernel's staged walk -> bool
    ``[n_tiles, n_blocks, T*K]``: which raw slots ``r = t*K + k`` of its
    tile a block of ``block`` frames keeps. A block covers the tile-relative
    frames ``[b0, b1)``, ``b0 = b*block``, ``b1 = min(b0 + block, tile)``; it
    keeps a slot iff the slot is active (``me > ms``) and ``[ms, me)`` meets
    ``[b0, b1)``. The kernel walks the kept slots in ascending ``r``, the
    ``(t, k)`` order of the sum, and never looks at the others."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    nt, T, K = plan.ms.shape
    ms = plan.ms.reshape(nt, 1, T * K)
    me = plan.me.reshape(nt, 1, T * K)
    b0 = np.arange(0, plan.tile, block, dtype=np.int64).reshape(1, -1, 1)
    b1 = np.minimum(b0 + block, plan.tile)
    return (me > ms) & (ms < b1) & (me > b0)


def block_slot_lists(plan: MixPlan, block: int = FRAMES_PER_BLOCK) -> list[list[np.ndarray]]:
    """The kept lists of :func:`block_slot_mask`: ``lists[ti][b]`` holds the
    raw slot indices ``r = t*K + k`` that block ``b`` of tile ``ti`` stages,
    in the order the kernel stages and adds them (ascending ``r``)."""
    mask = block_slot_mask(plan, block)
    return [[np.nonzero(row)[0] for row in tile_mask] for tile_mask in mask]


def lane_segment_range(xs: np.ndarray, g0, g1) -> tuple[np.ndarray, np.ndarray]:
    """Host model of the kernel's ``lane_range``: for lane rows ``xs``
    ``[..., P]`` (i32 breakpoints, sentinel-padded) and global frames ``g0 <=
    g1`` (broadcastable against ``xs[..., 0]``) -> ``(lo, hi)``, the last
    segment ``i`` in ``0..P-2`` with ``g0 >= xs[i]`` and with ``g1 >= xs[i]``
    (-1: none). The segment a frame ``g`` in ``[g0, g1]`` evaluates, the last
    ``i`` with ``g >= xs[i]``, lies in ``[lo, hi]`` whatever the order of the
    breakpoints: ``lo`` itself passes the test at ``g``, and nothing above
    ``hi`` passes it at ``g1``."""
    seg = xs[..., :-1].astype(np.int64)
    idx = np.arange(seg.shape[-1])

    def last(g):
        hit = np.asarray(g, dtype=np.int64)[..., None] >= seg
        return np.where(hit, idx, -1).max(axis=-1, initial=-1)

    return last(g0), last(g1)


def lane_held(xs: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host model of the kernel's ``lane_held``: True where a lane row holds
    one value over the whole block, i.e. its frames pick one segment (``lo ==
    hi``, from :func:`lane_segment_range`) that lies before the first point
    (-1) or after the last (the next breakpoint is the sentinel, which forces
    the ramp to 0). The automation kernel evaluates such a lane once per
    (block, track) instead of once per frame."""
    nxt = np.take_along_axis(np.broadcast_to(xs, lo.shape + xs.shape[-1:]),
                             np.clip(lo + 1, 0, xs.shape[-1] - 1)[..., None], axis=-1)[..., 0]
    return (lo == hi) & ((lo < 0) | (nxt == LANE_SENTINEL))


def block_frame_range(plan: MixPlan, block: int = FRAMES_PER_BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """First and last global frame of every (tile, block) -> two int64
    arrays ``[n_tiles, n_blocks]`` (the arguments of :func:`lane_segment_range`
    for one block)."""
    b0 = np.arange(0, plan.tile, block, dtype=np.int64)
    b1 = np.minimum(b0 + block, plan.tile)
    base = np.arange(plan.n_tiles, dtype=np.int64)[:, None] * plan.tile
    return base + b0, base + b1 - 1
