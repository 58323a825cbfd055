"""Sinc playback via pool oversampling.

Counterpart of ``whitebox_tpu/timeline/oversample.py``. Every sample that
a resampled row reads is upsampled once by an integer factor U with the
exact-phase rational sinc operator (``ops/resample.design_sinc_matrix``,
the later decimation's anti-alias cutoff folded in), and the rows are
rewritten to play the U-rate copy at U*speed through the mix kernel's
polynomial-tap slow slots (K2-poly, six LS-optimal taps). Reconstruction
error of the taps on a U-times-oversampled, band-limited signal is far
below that of the same taps at the source rate: sinc-class quality for the
price of six pool reads per frame. This is the form
``bounce(interpolation="sinc", prerender=False)`` renders, and the one the
residue of a partial prerender rides (``timeline/prerender.py``).

Semantics: fast (speed==1) rows are untouched, so bit parity holds.
Slow-row output is a high-quality extension (the reference has no sinc at
all, sampler.cpp:20-86). :func:`oversample_slow_rows` is host NumPy and a
copy; :func:`device_pool_cached` keeps the oversampled pool on the device
between renders.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace

import numpy as np
import torch

from whitebox_tpu_torch.ops.resample import design_poly_interp, design_sinc_matrix
from whitebox_tpu_torch.timeline.carve import SegmentTable
from whitebox_tpu_torch.timeline.pool import _GUARD, SamplePool

OVERSAMPLE_FACTOR = 4

#: device-resident oversampled pools, keyed by (length, sha1 of the pool's
#: bytes, device): a fingerprint shortcut could alias two pools and play
#: wrong audio. The same session's pool is byte-identical render to render,
#: so the upload of ~4x the session's samples happens once. Bounded FIFO.
_DEVICE_POOL_CACHE: dict = {}
_DEVICE_POOL_CACHE_MAX = 4


def device_pool_cached(pool: SamplePool, device: torch.device) -> torch.Tensor:
    """``pool.data`` as a 1-D f32 tensor on ``device``, cached across renders
    by content hash and device."""
    device = torch.device(device)
    key = (pool.data.shape[0], hashlib.sha1(pool.data.tobytes()).hexdigest(), str(device))
    hit = _DEVICE_POOL_CACHE.get(key)
    if hit is not None:
        return hit
    arr = torch.from_numpy(np.ascontiguousarray(pool.data, dtype=np.float32)).to(device)
    while len(_DEVICE_POOL_CACHE) >= _DEVICE_POOL_CACHE_MAX:
        _DEVICE_POOL_CACHE.pop(next(iter(_DEVICE_POOL_CACHE)))
    _DEVICE_POOL_CACHE[key] = arr
    return arr


def resolve_interpolation(table, pool, interpolation: str):
    """Shared dispatch for the render front ends: map a user-facing
    interpolation mode onto (table, pool, kernel-interp).

    "linear" and "catmull" pass through; "sinc" rewrites the table/pool via
    :func:`oversample_slow_rows` and selects the LS-optimal poly taps."""
    if interpolation == "linear":
        return table, pool, "linear"
    if interpolation == "catmull":
        return table, pool, "catmull" if not table.fast.all() else "linear"
    if interpolation == "sinc":
        if table.fast.all():
            return table, pool, "linear"
        table, pool = oversample_slow_rows(table, pool)
        return table, pool, ("poly", design_poly_interp(OVERSAMPLE_FACTOR))
    raise ValueError("interpolation must be 'linear', 'catmull', or 'sinc'")


def oversample_slow_rows(
    table: SegmentTable,
    pool: SamplePool,
    factor: int = OVERSAMPLE_FACTOR,
    taps: int = 32,
    atten_db: float = 90.0,
    rows: np.ndarray | None = None,
) -> tuple[SegmentTable, SamplePool]:
    """Append U-times sinc-upsampled copies of every sample referenced by a
    resampled row; rewrite those rows to the copies at U*speed.

    Returns (table', pool') — inputs are not mutated; row order and count
    are preserved. Fast rows keep their original sample ids (bit parity).
    Each needed sample is upsampled once with the anti-alias cutoff set by
    the fastest playback speed that reads it (slower clips of the same
    sample share the copy; their passband is narrowed by the same cutoff —
    documented trade for single-copy memory).

    ``rows``: restrict the rewrite to these row indices (partial-prerender
    residue: only the runs the exact polyphase path can't cover ride the
    oversampled fallback; see plan_prerender(partial=True)).
    """
    slow = ~table.fast
    if rows is not None:
        m = np.zeros(slow.shape[0], dtype=bool)
        m[rows] = True
        slow &= m
    if not slow.any() or factor < 2:
        return table, pool

    U = int(factor)
    need_sids = np.unique(table.sample_id[slow])

    # fastest |speed| per sample -> folded decimation cutoff
    cutoffs = {}
    for sid in need_sids:
        m = slow & (table.sample_id == sid)
        smax = float(np.max(np.abs(table.speed[m])))
        cutoffs[int(sid)] = 0.91 * min(1.0, 1.0 / max(smax, 1e-9))

    # upsample each distinct physical channel buffer once
    data = pool.data
    chunks = [data]
    offset = data.shape[0]  # 128-aligned (guards + strides all are)
    new_base_of: dict[tuple[int, int], int] = {}  # (sid, old_base) -> new base
    new_rows = []  # per new sample: [out_channels] bases
    new_counts = []
    new_rates = []
    sid_map: dict[int, int] = {}
    next_sid = pool.num_samples
    # original rows may read up to SAMPLE_PADDING past the end; scaled by U
    # in the copy, plus catmull taps — zero-pad generously (still tiny)
    pad = U * 20 + taps

    for sid in need_sids:
        sid = int(sid)
        n = int(pool.counts[sid])
        up_count = U * (n - 1) + 1 if n > 0 else 0
        bases = pool.channel_base[sid]
        row = np.zeros(bases.shape[0], dtype=np.int64)
        for oc, base in enumerate(bases):
            key = (sid, int(base))
            if key not in new_base_of:
                src = data[int(base) : int(base) + n]
                if n > 0:
                    # host-side strided-view matmul (one BLAS sgemm) per
                    # buffer, as the JAX package does it: this is bounce
                    # preparation, and the rewritten table needs the copy's
                    # layout on the host anyway. Same operator as
                    # ops/resample's device path (design_sinc_matrix, P=1,
                    # Q=U).
                    M, _, _ = design_sinc_matrix(1, U, taps, atten_db,
                                                 cutoff=cutoffs[sid])
                    W = M.shape[1]
                    half = taps // 2
                    xp = np.pad(src.astype(np.float32), (half, W))
                    win = np.lib.stride_tricks.sliding_window_view(xp, W)[:n]
                    up = (win @ M.T).reshape(-1)[:up_count]
                else:
                    up = np.zeros(0, np.float32)
                stride = up_count + pad
                stride += (-stride) % 128
                buf = np.zeros(stride, dtype=np.float32)
                buf[:up_count] = up
                chunks.append(buf)
                new_base_of[key] = offset
                offset += stride
            row[oc] = new_base_of[key]
        sid_map[sid] = next_sid
        new_rows.append(row)
        new_counts.append(up_count)
        new_rates.append(float(pool.rates[sid]) * U)
        next_sid += 1

    chunks.append(np.zeros(_GUARD, dtype=np.float32))  # fresh tail guard
    data2 = np.concatenate(chunks)
    if offset + max(new_counts, default=0) + pad >= 2**31:
        raise ValueError("oversampled pool exceeds int32 addressing")

    channel_base2 = np.concatenate(
        [pool.channel_base.astype(np.int64), np.stack(new_rows)]).astype(np.int32)
    counts2 = np.concatenate([pool.counts, np.asarray(new_counts, np.int64)])
    rates2 = np.concatenate([pool.rates, np.asarray(new_rates, np.float64)])
    pool2 = SamplePool(data=data2, channel_base=channel_base2, counts=counts2,
                       rates=rates2, index_of=dict(pool.index_of))

    # rewrite slow rows: exact phase scaling x' = U*x, speed' = U*speed
    sid2 = table.sample_id.copy()
    src_int2 = table.src_int.astype(np.int64)
    frac2 = table.src_frac.copy()
    speed2 = table.speed.copy()
    for old_sid, new_sid in sid_map.items():
        m = slow & (table.sample_id == old_sid)
        uf = U * table.src_frac[m]
        add = np.floor(uf)
        sid2[m] = new_sid
        src_int2[m] = U * src_int2[m] + add.astype(np.int64)
        frac2[m] = uf - add
        speed2[m] = U * table.speed[m]
    table2 = replace(
        table, sample_id=sid2, src_int=src_int2.astype(np.int32),
        src_frac=frac2, speed=speed2,
    )
    return table2, pool2
