"""Sample pool: all session audio flattened into one device buffer.

The reference streams per-clip from per-sample heap buffers; on TPU we
concatenate every (sample, channel) into a single 1-D f32 HBM array in the
*unclamped-normalized* representation (see core.formats), padded per channel
so interpolating reads past the end are safe (mirrors sample.h:19's padding).

``channel_base[sample_id, out_channel]`` resolves the reference's channel
wraparound (track.cpp: ``c = i % sample->channels``) into a flat pool offset
at carve time, so kernels do one add per access.

The pool is a function of the referenced assets alone (which ``SampleAsset``
objects, their ``Sample`` objects and the layout arguments), so it is cached
on that asset set and survives every edit that keeps it: a fader, a gain or
a clip move re-carves against the same pool, as the reference engine keeps a
loaded sample across such edits. Clips reach the pool only through
``SamplePool.index_of``, so the order in which assets are first seen does
not matter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.session.sample import SAMPLE_PADDING, Sample
from whitebox_tpu_torch.session.session import Session


@dataclass
class SamplePool:
    data: np.ndarray  # 1-D f32, concatenated padded channels
    channel_base: np.ndarray  # [num_samples, max_out_channels] int32 flat offsets
    counts: np.ndarray  # [num_samples] int64 frame counts
    rates: np.ndarray  # [num_samples] f64 native sample rates
    index_of: dict  # id(SampleAsset) -> sample_id

    @property
    def num_samples(self) -> int:
        return self.counts.shape[0]


#: Guard bands so the Pallas mix kernel's fixed-size DMA windows
#: (tile_frames <= MAX_TILE_FRAMES) are always in-bounds without clamping.
MAX_TILE_FRAMES = 32768
# windows are (tile/128 + 16) rows of 128 plus the 1024-alignment slack
_GUARD = MAX_TILE_FRAMES + 16 * 128 + 256

#: pools keyed by the asset set they hold: ``(frozenset of (id(asset),
#: id(asset.sample)), out_channels, pad, lane_align)`` -> ``(pool, refs)``.
#: Nothing of the timeline enters the key (no clip positions, gains,
#: faders or edit stamp), so every edit that references the same assets
#: hits; a clip of an asset not yet pooled, an asset's last clip deleted or
#: an asset given another ``Sample`` misses and flattens anew. ``refs``
#: holds strong references to the assets and samples the pool was built
#: from, and a hit checks them by ``is``: a freed asset's id can never alias
#: a live one's. Safe to share across calls and sessions: nothing in the
#: repo writes pool.data in place (extensions concatenate into fresh
#: arrays), and Sample buffers are immutable once registered (RecordingTake
#: grows a private buffer and registers a NEW asset on finalize). FIFO.
_POOL_CACHE: dict = {}
_POOL_CACHE_MAX = 4
#: cache hits and misses of :func:`build_sample_pool` in this process; it
#: adds one to either per call and nothing else touches them (callers may
#: reset them to 0)
pool_cache_hits = 0
pool_cache_misses = 0


def build_sample_pool(session: Session, out_channels: int = 2, pad: int = SAMPLE_PADDING, lane_align: int = 128) -> SamplePool:
    """Collect every asset referenced by an audio clip into one pool.

    Channels are aligned to ``lane_align`` so per-channel bases sit on TPU
    lane boundaries, and the whole pool carries leading/trailing zero guard
    bands sized for the Pallas kernel's fixed windows (bases are pre-offset
    by the lead guard). Cached by the set of referenced assets and the
    layout arguments (see ``_POOL_CACHE``), so an edit that keeps the asset
    set returns the same ``SamplePool``. A miss flattens inside the span
    ``wb.pool.flatten``; a hit opens none. Counts each call in
    ``pool_cache_hits`` or ``pool_cache_misses``.
    """
    global pool_cache_hits, pool_cache_misses
    referenced: dict = {}  # id(asset) -> asset, in the order first seen
    for track in session.tracks:
        for clip in track.clips:
            if clip.is_audio() and clip.audio is not None and clip.audio.asset is not None:
                a = clip.audio.asset
                if id(a) not in referenced:
                    referenced[id(a)] = a
    key = (frozenset((i, id(a.sample)) for i, a in referenced.items()), out_channels, pad, lane_align)
    hit = _POOL_CACHE.get(key)
    if hit is not None:
        pool, refs = hit
        if all(referenced.get(id(a)) is a and a.sample is smp for a, smp in refs):
            pool_cache_hits += 1
            return pool
    pool_cache_misses += 1
    from whitebox_tpu_torch.render.metrics import span  # render imports this module

    with span("wb.pool.flatten"):
        assets = list(referenced.values())

        chunks: list[np.ndarray] = []
        channel_base = np.zeros((max(len(assets), 1), out_channels), dtype=np.int64)
        counts = np.zeros(max(len(assets), 1), dtype=np.int64)
        rates = np.full(max(len(assets), 1), 48000.0, dtype=np.float64)
        index_of: dict = {}

        chunks.append(np.zeros(_GUARD, dtype=np.float32))  # lead guard
        offset = _GUARD
        for sid, asset in enumerate(assets):
            sample: Sample = asset.sample
            index_of[id(asset)] = sid
            counts[sid] = sample.count
            rates[sid] = float(sample.sample_rate)
            stride = sample.count + pad
            stride += (-stride) % lane_align
            ch_offsets = []
            for c in range(sample.channels):
                buf = np.zeros(stride, dtype=np.float32)
                buf[: sample.count + pad] = sample.normalized_f32(c, pad)
                chunks.append(buf)
                ch_offsets.append(offset)
                offset += stride
            for oc in range(out_channels):
                channel_base[sid, oc] = ch_offsets[oc % sample.channels]

        chunks.append(np.zeros(_GUARD, dtype=np.float32))  # tail guard
        data = np.concatenate(chunks)
        if channel_base.max(initial=0) + (counts.max(initial=0) + pad) >= 2**31:
            raise ValueError("sample pool exceeds int32 addressing (>2^31 elements)")
        pool = SamplePool(
            data=data,
            channel_base=channel_base.astype(np.int32),
            counts=counts,
            rates=rates,
            index_of=index_of,
        )
    _POOL_CACHE[key] = (pool, tuple((a, a.sample) for a in assets))
    while len(_POOL_CACHE) > _POOL_CACHE_MAX:
        _POOL_CACHE.pop(next(iter(_POOL_CACHE)))
    return pool
