"""Sample pool: all session audio flattened into one device buffer.

The reference streams per-clip from per-sample heap buffers; on TPU we
concatenate every (sample, channel) into a single 1-D f32 HBM array in the
*unclamped-normalized* representation (see core.formats), padded per channel
so interpolating reads past the end are safe (mirrors sample.h:19's padding).

``channel_base[sample_id, out_channel]`` resolves the reference's channel
wraparound (track.cpp: ``c = i % sample->channels``) into a flat pool offset
at carve time, so kernels do one add per access.
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

#: pools keyed by (id(session), edit_stamp, out_channels, pad, align) —
#: the concat of every asset's normalized channels is pure memcpy cost
#: repeated per render between edits. Safe to share: nothing in the repo
#: writes pool.data in place (extensions concatenate into fresh arrays),
#: and Sample buffers are immutable once registered (RecordingTake grows
#: a private buffer and registers a NEW asset on finalize). Same
#: invalidation signal the live preview trusts (session.edit_stamp).
_POOL_CACHE: dict = {}
_POOL_CACHE_MAX = 4


def build_sample_pool(session: Session, out_channels: int = 2, pad: int = SAMPLE_PADDING, lane_align: int = 128, _stamp: int | None = None) -> SamplePool:
    """Collect every asset referenced by an audio clip into one pool.

    Channels are aligned to ``lane_align`` so per-channel bases sit on TPU
    lane boundaries, and the whole pool carries leading/trailing zero guard
    bands sized for the Pallas kernel's fixed windows (bases are pre-offset
    by the lead guard). Cached by edit stamp (see ``_POOL_CACHE``);
    ``_stamp`` lets carve_session share one stamp computation across the
    pool and flatten caches (it IS session.edit_stamp() when given). A
    miss flattens inside the span ``wb.pool.flatten``; a hit opens none.
    """
    key = (id(session), _stamp if _stamp is not None else session.edit_stamp(),
           out_channels, pad, lane_align)
    hit = _POOL_CACHE.get(key)
    if hit is not None:
        return hit
    from whitebox_tpu_torch.render.metrics import span  # render imports this module

    with span("wb.pool.flatten"):
        assets = []
        seen = set()
        for track in session.tracks:
            for clip in track.clips:
                if clip.is_audio() and clip.audio is not None and clip.audio.asset is not None:
                    a = clip.audio.asset
                    if id(a) not in seen:
                        seen.add(id(a))
                        assets.append(a)

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
    _POOL_CACHE[key] = pool
    while len(_POOL_CACHE) > _POOL_CACHE_MAX:
        _POOL_CACHE.pop(next(iter(_POOL_CACHE)))
    return pool
