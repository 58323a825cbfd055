"""Native carve front-end — flattens the session's clip lists into column
arrays and drives csrc/host/wb_carve.cpp (the C++ port of the per-track block
walk in timeline/carve.py).

The C++ walk is bit-parity-contracted against the Python implementation
(fuzzed column-by-column in tests/test_carve_native.py); this module only
prepares inputs and re-assembles outputs, so the Python carve remains the
single source of truth for semantics. Falls back (returns None) when the
native host library is unavailable (no ``g++``; ``io/native.py``).
"""

from __future__ import annotations

import numpy as np

from collections import OrderedDict

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.io import native
from whitebox_tpu_torch.timeline.pool import SamplePool

#: flattened clip columns keyed by (id(session), edit_stamp, pool sid
#: mapping) — the per-clip Python loop below IS the host carve cost at
#: 128-track scale (~4900 clips x 14 appends), and between edits it
#: recomputes byte-identical arrays every render. The reference engine
#: never re-walks the session either: its carve state lives across blocks
#: and Track::internal_state_changed invalidates it (track.cpp:289-345);
#: edit_stamp() is this build's version of that invalidation signal (the
#: same one render.preview trusts for live re-carve).
_FLATTEN_CACHE: OrderedDict = OrderedDict()
_FLATTEN_CACHE_MAX = 8


def _flatten_clips(session, pool: SamplePool, _stamp: int | None = None):
    """Content-only flatten of all tracks' clips into column arrays.

    Returns (cols14, allid, clip_begin) — cols14 is the 14-tuple
    (mt, xt, so, cs, fs, fe, cnt, sr, gn, md, cid, sid, cl, sk); allid
    holds every clip's id (incl. non-audio, for the find_next_clip walk);
    or None to fall back to the Python walk. Raises the overlap
    ValueError exactly like carve._carve_track_audio. Pure function of
    session content + the pool's asset->sid mapping, so results cache by
    edit stamp."""
    from whitebox_tpu_torch.session.clip import ClipType

    index_of = pool.index_of
    stamp = _stamp if _stamp is not None else session.edit_stamp()
    key = (id(session), stamp,
           hash(tuple(index_of.values())), hash(tuple(index_of.keys())))
    hit = _FLATTEN_CACHE.get(key)
    if hit is not None:
        _FLATTEN_CACHE.move_to_end(key)
        return hit
    tracks = session.tracks
    # column collection runs through Python lists: list.append is ~10x a
    # numpy scalar store, and this flatten loop WAS the host carve cost at
    # 128-track scale (it outweighs the C++ walk itself) — hence the cache
    mt_l: list = []
    allid_l: list = []
    xt_l: list = []
    so_l: list = []
    cs_l: list = []
    fs_l: list = []
    fe_l: list = []
    cnt_l: list = []
    sr_l: list = []
    gn_l: list = []
    md_l: list = []
    cid_l: list = []
    sid_l: list = []
    cl_l: list = []
    sk_l: list = []
    clip_begin = np.zeros(len(tracks) + 1, np.int64)

    _AUDIO = ClipType.AUDIO
    _F32 = AudioFormat.F32
    i = 0
    for t, track in enumerate(tracks):
        clips = track.clips
        clip_begin[t] = i
        prev_max = None
        prev = None
        for c in clips:
            m, x = c.min_time, c.max_time
            if prev_max is not None and m < prev_max:
                # identical message to carve._carve_track_audio
                raise ValueError(
                    f"track {track.name!r}: overlapping clips [{prev.min_time},{prev.max_time}) and "
                    f"[{m},{x}) — use Session.delete_region/add APIs"
                )
            prev_max, prev = x, c
            mt_l.append(m)
            xt_l.append(x)
            allid_l.append(c.id)
            a = c.audio if c.type == _AUDIO else None
            if a is not None and a.asset is not None:
                smp = a.asset.sample
                _id = c.id
                if not (-2147483648 <= _id <= 2147483647):
                    # stale/INVALID ids (edit-API bypass): let the Python
                    # walk handle it and surface its exact errors
                    return None
                sk_l.append(0)
                cid_l.append(_id)
                so_l.append(c.start_offset)
                cs_l.append(a.speed)
                fs_l.append(a.fade_start)
                fe_l.append(a.fade_end)
                cnt_l.append(smp.count)
                sr_l.append(smp.sample_rate)
                gn_l.append(a.gain)
                md_l.append(int(a.mode))
                sid_l.append(index_of[id(a.asset)])
                cl_l.append(smp.format != _F32)
            else:
                sk_l.append(1)
                cid_l.append(0)
                so_l.append(0.0)
                cs_l.append(1.0)
                fs_l.append(0.0)
                fe_l.append(0.0)
                cnt_l.append(0.0)
                sr_l.append(0.0)
                gn_l.append(0.0)
                md_l.append(0)
                sid_l.append(0)
                cl_l.append(False)
            i += 1
    clip_begin[len(tracks)] = i

    mt = np.asarray(mt_l, np.float64)
    xt = np.asarray(xt_l, np.float64)
    so = np.asarray(so_l, np.float64)
    cs = np.asarray(cs_l, np.float64)
    fs = np.asarray(fs_l, np.float64)
    fe = np.asarray(fe_l, np.float64)
    cnt = np.asarray(cnt_l, np.float64)
    sr = np.asarray(sr_l, np.float64)
    gn = np.asarray(gn_l, np.float32)
    md = np.asarray(md_l, np.int32)
    cid = np.asarray(cid_l, np.int32)
    sid = np.asarray(sid_l, np.int32)
    cl = np.asarray(cl_l, np.uint8)
    sk = np.asarray(sk_l, np.uint8)

    out = ((mt, xt, so, cs, fs, fe, cnt, sr, gn, md, cid, sid, cl, sk),
           np.asarray(allid_l, np.int64), clip_begin)
    _FLATTEN_CACHE[key] = out
    while len(_FLATTEN_CACHE) > _FLATTEN_CACHE_MAX:
        _FLATTEN_CACHE.popitem(last=False)
    return out


def carve_audio_tracks(session, P: np.ndarray, S: np.ndarray, num_blocks: int,
                       buffer_size: int, sample_rate: float, beat_duration: float,
                       pool: SamplePool, slow_emit: str, transport=None,
                       _stamp: int | None = None):
    """Carve all tracks' audio clips natively.

    Returns (fast_arrays, fast_flags, clamp_flags, slow_arrays) matching
    carve.carve_session's internal assembly layout (each ``*_arrays`` is the
    13-column tuple, or None when empty), or None to fall back to Python.

    ``transport`` (BlockTransport) supplies the beat->sample conversions:
    every per-clip event position is precomputed HERE with the exact
    Python-walk expressions (``beat_to_samples`` unmapped, the TempoMap
    closed-form integrals mapped), vectorized over all clips, so the C++
    walk is pure sample-domain arithmetic and serves tempo-mapped sessions
    too (they used to force the Python walk — config 7 was carve-bound).

    The clip flatten is cached by ``session.edit_stamp()`` (see
    ``_flatten_clips``); everything downstream — the start-clip walk, the
    event-position vector math, the C++ walk itself — runs per call.

    Raises the same overlapping-clips ValueError as the Python walk.
    """
    if not native.has_carve():
        return None

    fl = _flatten_clips(session, pool, _stamp=_stamp)
    if fl is None:
        return None
    (mt, xt, so, cs, fs, fe, cnt, sr, gn, md, cid, sid, cl, sk), allid, clip_begin = fl

    tracks = session.tracks
    p0 = float(P[0])
    ci0 = np.full(len(tracks), -1, np.int64)
    # find_next_clip(P[0]) (track.cpp:182 clamp-to-last semantics)
    for t in range(len(tracks)):
        b, e = int(clip_begin[t]), int(clip_begin[t + 1])
        if e > b and xt[e - 1] >= p0:
            j = min(int(np.searchsorted(xt[b:e], p0, side="right")), e - b - 1)
            start_id = int(allid[b + j])
            if not (0 <= start_id < e - b):
                return None  # stale ids: let the Python walk surface it
            ci0[t] = start_id

    # ---- per-clip event positions, vectorized with the Python walk's
    #      exact expressions (carve._carve_track_audio lines ~135-185) ----
    mapped = bool(transport is not None and transport.mapped)
    side = "right" if mapped else "left"
    ka = np.searchsorted(P[1:], mt, side=side).astype(np.int64)
    ke = np.searchsorted(P[1:], xt, side=side).astype(np.int64)
    kac = np.minimum(ka, max(num_blocks - 1, 0))
    kec = np.minimum(ke, max(num_blocks - 1, 0))
    if mapped:
        tm = transport.tempo_map
        _sec = lambda b: np.asarray(tm.beats_to_seconds(b), np.float64)

        def dvec(a, b):  # TempoMap.delta_samples, elementwise
            return (_sec(b) - _sec(a)) * sample_rate
    else:
        from whitebox_tpu_torch.core.math import beat_to_samples

        def dvec(a, b):  # the reference's two-rounding beat_to_samples
            return np.asarray(beat_to_samples(
                np.asarray(b, np.float64) - np.asarray(a, np.float64),
                sample_rate, beat_duration), np.float64)

    ev_so_start = np.ascontiguousarray(S[kac] + dvec(P[kac], mt))
    ev_so_stop = np.ascontiguousarray(S[kec] + dvec(P[kec], xt))
    pos0 = np.ascontiguousarray(dvec(mt, p0))  # used only when mid-start
    elapsed0 = np.rint(pos0).astype(np.int64)
    clip_frames = np.rint(dvec(mt, xt)).astype(np.int64)
    if mapped:
        # fades are beat SPANS anchored at the clip edges — under a map
        # their frame lengths follow the local tempo there
        fin_frames = np.rint(dvec(mt, mt + fs)).astype(np.int64)
        fout_frames = np.rint(dvec(xt - fe, xt)).astype(np.int64)
    else:
        fin_frames = np.rint(dvec(0.0, fs)).astype(np.int64)
        fout_frames = np.rint(dvec(0.0, fe)).astype(np.int64)

    cols = dict(min_time=mt, max_time=xt, start_offset=so, clip_speed=cs,
                fade_start=fs, fade_end=fe, count=cnt, srate=sr, gain=gn,
                mode=md, clip_id=cid, sid=sid, clampf=cl, skip=sk,
                ev_ka=ka, ev_so_start=ev_so_start, ev_ke=ke,
                ev_so_stop=ev_so_stop, pos0=pos0, elapsed0=elapsed0,
                clip_frames=clip_frames, fin_frames=fin_frames,
                fout_frames=fout_frames)
    res = native.carve_audio(
        np.ascontiguousarray(P, np.float64), np.ascontiguousarray(S, np.float64),
        num_blocks, buffer_size, sample_rate, beat_duration,
        slow_emit == "runs", clip_begin, ci0, cols,
    )
    if res is None:
        return None
    fa, sa = res

    fast_arrays = None
    fast_flags = clamp_flags = None
    if fa[0].shape[0]:
        order = np.lexsort((fa[1], fa[0]))  # stable (track, dst) — rows.sort
        fa = tuple(col[order] for col in fa)
        fast_arrays = fa[0:8] + fa[10:15]
        fast_flags = fa[8].astype(bool)
        clamp_flags = fa[9].astype(bool)
    slow_arrays = sa if sa[0].shape[0] else None
    return fast_arrays, fast_flags, clamp_flags, slow_arrays
