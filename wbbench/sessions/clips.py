"""The ``clips`` kind of session: a configuration and a seed -> a plain session description.

Tracks of audio clips at speed 1. The tiling follows
``render/demo.py::make_demo_session`` (clips of 0.5 to 1 asset lengths, 0.05
to 0.3 beat gaps, a random start offset in the first quarter of the asset,
per-clip gain, per-track volume and pan), rewritten here so that the
benchmark owns it. Each track draws its clips from its own
``assets_per_track`` assets, and keeps one wider gap (``break_beats``) after
a clip near the middle, so that an edit can move that clip by
``clip_move_beats`` without touching its neighbour (:class:`Edits`).

The description is plain data (NumPy arrays and floats): the reference
(``reference/clips.py``) reads it, and ``program/clips.py`` builds the
program's ``Session`` from it. Both sides get the same assets, so a raw
array is all they share. What every kind's description has, and the
harness reads: ``sample_rate``, ``buffer_size``, ``channels``, ``assets``
(``[channels, frames]`` f32 each), ``tracks`` (each with its resolved
``chain``) and ``master_chain``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from wbbench.lib import chains


@dataclass(frozen=True)
class TrackDesc:
    volume_db: float
    pan: float
    #: per clip, in timeline order: beats (min, max), source frame offset,
    #: asset index, gain, fade-in and fade-out spans in beats
    min_beat: np.ndarray
    max_beat: np.ndarray
    offset: np.ndarray
    asset: np.ndarray
    gain: np.ndarray
    fade_in: np.ndarray
    fade_out: np.ndarray
    #: the clip before the track's wide gap (the one a variant moves)
    movable: int
    #: the track's chain: a tuple of (effect type, parameters) (``lib/chains.py``)
    chain: tuple = ()


@dataclass(frozen=True)
class SessionDesc:
    sample_rate: int
    buffer_size: int
    channels: int
    bpm: float
    #: every asset, [channels, frames] float32, at ``sample_rate``
    assets: list
    tracks: list
    master_chain: tuple = ()

    @property
    def beat_duration(self) -> float:
        return 60.0 / self.bpm


@dataclass(frozen=True)
class Variant:
    """The base session with one edit on one track."""

    desc: SessionDesc
    track: int
    moved_clip: int
    move_beats: float


def _rngs(seed: int, n: int) -> list:
    """``n`` independent generators from ``seed`` (any whole number)."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(abs(int(seed))).spawn(n)]


def _assets(cfg: dict, rng) -> list:
    """``cfg['assets']`` assets of ``asset_seconds``: a sine of a log-uniform
    pitch at ``asset_amplitude`` plus noise; even ones stereo (the second
    channel at 0.7), odd ones mono. Drawn in a few bulk calls."""
    n, rate = int(cfg["assets"]), int(cfg["sample_rate"])
    frames = int(round(float(cfg["asset_seconds"]) * rate))
    amp = np.float32(cfg["asset_amplitude"])
    freqs = 55.0 * 2.0 ** rng.uniform(0.0, 5.0, n)
    phases = rng.uniform(0.0, 2.0 * np.pi, n)
    noise = rng.standard_normal((n, frames), dtype=np.float32) * np.float32(0.08) * amp
    t = np.arange(frames, dtype=np.float64) / rate
    out = []
    for i in range(n):
        base = (np.sin(2.0 * np.pi * freqs[i] * t + phases[i]).astype(np.float32) * amp + noise[i])
        data = np.stack([base, base * np.float32(0.7)]) if i % 2 == 0 else base[None, :]
        out.append(np.ascontiguousarray(data, dtype=np.float32))
    return out


def _track(cfg: dict, rng, t: int, n_frames: int, total_beats: float, bd: float) -> TrackDesc:
    per = int(cfg["assets_per_track"])
    own = np.arange(t * per, (t + 1) * per) % int(cfg["assets"])
    clip_beats = float(cfg["asset_seconds"]) / bd
    fade = float(cfg["fade_share"])
    volume_db = float(rng.uniform(-9.0, 0.0))
    pan = float(rng.uniform(-0.8, 0.8))
    break_at = float(rng.uniform(0.25, 0.75)) * total_beats
    cols = {k: [] for k in ("min_beat", "max_beat", "offset", "asset", "gain")}
    movable = -1
    pos = float(rng.uniform(0.0, 0.5))
    while pos < total_beats - 0.01:
        length = min(clip_beats * float(rng.uniform(0.5, 1.0)), total_beats - pos)
        cols["min_beat"].append(pos)
        cols["max_beat"].append(pos + length)
        cols["offset"].append(float(int(rng.integers(0, n_frames // 4))))
        cols["asset"].append(int(own[int(rng.integers(per))]))
        cols["gain"].append(float(rng.uniform(0.4, 1.0)))
        pos += length + float(rng.uniform(0.05, 0.3))
        if movable < 0 and pos >= break_at and pos < total_beats - float(cfg["break_beats"]) - 1.0:
            movable = len(cols["min_beat"]) - 1
            pos += float(cfg["break_beats"])
    if movable < 0:
        raise ValueError(f"track {t}: no room for a {cfg['break_beats']}-beat gap; lengthen the session")
    arr = {k: np.asarray(v, dtype=np.int32 if k == "asset" else np.float64) for k, v in cols.items()}
    span = arr["max_beat"] - arr["min_beat"]
    return TrackDesc(volume_db=volume_db, pan=pan, fade_in=span * fade, fade_out=span * fade,
                     movable=movable, chain=chains.resolve(cfg.get("track_chain"), t), **arr)


def edit_track(tr: TrackDesc, fader_db: float, clip: int, move_beats: float) -> TrackDesc:
    """``tr`` with its fader moved by ``fader_db`` and clip ``clip`` moved by
    ``move_beats`` (same asset, offset, gain and fades; the new end is the
    new start plus the old length, as the session's ``move_clip`` sets it)."""
    lo, hi = tr.min_beat.copy(), tr.max_beat.copy()
    lo[clip] = tr.min_beat[clip] + move_beats
    hi[clip] = lo[clip] + (tr.max_beat[clip] - tr.min_beat[clip])
    return dataclasses.replace(tr, volume_db=tr.volume_db + fader_db, min_beat=lo, max_beat=hi)


def generate(cfg: dict, seed: int) -> SessionDesc:
    """The configuration's session from ``seed``."""
    r_assets, r_tracks = _rngs(seed, 2)
    rate = int(cfg["sample_rate"])
    bpm = float(cfg["bpm"])
    bd = 60.0 / bpm
    total_beats = float(cfg["seconds"]) / bd
    n_frames = int(round(float(cfg["asset_seconds"]) * rate))
    tracks = [_track(cfg, r_tracks, t, n_frames, total_beats, bd) for t in range(int(cfg["tracks"]))]
    return SessionDesc(sample_rate=rate, buffer_size=int(cfg["buffer_size"]), channels=int(cfg["channels"]),
                       bpm=bpm, assets=_assets(cfg, r_assets), tracks=tracks,
                       master_chain=chains.resolve(cfg.get("master_chain"), 0))


class Edits:
    """The seed's stream of edits: edit ``k`` moves the fader of track
    ``tracks[k % len(tracks)]`` by ``fader_db[0]`` to ``fader_db[1]`` dB either
    way (drawn afresh for every ``k``, so no two edits leave the session in
    the same state) and moves that track's movable clip by ``move_beats``.
    ``tracks`` are ``n_tracks`` distinct tracks drawn from the seed."""

    def __init__(self, base: SessionDesc, seed: int, n_tracks: int, fader_db=(0.5, 3.0), move_beats: float = 1.0):
        self.base, self.seed = base, abs(int(seed))
        self.fader_db, self.move_beats = tuple(fader_db), float(move_beats)
        rng = _rngs(seed, 3)[2]
        self.tracks = [int(t) for t in rng.choice(len(base.tracks), size=min(n_tracks, len(base.tracks)),
                                                  replace=False)]

    def __getitem__(self, k: int) -> Variant:
        rng = np.random.default_rng(np.random.SeedSequence(self.seed, spawn_key=(7, int(k))))
        t = self.tracks[k % len(self.tracks)]
        db = float(rng.uniform(*self.fader_db)) * (1.0 if rng.random() < 0.5 else -1.0)
        tr = self.base.tracks[t]
        edited = list(self.base.tracks)
        edited[t] = edit_track(tr, db, tr.movable, self.move_beats)
        return Variant(desc=dataclasses.replace(self.base, tracks=edited), track=t, moved_clip=tr.movable,
                       move_beats=self.move_beats)


def edits(base: SessionDesc, seed: int, traffic: dict) -> Edits:
    """The export loops' edits of ``base``, by the traffic mix's ``variants``,
    ``fader_db`` and ``clip_move_beats``."""
    return Edits(base, seed, int(traffic["variants"]), tuple(traffic.get("fader_db", (0.5, 3.0))),
                 float(traffic.get("clip_move_beats", 1.0)))
