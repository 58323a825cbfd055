"""The reference of the ``clips`` kind of session: the engine's f32 mix of
audio clips at speed 1, from the benchmark's session description
(``sessions/clips.py``).

A frozen rewrite of the semantics of ``whitebox_tpu/timeline/oracle.py``
(the block-sequential NumPy twin of the C++ engine: the f64 transport grid,
block ownership of clip edges, the sampler's fast copy, gain, volume and
pan, the ordered track sum, the hard clip) and of the clip fade envelope
that the carve adds (``whitebox_tpu/timeline/carve.py``: linear f32 ramps
anchored at the clip's first and last frame). It walks clips, not blocks:
at speed 1 a clip's frames are a contiguous copy of its asset, so each clip
is one slice, and every f32 product is taken in the engine's order.

Only what the ``clips`` kind holds is here: f32 assets at the session rate,
one-shot clips at speed 1, no tempo map, no automation. ``check()`` refuses
a description outside that. :class:`Render` is what the harness reads
(``lib/check.py``, ``lib/roofline.py``); another kind of session brings a
file of its own with the same class.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass

import numpy as np

#: a fade anchor that never ramps (the carve's identity rows)
NO_FADE = 1 << 30
#: the -72 dB floor of ``db_to_linear`` (core_math.h)
DB_SILENT = -72.0
#: f32 operations of the fade envelope per frame (two differences, two scalings, their product)
ENVELOPE_OPS = 5


def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


_POWF = _powf()


def db_to_linear_f32(db: float) -> np.float32:
    """``std::pow(10.0f, (float)(db * 0.05))`` by libm's powf, 0 at or below -72 dB."""
    if db <= DB_SILENT:
        return np.float32(0.0)
    return np.float32(_POWF(10.0, float(np.float32(float(db) * 0.05))))


def pan_coeffs(pan: float) -> tuple:
    """The constant-power -3 dB law in f64, narrowed to f32 (panning_law.cpp)."""
    x = 0.5 * (float(pan) + 1.0)
    boost = math.sqrt(2.0)
    return (np.float32(np.sin(0.5 * math.pi * (1.0 - x)) * boost), np.float32(np.sin(0.5 * math.pi * x) * boost))


def track_gain(tr, channels: int) -> np.ndarray:
    """``[C]`` f32: volume times the pan coefficient of each channel, one f32 product."""
    vol = db_to_linear_f32(tr.volume_db)
    pc = pan_coeffs(tr.pan)
    return np.array([np.float32(vol * pc[c % 2]) for c in range(channels)], dtype=np.float32)


@dataclass(frozen=True)
class Grid:
    """The engine's per-block f64 accumulators over ``blocks`` blocks."""

    playhead: np.ndarray  # [blocks + 1] beats
    sample_position: np.ndarray  # [blocks + 1]
    blocks: int
    buffer_size: int
    sample_rate: float
    beat_duration: float

    @property
    def frames(self) -> int:
        return self.blocks * self.buffer_size

    def delta_samples(self, beat_from: float, beat_to: float) -> float:
        # beat_to_samples: (beats * beat_duration) * rate, two f64 roundings
        return ((beat_to - beat_from) * self.beat_duration) * self.sample_rate

    def frame_of(self, beat: float) -> int:
        """The output frame where an event at ``beat`` lands: the first block
        whose end is at or past it (the engine's closed-interval walk), then
        ``(uint64)(sample_position + delta) % buffer_size`` inside it;
        ``frames`` past the last block."""
        k = int(np.searchsorted(self.playhead[1:], beat, side="left"))
        if k >= self.blocks:
            return -1
        so = float(self.sample_position[k]) + self.delta_samples(float(self.playhead[k]), beat)
        return k * self.buffer_size + ((int(so) if so > 0.0 else 0) % self.buffer_size)


def grid(desc) -> Grid:
    """The transport of ``desc`` over enough blocks for the playhead to pass
    the last clip edge."""
    rate, bs, bd = float(desc.sample_rate), int(desc.buffer_size), desc.beat_duration
    step_beats = (bs / rate) / bd
    end = max((float(tr.max_beat.max()) for tr in desc.tracks if len(tr.max_beat)), default=0.0)

    def acc(n, first, step):
        steps = np.full(n + 1, step, dtype=np.float64)
        steps[0] = first
        return np.add.accumulate(steps)

    n = int(np.ceil(max(end, 0.0) / step_beats))
    while float(acc(n, 0.0, step_beats)[-1]) < end:
        n += 1
    n = max(n, 1)
    sps = (step_beats * bd) * rate
    return Grid(acc(n, 0.0, step_beats), acc(n, 0.0, sps), n, bs, rate, bd)


@dataclass(frozen=True)
class ClipRun:
    """One clip as rendered: output frames ``[start, stop)`` read asset
    ``asset`` from frame ``src``; gain and the fade anchors in f32/int."""

    start: int
    stop: int
    asset: int
    src: int
    gain: np.float32
    fin_start: int
    fin_inv: np.float32
    fout_end: int
    fout_inv: np.float32


def check(desc) -> None:
    for i, a in enumerate(desc.assets):
        if a.dtype != np.float32 or a.ndim != 2:
            raise ValueError(f"asset {i}: the mix reference takes [channels, frames] float32 assets")


def track_runs(desc, t: int, g: Grid) -> list:
    """The clips of track ``t`` as rendered frame spans."""
    tr = desc.tracks[t]
    runs = []
    end_frame = g.frames
    order = np.argsort(tr.min_beat, kind="stable")
    for i in order:
        lo, hi = float(tr.min_beat[i]), float(tr.max_beat[i])
        play = g.frame_of(lo)
        if play < 0:
            break  # starts after the last block; later clips too
        stop = g.frame_of(hi)
        stop = end_frame if stop < 0 else min(stop, end_frame)
        asset = int(tr.asset[i])
        count = desc.assets[asset].shape[1]
        src = int(tr.offset[i])
        if stop <= play or src >= count:
            continue
        fi, fo = float(tr.fade_in[i]), float(tr.fade_out[i])
        if fi > 0.0 or fo > 0.0:
            clip_frames = int(round(g.delta_samples(lo, hi)))
            fin = int(round((fi * g.beat_duration) * g.sample_rate))
            fout = int(round((fo * g.beat_duration) * g.sample_rate))
            fin_start, fin_inv = (play, np.float32(1.0 / fin)) if fin > 0 else (-NO_FADE, np.float32(1.0))
            fout_end, fout_inv = ((play + clip_frames, np.float32(1.0 / fout)) if fout > 0
                                  else (NO_FADE, np.float32(1.0)))
        else:
            fin_start, fin_inv, fout_end, fout_inv = -NO_FADE, np.float32(1.0), NO_FADE, np.float32(1.0)
        # the sampler stops at the asset's end: frames past it stay silent
        stop = min(stop, play + (count - src))
        runs.append(ClipRun(play, stop, asset, src, np.float32(tr.gain[i]), fin_start, fin_inv, fout_end,
                            fout_inv))
    return runs


def _envelope(r: ClipRun, a: int, b: int) -> np.ndarray:
    """The fade envelope over output frames ``[a, b)``, f32:
    ``clip(f32(g - fin_start) * fin_inv, 0, 1) * clip(f32(fout_end - g) * fout_inv, 0, 1)``."""
    one, zero = np.float32(1.0), np.float32(0.0)
    g = np.arange(a, b, dtype=np.int64)
    return (np.clip((g - r.fin_start).astype(np.float32) * r.fin_inv, zero, one)
            * np.clip((r.fout_end - g).astype(np.float32) * r.fout_inv, zero, one))


def _ramp_frames(inv: np.float32) -> int:
    """Frames from a ramp's anchor past which its factor reads exactly 1:
    ``k * f32(1/n)`` rounds to 1 or more for every ``k > n`` (n < 2^24)."""
    return int(round(1.0 / float(inv))) + 1


def track_signal(desc, runs: list, f0: int, f1: int, channels: int, assets=None) -> np.ndarray:
    """Track's pre-gain signal ``[C, f1 - f0]`` f32: each clip's
    ``(sample * gain) * envelope`` (:func:`_envelope`). Where both ramps
    read 1 the envelope is 1 and ``(sample * gain) * 1`` is
    ``sample * gain`` bit for bit, so the envelope is evaluated on the
    ramps alone. ``assets`` replaces ``desc.assets`` (the control reads
    rounded copies)."""
    assets = desc.assets if assets is None else assets
    out = np.zeros((channels, f1 - f0), dtype=np.float32)
    for r in runs:
        a, b = max(r.start, f0), min(r.stop, f1)
        if b <= a:
            continue
        data = assets[r.asset]
        s0 = r.src + (a - r.start)
        seg = out[:, a - f0:b - f0]
        for c in range(channels):
            np.multiply(data[c % data.shape[0], s0:s0 + (b - a)], r.gain, out=seg[c])
        # the ramps: [fin_start, fin_start + n_in] and [fout_end - n_out, fout_end)
        lo = max(a, min(b, r.fin_start + _ramp_frames(r.fin_inv)) if r.fin_start != -NO_FADE else a)
        hi = min(b, max(a, r.fout_end - _ramp_frames(r.fout_inv)) if r.fout_end != NO_FADE else b)
        for p, q in ((a, lo), (hi, b)) if lo < hi else ((a, b),):
            if q > p:
                seg[:, p - a:q - a] *= _envelope(r, p, q)
    return out


def hard_clip(x: np.ndarray) -> np.ndarray:
    """The engine's output ceiling: values past +-1 set to +-1 (engine.cpp:1627-1636)."""
    return np.clip(x, -1.0, 1.0).astype(x.dtype, copy=False)


class Render:
    """The per-track render of a description and its variants (descriptions
    that share its transport and assets): what ``lib/check.py`` and
    ``lib/roofline.py`` read."""

    def __init__(self, desc):
        check(desc)
        self.grid = grid(desc)
        self.frames = self.grid.frames
        self._runs = {}

    def runs(self, desc, t: int) -> list:
        tr = desc.tracks[t]
        if id(tr) not in self._runs:
            self._runs[id(tr)] = (tr, track_runs(desc, t, self.grid))
        return self._runs[id(tr)][1]

    def signal(self, desc, t: int, f0: int, f1: int, assets=None) -> np.ndarray:
        """Track ``t``'s signal before its chain and gain, ``[C, f1 - f0]`` f32."""
        return track_signal(desc, self.runs(desc, t), f0, f1, desc.channels, assets)

    def gain(self, desc, t: int) -> np.ndarray:
        return track_gain(desc.tracks[t], desc.channels)

    @staticmethod
    def output(total: np.ndarray) -> np.ndarray:
        return hard_clip(total)

    def work(self, desc, t: int) -> tuple:
        """The least work of track ``t`` before its chain: ``(reads, played,
        ops)``, the asset source spans it plays (``(asset, first, end)``),
        the frames it plays, and the f32 operations of its clip gains and
        fade envelopes (per played frame the envelope where the clip fades,
        per played channel and frame the gain and the envelope's product)."""
        reads, played, ops = [], 0, 0
        C = desc.channels
        for r in self.runs(desc, t):
            n = r.stop - r.start
            played += n
            reads.append((r.asset, r.src, r.src + n))
            fades = r.fin_start != -NO_FADE or r.fout_end != NO_FADE
            ops += n * (ENVELOPE_OPS if fades else 0) + n * C * (2 if fades else 1)
        return reads, played, ops
