"""Sample-accurate track automation: lane model, packing, evaluation.

Counterpart of ``whitebox_tpu/ops/automation.py``. A lane is a sorted
list of (x beats, y value, curve, tension) breakpoints; the value holds
before the first and after the last point. Lanes attach to tracks as
``track.automation = TrackAutomation(volume=..., pan=...)``:

- volume lane: linear gain, replaces the track fader (mute still silences);
- pan lane: pan position in [-1, 1], fed through the ConstantPower -3 dB
  law per frame in f32.

Host side (NumPy, as in the JAX package): the data model, the packers
(``lane_frame_table``, ``pack_lane_tables``, ``pack_session_automation``)
that turn beats into frames through the scalar beat duration or the
session's ``TempoMap``, and ``eval_lane_numpy``, the f32 host mirror.

Device side: :func:`eval_lanes` and :func:`pan_coef` in plain PyTorch.
They follow the CUDA kernel's lane sweep (``csrc/mix_kernel.cu``, K3) and
the JAX kernel's (``whitebox_tpu/ops/mix_pallas.py:384-404``), not
``searchsorted``: ``ys[P-2] + 1*(ys[P-1]-ys[P-2])`` is not always
``ys[P-1]``, so the two forms differ by rounding at a lane's last point.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from whitebox_tpu_torch.core.math import beat_to_samples

_SENTINEL = np.int32(2**31 - 1)
HALF_PI = np.float32(0.5 * np.pi)
SQRT2 = np.float32(np.sqrt(2.0))


class CurveType(enum.IntEnum):
    """envelope_storage.h:12 EnvelopePointType — all nine curve shapes.

    The reference only *edits* these (env_editor.cpp); here they evaluate
    per frame. Formula notes: EXP_* use core_math.h exponential_ease,
    EXP_ALT_* the rational exponential_ease2, POW_* u^(2^tension); *_DUAL
    are the symmetric S-curve forms; HOLD/STEP are the two constants.
    """

    HOLD = 0
    LINEAR = 1
    EXP_SINGLE = 2
    EXP_DUAL = 3
    EXP_ALT_SINGLE = 4
    EXP_ALT_DUAL = 5
    POW_SINGLE = 6
    POW_DUAL = 7
    STEP = 8


#: backward-compat alias (earlier rounds persisted EXP_EASE == ExpAltSingle)
CurveType.EXP_EASE = CurveType.EXP_ALT_SINGLE


@dataclass
class EnvelopePoint:
    x: float  # beats
    y: float
    curve: CurveType = CurveType.LINEAR
    tension: float = 0.0


@dataclass
class AutomationLane:
    points: list[EnvelopePoint] = field(default_factory=list)

    def __post_init__(self):
        self.points.sort(key=lambda p: p.x)

    def add(self, x: float, y: float, curve: CurveType = CurveType.LINEAR, tension: float = 0.0):
        self.points.append(EnvelopePoint(x, y, curve, tension))
        self.points.sort(key=lambda p: p.x)
        return self


@dataclass
class TrackAutomation:
    volume: AutomationLane | None = None  # linear gain
    pan: AutomationLane | None = None  # [-1, 1]
    #: timed *effect*-parameter lanes, keyed ``(slot_index, param_name)``
    #: into the track's effect chain. Their time-varying sections are not
    #: ported yet, so ``bounce`` refuses sessions that have any (ROADMAP.md
    #: queue 1, item 6).
    effects: dict = field(default_factory=dict)

    def has_track_lanes(self) -> bool:
        return self.volume is not None or self.pan is not None


def lane_frame_table(lane: AutomationLane | None, sample_rate: float, time_base,
                     max_points: int, default: float):
    """Lane -> fixed-size frame-domain breakpoint arrays (xs, ys, curve, tension).

    ``time_base`` is what converts beats to frames: a scalar beat_duration
    (the reference's single-tempo arithmetic, bit-exact) or a
    :class:`~whitebox_tpu_torch.core.tempo.TempoMap` (exact piecewise
    closed forms — ``Session.time_base`` hands over whichever is active).
    Frame positions are f64, rounded to nearest frame. A None lane becomes
    a single point holding ``default``.
    """
    if lane is None or not lane.points:
        pts = [EnvelopePoint(0.0, default)]
    else:
        pts = lane.points
    P = max_points
    xs = np.full(P, _SENTINEL, dtype=np.int32)
    ys = np.zeros(P, dtype=np.float32)
    cv = np.zeros(P, dtype=np.int32)
    tn = np.zeros(P, dtype=np.float32)
    mapped = not isinstance(time_base, float)
    for i, p in enumerate(pts[:P]):
        if mapped:
            xs[i] = int(round(time_base.beats_to_samples(p.x, sample_rate)))
        else:
            xs[i] = int(round(beat_to_samples(p.x, sample_rate, time_base)))
        ys[i] = np.float32(p.y)
        cv[i] = int(p.curve)
        tn[i] = np.float32(p.tension)
    n = min(len(pts), P)
    ys[n:] = ys[n - 1]  # hold last value in padded slots
    return xs, ys, cv, tn


def _apply_curve(u, curve, t, mod):
    """Shape the unit ramp ``u`` per CurveType (works for numpy and torch).

    Computes all nine shapes and selects, as the JAX package does; the
    CUDA kernel evaluates only the segment's own branch, which selects the
    same value."""
    t_safe = mod.where(mod.abs(t) < 1e-2, 1e-2, t)
    exp_s = (mod.exp(u * t_safe) - 1.0) / (mod.exp(t_safe) - 1.0)
    exp_s = mod.where(mod.abs(t) < 1e-2, u, exp_s)  # linear near t == 0

    def dual(f_u, f_mirror):
        return mod.where(u < 0.5, 0.5 * f_u, 1.0 - 0.5 * f_mirror)

    # duals evaluate the single form at 2u / 2(1-u)
    u2 = mod.clip(2.0 * u, 0.0, 1.0)
    um = mod.clip(2.0 * (1.0 - u), 0.0, 1.0)
    exp_s2 = mod.where(mod.abs(t) < 1e-2, u2, (mod.exp(u2 * t_safe) - 1.0) / (mod.exp(t_safe) - 1.0))
    exp_sm = mod.where(mod.abs(t) < 1e-2, um, (mod.exp(um * t_safe) - 1.0) / (mod.exp(t_safe) - 1.0))

    # exponential_ease2 poles at |t| >= 1: clamp tension into its domain
    ta = mod.clip(t, -0.95, 0.95)
    alt = (u - ta * u) / (ta - 2.0 * ta * mod.abs(u) + 1.0)
    alt2 = (u2 - ta * u2) / (ta - 2.0 * ta * mod.abs(u2) + 1.0)
    altm = (um - ta * um) / (ta - 2.0 * ta * mod.abs(um) + 1.0)

    p = mod.exp2(t)
    pow_s = u ** p
    pow_2 = u2 ** p
    pow_m = um ** p

    out = u  # LINEAR default
    out = mod.where(curve == int(CurveType.HOLD), 0.0, out)
    out = mod.where(curve == int(CurveType.EXP_SINGLE), exp_s, out)
    out = mod.where(curve == int(CurveType.EXP_DUAL), dual(exp_s2, exp_sm), out)
    out = mod.where(curve == int(CurveType.EXP_ALT_SINGLE), alt, out)
    out = mod.where(curve == int(CurveType.EXP_ALT_DUAL), dual(alt2, altm), out)
    out = mod.where(curve == int(CurveType.POW_SINGLE), pow_s, out)
    out = mod.where(curve == int(CurveType.POW_DUAL), dual(pow_2, pow_m), out)
    out = mod.where(curve == int(CurveType.STEP), mod.where(u >= 1.0, 1.0, 0.0), out)
    return out.astype(mod.float32) if hasattr(out, "astype") else out


def _sub_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` with int32 wrap-around (as JAX and the kernel compute it),
    returned as int64; a ``SENTINEL - negative`` span wraps negative."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return torch.remainder(d + 2**31, 2**32) - 2**31


def eval_lanes(tables: dict, g: torch.Tensor) -> torch.Tensor:
    """Batched lane evaluation -> f32 values ``[..., F]`` (plain PyTorch).

    ``tables`` holds ``xs``/``ys``/``cv``/``tn`` tensors ``[..., P]``
    (i32/f32/i32/f32); ``g`` holds global frame indices, broadcastable
    against ``[..., F]`` (e.g. ``[F]``). The sweep of
    ``whitebox_tpu/ops/automation.py::eval_lanes_device``: start from
    ``ys[0]``; for each segment i, ``u = clip((g-x0)/max(x1-x0, 1), 0, 1)``,
    0 after the last point, shaped by the segment's curve, and
    ``ys[i] + u*(ys[i+1]-ys[i])`` taken where ``g >= x0``.
    """
    xs, ys, cv, tn = tables["xs"], tables["ys"], tables["cv"], tables["tn"]
    P = xs.shape[-1]
    val = torch.broadcast_to(ys[..., 0:1], torch.broadcast_shapes(ys[..., 0:1].shape, g.shape))
    for i in range(P - 1):
        x0 = xs[..., i : i + 1]
        x1 = xs[..., i + 1 : i + 2]
        span = torch.clamp(_sub_i32(x1, x0), min=1)
        u = torch.clamp(_sub_i32(g, x0).to(torch.float32) / span.to(torch.float32), 0.0, 1.0)
        u = torch.where(x1 == int(_SENTINEL), 0.0, u)  # hold after last point
        u = _apply_curve(u, cv[..., i : i + 1], tn[..., i : i + 1], torch)
        y0 = ys[..., i : i + 1]
        seg = y0 + u * (ys[..., i + 1 : i + 2] - y0)
        val = torch.where(g >= x0, seg, val)
    return val


def pan_coef(pan: torch.Tensor, channel: int) -> torch.Tensor:
    """ConstantPower -3 dB pan law in f32 for output ``channel`` (even =
    left): ``sin(pi/2 * (1-x or x)) * sqrt2`` with ``x = 0.5*(pan+1)``,
    the kernel's op order (``mix_pallas.py:453-458``)."""
    px = 0.5 * (pan + 1.0)
    arg = (1.0 - px) if channel % 2 == 0 else px
    return torch.sin(float(HALF_PI) * arg) * float(SQRT2)


def pack_lane_tables(lanes: list, defaults, sample_rate: float, time_base) -> dict:
    """Stack per-row lanes (None -> constant ``defaults[i]``) into
    {xs,ys,cv,tn} arrays [B, P] for :func:`eval_lanes`."""
    P = max([len(l.points) for l in lanes if l is not None] + [1])
    cols = {k: [] for k in ("xs", "ys", "cv", "tn")}
    for lane, dflt in zip(lanes, defaults):
        xs, ys, cv, tn = lane_frame_table(lane, sample_rate, time_base, P, float(dflt))
        for k, v in zip(("xs", "ys", "cv", "tn"), (xs, ys, cv, tn)):
            cols[k].append(v)
    return {k: np.stack(v) for k, v in cols.items()}


def eval_lane_numpy(xs, ys, cv, tn, g):
    """Host f32 mirror of the lane sweep by ``searchsorted`` (the f64 host
    reference's lane values)."""
    P = xs.shape[0]
    i = np.clip(np.searchsorted(xs, g, side="right") - 1, 0, P - 1)
    i1 = np.clip(i + 1, 0, P - 1)
    x0, x1 = xs[i], xs[i1]
    y0, y1 = ys[i], ys[i1]
    span = np.maximum(x1 - x0, 1)
    u = np.clip((g - x0).astype(np.float32) / span.astype(np.float32), 0.0, 1.0)
    u = np.where(x1 == _SENTINEL, np.float32(0.0), u)
    u = _apply_curve(u, cv[i], tn[i].astype(np.float32), np).astype(np.float32)
    return (y0 + u * (y1 - y0)).astype(np.float32)


def session_has_automation(session) -> bool:
    return any(t.automation is not None for t in session.tracks)


def session_has_effect_automation(session) -> bool:
    """True if any track (or the master chain) has timed effect-param lanes."""
    if getattr(session, "master_automation", None):
        return True
    return any(t.automation is not None and t.automation.effects for t in session.tracks)


def pack_session_automation(session, sample_rate: float, channels: int = 2):
    """All track lanes -> fixed-size arrays [T, P] (+ mute gains [T]).

    Tracks without lanes get constant lanes at their fader values, so every
    track evaluates uniformly. Equal, array for array, to the JAX
    package's tables (``tests/test_torch_automation.py``).
    """
    bd = session.time_base
    P = 1
    for t in session.tracks:
        a = t.automation
        if a is not None:
            for lane in (a.volume, a.pan):
                if lane is not None:
                    P = max(P, len(lane.points))

    vol = {k: [] for k in ("xs", "ys", "cv", "tn")}
    pan = {k: [] for k in ("xs", "ys", "cv", "tn")}
    for t in session.tracks:
        a = t.automation
        vol_lane = a.volume if a is not None else None
        pan_lane = a.pan if a is not None else None
        # default volume: the track fader's *linear* gain (f32, as the
        # engine computes it); mute applies in the gain stage
        vx, vy, vc, vt = lane_frame_table(vol_lane, sample_rate, bd, P, float(t.volume_linear))
        px, py, pc, pt_ = lane_frame_table(pan_lane, sample_rate, bd, P, float(t.pan))
        for k, v in zip(("xs", "ys", "cv", "tn"), (vx, vy, vc, vt)):
            vol[k].append(v)
        for k, v in zip(("xs", "ys", "cv", "tn"), (px, py, pc, pt_)):
            pan[k].append(v)

    mute = np.array([0.0 if t.mute else 1.0 for t in session.tracks], dtype=np.float32)
    return (
        {k: np.stack(v) for k, v in vol.items()},
        {k: np.stack(v) for k, v in pan.items()},
        mute,
    )
