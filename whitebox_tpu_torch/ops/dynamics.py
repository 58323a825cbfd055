"""Dynamics processing (compressor / limiter / gate) on torch tensors.

Counterpart of ``whitebox_tpu/ops/dynamics.py``. Built from frame-parallel
primitives:

- detector: peak (|x|, stereo-linked max over channels) or RMS (one-pole
  average of x^2) level, in dB;
- static curve: the soft-knee downward-compressor gain computer
  (Giannoulis/Massberg/Reiss, JAES 2012, eq. 4) giving a gain reduction
  in dB >= 0;
- ballistics: the smooth decoupled peak detector (same paper, eq. 17):
  release as the max-decay recurrence R[n] = max(r[n], rho * R[n-1]),
  then attack as a one-pole smoother. Both recurrences carry exact
  chunk-boundary state, so chunked processing equals one-shot. On the
  CPU they run as Hillis-Steele prefix scans (``ops/scan_util.hillis_scan``)
  in ceil(log2 F) steps.

On the card each processor is one launch of the hand kernel
``csrc/dynamics_scan.cu`` (``ops/dynamics_cuda.py``), which fuses the
detector, the curve, both recurrences and the gain; the torch ops here
(``*_torch``) are its plain version.

Every multiply and add is its own torch op (no FMA contraction). The
sequential float64 references (``*_ref``) are the JAX package's, copied;
the f32 scans track them to ~1e-5 relative.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from whitebox_tpu_torch.ops import dynamics_cuda
from whitebox_tpu_torch.ops.scan_util import hillis_scan

_EPS = 1e-10  # -200 dBFS detector floor
_LOG10_20 = 8.685889638065035  # 20 / ln(10)


def time_coef(seconds, sample_rate: float):
    """One-pole/decay coefficient for a time constant: exp(-1/(t*fs)) (host).

    t == 0 maps to coefficient 0 (instant). Accepts scalars or arrays."""
    t = np.asarray(seconds, dtype=np.float64)
    fs = float(sample_rate)
    with np.errstate(divide="ignore"):
        c = np.where(t <= 0.0, 0.0, np.exp(-1.0 / np.maximum(t * fs, 1e-12)))
    return np.float32(c) if np.ndim(t) == 0 else c.astype(np.float32)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# scan primitives (frames on the last axis, arbitrary leading batch dims)
# ---------------------------------------------------------------------------


def onepole_scan_t(x, a, y0):
    """:func:`onepole_scan` that also returns the cumulative transition
    m[n] = a^(n+1) (the injection weights of a state handed in later)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    a = torch.broadcast_to(_f32(a, x), x.shape)
    b = (1.0 - a) * x

    def comb(l, r):  # later(earlier(y)) = m_r*(m_l*y+b_l)+b_r
        return l[0] * r[0], r[0] * l[1] + r[1]

    m, bb = hillis_scan(comb, (a, b), (1.0, 0.0))
    y = m * _f32(y0, x)[..., None] + bb
    return y, y[..., -1], m


def onepole_scan(x, a, y0):
    """y[n] = a*y[n-1] + (1-a)*x[n] over the last axis, log depth.

    ``a`` broadcasts against ``x`` ([..., 1] or a scalar). Returns (y,
    y_last), y_last carrying across chunks."""
    y, y_last, _ = onepole_scan_t(x, a, y0)
    return y, y_last


def maxdecay_scan_t(v, rho, e0):
    """:func:`maxdecay_scan` that also returns the cumulative decay
    d[n] = rho^(n+1).

    The scan's left identity ``(-1, 1)`` holds because the values are
    >= 0 (gain reductions, openness targets): comb(identity, r) == r."""
    v = torch.as_tensor(v, dtype=torch.float32)
    d = torch.broadcast_to(_f32(rho, v), v.shape)

    def comb(l, r):  # decay the earlier span's max by the later span's length
        return torch.maximum(l[0] * r[1], r[0]), l[1] * r[1]

    m, dd = hillis_scan(comb, (v, d), (-1.0, 1.0))
    e = torch.maximum(m, _f32(e0, v)[..., None] * dd)
    return e, e[..., -1], dd


def maxdecay_scan(v, rho, e0):
    """e[n] = max(v[n], rho*e[n-1]) over the last axis, log depth: the
    peak detector with exponential release. Returns (e, e_last)."""
    e, e_last, _ = maxdecay_scan_t(v, rho, e0)
    return e, e_last


# ---------------------------------------------------------------------------
# static curves (elementwise)
# ---------------------------------------------------------------------------


def compressor_reduction_db(level_db, threshold_db, ratio, knee_db):
    """Desired downward gain reduction (dB, >= 0), soft knee
    (Giannoulis et al. eq. 4 as reduction = x_db - y_db)."""
    slope = 1.0 - 1.0 / ratio
    over = level_db - threshold_db
    w = torch.clamp(_f32(knee_db, level_db), min=1e-6)
    in_knee = slope * torch.square(over + 0.5 * w) / (2.0 * w)
    r = torch.where(over <= -0.5 * w, 0.0, torch.where(over >= 0.5 * w, slope * over, in_knee))
    return torch.clamp(r, min=0.0)


def limiter_reduction_db(level_db, ceiling_db):
    """Hard-limit curve: everything over the ceiling is reduced (ratio inf)."""
    return torch.clamp(level_db - ceiling_db, min=0.0)


def gate_open_gain(level_db, threshold_db, range_db, hysteresis_db=0.0):
    """Target gate gain: 1 when open (level >= threshold), the floor when
    closed; ``hysteresis_db`` ramps linearly just below the threshold."""
    floor = torch.exp(-torch.abs(_f32(range_db, level_db)) / _LOG10_20)
    h = _f32(hysteresis_db, level_db)
    ramp = torch.clamp((level_db - (threshold_db - h)) / torch.clamp(h, min=1e-6), 0.0, 1.0)
    step = torch.where(level_db >= threshold_db, 1.0, 0.0)
    t = torch.where(h > 0.0, ramp, step)
    return floor + (1.0 - floor) * t


def _level_db(x):
    return _LOG10_20 * torch.log(torch.clamp(x, min=_EPS))


# ---------------------------------------------------------------------------
# full processors: x [..., C, F] -> (y, state)
# ---------------------------------------------------------------------------
#
# ``compressor_process``, ``limiter_process`` and ``gate_process`` run one
# launch of the fused kernel ``csrc/dynamics_scan.cu`` on a CUDA ``x``
# (``ops/dynamics_cuda.py``) and the torch ops of ``*_torch`` on the CPU.
# The ``*_torch`` forms take ``scans``, a (ballistics, onepole) pair with the
# signatures of ``dynamics_cuda.ballistics_reference`` / ``onepole_reference``
# (those by default): with ``dynamics_cuda.model_scans`` they are the
# kernel's host model.


def _scans(scans):
    return scans or (dynamics_cuda.ballistics_reference, dynamics_cuda.onepole_reference)


def detector_level(x, mode: str, avg_coef, det0, onepole=None, silent: bool = False):
    """Stereo-linked detector level [..., F] from x [..., C, F].

    "peak": max |x| over channels (det0 returned unchanged). "rms": sqrt of
    the one-pole average of the channel-mean x^2 (state = the average).
    ``silent``: the detector hears silence (x gives only the shape)."""
    if mode not in ("peak", "rms"):
        raise ValueError(f"detector mode {mode!r}")
    quiet = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.float32, device=x.device) if silent else None
    if mode == "peak":
        return (quiet if silent else torch.abs(x).amax(dim=-2)), det0
    p = quiet if silent else torch.mean(torch.square(x), dim=-2)
    avg, last = (onepole or dynamics_cuda.onepole_reference)(p, avg_coef, det0)
    return torch.sqrt(torch.clamp(avg, min=0.0)), last


def compressor_process(x, params, state, *, detector: str = "peak", key=None, silent_key: bool = False):
    """Compress x [..., C, F].

    ``params``: f32 tensors broadcastable over the leading batch dims
    (shape [] or [B, 1]; per-frame lanes [B, F]): threshold_db, ratio,
    knee_db, attack (coef), release (coef), makeup_db, det_avg (RMS
    detector coef). ``state``: "red" (release-held reduction, dB), "att"
    (attack smoother output, dB), "det" (RMS average), each of the leading
    batch shape. ``key`` [..., C, F]: an external sidechain signal the
    detector listens to instead of ``x``; ``silent_key``: a sidechain with
    nothing routed, whose detector hears silence (no tensor of zeros).
    Returns (y, new_state)."""
    return dynamics_cuda.compressor(x, params, state, detector=detector, key=key, silent_key=silent_key)


def compressor_torch(x, params, state, *, detector: str = "peak", key=None, silent_key: bool = False,
                     scans=None):
    """:func:`compressor_process` in torch ops (the CPU's form)."""
    if silent_key and key is not None:
        raise ValueError("a silent key and a key tensor at once")
    ballistics, onepole = _scans(scans)
    lvl, det_last = detector_level(x if key is None else key, detector, params.get("det_avg", 0.0), state["det"],
                                   onepole, silent_key)
    r_db = compressor_reduction_db(_level_db(lvl), params["threshold_db"], params["ratio"],
                                   params["knee_db"])
    smooth, red_last, att_last = ballistics(r_db, params["release"], params["attack"], state["red"], state["att"])
    gain = torch.exp((params["makeup_db"] - smooth) / _LOG10_20)
    return x * gain[..., None, :], {"red": red_last, "att": att_last, "det": det_last}


def _window_max(seq, w: int):
    """Sliding max over a trailing window of width w: out[n] = max(seq[n:n+w])."""
    return seq.unfold(-1, w, 1).amax(dim=-1)


def limiter_process(x, params, state, *, lookahead: int = 0):
    """Limit x [..., C, F] to a ceiling (an infinite-ratio compressor).

    ``lookahead`` (frames) takes the window max of the desired reduction
    over [n, n+L] so the attack ramp finishes before the peak arrives:
    a trailing max over the last L+1 levels, paired with an L-frame delay
    of the audio. ``state``: "red", "att" as the compressor's; "look"
    [..., L], the last L levels of the previous chunk; "xdelay" [..., C, L],
    the audio delay line."""
    return dynamics_cuda.limiter(x, params, state, lookahead=lookahead)


def limiter_torch(x, params, state, *, lookahead: int = 0, scans=None):
    """:func:`limiter_process` in torch ops (the CPU's form)."""
    ballistics, _ = _scans(scans)
    lvl = torch.abs(x).amax(dim=-2)
    r_db = limiter_reduction_db(_level_db(lvl), params["ceiling_db"])
    if lookahead > 0:
        seq = torch.cat([state["look"], r_db], dim=-1)
        r_db = _window_max(seq, lookahead + 1)[..., : r_db.shape[-1]]
        look_last = seq[..., -lookahead:]
    else:
        look_last = state["look"]
    smooth, red_last, att_last = ballistics(r_db, params["release"], params["attack"], state["red"], state["att"])
    gain = torch.exp(-smooth / _LOG10_20)
    if lookahead > 0:
        xs = torch.cat([state["xdelay"], x], dim=-1)
        y = xs[..., : x.shape[-1]] * gain[..., None, :]
        return y, {"red": red_last, "att": att_last, "look": look_last,
                   "xdelay": xs[..., x.shape[-1]:]}
    return x * gain[..., None, :], {"red": red_last, "att": att_last, "look": look_last,
                                    "xdelay": state["xdelay"]}


def gate_process(x, params, state, key=None, silent_key: bool = False):
    """Noise gate on x [..., C, F]: openness o[n] = max(target[n],
    rho*o[n-1]) (instant open, exponential close), floored at the closed
    gain, then one-pole attack smoothing. ``params``: threshold_db,
    range_db, hyst_db, attack, release; ``state``: "open", "att". ``key``:
    an external sidechain detector signal; ``silent_key``: a sidechain with
    nothing routed (the detector hears silence)."""
    return dynamics_cuda.gate(x, params, state, key=key, silent_key=silent_key)


def gate_torch(x, params, state, key=None, silent_key: bool = False, scans=None):
    """:func:`gate_process` in torch ops (the CPU's form)."""
    if silent_key and key is not None:
        raise ValueError("a silent key and a key tensor at once")
    ballistics, _ = _scans(scans)
    lvl, _ = detector_level(x if key is None else key, "peak", 0.0, None, silent=silent_key)
    tgt = gate_open_gain(_level_db(lvl), params["threshold_db"], params["range_db"],
                         params.get("hyst_db", 0.0))
    floor = torch.exp(-torch.abs(_f32(params["range_db"], x)) / _LOG10_20)
    # the decay stops at the closed-gain floor
    smooth, open_last, att_last = ballistics(tgt, params["release"], params["attack"], state["open"], state["att"],
                                             floor=floor)
    return x * smooth[..., None, :], {"open": open_last, "att": att_last}


# ---------------------------------------------------------------------------
# float64 sequential references (test oracles), the JAX package's
# ---------------------------------------------------------------------------


def _level_db_np(v):
    return 20.0 * np.log10(np.maximum(v, _EPS))


def _per_frame(v, F: int) -> np.ndarray:
    """A scalar or per-frame param array broadcast to [F] f64."""
    return np.broadcast_to(np.asarray(v, np.float64), (F,))


def compressor_ref(x: np.ndarray, *, threshold_db, ratio, knee_db, attack, release,
                   makeup_db=0.0, detector="peak", det_avg=0.0, key=None) -> np.ndarray:
    """Sequential f64 reference of compressor_process (one row [C, F]);
    every param may be a scalar or a per-frame [F] array."""
    x = np.asarray(x, np.float64)
    C, F = x.shape
    det_src = x if key is None else np.asarray(key, np.float64)
    thr, rat, knee = _per_frame(threshold_db, F), _per_frame(ratio, F), _per_frame(knee_db, F)
    atk, rel, mk = _per_frame(attack, F), _per_frame(release, F), _per_frame(makeup_db, F)
    davg = _per_frame(det_avg, F)
    red = att = avg = 0.0
    y = np.empty_like(x)
    for n in range(F):
        if detector == "peak":
            lvl = np.max(np.abs(det_src[:, n]))
        else:
            avg = davg[n] * avg + (1.0 - davg[n]) * np.mean(det_src[:, n] ** 2)
            lvl = math.sqrt(max(avg, 0.0))
        slope = 1.0 - 1.0 / rat[n]
        w = max(knee[n], 1e-6)
        over = _level_db_np(lvl) - thr[n]
        if over <= -0.5 * w:
            r = 0.0
        elif over >= 0.5 * w:
            r = slope * over
        else:
            r = slope * (over + 0.5 * w) ** 2 / (2.0 * w)
        red = max(r, rel[n] * red)
        att = atk[n] * att + (1.0 - atk[n]) * red
        y[:, n] = x[:, n] * 10.0 ** ((mk[n] - att) / 20.0)
    return y


def limiter_ref(x: np.ndarray, *, ceiling_db, attack, release, lookahead=0) -> np.ndarray:
    x = np.asarray(x, np.float64)
    C, F = x.shape
    ceil_, atk, rel = _per_frame(ceiling_db, F), _per_frame(attack, F), _per_frame(release, F)
    lvl = np.max(np.abs(x), axis=0)
    r = np.maximum(_level_db_np(lvl) - ceil_, 0.0)
    if lookahead > 0:
        padded = np.concatenate([np.zeros(lookahead), r])  # past carry = silence
        r = np.array([np.max(padded[n : n + lookahead + 1]) for n in range(F)])
        xd = np.concatenate([np.zeros((C, lookahead)), x], axis=1)[:, :F]
    else:
        xd = x
    red = att = 0.0
    y = np.empty_like(x)
    for n in range(F):
        red = max(r[n], rel[n] * red)
        att = atk[n] * att + (1.0 - atk[n]) * red
        y[:, n] = xd[:, n] * 10.0 ** (-att / 20.0)
    return y


def gate_ref(x: np.ndarray, *, threshold_db, range_db, attack, release,
             hysteresis_db=0.0, key=None) -> np.ndarray:
    x = np.asarray(x, np.float64)
    C, F = x.shape
    det_src = x if key is None else np.asarray(key, np.float64)
    thr, rng = _per_frame(threshold_db, F), _per_frame(range_db, F)
    atk, rel = _per_frame(attack, F), _per_frame(release, F)
    hyst = _per_frame(hysteresis_db, F)
    opn = att = 0.0
    y = np.empty_like(x)
    for n in range(F):
        floor = 10.0 ** (-abs(rng[n]) / 20.0)
        lvl = np.max(np.abs(det_src[:, n]))
        ldb = _level_db_np(lvl)
        if hyst[n] > 0.0:  # linear ramp just below threshold (gate_open_gain)
            t = min(max((ldb - (thr[n] - hyst[n])) / max(hyst[n], 1e-6), 0.0), 1.0)
            tgt = floor + (1.0 - floor) * t
        else:
            tgt = 1.0 if ldb >= thr[n] else floor
        opn = max(tgt, rel[n] * opn)
        o = max(opn, floor)
        att = atk[n] * att + (1.0 - atk[n]) * o
        y[:, n] = x[:, n] * att
    return y
