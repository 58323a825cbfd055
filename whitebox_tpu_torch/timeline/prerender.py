"""Sinc playback via run pre-rendering: exact polyphase resampling as
banded matrix products on the device, then a mix of speed-1 rows.

Counterpart of ``whitebox_tpu/timeline/prerender.py``. The oversample path
(``timeline/oversample.py``) plays sinc quality through six polynomial
taps per frame; this module removes the resampled slots instead.
Observation: after the carve's run merge, every resampled span is a
*closed-form phase ramp* ``x(k) = x0 + k*speed``; when the speed is
rational P/Q and the start phase sits on the 1/Q grid (true for every
rate-conversion ratio, 44.1k/96k -> 48k, and for loop-accumulated offsets,
which advance by multiples of P/Q from integer clip offsets), the
positions are EXACTLY ``(N0 + k*P)/Q``: Q fixed fractional phases, no
phase-grid quantization.

Because gcd(P, Q) = 1, ``N0`` decomposes as ``k0*P + c0*Q`` with
``k0 = N0 * P^-1 mod Q``: every run is a window of the CANONICAL
resampling ``y[n] = x(n*P/Q)`` of its source shifted by the integer c0,
starting at output index k0 < Q. So one banded matrix per ratio

    out2d[q, :] = M0 @ x[c0 + q*P - half + 1 : ... + W]      (W <= 2*P')

renders every run (``ops.resample.design_sinc_matrix``'s operator, start
residue folded into the window base), all runs batch into a single einsum
per ratio, and the run's fast row simply starts ``src_int = k0`` into its
rendered buffer, a *pool extension* built on the device. The mix kernel
then runs over the extended pool with speed-1 slots only, and sinc quality
costs one matrix pass instead of per-frame tap gathers. It is also a
*quality* upgrade: the output is the exact Kaiser-sinc polyphase value,
not the oversample+poly approximation.

Runs with irrational speeds or off-grid phases ride the TAYLOR-corrected
variant of the same machinery: approximate the speed by a continued-
fraction convergent P/Q with Q forced to a multiple of 128 (CF of
``128*speed``), render the rational ramp block-banded (blocks of 128
canonical outputs sharing one dense [3*128, Wb] matrix slab, so the
per-output cost is ~``128*speed + taps`` MACs independent of Q, Q can be
~20k and the drift ``eps = speed - P/Q`` is ~1e-8..1e-10/frame), and
correct the residual phase error ``e(u) = e0 + (u - k0)*eps`` IN the same
einsum with first/second-derivative matrix slabs
(``ops.resample._design_rows_d012``): ``y = y0 + e*y1 + e^2/2*y2``. Runs
are segmented so ``|e|`` stays under ``_TAYLOR_EBUDGET`` (~0.014 source
samples, Taylor residual <= -100 dB, below the 90 dB Kaiser design).
Off-grid rational phases reuse the same correction with ``eps = 0``.

Reverse motion (LOOP_REVERSE / BIDIRECTIONAL, speed < 0) rides the same
machinery: the run is planned and rendered as its mirrored FORWARD ramp
(sinc interpolation is direction-independent) and the rewrite emits a
speed = -1.0 row reading the rendered buffer backward at exact integer
phases through the kernel's reverse slow slots. Only speeds > 8 and
pathological near-simple-fraction speeds (coarse achievable anchor grid)
fall back to the oversample path (``render.bounce`` dispatches).

The host half (planning, the table rewrite, the NumPy twin
:func:`apply_prerender_host`) is a copy of the JAX module's, so plans and
rewritten tables are equal to its. The device half is torch ops on an
explicit device: the windows are one index gather of a strided view of
the flat pool (the JAX module's 128-row gather and barrel shift were
shaped by another chip and are not carried over), each ratio group is one
batched ``torch.einsum`` in full f32, large groups render in slabs of
sub-runs written in place into the extension, and the extended pool never
visits the host. The fused form of the JAX module (the mix kernel traced
into the same program as the extension, ``prerender.py:737-752`` there)
is :func:`render_prerendered_fused`: the extension's torch ops and the
CUDA mix kernel enqueued on one stream with no host synchronisation
between them.

Reference scope: quality mode the reference abandoned (sampler.cpp:61-86);
phases snap to the exact rational grid (carve's f64 accumulation deviates
by <=1e-6/Q, inside the documented resampling contract).
"""

from __future__ import annotations

import functools
import logging
import math
from dataclasses import dataclass, replace
from fractions import Fraction

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.mix_plan import _merge_slow_runs_soa
from whitebox_tpu_torch.ops.resample import (
    _design_rows, _design_rows_d012, design_poly_interp, full_f32_matmul,
)
from whitebox_tpu_torch.timeline.carve import SegmentTable
from whitebox_tpu_torch.timeline.oversample import (
    OVERSAMPLE_FACTOR, oversample_slow_rows, resolve_interpolation,
)
from whitebox_tpu_torch.timeline.pool import _GUARD, SamplePool

_log = logging.getLogger("whitebox_tpu_torch.timeline.prerender")

DEFAULT_TAPS = 32
_QF = 16      # window rows per sub-run: one batched shape per ratio;
              # per-run padding <= _QF*Qp - 1 frames, window overlap 1/_QF

_TAYLOR_QDEN = 160      # CF denominator cap for 128*speed: Q = 128*q' <= 20480
_TAYLOR_EBUDGET = 0.014  # max |phase error| (source samples): residual ~ -100 dB
_TAYLOR_MIN_SEG = 2048   # segments shorter than this aren't worth the padding
_TAYLOR_MAX_SPEED = 8.0  # window memory scales with speed; beyond -> fallback
_TAYLOR_BLK = 128        # canonical outputs per matrix slab
_TAYLOR_MAT_BYTES = 96 * 1024 * 1024  # f32 device matrix cap per ratio
_TAYLOR_K0_BUDGET = 0.004  # |e0| share spent buying a small k0 (head pad)
_TAYLOR_K0_DMAX = 256      # anchor search halfwidth cap (host memory)
#: host cost of one _RunPlan in rendered-output equivalents: the exchange
#: rate the adaptive convergent chooser uses to trade segment count
#: against padding. The value is the JAX package's, kept because it
#: decides the plan, and the port's plans equal the JAX package's; it has
#: not been re-derived for the card.
_TAYLOR_ALPHA = 7000.0


def _taylor_candidates(speed: float) -> list:
    """Every viable (P, Q, eps) Taylor ramp for ``speed``: the CF
    convergents of ``128*speed`` (best rational approximations — each
    lengthens the drift-budget segment by ~q'_next/q'_prev) plus the
    legacy ``limit_denominator`` pick, capped by the per-ratio device
    matrix budget. The planner picks per session from the measured
    run-length distribution (see plan_prerender): small Q wins for short
    runs (tail padding ~Q/2 per segment), big Q for long runs (fewer
    segments = fewer plans + less head padding)."""
    if not np.isfinite(speed) or speed <= 0.0 or speed > _TAYLOR_MAX_SPEED:
        return []
    x = 128.0 * speed
    Wb = int(128 * speed) + DEFAULT_TAPS  # ~ band width -> matrix bytes/Q
    cands: dict = {}

    def add(num: int, den: int):
        if num <= 0 or den <= 0 or 3 * (128 * den) * Wb * 4 > _TAYLOR_MAT_BYTES:
            return
        Q = 128 * den
        cands.setdefault((num, Q), float((speed * Q - num) / Q))

    fr = Fraction(x).limit_denominator(_TAYLOR_QDEN)
    add(fr.numerator, fr.denominator)
    h0, h1 = 1, int(math.floor(x))
    k0_, k1 = 0, 1
    add(h1, k1)
    y = x - math.floor(x)
    for _ in range(64):
        if y <= 1e-15:
            break
        y = 1.0 / y
        ai = int(y)
        y -= ai
        h0, h1 = h1, ai * h1 + h0
        k0_, k1 = k1, ai * k1 + k0_
        if 3 * (128 * k1) * Wb * 4 > _TAYLOR_MAT_BYTES:
            break
        add(h1, k1)
    return [(P, Q, e) for (P, Q), e in cands.items()]


def _taylor_anchor(x0: float, P: int, Q: int):
    """Snap ``frac(x0)`` to the achievable canonical anchor grid.

    Canonical fracs at output k are ``(k*P mod Q)/Q`` = multiples of
    ``1/q_hat`` (q_hat = Q/gcd(P, Q)); returns (k0, W0, e0) with
    ``x0 = W0 + (k0*P mod Q)/Q + e0`` and ``|e0| <= 1/(2*q_hat)``."""
    import math as _math

    g = _math.gcd(P, Q)
    q_hat = Q // g
    p_hat = (P // g) % q_hat
    phi = x0 - _math.floor(x0)
    r = int(round(phi * q_hat)) % q_hat
    k0 = 0 if q_hat == 1 else (r * pow(p_hat, -1, q_hat)) % q_hat
    # canonical position at buffer output k0 is W0 + (k0*P)//Q + frac —
    # the integer advance to k0 must come out of the window base
    anchor_frac = (k0 * P % Q) / Q
    W0 = int(round(x0 - anchor_frac)) - (k0 * P) // Q
    e0 = x0 - W0 - (k0 * P) // Q - anchor_frac
    return k0, W0, e0, q_hat


@functools.lru_cache(maxsize=None)
def _taylor_matrices(P: int, Q: int, taps: int, atten_db: float):
    """Block-banded Taylor slabs for the canonical ramp ``pos(m) = m*P/Q``.

    Returns (M3 f32 [nblk, 3*BLK, Wb], M3 f64, d_b tuple[int], Wb): block b
    holds the order-0/1/2 rows for canonical outputs ``m = b*BLK + j``,
    band-placed at window column ``(m*P)//Q - d_b + t``. Per-output einsum
    cost is ``3*Wb ~ 3*(BLK*speed + taps)`` MACs regardless of Q."""
    BLK = _TAYLOR_BLK
    assert Q % BLK == 0
    nblk = Q // BLK
    m = np.arange(Q, dtype=np.int64)
    num = m * P
    d = (num // Q).astype(np.int64)
    fr = (num % Q).astype(np.float64) / Q
    y0, y1, y2 = _design_rows_d012(fr, P / Q, taps, atten_db)  # [Q, taps] f64
    d_b = d[::BLK]                      # block base offsets
    rel = d - np.repeat(d_b, BLK)       # in-block band offsets
    Wb = int(rel.max()) + taps
    M = np.zeros((nblk, 3 * BLK, Wb), dtype=np.float64)
    b_i = (m // BLK)[:, None]
    j_i = (m % BLK)[:, None]
    cols = rel[:, None] + np.arange(taps)
    for o, y in enumerate((y0, y1, y2)):
        M[b_i, o * BLK + j_i, cols] = y
    return M.astype(np.float32), M, tuple(int(v) for v in d_b), Wb


def _rational_speed(speed: float, max_den: int = 4096):
    if not np.isfinite(speed) or speed <= 0.0:
        return None
    fr = Fraction(speed).limit_denominator(max_den)
    if fr.numerator <= 0 or float(fr) != float(speed):
        return None
    return fr.numerator, fr.denominator


@functools.lru_cache(maxsize=None)
def _canonical_matrix(Pp: int, Qp: int, taps: int, atten_db: float, ratio_key: tuple):
    """[Qp, Pp + taps] f32 canonical operator (+ f64 twin) for positions
    (k*Pp)/Qp above an integer base; row j covers window column d_j + t.
    The width is the band's true support (d_max < Pp), not a padded
    power — a dense matmul over zeros would cost ~3x the FLOPs.

    ``ratio_key`` = (P, Q) of the unscaled speed — sets the anti-alias
    cutoff (downsampling lowers it)."""
    P, Q = ratio_key
    j = np.arange(Qp, dtype=np.int64)
    num = j * Pp
    d = num // Qp
    fr = (num % Qp).astype(np.float64) / Qp
    rows = _design_rows(fr, P / Q, taps, atten_db)  # [Qp, taps] f64
    W = Pp + taps
    assert int(d.max()) + taps <= W, (int(d.max()), Pp)
    M = np.zeros((Qp, W), dtype=np.float64)
    for jj in range(Qp):
        M[jj, d[jj] : d[jj] + taps] = rows[jj]
    return M.astype(np.float32), M


@dataclass
class _RunPlan:
    trk: int
    d0: int          # destination start frame
    L: int           # destination length
    sid: int         # source sample id
    c0: int          # integer source shift (N0 = k0*P + c0*Q)
    k0: int          # canonical output offset (< Q) -> the fast row's src_int
    Pp: int
    Qp: int
    nsub: int        # sub-runs of _QF window rows covering k0 + L outputs
    gain: float
    fis: int
    fii: float
    foe: int
    foi: float
    new_sid: int = -1
    ext_base: int = -1     # channel-0 offset inside the ext region
    sub0: int = -1         # first sub-run index within the group batch
    stride_group: int = 0  # channel separation (n_sub_g * stride)
    # Taylor-corrected runs (irrational / off-grid ramps): c0 plays W0 (the
    # integer anchor), k0 the canonical start output, and the residual
    # phase error e(u) = e0 + (u - k0)*eps is corrected in the einsum
    taylor: bool = False
    eps: float = 0.0
    e0: float = 0.0
    # reverse runs (speed < 0, LOOP_REVERSE / BIDIRECTIONAL): the run is
    # planned and rendered as its MIRRORED forward ramp (x0' = x0 +
    # (L-1)*speed, speed' = |speed| — sinc interpolation is direction-
    # independent, so the forward-rendered buffer holds exactly the values
    # the reverse output needs in reverse order) and the rewrite emits a
    # speed = -1.0 row reading the buffer backward at exact integer phases
    rev: bool = False


@dataclass
class PrerenderPlan:
    runs: list            # group-major order (== ext layout order)
    groups: list          # [(Pp, Qp, ratio_key, n_subruns)] in layout order
    ext_len: int          # total appended samples (128-aligned)
    guard: int            # device read-guard needed past the base pool
    taps: int
    atten_db: float
    #: original-table row indices of slow rows NOT covered by this plan
    #: (partial=True planning); they stay in the rewritten table and ride
    #: the oversample fallback. None = full coverage.
    uncovered_rows: np.ndarray | None = None
    #: device seconds of the last ext build from this plan
    #: (:func:`apply_prerender_device` sets it)
    ext_seconds: float = 0.0


def plan_prerender(table: SegmentTable, pool: SamplePool, taps: int = DEFAULT_TAPS,
                   atten_db: float = 90.0, partial: bool = False) -> PrerenderPlan | None:
    """Host planning: merge slow rows into runs and check every run is an
    exact rational phase ramp. Returns None when any run isn't (caller
    falls back to the oversample path).

    ``partial=True``: plan the coverable runs and report the rest —
    irrational speeds, off-grid phases, reverse runs — in
    ``plan.uncovered_rows`` (original-table row indices) so the caller can
    route ONLY those through the oversample fallback instead of dropping
    the whole session off the exact path. Returns None when nothing is
    coverable.

    Ext layout is group-major (one group per distinct ratio) and
    channel-major within a group: the group's rendered batch transposed to
    [C, n_sub, _QF*Qp] *is* its ext segment, so assembly is a handful of
    reshapes regardless of run count."""
    if not len(table) or table.fast.all():
        return None
    soa = _merge_slow_runs_soa(table)
    if soa is None or soa["trk"].size == 0:
        return None

    half = taps // 2
    C = pool.channel_base.shape[1]

    # vectorized per-run arithmetic: rationalize each DISTINCT speed once,
    # then batch the modular phase decomposition (thousands of runs would
    # otherwise pay a Python Fraction + pow() each).
    # Reverse runs (speed < 0) are planned as their MIRRORED forward ramp:
    # x(u) = x0 + u*speed for u in [0, L) descends, so the forward ramp
    # x'(v) = (x0 + (L-1)*speed) + v*|speed| visits the same positions in
    # reverse order — the rendered buffer serves the reverse output via a
    # speed = -1.0 rewrite row (see _rewrite).
    L_all = (soa["end"] - soa["d0"]).astype(np.int64)
    rev_all = soa["speed"] < 0.0
    speeds = np.abs(soa["speed"])
    x0s = np.where(rev_all, soa["x0"] + (L_all - 1) * soa["speed"], soa["x0"])
    uspeeds, inv = np.unique(speeds, return_inverse=True)
    ok_u = np.ones(uspeeds.size, dtype=bool)
    upqsp = []
    for ui, sp in enumerate(uspeeds):
        pq = _rational_speed(float(sp))
        if pq is None:
            ok_u[ui] = False  # not exact-coverable; Taylor gets it below
            upqsp.append((1, 1, 1, 0))  # placeholder; run masked below
            continue
        P, Q = pq
        s = 1
        while s * P < taps:  # the window trick needs taps <= Pp
            s *= 2
        upqsp.append((P, Q, s, pow(P, -1, Q)))
    upq = np.asarray(upqsp, np.int64)  # [U, 4]
    P_a, Q_a, s_a, Pinv_a = (upq[inv, j] for j in range(4))
    cov = ok_u[inv]  # [n_runs] run exact-coverable so far
    N0f = x0s * Q_a
    N0 = np.round(N0f).astype(np.int64)
    offgrid = np.abs(N0f - N0) > 1e-6  # off the 1/Q grid: not a polyphase ramp
    cov &= ~offgrid
    # 128-aligned sub-run buffers (layout precondition, checked per ratio)
    stride_bad = (_QF * s_a * Q_a) % 128 != 0
    cov &= ~stride_bad

    # runs the exact path can't take get the Taylor-corrected path:
    # CF-convergent rational ramp + in-einsum derivative correction, run
    # segmented so the phase drift stays under budget. Grouped by unique
    # speed: rationalize + modular-inverse once per speed, then the
    # per-segment anchor math (_taylor_anchor's body) runs as vectorized
    # int64 over every segment of every run at once (a session of 128
    # tracks at irrational speeds has thousands of runs and tens of
    # thousands of segments).
    taylor_plans: list[_RunPlan] = []
    tay_guard_parts: list[np.ndarray] = []
    fallback = np.zeros(cov.shape, dtype=bool)
    unc = np.nonzero(~cov)[0]
    for ui in (np.unique(inv[unc]) if unc.size else ()):
        runs_u = unc[inv[unc] == ui]
        sp = float(uspeeds[ui])
        L_u = L_all[runs_u]
        # adaptive convergent choice: the drift budget per segment is
        # Lseg ~ avail/|eps|, so a deeper convergent (bigger Q) buys fewer
        # segments — at ~Q/2 tail padding each. Minimize the measured
        # total: n_seg*(E[k0] + Q/2 + alpha) over this speed's actual run
        # lengths, with runs no candidate can hold costed at the
        # oversample fallback's ~20x-per-output penalty.
        best = None
        for (Pc, Qc, ec) in _taylor_candidates(sp):
            gc_ = math.gcd(Pc, Qc)
            qh_c = Qc // gc_
            D_c = max(min(int(_TAYLOR_K0_BUDGET * qh_c - 0.5),
                          _TAYLOR_K0_DMAX), 0)
            avail_c = _TAYLOR_EBUDGET - ((D_c + 0.5) / qh_c + 1e-9)
            if avail_c <= 0.0:
                continue
            Lseg_c = None if abs(ec) < 1e-18 else int(avail_c / abs(ec))
            if Lseg_c is not None and Lseg_c < _TAYLOR_MIN_SEG:
                continue
            Ls = L_u if Lseg_c is None else np.minimum(L_u, Lseg_c)
            valid = (Ls >= np.minimum(L_u, _TAYLOR_MIN_SEG))
            nseg_c = -(-L_u[valid] // np.maximum(Ls[valid], 1))
            ek0 = qh_c / (2.0 * (D_c + 1))
            cost = float((nseg_c * (ek0 + Qc / 2.0 + _TAYLOR_ALPHA)).sum()
                         + 20.0 * L_u[~valid].sum())
            if best is None or cost < best[0]:
                best = (cost, Pc, Qc, ec, D_c, avail_c)
        if best is None:
            fallback[runs_u] = True
            continue
        _, P, Q, eps, D, avail = best
        g = math.gcd(P, Q)
        q_hat = Q // g
        p_hat = (P // g) % q_hat
        inv_p = 0 if q_hat == 1 else pow(p_hat, -1, q_hat)
        Lseg_u = (L_u.copy() if abs(eps) < 1e-18
                  else np.full(runs_u.size, int(avail / abs(eps)), np.int64))
        ok = Lseg_u >= np.minimum(L_u, _TAYLOR_MIN_SEG)
        fallback[runs_u[~ok]] = True
        runs_ok, L_o, Lseg_o = runs_u[ok], L_u[ok], Lseg_u[ok]
        if runs_ok.size == 0:
            continue
        # segment grid: run r_local contributes ceil(L/Lseg) segments at
        # t = j*Lseg, Li = min(Lseg, L - t)
        nseg = -(-L_o // Lseg_o)
        ridx = np.repeat(np.arange(runs_ok.size), nseg)
        j = np.arange(int(nseg.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(nseg) - nseg, nseg)
        t = j * Lseg_o[ridx]
        Li = np.minimum(Lseg_o[ridx], L_o[ridx] - t)
        x0_seg = x0s[runs_ok][ridx] + t.astype(np.float64) * sp
        # _taylor_anchor, vectorized — extended with a +-D numerator
        # search that buys the SMALLEST reachable k0 within the |e0|
        # budget share (head padding is k0 wasted canonical outputs; the
        # plain round() lands at E[k0] ~ q_hat/2, the search at
        # ~q_hat/(2D+2))
        phi = x0_seg - np.floor(x0_seg)
        r_ = np.round(phi * q_hat).astype(np.int64) % q_hat
        if q_hat == 1:
            k0 = np.zeros_like(r_)
        elif D > 0:
            deltas = np.arange(-D, D + 1, dtype=np.int64)
            kc = (((r_[:, None] + deltas) % q_hat) * inv_p) % q_hat
            k0 = kc[np.arange(r_.size), np.argmin(kc, axis=1)]
        else:
            k0 = (r_ * inv_p) % q_hat
        kP = k0 * P
        anchor_frac = (kP % Q).astype(np.float64) / Q
        kPQ = kP // Q
        W0 = np.round(x0_seg - anchor_frac).astype(np.int64) - kPQ
        e0 = x0_seg - W0.astype(np.float64) - kPQ.astype(np.float64) - anchor_frac
        rev_seg = rev_all[runs_ok][ridx]
        # forward-ramp segment [t, t+Li) maps to reverse dst frames
        # [d0 + L-t-Li, d0 + L-t) — segment v plays at u = L-1-(t+v)
        d0_t = np.where(rev_seg, L_o[ridx] - t - Li, t)
        gidx = runs_ok[ridx]
        nsub = -(-(k0 + Li) // Q)
        taylor_plans.extend(_RunPlan(
            trk=trk, d0=d0, L=Lv, sid=sid, c0=c0, k0=k0v, Pp=P, Qp=Q,
            nsub=ns, gain=gn, fis=fis, fii=fii, foe=foe, foi=foi,
            taylor=True, eps=eps, e0=e0v, rev=rv)
            for trk, d0, Lv, sid, c0, k0v, ns, gn, fis, fii, foe, foi, e0v, rv
            in zip(soa["trk"][gidx].tolist(), (soa["d0"][gidx] + d0_t).tolist(),
                   Li.tolist(), soa["sid"][gidx].tolist(), W0.tolist(),
                   k0.tolist(), nsub.tolist(), soa["gain"][gidx].tolist(),
                   soa["fis"][gidx].tolist(), soa["fii"][gidx].tolist(),
                   soa["foe"][gidx].tolist(), soa["foi"][gidx].tolist(),
                   e0.tolist(), rev_seg.tolist()))
        # per-segment window end for the device read guard (vectorized
        # twin of the old per-plan loop)
        base_seg = pool.channel_base[soa["sid"][gidx]].max(axis=1).astype(np.int64)
        tay_guard_parts.append(
            base_seg + W0 - (taps // 2 - 1) + (nsub - 1) * P + P + taps + 2)

    if fallback.any():
        if not partial:
            return None
        if not (cov.any() or taylor_plans):
            return None
        slow_mask = ~table.fast
        unc_rows = []
        for r in np.nonzero(fallback)[0]:
            lo, hi = int(soa["row_lo"][r]), int(soa["row_hi"][r])
            rows = np.arange(lo, hi + 1)
            unc_rows.append(rows[slow_mask[lo : hi + 1]])
        uncovered_rows = np.concatenate(unc_rows)
    else:
        uncovered_rows = None
    keep_runs = np.nonzero(cov)[0]
    soa = {k: v[keep_runs] for k, v in soa.items()}
    P_a, Q_a, s_a, Pinv_a, N0, rev_k = (
        a[keep_runs] for a in (P_a, Q_a, s_a, Pinv_a, N0, rev_all))

    k0_a = (N0 % Q_a * Pinv_a) % Q_a
    c0_a = (N0 - k0_a * P_a) // Q_a
    L_a = soa["end"] - soa["d0"]
    nsub_a = -(-(k0_a + L_a) // (_QF * s_a * Q_a))

    plans = [
        _RunPlan(trk=trk, d0=d0, L=L, sid=sid, c0=c0, k0=k0,
                 Pp=Pp, Qp=Qp, nsub=nsub,
                 gain=gain, fis=fis, fii=fii, foe=foe, foi=foi, rev=rev)
        for trk, d0, L, sid, c0, k0, Pp, Qp, nsub, gain, fis, fii, foe, foi, rev in zip(
            soa["trk"].tolist(), soa["d0"].tolist(), L_a.tolist(), soa["sid"].tolist(),
            c0_a.tolist(), k0_a.tolist(), (s_a * P_a).tolist(), (s_a * Q_a).tolist(),
            nsub_a.tolist(), soa["gain"].tolist(), soa["fis"].tolist(),
            soa["fii"].tolist(), soa["foe"].tolist(), soa["foi"].tolist(),
            rev_k.tolist())
    ]

    # group-major layout: one group per (kind, ratio); channel-major inside
    # (ratio key from the uniq table — a per-run Fraction here was ~30% of
    # the whole plan cost at 10k-run scale)
    by_shape: dict[tuple, list[_RunPlan]] = {}
    for i, p in enumerate(plans):
        key = ("exact", p.Pp, p.Qp, (int(P_a[i]), int(Q_a[i])))
        by_shape.setdefault(key, []).append(p)
    for p in taylor_plans:
        key = ("taylor", p.Pp, p.Qp, (p.Pp, p.Qp))
        by_shape.setdefault(key, []).append(p)
    ordered: list[_RunPlan] = []
    groups = []
    ext_off = 0
    for key in sorted(by_shape.keys()):
        runs = by_shape[key]
        kind, Pp, Qp, ratio_key = key
        # frames per sub-run buffer: exact sub-runs batch _QF canonical
        # window rows; taylor sub-runs are one canonical period each
        stride = Qp if kind == "taylor" else _QF * Qp
        if stride % 128:
            return None  # layout needs 128-aligned sub-run buffers
        n_sub_g = sum(p.nsub for p in runs)
        sub = 0
        for p in runs:
            p.sub0 = sub
            # channel-major: channel ch of sub-run j lives at
            # ext_origin + ext_base_of_group + (ch*n_sub_g + j)*stride
            p.ext_base = ext_off + sub * stride
            sub += p.nsub
        for p in runs:
            p.stride_group = n_sub_g * stride  # channel separation
        ordered.extend(runs)
        groups.append((kind, Pp, Qp, ratio_key, n_sub_g))
        ext_off += n_sub_g * stride * C

    # device read guard: the last sub-run's window may overshoot the pool
    # (vectorized over runs x channels)
    pool_len = pool.data.shape[0]
    pool_len += (-pool_len) % 128
    guard = 0
    if plans:
        Pp_a = s_a * P_a
        win_last = (pool.channel_base[soa["sid"]].astype(np.int64) + (
            c0_a - (half - 1) + (nsub_a - 1) * _QF * Pp_a)[:, None])
        guard = int(max(0, (win_last + ((_QF + 1) * Pp_a)[:, None]).max() - pool_len))
    if tay_guard_parts:
        guard = max(guard, int(np.concatenate(tay_guard_parts).max()) - pool_len)
    guard += (-guard) % 128
    return PrerenderPlan(runs=ordered, groups=groups, ext_len=ext_off,
                         guard=max(guard, 0), taps=taps, atten_db=float(atten_db),
                         uncovered_rows=uncovered_rows)



def _rewrite(table: SegmentTable, pool: SamplePool, plan: PrerenderPlan,
             ext_origin: int) -> tuple[SegmentTable, SamplePool]:
    """Replace slow rows with fast rows into the ext region; extend pool
    METADATA (data stays wherever the caller materialized it)."""
    C = pool.channel_base.shape[1]
    n_new = len(plan.runs)
    base_sid = pool.num_samples
    cb_new = np.zeros((n_new, C), dtype=np.int64)
    counts_new = np.zeros(n_new, dtype=np.int64)
    for i, p in enumerate(plan.runs):
        p.new_sid = base_sid + i
        for ch in range(C):
            cb_new[i, ch] = ext_origin + p.ext_base + ch * p.stride_group
        counts_new[i] = p.k0 + p.L

    keep = table.fast.copy()
    if plan.uncovered_rows is not None:
        keep[plan.uncovered_rows] = True  # partial plan: leave them slow

    def cat(a, vals, dt):
        return np.concatenate([a[keep], np.asarray(vals, dt)])

    runs = plan.runs
    # reverse runs were rendered as their mirrored FORWARD ramp: the row
    # reads the buffer backward (speed -1.0 from the last valid output) at
    # exact integer phases — bit-exact through the planned reverse slow
    # path (frac is exactly 0, so interpolation degenerates to the sample)
    table2 = SegmentTable(
        track=cat(table.track, [p.trk for p in runs], np.int32),
        dst_start=cat(table.dst_start, [p.d0 for p in runs], np.int32),
        length=cat(table.length, [p.L for p in runs], np.int32),
        sample_id=cat(table.sample_id, [p.new_sid for p in runs], np.int32),
        src_int=cat(table.src_int,
                    [p.k0 + p.L - 1 if p.rev else p.k0 for p in runs], np.int32),
        src_frac=cat(table.src_frac, [0.0] * len(runs), np.float64),
        speed=cat(table.speed, [-1.0 if p.rev else 1.0 for p in runs], np.float64),
        gain=cat(table.gain, [p.gain for p in runs], np.float32),
        fast=cat(table.fast, [not p.rev for p in runs], bool),
        clamp=cat(table.clamp, [False] * len(runs), bool),
        clip_id=cat(table.clip_id, [-1] * len(runs), np.int32),
        fin_start=cat(table.fin_start, [p.fis for p in runs], np.int32),
        fin_inv=cat(table.fin_inv, [p.fii for p in runs], np.float32),
        fout_end=cat(table.fout_end, [p.foe for p in runs], np.int32),
        fout_inv=cat(table.fout_inv, [p.foi for p in runs], np.float32),
        num_tracks=table.num_tracks, total_frames=table.total_frames,
        buffer_size=table.buffer_size,
    )
    order = np.lexsort((table2.dst_start, table2.track))
    table2 = SegmentTable(
        **{f: getattr(table2, f)[order] for f in (
            "track", "dst_start", "length", "sample_id", "src_int", "src_frac",
            "speed", "gain", "fast", "clamp", "clip_id",
            "fin_start", "fin_inv", "fout_end", "fout_inv")},
        num_tracks=table2.num_tracks, total_frames=table2.total_frames,
        buffer_size=table2.buffer_size,
    )
    if ext_origin + plan.ext_len + _GUARD >= 2**31:
        raise ValueError("prerendered pool exceeds int32 addressing")
    pool2 = SamplePool(
        data=pool.data,  # metadata extension only; see apply_prerender_*
        channel_base=np.concatenate(
            [pool.channel_base.astype(np.int64), cb_new]).astype(np.int32),
        counts=np.concatenate([pool.counts, counts_new]),
        rates=np.concatenate([pool.rates, np.full(n_new, 48000.0)]),
        index_of=dict(pool.index_of),
    )
    return table2, pool2


def _group_runs(plan: PrerenderPlan):
    """The runs of ``plan`` group by group (they lie in group-major order)."""
    i0 = 0
    for group in plan.groups:
        i1, acc = i0, 0
        while acc < group[4]:
            acc += plan.runs[i1].nsub
            i1 += 1
        yield group, plan.runs[i0:i1]
        i0 = i1


def restrict_plan(plan: PrerenderPlan, keep, channels: int) -> PrerenderPlan:
    """The plan of the runs ``r`` of ``plan`` with ``keep(r)``, laid out
    anew in the same group-major, channel-major order; the runs are copies.
    Each kept run renders the same buffer as in ``plan`` (at another place
    of a shorter extension), so a host reference too slow for a whole
    session (:func:`apply_prerender_host` in f64) can check a sample of
    it."""
    runs, groups, ext_off = [], [], 0
    for (kind, Pp, Qp, ratio_key, _), group_runs in _group_runs(plan):
        kept = [replace(r) for r in group_runs if keep(r)]
        if not kept:
            continue
        stride = Qp if kind == "taylor" else _QF * Qp
        n_sub_g = sum(r.nsub for r in kept)
        sub = 0
        for r in kept:
            r.sub0, r.ext_base, r.stride_group = sub, ext_off + sub * stride, n_sub_g * stride
            sub += r.nsub
        runs.extend(kept)
        groups.append((kind, Pp, Qp, ratio_key, n_sub_g))
        ext_off += n_sub_g * stride * channels
    return replace(plan, runs=runs, groups=groups, ext_len=ext_off)


def _group_starts(plan: PrerenderPlan, pool: SamplePool):
    """Per-group (starts [n_sub, C] int32, taylor_extras) — extras is
    (e0_sub f32 [n_sub], eps_sub f32 [n_sub]) for taylor groups, else None
    (host, vectorized)."""
    half = plan.taps // 2
    out = []
    for (kind, Pp, Qp, ratio_key, n_sub), runs in _group_runs(plan):
        nsub = np.array([p.nsub for p in runs], np.int64)
        sid = np.array([p.sid for p in runs], np.int64)
        c0 = np.array([p.c0 for p in runs], np.int64)
        parent = np.repeat(np.arange(len(runs)), nsub)
        j = np.arange(nsub.sum()) - np.repeat(np.cumsum(nsub) - nsub, nsub)
        base = pool.channel_base[sid[parent]].astype(np.int64)  # [n_sub, C]
        extras = None
        if kind == "taylor":
            # window advance per canonical period is exactly Pp source
            # samples; residual error at the period start is e0 + drift
            starts = base + (c0[parent] - (half - 1) + j * Pp)[:, None]
            k0 = np.array([p.k0 for p in runs], np.int64)[parent]
            e0 = np.array([p.e0 for p in runs], np.float64)[parent]
            eps = np.array([p.eps for p in runs], np.float64)[parent]
            e0_sub = e0 + (j * Qp - k0) * eps
            extras = (e0_sub.astype(np.float32), eps.astype(np.float32))
        else:
            starts = base + (c0[parent] - (half - 1) + j * (_QF * Pp))[:, None]
        assert starts.shape[0] == n_sub
        out.append((starts.astype(np.int32), extras))
    return out


def resolve_sinc_host(table: SegmentTable, pool: SamplePool):
    """HOST-side ``interpolation="sinc"`` front-end (renders whose pools
    live in host memory, and the reference of the device path): same
    dispatch as :func:`resolve_sinc_device` but the ext renders in NumPy
    and lands in ``pool.data``. Returns ``(table, pool, interp)`` — ``interp`` is
    "linear" when the prerender covers everything (rewritten rows play at
    speed ±1.0, exact under linear interpolation) or the poly-tap tuple
    when a pathological residue rode the oversample fallback."""
    if not len(table) or table.fast.all():
        return table, pool, "linear"
    pplan = plan_prerender(table, pool, partial=True)
    if pplan is None:
        return resolve_interpolation(table, pool, "sinc")
    interp = "linear"
    if pplan.uncovered_rows is not None:
        table, pool = oversample_slow_rows(table, pool, rows=pplan.uncovered_rows)
        interp = ("poly", design_poly_interp(OVERSAMPLE_FACTOR))
    table, pool = apply_prerender_host(table, pool, pplan)
    return table, pool, interp


def apply_prerender_host(table: SegmentTable, pool: SamplePool, plan: PrerenderPlan,
                         f64: bool = False):
    """NumPy twin of the device path (the tests' and the smoke test's
    reference): returns
    (table2, pool2) with pool2.data extended by the rendered runs.

    ``f64=True`` evaluates the banded products in float64 (the quality
    reference)."""
    C = pool.channel_base.shape[1]
    flat = pool.data
    if flat.shape[0] % 128:
        flat = np.pad(flat, (0, 128 - flat.shape[0] % 128))
    pool_len = flat.shape[0]
    flatg = np.pad(flat, (0, plan.guard)) if plan.guard else flat
    def _fetch(start: int, need: int) -> np.ndarray:
        # windows near sample 0 may start negative (half-1 pre-ring); the
        # device path pads with zeros there, and so does this
        seg = flatg[max(start, 0) : start + need]
        if start < 0:
            seg = np.pad(seg, (min(-start, need), 0))
        if seg.shape[0] < need:
            seg = np.pad(seg, (0, need - seg.shape[0]))
        return seg

    ext = np.zeros(plan.ext_len + _GUARD, dtype=np.float32)  # incl. tail guard
    ext_off = 0
    for (starts, extras), (kind, Pp, Qp, ratio_key, n_sub) in zip(
            _group_starts(plan, pool), plan.groups):
        if kind == "taylor":
            M3f, M3_64, d_b, Wb = _taylor_matrices(Pp, Qp, plan.taps, plan.atten_db)
            M3 = M3_64 if f64 else M3f
            BLK = _TAYLOR_BLK
            nblk = Qp // BLK
            stride = Qp
            need = d_b[-1] + Wb
            e0s, epss = extras
            m = np.arange(Qp, dtype=np.float64).reshape(nblk, BLK)
            for s in range(n_sub):
                E = np.float64(e0s[s]) + m * np.float64(epss[s])
                if not f64:
                    E = E.astype(np.float32)
                for ch in range(C):
                    seg = _fetch(int(starts[s, ch]), need)
                    Xb = np.stack([seg[db : db + Wb] for db in d_b])  # [nblk, Wb]
                    out = np.einsum("bw,bjw->bj", Xb.astype(M3.dtype), M3)
                    out = out.reshape(nblk, 3, BLK)
                    y = out[:, 0] + E * out[:, 1] + (0.5 * E * E) * out[:, 2]
                    o = ext_off + (ch * n_sub + s) * stride
                    ext[o : o + stride] = y.reshape(-1).astype(np.float32)
            ext_off += n_sub * stride * C
            continue
        Mf, M64 = _canonical_matrix(Pp, Qp, plan.taps, plan.atten_db, ratio_key)
        M = M64 if f64 else Mf
        stride = _QF * Qp
        need = (_QF + 1) * Pp
        for s in range(n_sub):
            for ch in range(C):
                seg = _fetch(int(starts[s, ch]), need)
                A = seg.reshape(_QF + 1, Pp)
                Xr = np.concatenate([A[:_QF], A[1:, : plan.taps]], axis=-1)
                y = (Xr.astype(M.dtype) @ M.T).reshape(-1)
                o = ext_off + (ch * n_sub + s) * stride
                ext[o : o + stride] = y.astype(np.float32)
        ext_off += n_sub * stride * C
    table2, pool2 = _rewrite(table, pool, plan, ext_origin=pool_len)
    pool2 = replace(pool2, data=np.concatenate([flat, ext]))
    return table2, pool2


#: cap on a prerender group's live window and einsum intermediates; groups
#: bigger than this render in sequential slabs of sub-runs, each written in
#: place into the extension, so peak memory is the extended pool plus one
#: slab. Swept by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 (700 W
#: limit) at 128 tracks x 60 s, exact groups / Taylor groups: 64 MiB 10.4 /
#: 79.6 ms, 256 MiB 9.5 / 55.1 ms, 1 GiB 8.8 / 49.0 ms, 8 GiB 8.6 / 45.7 ms,
#: peak card memory 2.2 / 3.3, 2.3 / 3.5, 3.0 / 4.2 and 4.5 / 9.6 GB. Small
#: slabs cost launches (the Taylor build is ~10 torch ops per slab), large
#: ones memory; 1 GiB is within 7 % of the unbounded time for 0.7 GB.
_EXT_SLAB_BYTES = 1024 * 1024 * 1024


def _ext_chunk(n_sub: int, per_sub_bytes: int) -> int:
    """Sub-runs per slab so one slab's intermediates stay under
    ``_EXT_SLAB_BYTES`` (at least one)."""
    return min(n_sub, max(1, _EXT_SLAB_BYTES // max(per_sub_bytes, 1)))


#: device-resident canonical matrices, keyed by (kind, P', Q', taps, atten,
#: ratio, device). They are pure functions of the ratio, tens of MB each at
#: large Q', so repeated renders reuse them instead of uploading them every
#: time. Bounded FIFO.
_DEVICE_MAT_CACHE: dict = {}
_DEVICE_MAT_CACHE_MAX = 16


def _device_matrix(kind: str, Pp: int, Qp: int, taps: int, atten_db: float, ratio_key,
                   device: torch.device) -> torch.Tensor:
    key = (kind, Pp, Qp, taps, atten_db, ratio_key, str(device))
    hit = _DEVICE_MAT_CACHE.get(key)
    if hit is not None:
        return hit
    if kind == "taylor":
        M, _, _, _ = _taylor_matrices(Pp, Qp, taps, atten_db)
    else:
        M, _ = _canonical_matrix(Pp, Qp, taps, atten_db, ratio_key)
    dev = torch.from_numpy(M).to(device)
    while len(_DEVICE_MAT_CACHE) >= _DEVICE_MAT_CACHE_MAX:
        _DEVICE_MAT_CACHE.pop(next(iter(_DEVICE_MAT_CACHE)))
    _DEVICE_MAT_CACHE[key] = dev
    return dev


def _device_group_args(plan: PrerenderPlan, pool: SamplePool, device: torch.device):
    """Per group ``(layout, operands)``: the static layout entry
    (``("exact", Pp, Qp, n_sub)`` or ``("taylor", P, Q, n_sub, Wb, d_b)``),
    the window starts ``[n_sub, C]`` as host int64 (the window fetch pads
    from them) and the matrix (+ the Taylor ``e0``/``eps`` per sub-run) on
    ``device``."""
    out = []
    for (starts, extras), (kind, Pp, Qp, ratio_key, n_sub) in zip(
            _group_starts(plan, pool), plan.groups):
        M = _device_matrix(kind, Pp, Qp, plan.taps, plan.atten_db, ratio_key, device)
        starts = starts.astype(np.int64)
        if kind == "taylor":
            _, _, d_b, Wb = _taylor_matrices(Pp, Qp, plan.taps, plan.atten_db)
            e0s, epss = (torch.from_numpy(a).to(device) for a in extras)
            out.append((("taylor", Pp, Qp, n_sub, Wb, d_b), (starts, M, e0s, epss)))
        else:
            out.append((("exact", Pp, Qp, n_sub), (starts, M)))
    return out


def _render_ext_body(pool_dev: torch.Tensor, groups, C: int, ext_len: int, taps: int) -> torch.Tensor:
    """The prerendered full pool, 1-D f32 on the pool's device:
    ``[pool padded to 128 | ext | tail guard]``.

    Windows are gathered from a strided view of the flat pool (``unfold``:
    row i is ``pool[i : i + W]``) at each sub-run's start, so a sub-run's
    operand is one index gather; windows that start before the pool or run
    past it read explicit zero padding (the JAX module pads the same
    zeros). One batched einsum per ratio group; its transposed batch
    ``[C, n_sub, F]`` IS the group's ext segment (channel-major layout) and
    is written in place, slab by slab."""
    dev = pool_dev.device
    pool_len = pool_dev.shape[0] + (-pool_dev.shape[0]) % 128
    full = torch.empty(pool_len + ext_len + _GUARD, dtype=torch.float32, device=dev)
    full[: pool_dev.shape[0]] = pool_dev
    full[pool_dev.shape[0] : pool_len] = 0.0
    full[pool_len + ext_len :] = 0.0  # fresh tail guard: slots may read past the last buffer

    # zero padding for windows that leave the base pool on either side
    lead = tail = 0
    for layout, (starts, *_) in groups:
        if layout[0] == "taylor":
            _, _, _, _, Wb, d_b = layout
            need = d_b[-1] + Wb
        else:
            need = (_QF + 1) * layout[1]
        lead = max(lead, -int(starts.min()))
        tail = max(tail, int(starts.max()) + need - pool_dev.shape[0])
    src = pool_dev
    if lead > 0 or tail > 0:
        src = torch.nn.functional.pad(pool_dev, (lead, max(tail, 0)))

    off = pool_len
    for layout, ga in groups:
        if layout[0] == "taylor":
            _, P, Q, n_sub, Wb, d_b = layout
            starts, M3, e0s, epss = ga
            BLK = _TAYLOR_BLK
            nblk = Q // BLK
            win = src.unfold(0, Wb, 1)
            d_bt = torch.tensor(d_b, dtype=torch.int64, device=dev)
            m = torch.arange(Q, dtype=torch.float32, device=dev).reshape(nblk, BLK)

            def slab(sT, e0c, epsc):
                # sT [C, n], e0c/epsc [n] -> y [C, n, Q]; block b of a
                # sub-run reads the window at start + d_b[b]
                Xb = win[sT[..., None] + d_bt]  # [C, n, nblk, Wb]
                with full_f32_matmul():
                    out = torch.einsum("csbw,bjw->csbj", Xb, M3)
                # orders 0/1/2 stacked along j: [C, n, nblk, 3, BLK]
                out = out.reshape(C, sT.shape[1], nblk, 3, BLK)
                E = e0c[:, None, None] + m[None] * epsc[:, None, None]
                return out[:, :, :, 0] + E * out[:, :, :, 1] + (0.5 * E * E) * out[:, :, :, 2]

            stride = Q
            per_sub = C * 4 * (2 * nblk * Wb + 2 * nblk * 3 * BLK + 2 * Q)
        else:
            _, Pp, Qp, n_sub = layout
            starts, M = ga
            W = Pp + taps
            win = src.unfold(0, W, 1)
            rows = torch.arange(_QF, dtype=torch.int64, device=dev) * Pp

            def slab(sT, e0c, epsc):
                # sT [C, n] -> y [C, n, QF, Qp]; window row q is the run's
                # own P' samples plus the next row's first `taps`
                Xr = win[sT[..., None] + rows]  # [C, n, QF, W]
                with full_f32_matmul():
                    return torch.einsum("csqw,jw->csqj", Xr, M)

            e0s = epss = None
            stride = _QF * Qp
            per_sub = C * 4 * (2 * _QF * W + 2 * _QF * Qp)
        sT = (torch.from_numpy(starts).to(dev) + lead).T.contiguous()  # [C, n_sub]
        seg = full[off : off + C * n_sub * stride].view(C, n_sub, stride)
        chunk = _ext_chunk(n_sub, per_sub)
        for s0 in range(0, n_sub, chunk):
            s1 = min(s0 + chunk, n_sub)
            y = slab(sT[:, s0:s1], None if e0s is None else e0s[s0:s1],
                     None if epss is None else epss[s0:s1])
            seg[:, s0:s1] = y.reshape(C, s1 - s0, stride)
        off += C * n_sub * stride
    assert off == pool_len + ext_len, (off, pool_len, ext_len)
    return full


def prerender_tables(table: SegmentTable, pool: SamplePool, plan: PrerenderPlan,
                     pool_device: torch.Tensor) -> tuple[SegmentTable, SamplePool]:
    """Metadata-only rewrite for the fused render path (no device work):
    the ext region's origin is the device pool's length, padded to 128."""
    n = int(pool_device.shape[0])
    return _rewrite(table, pool, plan, ext_origin=n + (-n) % 128)


def apply_prerender_device(table: SegmentTable, pool: SamplePool, plan: PrerenderPlan,
                           pool_device: torch.Tensor | None = None, device=None):
    """Render every run on the device and return
    ``(table2, pool2_meta, full_pool)``: the rewritten table, the pool's
    extended metadata (``pool2_meta.data`` is still the base pool) and the
    extended pool as a 1-D f32 device tensor that never visits the host.

    ``pool_device``: an existing device-resident base pool (repeated
    renders); default uploads ``pool.data`` to ``device`` (default: CUDA).
    Sets ``plan.ext_seconds``, the device time of the build."""
    if pool_device is None:
        pool_device = torch.from_numpy(np.ascontiguousarray(pool.data, dtype=np.float32)).to(
            resolve_device(device))
    if pool_device.dim() != 1 or pool_device.dtype != torch.float32:
        raise ValueError("pool_device must be a 1-D float32 tensor")
    C = pool.channel_base.shape[1]
    table2, pool2 = prerender_tables(table, pool, plan, pool_device)  # refuses >= 2**31 elements
    groups = _device_group_args(plan, pool, pool_device.device)
    from whitebox_tpu_torch.render.metrics import DeviceTimer  # render imports this module

    with DeviceTimer(pool_device.device) as timer:
        full = _render_ext_body(pool_device, groups, C, plan.ext_len, plan.taps)
    plan.ext_seconds = timer.seconds
    return table2, pool2, full


def render_prerendered_fused(plan: PrerenderPlan, pool: SamplePool, renderer,
                             pool_device: torch.Tensor) -> torch.Tensor:
    """Prerender the runs AND run the mix kernel with no host
    synchronisation between them (the JAX module's single jitted program;
    here the extension's torch ops and the kernel launch follow each other
    on the current stream). ``renderer``: a ``CudaMixRenderer`` built on the
    rewritten table (:func:`prerender_tables`) with ``pool_device``; its
    pool is replaced by the extended one. Returns the device output
    ``[C, n_tiles*tile]``."""
    from whitebox_tpu_torch.ops.mix_cuda import mix
    from whitebox_tpu_torch.ops.mix_plan import check_pool_bounds

    C = pool.channel_base.shape[1]
    groups = _device_group_args(plan, pool, pool_device.device)
    full = _render_ext_body(pool_device, groups, C, plan.ext_len, plan.taps)
    check_pool_bounds(renderer.plan, full.shape[0], renderer.interp)
    p = renderer.plan
    return mix(full, renderer.tables, p.n_tiles, p.tile, p.channels, auto=renderer.auto,
               interp=renderer.interp)


def resolve_sinc_device(table: SegmentTable, pool: SamplePool, device=None):
    """Shared ``interpolation="sinc"`` front-end for the kernel path; the
    counterpart of the JAX module's ``resolve_sinc_pallas``.

    Pre-renders every coverable resampled run (forward AND reverse) with
    the exact/Taylor polyphase products into a speed-1 pool extension on
    ``device``; the residue (pathological ratios, speeds > 8) is oversampled
    4x and plays through the LS-optimal 6-tap slots. Returns
    ``(table, pool, interp, pool_device, pplan)`` where ``pplan`` is None
    when no run qualified (the whole session took the oversample form, and
    ``pool_device`` is None: the caller uploads ``pool.data``)."""
    pplan = plan_prerender(table, pool, partial=True)
    if pplan is None:
        table, pool, interp = resolve_interpolation(table, pool, "sinc")
        return table, pool, interp, None, None
    interp = "linear"
    if pplan.uncovered_rows is not None:
        # mixed session: rational/Taylor runs ride the exact polyphase
        # path; the residue plays from the oversampled fallback pool at
        # U*speed through the poly-tap slots
        table, pool = oversample_slow_rows(table, pool, rows=pplan.uncovered_rows)
        interp = ("poly", design_poly_interp(OVERSAMPLE_FACTOR))
        _log.debug("sinc prerender: partial, %d residual rows via oversample fallback",
                   len(pplan.uncovered_rows))
    table, pool, full = apply_prerender_device(table, pool, pplan, device=device)
    _log.debug("sinc prerender: %d runs -> fast rows", len(pplan.runs))
    return table, pool, interp, full, pplan
