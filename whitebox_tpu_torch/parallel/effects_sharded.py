"""Frame-sharded effect chains: the whole effect family with exact
cross-shard state handoff.

Counterpart of ``whitebox_tpu/parallel/effects_sharded.py``. Every effect
carries chunk-boundary state; here that property becomes frame
parallelism across ranks: each shard processes its frames from a zero
state, the shards exchange O(summary) state over the frames axis
(``parallel/collectives.py``), and each shard folds its predecessors'
summaries into its exact incoming state, which it injects:

- one-pole smoothers: affine summaries ``(a^F, y_last)``, linear injection;
- max-decay peak detectors: max-plus summaries ``(rho^F, e_last)``,
  injection ``max(e_local, rho^(n+1) * z_in)``;
- feedback combs (delay): the shard-to-shard map of the ``D``-tap tail is
  a scaled permutation (closed form from ``F_local``, ``D``, ``fb``;
  ping-pong folds the channel swap's parity into it); the comb runs again
  from the folded tail;
- modulated taps (chorus/flanger) and the limiter's lookahead: a bounded
  dry/level tail from the previous shard;
- convolution reverb: each shard convolves locally and its ``L-1``-frame
  spill reaches ``ceil((L-1)/F_local)`` shards ahead;
- static biquad/EQ sections: ``parallel/biquad_sharded.py`` (the cascade
  kernel in two passes on the card, the Hillis-scan injection on the
  CPU); time-varying ones exchange their span transitions and run again
  from the exact incoming state.

On the card a shard's recurrences run :data:`SHARD_CHUNK` frames at a time
with their state carried (the finisher's ``CUDA_CHUNK_CAP``), which bounds
the prefix scans' temporaries: a 15 s stereo shard of 128 tracks is
``[256, 720000]``, and a whole-shard scan holds about twenty levels of such
temporaries. On the CPU a shard runs at once, as the JAX package runs it.
The summary exchange happens once per recurrence, on the shard's final
summary. Equal to the single-device stream up to f32 rounding of the
injection terms.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.effects.reverb import fft_convolve_chunk, ir_spectrum
from whitebox_tpu_torch.ops import delay as dl
from whitebox_tpu_torch.ops.automation import eval_lanes
from whitebox_tpu_torch.ops.biquad import (
    PARAM_BLOCK, BiquadType, biquad_scan_blocked_tv, design_biquad_device, tv_section_params,
)
from whitebox_tpu_torch.ops.dynamics import (
    _LOG10_20, _level_db, _window_max, compressor_reduction_db, gate_open_gain,
    limiter_reduction_db, maxdecay_scan_t, onepole_scan_t,
)
from whitebox_tpu_torch.parallel.biquad_sharded import biquad_shard_framewise, cascade_shard_framewise
from whitebox_tpu_torch.parallel.collectives import all_gather, axis, gather_frames, shift
from whitebox_tpu_torch.render.effects_generic import (
    _LN10_20, CUDA_CHUNK_CAP, GenericFX, _cascade_coeffs, _db_to_lin_dev, _Group, _stage_kind,
    _stage_params, _time_coef_dev, _tv_vals, device_params,
)

#: frames a shard's recurrences run at a time, by device type (None: the
#: whole shard at once); a multiple of PARAM_BLOCK
SHARD_CHUNK = {"cuda": CUDA_CHUNK_CAP, "cpu": None}


def _chunk(x: torch.Tensor) -> int:
    c = SHARD_CHUNK.get(x.device.type)
    F = x.shape[-1]
    return F if c is None else min(int(c), F)


def _spans(F: int, chunk: int):
    return [(a, min(a + chunk, F)) for a in range(0, F, chunk)]


def _frames_of(v, a: int, b: int, F: int):
    """A coefficient's frames [a, b): per-frame lanes ``[..., F]`` sliced,
    constants (scalars, ``[..., 1]``) as they are."""
    if torch.is_tensor(v) and v.dim() and v.shape[-1] == F and F > 1:
        return v[..., a:b]
    return v


def _scan_from_zero(scan_t, x, coef):
    """``scan_t`` (``onepole_scan_t`` / ``maxdecay_scan_t``) over ``x`` from
    a zero state, chunk by chunk with the state carried -> (the output, the
    cumulative transition over the whole shard)."""
    F = x.shape[-1]
    chunk = _chunk(x)
    zero = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    if chunk >= F:
        y0, _, m = scan_t(x, coef, zero)
        return y0, m
    y0, m = torch.empty_like(x), torch.empty_like(x)
    s, M = zero, torch.ones_like(zero)
    for a, b in _spans(F, chunk):
        yk, s, mk = scan_t(x[..., a:b], _frames_of(coef, a, b, F), s)
        y0[..., a:b] = yk
        m[..., a:b] = M[..., None] * mk
        M = m[..., b - 1].clone()
    return y0, m


def onepole_shard(x, a, axis_name, fp: int):
    """Frame-sharded one-pole smoother y[n] = a*y[n-1] + (1-a)*x[n]."""
    ax = axis(axis_name)
    y0, m = _scan_from_zero(onepole_scan_t, x, a)
    m_all = all_gather(m[..., -1], ax)
    v_all = all_gather(y0[..., -1], ax)
    z_in = torch.zeros_like(v_all[0])
    for j in range(min(ax.index, fp)):  # z <- m_j*z + v_j over the predecessors
        z_in = m_all[j] * z_in + v_all[j]
    return y0 + m * z_in[..., None]


def maxdecay_shard(v, rho, axis_name, fp: int):
    """Frame-sharded peak detector e[n] = max(v[n], rho*e[n-1])."""
    ax = axis(axis_name)
    e0, dd = _scan_from_zero(maxdecay_scan_t, v, rho)
    d_all = all_gather(dd[..., -1], ax)
    e_all = all_gather(e0[..., -1], ax)
    z_in = torch.zeros_like(e_all[0])
    for j in range(min(ax.index, fp)):  # max-plus affine: z <- max(d_j * z, e_j)
        z_in = torch.maximum(d_all[j] * z_in, e_all[j])
    return torch.maximum(e0, dd * z_in[..., None])


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------


def compressor_shard(x, params, axis_name, fp: int, detector: str = "peak", key=None):
    """x_local [B, C, F_local] -> compressed local frames (exact handoff).

    ``key``: external sidechain detector shard (same layout as x)."""
    det_src = x if key is None else key
    if detector == "rms":
        p = torch.mean(torch.square(det_src), dim=-2)
        avg = onepole_shard(p, params.get("det_avg", 0.0), axis_name, fp)
        lvl = torch.sqrt(torch.clamp(avg, min=0.0))
    else:
        lvl = torch.abs(det_src).amax(dim=-2)
    r_db = compressor_reduction_db(_level_db(lvl), params["threshold_db"], params["ratio"],
                                   params["knee_db"])
    held = maxdecay_shard(r_db, params["release"], axis_name, fp)
    smooth = onepole_shard(held, params["attack"], axis_name, fp)
    gain = torch.exp((params["makeup_db"] - smooth) / _LOG10_20)
    return x * gain[..., None, :]


def limiter_shard(x, params, axis_name, fp: int, lookahead: int = 0):
    lvl = torch.abs(x).amax(dim=-2)
    r_db = limiter_reduction_db(_level_db(lvl), params["ceiling_db"])
    xd = x
    F = x.shape[-1]
    if lookahead > 0:
        assert F >= lookahead, "shard must be at least the lookahead long"
        look = shift(r_db[..., -lookahead:].contiguous(), axis_name)
        seq = torch.cat([look, r_db], dim=-1)
        r_db = _window_max(seq, lookahead + 1)[..., :F]
        xtail = shift(x[..., -lookahead:].contiguous(), axis_name)
        xd = torch.cat([xtail, x], dim=-1)[..., :F]
    held = maxdecay_shard(r_db, params["release"], axis_name, fp)
    smooth = onepole_shard(held, params["attack"], axis_name, fp)
    return xd * torch.exp(-smooth / _LOG10_20)[..., None, :]


def gate_shard(x, params, axis_name, fp: int, key=None):
    lvl = torch.abs(x if key is None else key).amax(dim=-2)
    tgt = gate_open_gain(_level_db(lvl), params["threshold_db"], params["range_db"],
                         params.get("hyst_db", 0.0))
    floor = torch.exp(-torch.abs(torch.as_tensor(params["range_db"], dtype=torch.float32,
                                                 device=x.device)) / _LOG10_20)
    held = torch.maximum(maxdecay_shard(tgt, params["release"], axis_name, fp), floor)
    smooth = onepole_shard(held, params["attack"], axis_name, fp)
    return x * smooth[..., None, :]


# ---------------------------------------------------------------------------
# delay family
# ---------------------------------------------------------------------------


def _comb_tail_map(F_local: int, D: int):
    """The shard-to-shard map of the comb's D-tap tail: after F_local frames,
    tail_out[m] = fb^k(m) * tail_in[src(m)] (channel-swapped k times for
    ping-pong). Closed form: static numpy arrays."""
    m = np.arange(D)
    src = (F_local + m) % D
    k = (F_local - D + m) // D + 1
    return src.astype(np.int64), k.astype(np.float32), (k % 2).astype(bool)


def _comb_run(comb, x, fb, w0, x0, D: int, keep_output: bool = True):
    """The comb over the shard chunk by chunk, tails carried -> (w or None,
    the wet tail after the shard)."""
    F = x.shape[-1]
    w = torch.empty_like(x) if keep_output else None
    wl, xl = w0, x0
    for a, b in _spans(F, _chunk(x)):
        wk, wl, xl = comb(x[..., a:b], fb, wl, xl, D=D)
        if keep_output:
            w[..., a:b] = wk
    return w, wl


def delay_shard(x, params, axis_name, fp: int, D: int, mode: str = "stereo"):
    """Frame-sharded feedback comb delay (stereo or ping-pong)."""
    ax = axis(axis_name)
    B, C, F_local = x.shape
    assert F_local >= D, "shard must be at least the delay length long"
    fb4 = params["feedback"][:, None, None, None]
    fb3 = params["feedback"][:, None, None]
    x0 = shift(x[..., -D:].contiguous(), ax)
    zero_w = torch.zeros((B, C, D), dtype=torch.float32, device=x.device)
    pingpong = mode == "pingpong" and C == 2
    comb = dl.comb_feedback_pingpong if pingpong else dl.comb_feedback

    # the local wet from a zero tail: its out-tail is the shard's b_j summary
    _, b_j = _comb_run(comb, x, fb4, zero_w, x0, D, keep_output=False)
    b_all = all_gather(b_j, ax)  # [fp, B, C, D]

    src, k, k_odd = _comb_tail_map(F_local, D)
    k_t = torch.from_numpy(k).to(x.device)
    odd = torch.from_numpy(k_odd).to(x.device)
    # |fb|^k with the sign restored by k's parity (a float power of a
    # negative base is NaN); 0^0 == 1 keeps the k == 0 slide-through rows exact
    mag = torch.abs(fb3) ** k_t  # [B, 1, D]
    pw = torch.where((fb3 < 0.0) & odd, -mag, mag)
    src_t = torch.from_numpy(src).to(x.device)

    def A(z):
        g = z[..., src_t]
        return pw * (torch.where(odd, g.flip(-2), g) if pingpong else g)

    w0 = torch.zeros_like(b_j)
    for j in range(min(ax.index, fp)):
        w0 = A(w0) + b_all[j]
    w, _ = _comb_run(comb, x, fb4, w0, x0, D)
    return params["dry"][:, None, None] * x + params["wet"][:, None, None] * w


def chorus_shard(x, params, axis_name, fp: int, voices: int, max_delay: int, sample_rate: float,
                 chunk_start=0):
    """Frame-sharded feedforward chorus/flanger: exact (pure gathers; the
    dry tail comes from the previous shard, the LFO phase from the global
    frame index)."""
    ax = axis(axis_name)
    B, C, F_local = x.shape
    assert F_local >= max_delay, "shard must be at least max_delay long"
    xtail = shift(x[..., -max_delay:].contiguous(), ax)
    n0 = int(chunk_start) + ax.index * F_local
    two_pi = 2.0 * np.pi
    acc = torch.zeros_like(x)
    spans = _spans(F_local, _chunk(x))
    for v in range(voices):
        phases = torch.tensor([two_pi * v / voices + c * (0.5 * np.pi) for c in range(C)],
                              dtype=torch.float32, device=x.device)[:, None]
        tail = xtail
        for a, b in spans:
            d = dl.lfo_delay_frames(n0 + a, b - a, depth_frames=params["depth"][:, None, None],
                                    center_frames=params["center"][:, None, None], phase=phases,
                                    rate_splits=params["rate_splits"][:, None, None, :])
            tap, tail = dl.modulated_tap(x[..., a:b], d, tail, max_delay=max_delay)
            acc[..., a:b] = acc[..., a:b] + tap
    wet = params["wet"][:, None, None] / float(voices)
    return params["dry"][:, None, None] * x + wet * acc


def convreverb_shard(x, params, axis_name, fp: int, ir_len: int):
    """Frame-sharded FIR convolution: the local overlap-add from a zero
    carry; the (ir_len-1)-frame spill reaches ceil((ir_len-1)/F_local)
    shards ahead. Exact."""
    ax = axis(axis_name)
    B, C, F_local = x.shape
    L = ir_len
    chunk = _chunk(x)
    ir_f = ir_spectrum(params["ir"], chunk)
    carry = torch.zeros((B, C, L - 1), dtype=torch.float32, device=x.device)
    wet = torch.empty_like(x)
    for a, b in _spans(F_local, chunk):
        wet[..., a:b], carry = fft_convolve_chunk(x[..., a:b], ir_f, L, carry)
    hops = -(-(L - 1) // F_local)
    if fp > 1:
        spills = all_gather(carry, ax)  # every shard's local spill [fp, B, C, L-1]
        for h in range(1, min(hops, fp - 1) + 1):
            if ax.index >= h:
                seg = spills[ax.index - h][..., (h - 1) * F_local: h * F_local]
                wet[..., :seg.shape[-1]] = wet[..., :seg.shape[-1]] + seg
    return params["dry"][:, None, None] * x + params["wet"][:, None, None] * wet


# ---------------------------------------------------------------------------
# chain dispatch (mirrors render/effects_generic stage kinds)
# ---------------------------------------------------------------------------


def _biquad_rows_shard(x, pa_rows, axis_name, fp: int):
    """One batched biquad section on ``[R, F_local]`` rows (``pa_rows``
    ``[R, 9]``): the cascade kernel's two passes on the card, the scan
    injection on the CPU."""
    if x.device.type == "cuda":
        return cascade_shard_framewise(x, pa_rows.t()[:, None, :, None].contiguous(), axis_name, fp)
    return biquad_shard_framewise(x, [pa_rows[:, j:j + 1] for j in range(9)], axis_name, fp)


def _tv_biquad_rows_shard(ftype, freq, q, gain_db, x_rows, axis_name, fp: int, sample_rate: float,
                          C: int):
    """Frame-sharded time-varying biquad (timed coefficient automation):
    each shard runs the blocked TV scan from zero, the shards exchange
    their z-coordinate transitions (``Tz [R, 2, 2]``, ``v [R, 2]``), and the
    scan runs again from the true incoming state, chunk by chunk.
    freq/q/gain_db: ``[B, K_local]``."""
    ax = axis(axis_name)
    d = design_biquad_device(BiquadType(ftype), freq, q, gain_db, sample_rate)
    p9, P, Pinv, aux = tv_section_params(d)
    R, F = x_rows.shape
    chunk = max(_chunk(x_rows) // PARAM_BLOCK, 1) * PARAM_BLOCK

    def rep(a):  # [B, K, ...] -> [R, K, ...]
        return a.repeat_interleave(C, dim=0)

    def run(z, keep_output: bool):
        ys, T = [], None
        for a, b in _spans(F, chunk):
            ka, kb = a // PARAM_BLOCK, b // PARAM_BLOCK
            res = biquad_scan_blocked_tv(x_rows[:, a:b], [rep(p[:, ka:kb]) for p in p9],
                                         rep(P[:, ka:kb]), rep(Pinv[:, ka:kb]), z,
                                         aux={k: rep(v[:, ka:kb]) for k, v in aux.items()},
                                         return_injection=not keep_output)
            if keep_output:
                y, z = res
                ys.append(y)
            else:
                _, z, Tz, _ = res
                T = Tz if T is None else torch.einsum("rij,rjk->rik", Tz, T)
        return (torch.cat(ys, dim=-1) if keep_output else T), z

    zero = torch.zeros((R, 2), dtype=torch.float32, device=x_rows.device)
    T_total, v_total = run(zero, keep_output=False)
    Tz_all = all_gather(T_total, ax)
    v_all = all_gather(v_total, ax)
    z_in = zero
    for j in range(min(ax.index, fp)):
        z_in = torch.einsum("rij,rj->ri", Tz_all[j], z_in) + v_all[j]
    y, _ = run(z_in, keep_output=True)
    return y


def _eval_shard_lanes(kind: str, params, n0: int, F_local: int):
    """Evaluate a stage's lane tables on this shard's global frame range
    (mirrors ``effects_generic._eval_stage_lanes``; n0 = shard start frame)."""
    auto_tab = params.get("auto")
    if not auto_tab:
        return {}
    dev = next(iter(next(iter(auto_tab.values())).values())).device
    if kind in ("biquad", "eq"):
        g = n0 + torch.arange(max(F_local // PARAM_BLOCK, 1), dtype=torch.int32, device=dev) * PARAM_BLOCK
    else:
        g = n0 + torch.arange(F_local, dtype=torch.int32, device=dev)
    return {name: eval_lanes(tab, g) for name, tab in auto_tab.items()}


def _static_cascade(params, kind: str, C: int) -> torch.Tensor:
    """The cascade coefficients ``[9, S, B*C, 1]`` of a static biquad/EQ
    stage (``device_params`` keeps them as "casc")."""
    if "casc" in params:
        return params["casc"]
    pa = params["pa"] if kind == "eq" else params["pa"][:, None, :]
    return _cascade_coeffs(pa, C)


def stage_shard(kind: str, static: tuple, params, x, axis_name, fp: int, sample_rate: float,
                chunk_start=0, key=None):
    """Apply one effect stage to a frame shard x [B, C, F_local].

    Stages with "auto" lane tables in ``params`` evaluate them at this
    shard's *global* frame positions, so sharded automation matches the
    single-device render (biquad/EQ require F_local to be a multiple of
    PARAM_BLOCK so shard-local param blocks align with the global grid)."""
    ax = axis(axis_name)
    B, C, F_local = x.shape

    def col(a):
        return a[:, None]

    n0 = int(chunk_start) + ax.index * F_local
    lanes = _eval_shard_lanes(kind, params, n0, F_local)

    def mix_coef(name):
        return lanes[name][:, None, :] if name in lanes else params[name][:, None, None]

    if kind == "gain":
        if "gain_db" in lanes:
            return x * _db_to_lin_dev(lanes["gain_db"])[:, None, :]
        return x * params["g"][:, None, None]
    if kind in ("biquad", "eq") and not (static if kind == "biquad" else
                                         len(static) > 1 and isinstance(static[1], tuple)):
        rows = x.reshape(B * C, F_local)
        if x.device.type == "cuda":  # every section in one cascade, two kernel passes
            y = cascade_shard_framewise(rows, _static_cascade(params, kind, C), ax, fp)
            return y.reshape(B, C, F_local)
        pa = params["pa"] if kind == "eq" else params["pa"][:, None, :]
        for b in range(pa.shape[1]):
            rows = _biquad_rows_shard(rows, pa[:, b].repeat_interleave(C, dim=0), ax, fp)
        return rows.reshape(B, C, F_local)
    if kind == "biquad":  # TV form: static == (ftype_value,)
        assert F_local % PARAM_BLOCK == 0, "TV-biquad shards must be PARAM_BLOCK-aligned"
        K = F_local // PARAM_BLOCK
        y = _tv_biquad_rows_shard(static[0], _tv_vals(lanes, params, "freq_hz", "freq", K),
                                  _tv_vals(lanes, params, "q", "q", K),
                                  _tv_vals(lanes, params, "gain_db", "gain_db", K),
                                  x.reshape(B * C, F_local), ax, fp, sample_rate, C)
        return y.reshape(B, C, F_local)
    if kind == "eq":  # TV form
        assert F_local % PARAM_BLOCK == 0, "TV-EQ shards must be PARAM_BLOCK-aligned"
        K = F_local // PARAM_BLOCK
        y = x.reshape(B * C, F_local)
        for b in range(static[0]):
            y = _tv_biquad_rows_shard(static[1][b], _tv_vals(lanes, params, f"b{b}.freq_hz", "freq", K, band=b),
                                      _tv_vals(lanes, params, f"b{b}.q", "q", K, band=b),
                                      _tv_vals(lanes, params, f"b{b}.gain_db", "gain_db", K, band=b),
                                      y, ax, fp, sample_rate, C)
        return y.reshape(B, C, F_local)
    if kind in ("compressor", "limiter", "gate"):
        p = {k: col(v) for k, v in params.items() if k != "auto"}
        for nm in ("threshold_db", "ratio", "knee_db", "makeup_db", "ceiling_db", "range_db"):
            if nm in lanes:
                p[nm] = lanes[nm]
        if "attack_s" in lanes:
            p["attack"] = _time_coef_dev(lanes["attack_s"], sample_rate)
        if "release_s" in lanes:
            p["release"] = _time_coef_dev(lanes["release_s"], sample_rate)
        if key is None:
            key = torch.zeros_like(x)  # a sidechain with nothing routed hears silence
        if kind == "compressor":
            detector, sc = static
            return compressor_shard(x, p, ax, fp, detector, key=key if sc else None)
        if kind == "limiter":
            (L,) = static
            return limiter_shard(x, p, ax, fp, L)
        (sc,) = static
        return gate_shard(x, p, ax, fp, key=key if sc else None)
    if kind == "delay":
        mode, D = static
        w = delay_shard(x, dict(params, dry=torch.zeros_like(params["dry"]),
                                wet=torch.ones_like(params["wet"])), ax, fp, D, mode)
        return mix_coef("dry") * x + mix_coef("wet") * w
    if kind in ("chorus", "flanger"):
        voices, MT = static
        wetsig = chorus_shard(x, dict(params, dry=torch.zeros_like(params["dry"]),
                                      wet=torch.full_like(params["wet"], float(voices))),
                              ax, fp, voices, MT, sample_rate, chunk_start)
        return mix_coef("dry") * x + (mix_coef("wet") / float(voices)) * wetsig
    if kind == "convreverb":
        (L,) = static
        wetsig = convreverb_shard(x, dict(params, dry=torch.zeros_like(params["dry"]),
                                          wet=torch.ones_like(params["wet"])), ax, fp, L)
        return mix_coef("dry") * x + mix_coef("wet") * wetsig
    if kind == "linphase":
        (L,) = static
        one = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
        return convreverb_shard(x, dict(params, dry=torch.zeros_like(one), wet=one), ax, fp, L)
    if kind == "saturator":
        if "drive_db" in lanes:
            drive = torch.exp(_LN10_20 * lanes["drive_db"])[:, None, :]
            norm = 1.0 / torch.tanh(drive)
        else:
            drive = params["drive"][:, None, None]
            norm = params["norm"][:, None, None]
        shaped = torch.tanh(drive * x) * norm
        m = mix_coef("mix")
        return m * shaped + (1.0 - m) * x
    if kind == "width":
        if C != 2:
            return x
        w = lanes["width"] if "width" in lanes else params["width"][:, None]
        mid = 0.5 * (x[:, 0, :] + x[:, 1, :])
        side = 0.5 * (x[:, 0, :] - x[:, 1, :]) * w
        return torch.stack([mid + side, mid - side], dim=1)
    raise ValueError(f"unknown effect kind {kind!r}")


def chain_shard(stages, params_list, x, axis_name, fp: int, sample_rate: float, chunk_start=0, key=None):
    """Apply a whole chain (``effects_generic``-style (kind, static) stages +
    aligned params) to a frame shard. ``key``: sidechain detector shard
    delivered to every sidechain-flagged dynamics stage in the chain."""
    for (kind, static), params in zip(stages, params_list):
        x = stage_shard(kind, static, params, x, axis_name, fp, sample_rate, chunk_start, key=key)
    return x


def chain_group(effects, rate: float, channels: int):
    """An effect list prepared as one ``B == 1`` group of stages (the JAX
    package's explicit master list), or None when empty."""
    for e in effects:
        e.prepare(rate, channels)
    stages = []
    for e in effects:
        kind, static = _stage_kind(e)
        stages.append((kind, static, {k: np.stack([v]) for k, v in _stage_params(e, kind).items()}))
    return _Group(np.asarray([0], np.int64), stages) if stages else None


def chain_program(effects, rate: float, channels: int, device):
    """(stages, params on ``device``) of an effect list, one row each, for
    :func:`chain_shard`."""
    g = chain_group(effects, rate, channels)
    _, mp = device_params(GenericFX(master=g, sample_rate=rate, channels=channels), device)
    return [(k, s) for (k, s, _) in g.stages], mp


def apply_chain_sharded(effects, x, mesh, sample_rate: float, *, frames_axis: str = "frames",
                        channels: int | None = None):
    """Apply an ``Effect`` list to ``x`` ``[C, F]`` (the same tensor on every
    rank) with the frames axis sharded over ``mesh``, the multi-device
    master-bus finisher -> ``[C, F]`` on every rank, on the rank's device.

    Prepares each effect (:func:`chain_program`), runs
    :func:`chain_shard` on this rank's frame shard and gathers the
    shards. F must divide by the mesh's frames-axis size, and each shard
    must be longer than any effect's intrinsic horizon (delay length, IR
    spill, limiter lookahead)."""
    C = int(x.shape[0]) if channels is None else channels
    stages, params = chain_program(effects, float(sample_rate), C, mesh.device)
    ax = mesh.axis(frames_axis)
    F = x.shape[-1]
    if F % ax.size:
        raise ValueError(f"{F} frames do not divide over {ax.size} frame shards")
    f_local = F // ax.size
    xl = torch.as_tensor(x, dtype=torch.float32)[..., ax.index * f_local:(ax.index + 1) * f_local]
    y = chain_shard(stages, params, xl.to(mesh.device)[None].contiguous(), ax, ax.size, sample_rate)
    return gather_frames(y[0], ax)
