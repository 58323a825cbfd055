"""Generic effects finishing: heterogeneous (nonlinear, long-memory) chains.

Counterpart of ``whitebox_tpu/render/effects_generic.py``. The linear
finishers (``effects_pipeline``, ``effects_fir``) take only chains of
``Gain``/``Biquad``/``ParametricEQ``; sessions with the wider family
(dynamics, delays, chorus/flanger, convolution reverb, shaping,
linear-phase EQ, registered user effects) or with effect-parameter lanes
finish here:

- tracks are grouped by chain signature (the sequence of stage kinds and
  static configs, plus the automated parameter names); each group's
  per-effect parameters stack into ``[B]``-leading tensors, so one pass
  of torch ops processes all B tracks of the group;
- the timeline streams chunk by chunk (a Python loop where the JAX
  package runs a jitted ``lax.scan``); every stage carries exact
  chunk-boundary state, so the chunked stream equals a one-shot render;
- gains, the ordered track sum, the master chain, the hard clip and the
  meters mirror ``finish_mix`` (track.cpp:728-733, engine.cpp:1627).

Static ``biquad``/``eq`` stages run through ``ops/biquad_cuda.py::
biquad_cascade``: the hand CUDA kernel on the card, the per-section
prefix scan (what the JAX package runs) on the CPU. Every other stage is
torch ops (Hillis prefix scans for the recurrences). The f64 host oracles
``reference_run_chain`` and ``reference_generic_finish`` are the JAX
package's, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as tF
from torch.profiler import record_function

from whitebox_tpu_torch.effects import (
    Biquad, Chorus, Compressor, ConvolutionReverb, Delay, EffectChain, Gain, Limiter,
    LinearPhaseEQ, NoiseGate, ParametricEQ, Saturator, StereoWidth,
)
from whitebox_tpu_torch.effects.registry import UnknownEffect, lookup_effect, type_name_of
from whitebox_tpu_torch.effects.reverb import fft_convolve_chunk, ir_spectrum
from whitebox_tpu_torch.ops import delay as dl
from whitebox_tpu_torch.ops import dynamics as dyn
from whitebox_tpu_torch.ops.automation import (
    eval_lane_numpy, eval_lanes, lane_frame_table, pack_lane_tables, pack_session_automation,
    session_has_automation, session_has_effect_automation,
)
from whitebox_tpu_torch.ops.biquad import (
    PARAM_BLOCK, BiquadType, biquad_scan_blocked_tv, biquad_sequential, biquad_sequential_tv,
    coeffs_device_arrays, design_biquad_device, tv_section_params,
)
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade
from whitebox_tpu_torch.render.effects_pipeline import (
    _chains_of, _frame_gains, _ordered_sum, meters_from_partials,
)

_PACKABLE = ("gain", "biquad", "eq")

#: raw automatable parameter names per effect kind (a plugin's parameter
#: list, plugin_interface.h:77-90). Elementwise params evaluate per frame;
#: biquad/EQ design params per PARAM_BLOCK frames, the coefficients
#: redesigned on the device. EQ band params are "b{i}.{name}".
AUTOMATABLE: dict[str, frozenset] = {
    "gain": frozenset({"gain_db"}),
    "biquad": frozenset({"freq_hz", "q", "gain_db"}),
    "compressor": frozenset({"threshold_db", "ratio", "knee_db", "makeup_db",
                             "attack_s", "release_s"}),
    "limiter": frozenset({"ceiling_db", "attack_s", "release_s"}),
    "gate": frozenset({"threshold_db", "range_db", "attack_s", "release_s"}),
    "delay": frozenset({"wet", "dry"}),
    "chorus": frozenset({"wet", "dry"}),
    "flanger": frozenset({"wet", "dry"}),
    "convreverb": frozenset({"wet", "dry"}),
    "saturator": frozenset({"drive_db", "mix"}),
    "width": frozenset({"width"}),
}


def automatable_params(kind: str, static: tuple = ()) -> frozenset:
    """Raw automatable names of one effect kind ("eq" expands per band;
    a registered class lists its own in an ``automatable`` attribute)."""
    if kind == "eq":
        (nb,) = static[:1]
        return frozenset(f"b{i}.{n}" for i in range(nb) for n in ("freq_hz", "q", "gain_db"))
    if kind in AUTOMATABLE:
        return AUTOMATABLE[kind]
    cls = lookup_effect(kind)
    return frozenset(getattr(cls, "automatable", ()) or ()) if cls else frozenset()


def _auto_default(e, kind: str, name: str) -> float:
    """The effect's static value of an automatable raw param."""
    if kind == "eq":
        band, field_ = name.split(".", 1)
        t, f, q, g = e.bands[int(band[1:])]
        return {"freq_hz": f, "q": q, "gain_db": g}[field_]
    return float(getattr(e, name))


def _slot_auto_names(track_auto: dict, pos: int, kind: str, static: tuple, e) -> tuple:
    """Sorted automated raw-param names of chain slot ``pos`` (validated)."""
    names = sorted(p for (s, p) in track_auto.keys() if s == pos)
    if not names:
        return ()
    allowed = automatable_params(kind, static)
    bad = [n for n in names if n not in allowed]
    if bad:
        raise ValueError(f"effect {kind!r} (slot {pos}) has no automatable param(s) {bad}; "
                         f"automatable: {sorted(allowed)}")
    return tuple(names)


def _kind_of(e) -> str:
    """Stage kind alone, safe on unprepared effects."""
    if isinstance(e, Gain):
        return "gain"
    if isinstance(e, Biquad):
        return "biquad"
    if isinstance(e, ParametricEQ):
        return "eq"
    return e.name


def _stage_kind(e) -> tuple[str, tuple]:
    """(kind, static config) of one prepared effect: its signature entry."""
    if isinstance(e, Gain):
        return "gain", ()
    if isinstance(e, Biquad):
        return "biquad", ()
    if isinstance(e, ParametricEQ):
        return "eq", (len(e.bands),)
    return e.name, tuple(e.static_config())


def chain_is_packable(chain) -> bool:
    """True if every effect reduces to biquad sections (the LTI paths)."""
    if chain is None:
        return True
    effs = chain.effects if isinstance(chain, EffectChain) else list(chain)
    return all(_kind_of(e) in _PACKABLE for e in effs)


def session_fx_packable(session) -> bool:
    if session_has_effect_automation(session):
        return False  # timed effect params run in the generic pipeline
    chains, master = _chains_of(session)
    return all(chain_is_packable(c) for c in chains) and chain_is_packable(master)


def _stage_params(e, kind: str, auto: tuple = ()) -> dict[str, np.ndarray]:
    """Per-effect parameter arrays (stacked later across the group); with
    ``auto``, biquad/EQ stages pack raw design values for the redesign on
    the device instead of coefficients."""
    if kind == "gain":
        return {"g": np.float32(e.gain_linear)}
    if kind == "biquad":
        if auto:
            return {"freq": np.float32(e.freq_hz), "q": np.float32(e.q), "gain_db": np.float32(e.gain_db)}
        assert e.coeffs is not None, "effect not prepared"
        return {"pa": coeffs_device_arrays(e.coeffs)}  # [9]
    if kind == "eq":
        if auto:
            return {"freq": np.asarray([b[1] for b in e.bands], np.float32),
                    "q": np.asarray([b[2] for b in e.bands], np.float32),
                    "gain_db": np.asarray([b[3] for b in e.bands], np.float32)}
        assert e.coeffs, "effect not prepared"
        return {"pa": np.stack([coeffs_device_arrays(c) for c in e.coeffs])}  # [nb, 9]
    p = {k: np.asarray(v, np.float32) for k, v in e.param_arrays().items()}
    if kind in ("convreverb", "linphase"):
        p["ir"] = np.asarray(e._ir, np.float32)  # [C, L]
    return p


@dataclass
class _Group:
    track_idx: np.ndarray  # [B] row indices into per_track
    stages: list  # [(kind, static, params {name: host array [B, ...]})]


@dataclass
class GenericFX:
    """Prepared generic-effects program of one session."""

    groups: list = field(default_factory=list)  # track groups
    master: _Group | None = None  # B == 1 group over the mixed bus
    sample_rate: float = 48000.0
    channels: int = 2


def _chain_stages(chain) -> list:
    effs = chain.effects if isinstance(chain, EffectChain) else list(chain)
    return [(e, *_stage_kind(e)) for e in effs]


def _stage_sig_entry(e, kind: str, static: tuple, names: tuple):
    """Grouping-signature entry; time-varying biquad/EQ stages carry their
    filter types in ``static`` (the redesign needs them)."""
    if names and kind == "biquad":
        static = (e.ftype.value,)
    elif names and kind == "eq":
        static = (static[0], tuple(b[0].value for b in e.bands))
    return kind, static, names


def _pack_stage_auto(session, chains, tracks, pos, kind, names, sample_rate, auto_of):
    """Lane tables {name: {xs,ys,cv,tn} [B, P]} of one automated stage."""
    tables = {}
    for name in names:
        lanes, defaults = [], []
        for t in tracks:
            e = _chain_stages(chains[t])[pos][0]
            lanes.append(auto_of(t).get((pos, name)))
            defaults.append(_auto_default(e, kind, name))
        tables[name] = pack_lane_tables(lanes, defaults, sample_rate, session.time_base)
    return tables


def _group_stages(session, chains, sig, tracks, sample_rate, auto_of):
    stages = []
    for pos, (kind, static, names) in enumerate(sig):
        stacked: dict[str, list] = {}
        for t in tracks:
            e = _chain_stages(chains[t])[pos][0]
            for k, v in _stage_params(e, kind, auto=names).items():
                stacked.setdefault(k, []).append(v)
        params = {k: np.stack(v) for k, v in stacked.items()}  # host numpy
        if names:
            params["auto"] = _pack_stage_auto(session, chains, tracks, pos, kind, names,
                                              sample_rate, auto_of)
        stages.append((kind, static, params))
    return stages


def prepare_generic_fx(session, sample_rate: float, channels: int = 2) -> GenericFX:
    """Prepare every chain and group the tracks by chain signature."""
    chains, master = _chains_of(session)
    for c in chains:
        if c is not None:
            c.prepare(sample_rate, channels)
    fx = GenericFX(sample_rate=float(sample_rate), channels=channels)

    def track_lanes(t: int) -> dict:
        a = session.tracks[t].automation
        return a.effects if (a is not None and a.effects) else {}

    by_sig: dict[tuple, list[int]] = {}
    for t, c in enumerate(chains):
        stages_t = _chain_stages(c) if c is not None else []
        eff_lanes = track_lanes(t)
        bad = [s for (s, _) in eff_lanes.keys() if s >= len(stages_t)]
        if bad:
            raise ValueError(f"track {t} automates effect slot(s) {sorted(set(bad))} but its "
                             f"chain has {len(stages_t)} effect(s)")
        if not stages_t:
            continue
        sig = tuple(_stage_sig_entry(e, kind, static, _slot_auto_names(eff_lanes, pos, kind, static, e))
                    for pos, (e, kind, static) in enumerate(stages_t))
        by_sig.setdefault(sig, []).append(t)
    for sig, tracks in by_sig.items():
        fx.groups.append(_Group(np.asarray(tracks, np.int64),
                                _group_stages(session, chains, sig, tracks, sample_rate, track_lanes)))

    if master is not None and len(_chain_stages(master)) > 0:
        master.prepare(sample_rate, channels)
        mlanes = dict(getattr(session, "master_automation", {}) or {})
        mstages = _chain_stages(master)
        bad = [s for (s, _) in mlanes.keys() if s >= len(mstages)]
        if bad:
            raise ValueError(f"master automation targets slot(s) {sorted(set(bad))} but the "
                             f"master chain has {len(mstages)} effect(s)")
        sig = tuple(_stage_sig_entry(e, kind, static, _slot_auto_names(mlanes, pos, kind, static, e))
                    for pos, (e, kind, static) in enumerate(mstages))
        fx.master = _Group(np.asarray([0], np.int64),
                           _group_stages(session, [master], sig, [0], sample_rate, lambda _t: mlanes))
    return fx


def _cascade_coeffs(pa: torch.Tensor, C: int) -> torch.Tensor:
    """Static sections ``[B, nb, 9]`` -> the cascade's ``[9, nb, B*C, 1]``
    (row b*C + c, as the JAX package repeats them)."""
    return pa.permute(2, 1, 0).repeat_interleave(C, dim=2)[..., None].contiguous()


def device_params(fx: GenericFX, device="cpu"):
    """Params mirroring fx.groups / fx.master stage lists, as tensors on
    ``device``; static biquad/EQ stages also hold their cascade
    coefficients ("casc")."""
    def dev(kind, static, params):
        out = {}
        for k, v in params.items():
            if k == "auto":  # nested lane tables {name: {xs,ys,cv,tn}}
                out[k] = {n: {kk: torch.from_numpy(np.ascontiguousarray(t)).to(device)
                              for kk, t in tab.items()} for n, tab in v.items()}
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if kind in ("biquad", "eq") and "pa" in out:
            pa = out["pa"] if kind == "eq" else out["pa"][:, None, :]
            out["casc"] = _cascade_coeffs(pa, fx.channels)
        return out

    gp = [[dev(*st) for st in g.stages] for g in fx.groups]
    mp = [dev(*st) for st in fx.master.stages] if fx.master is not None else []
    return gp, mp


def _with_ir_ffts(fx: GenericFX, gparams, mparams, chunk: int):
    """Each convolution stage's IR spectrum at the chunk's FFT size
    ("ir_f"), computed once per stream."""
    def xform(stages, plist):
        return [dict(p, ir_f=ir_spectrum(p["ir"], chunk)) if kind in ("convreverb", "linphase") else p
                for (kind, _, _), p in zip(stages, plist)]

    gp = [xform(g.stages, pl) for g, pl in zip(fx.groups, gparams)]
    mp = xform(fx.master.stages, mparams) if fx.master is not None else mparams
    return gp, mp


# ---------------------------------------------------------------------------
# stage execution (x [B, C, Fc])
# ---------------------------------------------------------------------------


def _init_stage_state(kind: str, static: tuple, params, B: int, C: int, device="cpu"):
    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    if kind in ("gain", "saturator", "width"):
        return ()
    if kind == "biquad":
        return z(B * C, 2)
    if kind == "eq":
        return [z(B * C, 2) for _ in range(static[0])]
    if kind == "compressor":
        return {"red": z(B), "att": z(B), "det": z(B)}
    if kind == "limiter":
        (L,) = static
        return {"red": z(B), "att": z(B), "look": z(B, L), "xdelay": z(B, C, L)}
    if kind == "gate":
        return {"open": z(B), "att": z(B)}
    if kind == "delay":
        mode, D = static
        return {"w": z(B, C, D), "x": z(B, C, D)}
    if kind in ("chorus", "flanger"):
        voices, MT = static
        return {"xtail": z(B, C, MT)}
    if kind in ("convreverb", "linphase"):
        (L,) = static
        return {"carry": z(B, C, L - 1)}
    cls = _registered_stage_cls(kind)
    if cls is not None:
        return cls.stage_init_state(static, params, B, C)
    raise ValueError(f"unknown effect kind {kind!r}")


def _registered_stage_cls(kind: str):
    """The registered user-effect class implementing the stage protocol,
    or None (``effects/registry.py``)."""
    if kind == UnknownEffect.name:  # unregistered persisted effect: bypass
        return UnknownEffect
    cls = lookup_effect(kind)
    if cls is None:
        return None
    if not (callable(getattr(cls, "stage_init_state", None)) and callable(getattr(cls, "stage_apply", None))):
        raise ValueError(f"registered effect {kind!r} ({cls.__name__}) lacks the stage protocol "
                         f"(stage_init_state/stage_apply classmethods) the batched pipeline needs")
    return cls


_LN10_20 = float(np.log(10.0) / 20.0)


def _db_to_lin_dev(db):
    """f32 dB -> linear with the engine's -72 dB silence floor."""
    return torch.where(db > -72.0, torch.exp(_LN10_20 * db), 0.0)


def _time_coef_dev(t_s, sample_rate: float):
    """Tensor form of ops.dynamics.time_coef: exp(-1/(t*fs)), 0 at t <= 0."""
    return torch.where(t_s <= 0.0, 0.0, torch.exp(-1.0 / torch.clamp(t_s * float(sample_rate), min=1e-12)))


def _eval_stage_lanes(kind: str, params, n0: int, Fc: int):
    """A stage's lane tables at this chunk's frames: elementwise params per
    frame [B, Fc]; biquad/EQ design params per param block [B, K]."""
    auto_tab = params.get("auto")
    if not auto_tab:
        return {}
    dev = next(iter(next(iter(auto_tab.values())).values())).device
    if kind in ("biquad", "eq"):
        g = n0 + torch.arange(max(Fc // PARAM_BLOCK, 1), dtype=torch.int32, device=dev) * PARAM_BLOCK
    else:
        g = n0 + torch.arange(Fc, dtype=torch.int32, device=dev)
    return {name: eval_lanes(tab, g) for name, tab in auto_tab.items()}


def _tv_biquad_rows(ftype, freq, q, gain_db, x2, state, sample_rate: float, C: int):
    """TV biquad over rows: freq/q/gain_db [B, K]; x2 [B*C, F] (row
    b*C+c); state [B*C, 2] in z coordinates."""
    d = design_biquad_device(BiquadType(ftype), freq, q, gain_db, sample_rate)
    p9, P, Pinv, aux = tv_section_params(d)

    def rep(a):  # [B, K, ...] -> [B*C, K, ...]
        return a.repeat_interleave(C, dim=0)

    F = x2.shape[-1]
    K = freq.shape[-1]
    PBv = -(-F // K)
    pad = K * PBv - F
    if pad:  # framework chunks are 512-multiples; a safety net only
        x2 = tF.pad(x2, (0, pad))
    y, z = biquad_scan_blocked_tv(x2, [rep(p) for p in p9], rep(P), rep(Pinv), state, PB=PBv,
                                  aux={k: rep(v) for k, v in aux.items()})
    return (y[:, :F] if pad else y), z


def _tv_vals(lanes, params, lane_name: str, raw_key: str, K: int, band: int | None = None):
    """[B, K] design values: the lane where automated, else the base value."""
    v = lanes.get(lane_name)
    if v is not None:
        return v
    base = params[raw_key] if band is None else params[raw_key][:, band]
    return torch.broadcast_to(base[:, None], (base.shape[0], K))


def _apply_stage(kind: str, static: tuple, params, x, state, n0: int, sample_rate: float, key=None):
    """x [B, C, Fc] -> (y, new_state); ``n0``: the chunk's first frame.

    Stages with an "auto" entry evaluate their lanes here (elementwise
    params per frame, biquad/EQ coefficients per 512-frame param block).
    ``key`` [B, C, Fc]: an external sidechain detector signal for
    compressor/gate stages flagged sidechain=True (silence when None)."""
    B, C, Fc = x.shape

    def col(a):  # [B] -> [B, 1]
        return a[:, None]

    lanes = _eval_stage_lanes(kind, params, n0, Fc)

    def mix_coef(name):  # wet/dry/mix lane [B,1,Fc] or static [B,1,1]
        return lanes[name][:, None, :] if name in lanes else params[name][:, None, None]

    if kind == "gain":
        if "gain_db" in lanes:
            return x * _db_to_lin_dev(lanes["gain_db"])[:, None, :], state
        return x * params["g"][:, None, None], state
    if kind == "biquad":
        if static:  # time-varying form: static == (ftype_value,)
            K = lanes[next(iter(lanes))].shape[-1] if lanes else Fc // PARAM_BLOCK
            y, ns = _tv_biquad_rows(static[0], _tv_vals(lanes, params, "freq_hz", "freq", K),
                                    _tv_vals(lanes, params, "q", "q", K),
                                    _tv_vals(lanes, params, "gain_db", "gain_db", K),
                                    x.reshape(B * C, Fc), state, sample_rate, C)
            return y.reshape(B, C, Fc), ns
        y, ns = biquad_cascade(x.reshape(B * C, Fc), params["casc"], [state])
        return y.reshape(B, C, Fc), ns[0]
    if kind == "eq":
        nb = static[0]
        y = x.reshape(B * C, Fc)
        if len(static) > 1 and isinstance(static[1], tuple):  # time-varying form
            ftypes = static[1]
            K = lanes[next(iter(lanes))].shape[-1]
            new_states = []
            for b in range(nb):
                y, ns = _tv_biquad_rows(ftypes[b], _tv_vals(lanes, params, f"b{b}.freq_hz", "freq", K, band=b),
                                        _tv_vals(lanes, params, f"b{b}.q", "q", K, band=b),
                                        _tv_vals(lanes, params, f"b{b}.gain_db", "gain_db", K, band=b),
                                        y, state[b], sample_rate, C)
                new_states.append(ns)
            return y.reshape(B, C, Fc), new_states
        y, new_states = biquad_cascade(y, params["casc"], list(state))
        return y.reshape(B, C, Fc), new_states
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
            return dyn.compressor_process(x, p, state, detector=detector, key=key if sc else None)
        if kind == "limiter":
            (L,) = static
            return dyn.limiter_process(x, p, state, lookahead=L)
        (sc,) = static
        return dyn.gate_process(x, p, state, key=key if sc else None)
    if kind == "delay":
        mode, D = static
        fb = params["feedback"][:, None, None, None]  # broadcast vs [B, *, *, D]
        if mode == "pingpong" and C == 2:
            w, wl, xl = dl.comb_feedback_pingpong(x, fb, state["w"], state["x"], D=D)
        else:
            w, wl, xl = dl.comb_feedback(x, fb, state["w"], state["x"], D=D)
        return mix_coef("dry") * x + mix_coef("wet") * w, {"w": wl, "x": xl}
    if kind in ("chorus", "flanger"):
        voices, MT = static
        two_pi = 2.0 * np.pi
        acc = torch.zeros_like(x)
        new_tail = state["xtail"]
        for v in range(voices):
            phases = torch.tensor([two_pi * v / voices + c * (0.5 * np.pi) for c in range(C)],
                                  dtype=torch.float32, device=x.device)[:, None]
            d = dl.lfo_delay_frames(n0, Fc, depth_frames=params["depth"][:, None, None],
                                    center_frames=params["center"][:, None, None], phase=phases,
                                    rate_splits=params["rate_splits"][:, None, None, :])
            tap, new_tail = dl.modulated_tap(x, d, state["xtail"], max_delay=MT)
            acc = acc + tap
        wet = mix_coef("wet") / float(voices)
        return mix_coef("dry") * x + wet * acc, {"xtail": new_tail}
    if kind in ("convreverb", "linphase"):
        (L,) = static
        ir_f = params.get("ir_f")
        if ir_f is None or 2 * (ir_f.shape[-1] - 1) < Fc + L - 1:
            ir_f = ir_spectrum(params["ir"], Fc)
        wetsig, carry = fft_convolve_chunk(x, ir_f, L, state["carry"])
        if kind == "linphase":
            return wetsig, {"carry": carry}
        return mix_coef("dry") * x + mix_coef("wet") * wetsig, {"carry": carry}
    if kind == "saturator":
        if "drive_db" in lanes:
            drive = torch.exp(_LN10_20 * lanes["drive_db"])[:, None, :]
            norm = 1.0 / torch.tanh(drive)
        else:
            drive = params["drive"][:, None, None]
            norm = params["norm"][:, None, None]
        shaped = torch.tanh(drive * x) * norm
        m = mix_coef("mix")
        return m * shaped + (1.0 - m) * x, state
    if kind == "width":
        if C != 2:
            return x, state
        w = lanes["width"] if "width" in lanes else params["width"][:, None]
        mid = 0.5 * (x[:, 0, :] + x[:, 1, :])
        side = 0.5 * (x[:, 0, :] - x[:, 1, :]) * w
        return torch.stack([mid + side, mid - side], dim=1), state
    cls = _registered_stage_cls(kind)
    if cls is not None:
        return cls.stage_apply(static, params, x, state, n0, sample_rate, key=key, lanes=lanes)
    raise ValueError(f"unknown effect kind {kind!r}")


def _apply_group(group: _Group, plist, x, states, n0: int, sample_rate: float, key=None,
                 scope: str = "track"):
    """The group's stages in order; each runs inside a ``torch.profiler``
    range ``wb.<scope>.<kind>``, so a profile of the finisher reads its
    device time per stage kind."""
    new_states = []
    for (kind, static, _), params, st in zip(group.stages, plist, states):
        with record_function(f"wb.{scope}.{kind}"):
            x, ns = _apply_stage(kind, static, params, x, st, n0, sample_rate, key=key)
        new_states.append(ns)
    return x, new_states


def init_generic_states(fx: GenericFX, C: int, device="cpu"):
    g_states = [[_init_stage_state(kind, static, params, len(g.track_idx), C, device)
                 for (kind, static, params) in g.stages] for g in fx.groups]
    m_states = ([_init_stage_state(kind, static, params, 1, C, device)
                 for (kind, static, params) in fx.master.stages] if fx.master is not None else [])
    return g_states, m_states


#: per-stage-kind weights of the JAX package's compile-cost model (its
#: scan programs grow with chunk length); the port keeps the model so both
#: packages chunk a stream alike on the CPU
_COMPILE_WEIGHT = {
    "gain": 0, "saturator": 0, "width": 0,
    "biquad": 1, "eq": 1, "convreverb": 1, "linphase": 1,
    "delay": 2, "chorus": 2, "flanger": 2,
    "compressor": 4, "limiter": 5, "gate": 4,
}

PARAM_BLOCK_MIN = 512  # chunks stay PARAM_BLOCK-aligned for TV stages
#: chunk length on the card, where no compile step bounds it: shorter
#: chunks leave the card waiting on launches (each scan step is a few
#: torch ops per chunk), longer ones pay log2(chunk) scan steps over more
#: bytes and grow the temporaries; 2^18 was the fastest of 2^15-2^21 in
#: chip_smoke.py's generic_fx_128trk sweep (PERF.md)
CUDA_CHUNK_CAP = 1 << 18


def auto_chunk_frames(fx: GenericFX, requested: int | None = None, device="cpu") -> int:
    """Chunk length of the generic stream, a multiple of 512 frames.

    On the CPU the JAX package's values (its chains' compile cost: 2^16
    for cost <= 2, 2^14 for <= 10, 2^13 beyond), so the two packages chunk
    alike and compare at equal chunks (chunking changes the prefix scans'
    rounding); ``requested`` defaults to 2^16 there. On the card
    :data:`CUDA_CHUNK_CAP`, which ``requested`` defaults to."""
    on_card = torch.device(device).type == "cuda"
    if requested is None:
        requested = CUDA_CHUNK_CAP if on_card else 1 << 16
    if on_card:
        cap = CUDA_CHUNK_CAP
    else:
        cost = 0
        for g in list(fx.groups) + ([fx.master] if fx.master is not None else []):
            for (kind, static, params) in g.stages:
                cost += _COMPILE_WEIGHT.get(kind, 3) + (1 if "auto" in params else 0)
        cap = 1 << 16 if cost <= 2 else 1 << 14 if cost <= 10 else 1 << 13
    return max(min(requested, cap), PARAM_BLOCK_MIN)


def stage_latency_frames(stages) -> int:
    """Chain processing latency from the stage list: limiter lookahead +
    linear-phase EQ group delay ((taps-1)/2); other stages have none."""
    lat = 0
    for (kind, static, _) in stages:
        if kind == "limiter":
            lat += int(static[0])
        elif kind == "linphase":
            lat += (int(static[0]) - 1) // 2
    return lat


def fx_latencies(fx: GenericFX) -> tuple[list[int], int]:
    """(per-group chain latency, master-chain latency) in frames (uniform
    within a group: equal signatures share static configs)."""
    glat = [stage_latency_frames(g.stages) for g in fx.groups]
    mlat = stage_latency_frames(fx.master.stages) if fx.master is not None else 0
    return glat, mlat


def _pdc_preshift(fx: GenericFX, xall, glat: list[int]):
    """Advance each group's rows by its chain's latency, zero-filled (PDC
    fetch-ahead): a causal chain fed input advanced by L emits output
    aligned to timeline time."""
    xall = xall.clone()
    for g, lat in zip(fx.groups, glat):
        if lat > 0:
            idx = torch.as_tensor(g.track_idx, device=xall.device)
            xall[idx] = tF.pad(xall[idx][:, :, lat:], (0, lat))
    return xall


def _chunk_input(per_track, start: int, chunk: int, shifted_rows):
    """Frames [start, start + chunk) of ``per_track`` [T, C, F], zero past
    its end; the rows of each ``(rows, lat)`` of ``shifted_rows`` read
    ``lat`` frames ahead (the PDC fetch-ahead without a padded copy of the
    whole buffer)."""
    F = per_track.shape[-1]

    def window(x, a):
        w = x[..., a:a + chunk]
        return w if w.shape[-1] == chunk else tF.pad(w, (0, chunk - w.shape[-1]))

    xc = window(per_track, start)
    if shifted_rows:
        xc = xc.clone()
        for rows, lat in shifted_rows:
            xc[rows] = window(per_track[rows], start + lat) if start + lat < F else 0.0
    return xc


def _apply_groups(fx: GenericFX, rows, xc, g_states, gparams, start: int):
    """Every track group's chain on its rows of ``xc`` [T, C, chunk] (a
    copy; ``xc`` is not written) -> (processed, new group states)."""
    new_g = []
    if fx.groups:
        xc = xc.clone()
    for r, g, pl, sts in zip(rows, fx.groups, gparams, g_states):
        yg, ns = _apply_group(g, pl, xc[r], sts, start, fx.sample_rate)
        xc[r] = yg
        new_g.append(ns)
    return xc, new_g


def _chunk_step(fx: GenericFX, rows, xc, g_states, m_states, gparams, mparams, start: int,
                track_gain, auto, T: int, C: int, with_meters: bool, Fv):
    """One [T, C, chunk] slice: chains -> gains -> ordered sum -> master ->
    clip (+ meter partials). Returns (total, new_g, new_m, meters)."""
    chunk = xc.shape[-1]
    xc, new_g = _apply_groups(fx, rows, xc, g_states, gparams, start)
    gidx = start + torch.arange(chunk, dtype=torch.int32, device=xc.device)
    with record_function("wb.gains_sum"):
        y = xc * _frame_gains(auto, track_gain, gidx, T, C)
        total = _ordered_sum(y)
    new_m = m_states
    if fx.master is not None:
        tm, new_m = _apply_group(fx.master, mparams, total[None], m_states, start, fx.sample_rate,
                                 scope="master")
        total = tm[0]
    total = torch.where(total > 1.0, 1.0, total)
    total = torch.where(total < -1.0, -1.0, total)
    meters = None
    if with_meters:
        ym, tmm = y, total
        if Fv is not None:  # the pad tail is ring-out, not audio
            valid = gidx < Fv
            ym = torch.where(valid, y, 0.0)
            tmm = torch.where(valid, total, 0.0)
        meters = (ym.abs().amax(dim=-1), (ym * ym).sum(dim=-1),
                  tmm.abs().amax(dim=-1), (tmm * tmm).sum(dim=-1))
    return total, new_g, new_m, meters


def _group_rows(fx: GenericFX, device):
    return [torch.as_tensor(g.track_idx, device=device) for g in fx.groups]


def make_generic_chunk_fn(fx: GenericFX, T: int, C: int, *, chunk: int, with_meters: bool = False,
                          device="cpu"):
    """Streaming form: fn(pt_chunk [T, C, chunk], g_states, m_states,
    start, track_gain, auto) -> (total, new_g, new_m[, meters]) for callers
    that pull chunks (the gather path). States thread across calls
    exactly; the IR spectra are computed once."""
    gp, mp = _with_ir_ffts(fx, *device_params(fx, device), chunk)
    rows = _group_rows(fx, device)

    def call(pt_chunk, g_states, m_states, start, track_gain, auto=None):
        total, ng, nm, meters = _chunk_step(fx, rows, pt_chunk, g_states, m_states, gp, mp, int(start),
                                            track_gain, auto, T, C, with_meters, None)
        return (total, ng, nm, meters) if with_meters else (total, ng, nm)

    return call


def make_generic_stems_finisher(fx: GenericFX, T: int, C: int, *, chunk: int | None = None,
                                device="cpu"):
    """Stems form: fn(per_track [T, C, F], track_gain, auto) -> [T, C, F]
    post-chain post-gain (the track.cpp:728-733 feed point)."""
    if chunk is None:
        chunk = auto_chunk_frames(fx, device=device)
    gp, _ = _with_ir_ffts(fx, *device_params(fx, device), chunk)
    rows = _group_rows(fx, device)

    def finish(per_track, track_gain, auto=None):
        F = per_track.shape[-1]
        states, _ = init_generic_states(fx, C, device)
        outs = []
        for start in range(0, F, chunk):
            xc, states = _apply_groups(fx, rows, _chunk_input(per_track, start, chunk, ()), states, gp, start)
            gidx = start + torch.arange(chunk, dtype=torch.int32, device=xc.device)
            outs.append(xc * _frame_gains(auto, track_gain, gidx, T, C))
        return torch.cat(outs, dim=-1)[..., :F]

    return finish


def make_generic_finisher(fx: GenericFX, T: int, C: int, *, chunk: int | None = None,
                          with_meters: bool = False, valid_frames: int | None = None,
                          pdc: bool = False, device="cpu"):
    """fn(per_track [T, C, F], track_gain, auto) -> mixed [C, F] (or
    (mixed, meters)), chunk by chunk with the states carried; ``chunk``
    defaults to :func:`auto_chunk_frames`. ``per_track`` is read, not
    written.

    ``pdc=True`` compensates latency: each chain's input rows are advanced
    by its latency (limiter lookahead, linear-phase group delay) so the
    tracks sum timeline-aligned, and master latency is absorbed by
    rendering that much further and trimming the head. Off by default:
    the uncompensated render keeps each effect's own delay."""
    if chunk is None:
        chunk = auto_chunk_frames(fx, device=device)
    glat, mlat = fx_latencies(fx) if pdc else ([0] * len(fx.groups), 0)
    gp, mp = _with_ir_ffts(fx, *device_params(fx, device), chunk)
    rows = _group_rows(fx, device)
    shifted = [(r, lat) for r, lat in zip(rows, glat) if lat > 0]

    def finish(per_track, track_gain, auto=None):
        F = per_track.shape[-1]
        Fv = F if valid_frames is None else int(valid_frames)
        g_states, m_states = init_generic_states(fx, C, device)
        outs, parts = [], []
        for start in range(0, F + mlat, chunk):
            xc = _chunk_input(per_track, start, chunk, shifted)
            total, g_states, m_states, m = _chunk_step(fx, rows, xc, g_states, m_states, gp, mp, start,
                                                       track_gain, auto, T, C, with_meters, Fv)
            outs.append(total)
            parts.append(m)
        mixed = torch.cat(outs, dim=-1)[:, mlat:mlat + F]
        return (mixed, meters_from_partials(parts, Fv)) if with_meters else mixed

    return finish


# ---------------------------------------------------------------------------
# host-side f64 reference (test oracle), the JAX package's
# ---------------------------------------------------------------------------


def _ref_lane_values(lane, default: float, g: np.ndarray, sample_rate: float, time_base) -> np.ndarray:
    """Host lane evaluation at frames ``g`` -> f64 (f32 lane eval, widened)."""
    P = max(len(lane.points), 1) if lane is not None else 1
    xs, ys, cv, tn = lane_frame_table(lane, sample_rate, time_base, P, float(default))
    return eval_lane_numpy(xs, ys, cv, tn, g).astype(np.float64)


def _ref_db_to_lin(db: np.ndarray) -> np.ndarray:
    """f64 dB -> linear with the -72 dB silence floor."""
    return np.where(np.asarray(db) > -72.0, 10.0 ** (np.asarray(db, np.float64) / 20.0), 0.0)


def _ref_time_coef(t_s: np.ndarray, sample_rate: float) -> np.ndarray:
    t = np.asarray(t_s, np.float64)
    with np.errstate(divide="ignore"):
        return np.where(t <= 0.0, 0.0, np.exp(-1.0 / np.maximum(t * sample_rate, 1e-12)))


def reference_run_chain(chain, x, eff_lanes, sample_rate, channels, bd, key=None):
    """f64 sequential reference of one effect chain on x [C, F], with timed
    effect-param lanes; ``key`` [C, F] feeds sidechain-flagged dynamics
    stages (silence when None)."""
    if chain is None:
        return x
    chain.prepare(sample_rate, channels)
    effs = chain.effects if isinstance(chain, EffectChain) else list(chain)
    F = x.shape[-1]
    gf = np.arange(F, dtype=np.int64)
    K = max(F // PARAM_BLOCK, 1)
    gk = np.arange(K, dtype=np.int64) * PARAM_BLOCK

    def lane_vals(pos, name, default, g=None):
        lane = (eff_lanes or {}).get((pos, name))
        if lane is None:
            return None
        return _ref_lane_values(lane, default, gf if g is None else g, sample_rate, bd)

    def lane_or(pos, name, default, g=None):
        v = lane_vals(pos, name, default, g)
        return default if v is None else v

    def coeff_lane(pos, name, default):
        return np.broadcast_to(np.asarray(lane_or(pos, name, float(default), gk), np.float64), (K,))

    def times(pos, e, p):
        av = lane_vals(pos, "attack_s", e.attack_s)
        rv = lane_vals(pos, "release_s", e.release_s)
        return (p["attack"] if av is None else _ref_time_coef(av, sample_rate),
                p["release"] if rv is None else _ref_time_coef(rv, sample_rate))

    for pos, e in enumerate(effs):
        slot_auto = any(s == pos for (s, _) in (eff_lanes or {}).keys())
        if isinstance(e, Gain):
            v = lane_vals(pos, "gain_db", e.gain_db)
            x = x * (_ref_db_to_lin(v) if v is not None else float(e.gain_linear))
        elif isinstance(e, Biquad):
            if slot_auto:
                x, _ = biquad_sequential_tv(x, e.ftype, coeff_lane(pos, "freq_hz", e.freq_hz),
                                            coeff_lane(pos, "q", e.q), coeff_lane(pos, "gain_db", e.gain_db),
                                            sample_rate, PARAM_BLOCK)
            else:
                x, _ = biquad_sequential(x, e.coeffs)
        elif isinstance(e, ParametricEQ):
            if slot_auto:
                for b, (t, f, q, g_) in enumerate(e.bands):
                    x, _ = biquad_sequential_tv(x, t, coeff_lane(pos, f"b{b}.freq_hz", f),
                                                coeff_lane(pos, f"b{b}.q", q),
                                                coeff_lane(pos, f"b{b}.gain_db", g_), sample_rate, PARAM_BLOCK)
            else:
                for c in e.coeffs:
                    x, _ = biquad_sequential(x, c)
        elif isinstance(e, LinearPhaseEQ):
            ir = np.asarray(e._ir, np.float64)  # the causal FIR, trimmed to F
            x = np.stack([np.convolve(x[c], ir[c % ir.shape[0]])[:F] for c in range(x.shape[0])])
        elif isinstance(e, Compressor):
            p = e.param_arrays()
            attack, release = times(pos, e, p)
            x = dyn.compressor_ref(
                x, threshold_db=lane_or(pos, "threshold_db", p["threshold_db"]),
                ratio=lane_or(pos, "ratio", p["ratio"]), knee_db=lane_or(pos, "knee_db", p["knee_db"]),
                attack=attack, release=release, makeup_db=lane_or(pos, "makeup_db", p["makeup_db"]),
                detector=e.detector, det_avg=p["det_avg"],
                key=(np.zeros_like(x) if key is None else key) if e.sidechain else None)
        elif isinstance(e, Limiter):
            p = e.param_arrays()
            attack, release = times(pos, e, p)
            x = dyn.limiter_ref(x, ceiling_db=lane_or(pos, "ceiling_db", p["ceiling_db"]),
                                attack=attack, release=release, lookahead=e.lookahead)
        elif isinstance(e, NoiseGate):
            p = e.param_arrays()
            attack, release = times(pos, e, p)
            x = dyn.gate_ref(x, threshold_db=lane_or(pos, "threshold_db", p["threshold_db"]),
                             range_db=lane_or(pos, "range_db", p["range_db"]), attack=attack,
                             release=release, hysteresis_db=p.get("hyst_db", 0.0),
                             key=(np.zeros_like(x) if key is None else key) if e.sidechain else None)
        elif isinstance(e, Delay):
            if e.mode == "pingpong" and x.shape[0] == 2:
                w = dl.comb_pingpong_ref(x, e.feedback, e.D)
            else:
                w = dl.comb_feedback_ref(x, e.feedback, e.D)
            x = lane_or(pos, "dry", e.dry) * x + lane_or(pos, "wet", e.wet) * w
        elif isinstance(e, Chorus):  # covers Flanger
            fs = sample_rate
            acc = np.zeros_like(x)
            n = np.arange(F, dtype=np.float64)
            for v in range(e.voices):
                taps = []
                for c in range(x.shape[0]):
                    ph = 2.0 * np.pi * v / e.voices + c * 0.5 * np.pi
                    d = e.center_s * fs + e.depth_s * fs * np.sin(2.0 * np.pi * e.rate_hz / fs * n + ph)
                    taps.append(dl.modulated_tap_ref(x[c], d.astype(np.float32).astype(np.float64)))
                acc += np.stack(taps)
            x = lane_or(pos, "dry", e.dry) * x + (lane_or(pos, "wet", e.wet) / e.voices) * acc
        elif isinstance(e, ConvolutionReverb):
            ir = np.asarray(e._ir, np.float64)
            wet = np.stack([np.convolve(x[c], ir[c % ir.shape[0]])[:F] for c in range(x.shape[0])])
            x = lane_or(pos, "dry", e.dry) * x + lane_or(pos, "wet", e.wet) * wet
        elif isinstance(e, Saturator):
            p = e.param_arrays()
            dv = lane_vals(pos, "drive_db", e.drive_db)
            if dv is not None:
                drive = 10.0 ** (dv / 20.0)
                norm = 1.0 / np.tanh(drive)
            else:
                drive, norm = p["drive"], p["norm"]
            m = lane_or(pos, "mix", p["mix"])
            x = m * (np.tanh(drive * x) * norm) + (1.0 - m) * x
        elif isinstance(e, StereoWidth):
            if x.shape[0] == 2:
                mid = 0.5 * (x[0] + x[1])
                side = 0.5 * (x[0] - x[1]) * lane_or(pos, "width", e.width)
                x = np.stack([mid + side, mid - side])
        elif isinstance(e, UnknownEffect):
            pass  # unregistered persisted effect: bypass
        elif callable(getattr(e, "reference_process", None)):
            # a registered effect's own f64 reference; automated params as
            # per-frame lane values {name: [F]}
            ref_lanes = {}
            for name in getattr(type(e), "automatable", ()) or ():
                v = lane_vals(pos, name, float(getattr(e, name)))
                if v is not None:
                    ref_lanes[name] = np.asarray(v, np.float64)
            x = np.asarray(e.reference_process(np.asarray(x, np.float64), lanes=ref_lanes or None), np.float64)
        elif type_name_of(type(e)) is not None:
            # the effect's own process() serves as its reference
            y, _ = e.process(torch.as_tensor(np.asarray(x, np.float32)), e.init_state(x.shape[0]))
            x = np.asarray(y, np.float64)
        else:
            raise TypeError(e)
    return x


def reference_generic_finish(per_track: np.ndarray, session, sample_rate: float, channels: int = 2,
                             pdc: bool = False) -> np.ndarray:
    """Sequential host reference of the generic finish: per-effect f64
    models, f64 gains and sum, the master chain, the hard clip; timed
    effect-param lanes per frame (per PARAM_BLOCK for biquad/EQ
    coefficients). ``pdc=True`` mirrors the device PDC."""
    chains, master = _chains_of(session)
    bd = session.time_base
    T, C, F = per_track.shape

    def track_lanes(t):
        a = session.tracks[t].automation
        return a.effects if (a is not None and a.effects) else None

    def chain_input(t):
        x = per_track[t].astype(np.float64)
        if pdc and chains[t] is not None:
            chains[t].prepare(sample_rate, channels)
            lat = chains[t].latency_frames()
            if lat > 0:  # fetch-ahead: advance the chain input by lat
                x = np.pad(x[:, lat:], ((0, 0), (0, lat)))
        return x

    processed = np.stack([reference_run_chain(chains[t], chain_input(t), track_lanes(t), sample_rate,
                                              channels, bd) for t in range(T)])
    g = np.arange(F, dtype=np.int64)
    auto_tables = pack_session_automation(session, sample_rate) if session_has_automation(session) else None
    total = np.zeros((C, F), dtype=np.float64)
    for t, track in enumerate(session.tracks):
        if track.automation is not None and track.automation.has_track_lanes() and auto_tables is not None:
            vol_t, pan_t, mute = auto_tables
            volv = eval_lane_numpy(vol_t["xs"][t], vol_t["ys"][t], vol_t["cv"][t], vol_t["tn"][t], g)
            panv = eval_lane_numpy(pan_t["xs"][t], pan_t["ys"][t], pan_t["cv"][t], pan_t["tn"][t], g)
            for ch in range(C):
                arg = (1.0 - 0.5 * (panv + 1.0)) if ch == 0 else 0.5 * (panv + 1.0)
                coef = (np.sin(np.float32(0.5 * np.pi) * arg.astype(np.float32))
                        * np.float32(np.sqrt(2.0))).astype(np.float32)
                total[ch] += processed[t][ch] * ((volv * coef) * mute[t]).astype(np.float64)
        else:
            vol = np.float32(0.0) if track.mute else track.volume_linear
            pan = track.pan_coeffs
            for ch in range(C):
                total[ch] += processed[t][ch] * float(np.float32(vol * np.float32(pan[ch % 2])))
    mlanes = dict(getattr(session, "master_automation", {}) or {}) or None
    if master is not None:
        mlat = 0
        if pdc:
            master.prepare(sample_rate, channels)
            mlat = master.latency_frames()
        if mlat > 0:  # absorb master latency: render further, trim the head
            total = reference_run_chain(master, np.pad(total, ((0, 0), (0, mlat))), mlanes, sample_rate,
                                        channels, bd)[:, mlat:]
        else:
            total = reference_run_chain(master, total, mlanes, sample_rate, channels, bd)
    return np.clip(total, -1.0, 1.0).astype(np.float32)
