"""Routed mix finishing: buses, track groups, sends and sidechain keys.

Counterpart of ``whitebox_tpu/render/routing.py``. It extends the generic
finisher (``render/effects_generic.py``) with the bus model of
``session/bus.py``:

    track chains -> gains -> ROUTING -> bus chains -> bus gains -> master

The routing step is two small matrix products per chunk (``r_post
[1+B, T]`` over the post-fader signals, ``r_pre [B, T]`` over the
post-chain, pre-fader taps), and two more for the buses' sidechain keys
(``k_post``/``k_pre``) when a sidechain send exists. They run in full f32
(``ops/resample.py::full_f32_matmul``): TF32 would put a noise floor near
-60 dB under the audio. Bus chains reuse the generic stage machinery
(grouped by signature, stacked parameters, explicit state), so every
effect in the family can sit on a bus, with exact chunk-boundary state;
a sidechain-flagged compressor or gate on a bus hears its key.

Sessions without routing never enter this module: ``bounce`` keeps the
bit-parity ordered track sum for them. Routed sessions trade it for the
routing product (f32, deterministic) and are held to the f64 host
oracle :func:`reference_routed_finish`, the JAX package's, copied.

The JAX package scans chunks inside one jitted ``lax.scan``; here
:class:`RoutedFinisher` is one chunk step, which ``render/finisher.py::
run`` feeds, the states carried from chunk to chunk. Each routing product
runs inside a ``torch.profiler`` range ``wb.route.matmul`` and each bus
stage inside ``wb.bus.<kind>``, beside the track and master stages'
``wb.<scope>.<kind>``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from whitebox_tpu_torch.effects.base import EffectChain
from whitebox_tpu_torch.ops.automation import (
    eval_lane_numpy, lane_frame_table, pack_session_automation, session_has_automation,
)
from whitebox_tpu_torch.ops.mix import _ordered_sum
from whitebox_tpu_torch.ops.resample import full_f32_matmul
from whitebox_tpu_torch.render.effects_generic import (
    PARAM_BLOCK_MIN, GenericFX, _apply_group, _apply_groups, _chain_stages, _group_rows, _group_stages,
    _Group, _slot_auto_names, _stage_sig_entry, _with_ir_ffts, auto_chunk_frames, device_params,
    fetch_ahead, init_generic_states, master_step, prepare_generic_fx, reference_run_chain,
    stage_latency_frames,
)
from whitebox_tpu_torch.render.effects_pipeline import _chains_of, _frame_gains, mix_tail, prepare_automation_tables
from whitebox_tpu_torch.render.metrics import span
from whitebox_tpu_torch.session.bus import build_routing_matrices, session_has_routing

__all__ = [
    "RoutedFX",
    "RoutedFinisher",
    "prepare_routed_fx",
    "reference_routed_finish",
    "routed_auto_chunk_frames",
    "session_has_routing",
]


@dataclass
class RoutedFX:
    """Prepared routed-finishing program: generic fx + bus groups + matrices."""

    fx: GenericFX
    bus_groups: list = field(default_factory=list)  # _Group over bus indices
    r_post: np.ndarray | None = None  # [1+B, T] f32
    r_pre: np.ndarray | None = None  # [B, T] f32
    bus_gain: np.ndarray | None = None  # [B, C] f32
    k_post: np.ndarray | None = None  # [B, T] f32 sidechain key sends
    k_pre: np.ndarray | None = None  # [B, T] f32
    num_buses: int = 0
    #: packed per-bus fader lanes (:func:`pack_bus_automation`) or None:
    #: the (vol, pan, mute, use_auto) layout ``_frame_gains`` reads for tracks
    bus_auto: object = None

    @property
    def has_key(self) -> bool:
        """True when any sidechain send exists (the key products are needed)."""
        return bool((self.k_post is not None and self.k_post.any())
                    or (self.k_pre is not None and self.k_pre.any()))


def pack_bus_automation(session, sample_rate: float, device="cpu"):
    """Per-bus fader lanes -> the (vol, pan, mute, use_auto) tensors on
    ``device`` that ``_frame_gains`` reads (None when no bus has fader
    lanes); ``ops.automation.pack_session_automation`` over ``session.buses``."""
    buses = getattr(session, "buses", [])

    def lanes_of(b):
        return getattr(b, "automation", None)

    if not any(lanes_of(b) is not None and lanes_of(b).has_track_lanes() for b in buses):
        return None
    bd = session.time_base
    P = 1
    for b in buses:
        a = lanes_of(b)
        if a is not None:
            for lane in (a.volume, a.pan):
                if lane is not None:
                    P = max(P, len(lane.points))
    vol = {k: [] for k in ("xs", "ys", "cv", "tn")}
    pan = {k: [] for k in ("xs", "ys", "cv", "tn")}
    for b in buses:
        a = lanes_of(b)
        vt = lane_frame_table(a.volume if a is not None else None, sample_rate, bd, P, float(b.volume_linear))
        pt = lane_frame_table(a.pan if a is not None else None, sample_rate, bd, P, float(b.pan))
        for k, v, p in zip(("xs", "ys", "cv", "tn"), vt, pt):
            vol[k].append(v)
            pan[k].append(p)
    mute = np.array([0.0 if b.mute else 1.0 for b in buses], np.float32)
    use_auto = np.array([lanes_of(b) is not None and lanes_of(b).has_track_lanes() for b in buses], bool)

    def tensors(d):
        return {k: torch.from_numpy(np.ascontiguousarray(np.stack(v))).to(device) for k, v in d.items()}

    return (tensors(vol), tensors(pan), torch.from_numpy(mute).to(device),
            torch.from_numpy(use_auto).to(device))


def _bus_fx(rfx: RoutedFX) -> GenericFX:
    """The bus groups as a master-less GenericFX (for the generic helpers)."""
    return GenericFX(groups=rfx.bus_groups, master=None, sample_rate=rfx.fx.sample_rate,
                     channels=rfx.fx.channels)


#: chunk length of the routed finisher on the card: bus and master chains
#: run on a few rows, where a chunk's cost is its scans' launches, not their
#: bytes, so longer chunks win (2^20 was the fastest of 2^15-2^20 in
#: chip_smoke.py's routed_sidechain_128trk sweep, PERF.md; the generic
#: finisher's track-wide scans were as fast at 2^20 as at 2^18)
ROUTED_CUDA_CHUNK_CAP = 1 << 20


def routed_auto_chunk_frames(rfx: RoutedFX, requested: int | None = None, device="cpu") -> int:
    """Chunk length of the routed stream: ``auto_chunk_frames`` over the
    whole routed program (track groups, bus groups and master: weighing
    only ``rfx.fx`` would let a heavy bus chain past the CPU's
    compile-cost caps, which the port keeps so that both packages chunk
    alike there); on the card :data:`ROUTED_CUDA_CHUNK_CAP`, which
    ``requested`` defaults to."""
    if torch.device(device).type == "cuda":
        cap = ROUTED_CUDA_CHUNK_CAP
        return max(min(cap if requested is None else requested, cap), PARAM_BLOCK_MIN)
    whole = GenericFX(groups=list(rfx.fx.groups) + list(rfx.bus_groups), master=rfx.fx.master,
                      sample_rate=rfx.fx.sample_rate, channels=rfx.fx.channels)
    return auto_chunk_frames(whole, requested, device=device)


def _bus_chains_of(session) -> list:
    return [(b.effects if isinstance(b.effects, EffectChain) else EffectChain(list(b.effects)))
            if b.effects else None for b in session.buses]


def prepare_routed_fx(session, sample_rate: float, channels: int = 2, device="cpu") -> RoutedFX:
    """Prepare every track, bus and master chain, group the tracks and the
    buses by chain signature, and build the routing matrices; the bus
    fader lanes go to ``device``."""
    fx = prepare_generic_fx(session, sample_rate, channels)
    bus_chains = _bus_chains_of(session)
    for c in bus_chains:
        if c is not None:
            c.prepare(sample_rate, channels)

    def bus_lanes(b: int) -> dict:
        a = getattr(session.buses[b], "automation", None)
        return a.effects if (a is not None and a.effects) else {}

    by_sig: dict[tuple, list[int]] = {}
    for b, c in enumerate(bus_chains):
        stages_b = _chain_stages(c) if c is not None else []
        eff_lanes = bus_lanes(b)
        bad = [s for (s, _) in eff_lanes.keys() if s >= len(stages_b)]
        if bad:
            raise ValueError(f"bus {b} automates effect slot(s) {sorted(set(bad))} but its "
                             f"chain has {len(stages_b)} effect(s)")
        if not stages_b:
            continue
        sig = tuple(_stage_sig_entry(e, kind, static, _slot_auto_names(eff_lanes, pos, kind, static, e))
                    for pos, (e, kind, static) in enumerate(stages_b))
        by_sig.setdefault(sig, []).append(b)
    bus_groups = [_Group(np.asarray(buses, np.int64),
                         _group_stages(session, bus_chains, sig, buses, sample_rate, bus_lanes))
                  for sig, buses in by_sig.items()]
    m = build_routing_matrices(session, channels)
    return RoutedFX(fx=fx, bus_groups=bus_groups, r_post=m.r_post, r_pre=m.r_pre,
                    bus_gain=m.bus_gain, k_post=m.k_post, k_pre=m.k_pre,
                    num_buses=len(session.buses),
                    bus_auto=pack_bus_automation(session, sample_rate, device=device))


def routed_device_params(rfx: RoutedFX, device="cpu"):
    """(gparams, bparams, mparams, routing): the stages' parameters and the
    five routing matrices as tensors on ``device``."""
    gp, mp = device_params(rfx.fx, device)
    bp, _ = device_params(_bus_fx(rfx), device)
    routing = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                    for a in (rfx.r_post, rfx.r_pre, rfx.bus_gain, rfx.k_post, rfx.k_pre))
    return gp, bp, mp, routing


def _with_ir_ffts_routed(rfx: RoutedFX, gparams, bparams, mparams, chunk: int):
    gp, mp = _with_ir_ffts(rfx.fx, gparams, mparams, chunk)
    bp, _ = _with_ir_ffts(_bus_fx(rfx), bparams, [], chunk)
    return gp, bp, mp


def _route(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bt,tcf->bcf", r, x)`` as one full-f32 product
    ``[b, T] @ [T, C*F]``."""
    T, C, F = x.shape
    return torch.matmul(r, x.reshape(T, C * F)).reshape(r.shape[0], C, F)


class RoutedFinisher:
    """The routed family (``render/finisher.py`` sets out the shape): track
    chains -> gains -> routing products -> bus chains -> bus gains, then
    ``effects_pipeline.mix_tail`` over the master-direct sum plus the
    buses; the stems form stops before that sum and returns ``(direct [C,
    n], bus_out [B, C, n])``, the pre-master components (direct + the sum
    of bus_out, then the master chain, is the mix). Chunks are fixed:
    ``chunk``, else :func:`routed_auto_chunk_frames` up to ``max_chunk``.
    With sidechain sends the key matrices ride under the audio ones
    (``[r_post; k_post]`` and ``[r_pre; k_pre]``), so each chunk is read by
    two products, not four.

    ``pdc=True``: track-chain latency is compensated by fetch-ahead;
    bus-chain latency by delaying every master input to the largest bus
    latency (bus inputs are made within the step, so fetch-ahead cannot
    apply; delay-to-align and a head trim is exact instead), ``bus_pdc``;
    master latency by rendering further and trimming the head."""

    fixed = True

    def __init__(self, session, sample_rate: float, track_gain, *, form="mix", meters=False, pdc=False,
                 chunk=None, max_chunk=None, device="cpu"):
        self.device = torch.device(device)
        self.track_gain, self.form, self.meters = track_gain, form, meters
        self.rfx = rfx = prepare_routed_fx(session, sample_rate, track_gain.shape[1], device=self.device)
        self.auto = prepare_automation_tables(session, sample_rate, device=self.device)
        self.chunk = chunk or routed_auto_chunk_frames(rfx, max_chunk, device=self.device)
        self.ahead, mlat = fetch_ahead(rfx.fx) if pdc else ((), 0)
        B = rfx.num_buses
        blat = np.zeros(B, np.int64)
        if pdc:
            for g in rfx.bus_groups:
                blat[np.asarray(g.track_idx)] = stage_latency_frames(g.stages)
        BL = int(blat.max()) if (pdc and B) else 0
        #: (largest bus latency, each bus's delay to it), or None
        self.bus_pdc = (BL, tuple(int(BL - blat[b]) for b in range(B))) if BL > 0 else None
        self.trim = mlat + BL
        gp, bp, mp, routing = routed_device_params(rfx, self.device)
        self.params = _with_ir_ffts_routed(rfx, gp, bp, mp, self.chunk)
        r_post, r_pre, self.bus_gain, k_post, k_pre = routing
        if rfx.has_key:
            r_post, r_pre = torch.cat([r_post, k_post]), torch.cat([r_pre, k_pre])
        self.post, self.pre = r_post, r_pre
        self.rows = _group_rows(rfx.fx, self.device)
        self.brows = [torch.as_tensor(g.track_idx, device=self.device) for g in rfx.bus_groups]

    def init(self):
        """(track group states, bus group states (with the bus PDC delay
        lines' carries), master states), zero."""
        C, dev = self.track_gain.shape[1], self.device
        g_states, m_states = init_generic_states(self.rfx.fx, C, dev)
        b_states, _ = init_generic_states(_bus_fx(self.rfx), C, dev)
        if self.bus_pdc is not None:
            BL, dbs = self.bus_pdc
            d0 = {"direct": torch.zeros((C, BL), dtype=torch.float32, device=dev)}
            for b, d in enumerate(dbs):
                if d > 0:
                    d0[f"bus{b}"] = torch.zeros((C, d), dtype=torch.float32, device=dev)
            b_states = (b_states, d0)
        return g_states, b_states, m_states

    def step(self, x, states, start: int, valid=None):
        rfx = self.rfx
        fx = rfx.fx
        sample_rate = fx.sample_rate
        T, C, chunk = x.shape
        g_states, b_states, m_states = states
        dstates = None
        if self.bus_pdc is not None:  # the delay-line carries ride with the bus states
            b_states, dstates = b_states
        gparams, bparams, mparams = self.params

        x, new_g = _apply_groups(fx, self.rows, x, g_states, gparams, start)
        gidx = start + torch.arange(chunk, dtype=torch.int32, device=x.device)
        with span("wb.gains"):
            y = x * _frame_gains(self.auto, self.track_gain, gidx, T, C)  # post-fader; x is the pre-fader tap
        B = rfx.num_buses
        key_in = None
        with span("wb.route.matmul"), full_f32_matmul():
            routed = _route(self.post, y)  # [1 + B (+ B keys), C, chunk]
            direct = routed[0]
            if B:
                pre = _route(self.pre, x)  # [B (+ B keys), C, chunk]
                bus_in = routed[1:1 + B] + pre[:B]
                if rfx.has_key:  # the buses' sidechain key inputs [B, C, chunk]
                    key_in = routed[1 + B:] + pre[B:]
        if not B:
            new_b = b_states
            total = direct
            if self.form == "stems":
                return (direct, direct.new_zeros((0, C, chunk))), (new_g, new_b, m_states), None
        else:
            new_b = []
            for g, r, pl, sts in zip(rfx.bus_groups, self.brows, bparams, b_states):
                yb, ns = _apply_group(g, pl, bus_in[r], sts, start, sample_rate,
                                      key=None if key_in is None else key_in[r], scope="bus")
                bus_in.index_copy_(0, r, yb)
                new_b.append(ns)
            with span("wb.bus.fader"):
                # the bus faders per frame: lanes where a bus has them, its
                # constant gain elsewhere
                bus_out = bus_in * _frame_gains(rfx.bus_auto, self.bus_gain, gidx, B, C)
            if self.form == "stems":  # bus-stem export: the pre-master components
                return (direct, bus_out), (new_g, new_b, m_states), None
            if self.bus_pdc is not None:
                # bus-chain latency compensation: every master input is delayed
                # to the largest bus latency BL (direct by BL, bus b by
                # BL - lat_b) so all paths align; the head trim takes BL off.
                # Each delay line is concat(carry, x) and keep-the-tail.
                BL, dbs = self.bus_pdc
                new_d = dict(dstates)
                if BL > 0:
                    seq = torch.cat([dstates["direct"], direct], dim=-1)
                    direct, new_d["direct"] = seq[:, :chunk], seq[:, chunk:]
                rows = []
                for b in range(B):
                    row = bus_out[b]
                    if dbs[b] > 0:
                        seq = torch.cat([dstates[f"bus{b}"], row], dim=-1)
                        row, new_d[f"bus{b}"] = seq[:, :chunk], seq[:, chunk:]
                    rows.append(row)
                bus_out = torch.stack(rows)
                new_b = (new_b, new_d)
            total = direct + _ordered_sum(bus_out)
        total, new_m, partials = mix_tail(y, gidx, master_step(fx, mparams, start), m_states, self.meters, valid,
                                          total=total)
        return total, (new_g, new_b, new_m), partials


# ---------------------------------------------------------------------------
# host-side f64 reference (test oracle), the JAX package's
# ---------------------------------------------------------------------------


def _pan_coef_f32(panv: np.ndarray, ch: int) -> np.ndarray:
    arg = (1.0 - 0.5 * (panv + 1.0)) if ch == 0 else 0.5 * (panv + 1.0)
    return (np.sin(np.float32(0.5 * np.pi) * arg.astype(np.float32)) * np.float32(np.sqrt(2.0))).astype(np.float32)


def _ref_track_gains(session, t: int, C: int, g: np.ndarray, auto_tables):
    """Per-channel f64 gain arrays (or scalars), the fader math of
    ``reference_generic_finish`` exactly."""
    track = session.tracks[t]
    if track.automation is not None and track.automation.has_track_lanes() and auto_tables is not None:
        vol_t, pan_t, mute = auto_tables
        volv = eval_lane_numpy(vol_t["xs"][t], vol_t["ys"][t], vol_t["cv"][t], vol_t["tn"][t], g)
        panv = eval_lane_numpy(pan_t["xs"][t], pan_t["ys"][t], pan_t["cv"][t], pan_t["tn"][t], g)
        return [((volv * _pan_coef_f32(panv, ch)) * mute[t]).astype(np.float64) for ch in range(C)]
    vol = np.float32(0.0) if track.mute else track.volume_linear
    pan = track.pan_coeffs
    return [float(np.float32(vol * np.float32(pan[ch % 2]))) for ch in range(C)]


def _ref_bus_gains(bus, C: int, g: np.ndarray, sample_rate: float, bd: float):
    """Per-channel f64 bus fader gains (arrays where lanes exist, scalars
    otherwise), the f32 math of ``_frame_gains`` exactly."""
    a = getattr(bus, "automation", None)
    if a is None or not a.has_track_lanes():
        bg = bus.gain(C)
        return [float(bg[ch]) for ch in range(C)]
    P = max(len(a.volume.points) if a.volume is not None else 1,
            len(a.pan.points) if a.pan is not None else 1, 1)
    volv = eval_lane_numpy(*lane_frame_table(a.volume, sample_rate, bd, P, float(bus.volume_linear)), g)
    panv = eval_lane_numpy(*lane_frame_table(a.pan, sample_rate, bd, P, float(bus.pan)), g)
    mute = np.float32(0.0 if bus.mute else 1.0)
    return [((volv * _pan_coef_f32(panv, ch)) * mute).astype(np.float64) for ch in range(C)]


def reference_routed_finish(per_track: np.ndarray, session, sample_rate: float, channels: int = 2,
                            pdc: bool = False) -> np.ndarray:
    """Sequential f64 host ground truth of the routed pipeline: per-effect
    reference models, f64 gains, routing and sums, the hard clip. ``pdc``
    mirrors the device PDC (track fetch-ahead, bus delay-to-align, master
    head trim)."""
    chains, master = _chains_of(session)
    bus_chains = _bus_chains_of(session)
    bd = session.time_base
    T, C, F = per_track.shape
    g = np.arange(F, dtype=np.int64)
    auto_tables = pack_session_automation(session, sample_rate) if session_has_automation(session) else None

    def track_lanes(t):
        a = session.tracks[t].automation
        return a.effects if (a is not None and a.effects) else None

    def chain_input(t):
        x = per_track[t].astype(np.float64)
        if pdc and chains[t] is not None:
            chains[t].prepare(sample_rate, channels)
            lat = chains[t].latency_frames()
            if lat > 0:
                x = np.pad(x[:, lat:], ((0, 0), (0, lat)))
        return x

    blat_ref = np.zeros(len(bus_chains), np.int64)
    if pdc:
        for bi, c in enumerate(bus_chains):
            if c is not None:
                blat_ref[bi] = c.prepare(sample_rate, channels).latency_frames()
    BL_ref = int(blat_ref.max()) if (pdc and len(bus_chains)) else 0

    pre = np.stack([reference_run_chain(chains[t], chain_input(t), track_lanes(t), sample_rate, channels, bd)
                    for t in range(T)])
    post = np.empty_like(pre)
    for t in range(T):
        gains = _ref_track_gains(session, t, C, g, auto_tables)
        for ch in range(C):
            post[t, ch] = pre[t, ch] * gains[ch]

    m = build_routing_matrices(session, channels)
    r_post, r_pre = m.r_post, m.r_pre
    B = len(session.buses)
    direct = np.einsum("t,tcf->cf", r_post[0].astype(np.float64), post)
    # bus-latency PDC as on the device: every master input is delayed to
    # the largest bus latency BL, the master chain runs over the extended
    # stream, and BL trims off the head with the master latency
    total = np.zeros((C, F + BL_ref), np.float64)
    total[:, BL_ref:] += direct
    for b in range(B):
        bus_in = (np.einsum("t,tcf->cf", r_post[1 + b].astype(np.float64), post)
                  + np.einsum("t,tcf->cf", r_pre[b].astype(np.float64), pre))
        key = None
        if m.k_post[b].any() or m.k_pre[b].any():
            key = (np.einsum("t,tcf->cf", m.k_post[b].astype(np.float64), post)
                   + np.einsum("t,tcf->cf", m.k_pre[b].astype(np.float64), pre))
        ab = getattr(session.buses[b], "automation", None)
        blanes = ab.effects if (ab is not None and ab.effects) else None
        bus_out = reference_run_chain(bus_chains[b], bus_in, blanes, sample_rate, channels, bd, key=key)
        bg = _ref_bus_gains(session.buses[b], C, g, sample_rate, bd)
        d_b = BL_ref - int(blat_ref[b])
        for ch in range(C):
            total[ch, d_b:d_b + F] += bus_out[ch] * bg[ch]
    mlanes = dict(getattr(session, "master_automation", {}) or {}) or None
    if master is not None:
        mlat = 0
        if pdc:
            master.prepare(sample_rate, channels)
            mlat = master.latency_frames()
        if mlat > 0:
            total = np.pad(total, ((0, 0), (0, mlat)))
        total = reference_run_chain(master, total, mlanes, sample_rate, channels, bd)
        total = total[:, BL_ref + mlat:]
    else:
        total = total[:, BL_ref:] if BL_ref else total
    return np.clip(total, -1.0, 1.0).astype(np.float32)
