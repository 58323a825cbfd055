"""The sharded timeline render over a ('tracks', 'frames') mesh of ranks.

Counterpart of ``whitebox_tpu/parallel/render_sharded.py``. Each rank
renders its track shard x frame shard tile with the per-track
contribution program of the single-device gather mix
(``ops/mix.py::_track_contrib``), sums its tracks in index order, and the
partial sums meet in the ordered track sum over the tracks axis
(``collectives.ordered_sum``: gathered and added in rank order); the hard
clip follows. Frame shards are independent in the mix (it is a gather,
not a stencil). As in the JAX package the sharded mix is the gather, not
the mix kernel.

Sum order: within a rank the tracks add in index order from zero; across
the tracks axis the partials add in rank order. On a frames-only mesh
the sum is the single-device gather bounce's, bit for bit; a tracks axis
of more than one changes the association (a tolerance, not the bit).

``bounce_sharded`` returns the whole ``[C, F]`` ``np.float32`` on every
rank, as the JAX function returns it to its one controller. Sessions with
per-track processing (chains, lanes, MIDI, buses) take
:func:`_bounce_sharded_fx_2d`: per-track contributions on the rank's tile,
each chain group spread over the tracks axis by an explicit exchange and
run frame-sharded with the exact state handoff (``effects_sharded``),
gains, the routing products or the ordered sum, bus chains, the master
chain and the clip. The shard's contributions are rendered
:data:`CONTRIB_FRAMES` frames at a time, which bounds the gather's
temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.midi.synth import render_synth_chunk
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.mix import _frames, _track_contrib, pack_device_tables
from whitebox_tpu_torch.ops.resample import full_f32_matmul
from whitebox_tpu_torch.parallel.collectives import all_gather, gather_frames, ordered_sum
from whitebox_tpu_torch.parallel.effects_sharded import chain_group, chain_program, chain_shard
from whitebox_tpu_torch.render.bounce import _prepare_synth_tables, session_has_midi
from whitebox_tpu_torch.render.effects_generic import (
    device_params, fx_latencies, prepare_generic_fx, stage_latency_frames,
)
from whitebox_tpu_torch.render.effects_pipeline import _frame_gains, _ordered_sum, prepare_automation_tables
from whitebox_tpu_torch.render.routing import _route, prepare_routed_fx, routed_device_params
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.timeline.carve import carve_session

#: frames of a shard's contributions rendered at once (the gather's
#: per-frame temporaries are ``[T, frames]`` int64 and f32)
CONTRIB_FRAMES = 1 << 16


def shard_tables(tables: dict, mesh) -> dict:
    """This rank's rows of the packed tables (``DeviceTables.as_torch``),
    sliced by its tracks coordinate, on its device; the track count must
    divide by the tracks axis (``pack_device_tables(pad_tracks_to=...)``)."""
    tp, ti = mesh.shape["tracks"], mesh.coords["tracks"]
    T = tables["dst_start"].shape[0]
    if T % tp:
        raise ValueError(f"{T} table tracks do not divide over {tp} track shards")
    n = T // tp
    return {k: torch.as_tensor(v)[ti * n:(ti + 1) * n].to(mesh.device) for k, v in tables.items()}


def _tile_contribs(pool, tables, chunk_start: int, f_local: int, frames_index: int) -> torch.Tensor:
    """Per-track contributions ``[T_local, C, f_local]`` of this frame shard."""
    T, _, C = tables["src_base"].shape
    g0 = int(chunk_start) + frames_index * f_local
    out = torch.empty((T, C, f_local), dtype=torch.float32, device=pool.device)
    for a in range(0, f_local, CONTRIB_FRAMES):
        n = min(CONTRIB_FRAMES, f_local - a)
        out[..., a:a + n] = _track_contrib(pool, tables, _frames(g0 + a, n, pool.device))
    return out


def _clip(total: torch.Tensor) -> torch.Tensor:
    total = torch.where(total > 1.0, 1.0, total)
    return torch.where(total < -1.0, -1.0, total)


def render_chunk_sharded(pool, tables, chunk_start: int, frames: int, mesh) -> torch.Tensor:
    """Render ``frames`` output frames from ``chunk_start`` -> this rank's
    frame shard ``[C, frames // fp]`` (the same on every rank of a tracks
    column). ``tables``: this rank's track shard (:func:`shard_tables`);
    ``frames`` must divide by the frames axis."""
    fp = mesh.shape["frames"]
    if frames % fp:
        raise ValueError("frames must divide over the frames mesh axis")
    f_local = frames // fp
    g0 = int(chunk_start) + mesh.coords["frames"] * f_local
    C = tables["src_base"].shape[2]
    local = torch.empty((C, f_local), dtype=torch.float32, device=pool.device)
    for a in range(0, f_local, CONTRIB_FRAMES):
        n = min(CONTRIB_FRAMES, f_local - a)
        contribs = _track_contrib(pool, tables, _frames(g0 + a, n, pool.device))
        local[:, a:a + n] = _ordered_sum(contribs * tables["track_gain"][:, :, None])
    return _clip(ordered_sum(local, mesh.axis("tracks")))


def _resolve_sinc_host(table, pool, interpolation: str):
    """Quality-mode front end for mesh renders.

    ``interpolation="sinc"`` rewrites the table with the HOST prerender
    (``timeline/prerender.py::apply_prerender_host``): every resampled run
    becomes a speed +-1.0 row over exactly rendered polyphase content,
    which the linear sharded mix plays exactly. Requires full coverage;
    the pathological residue class (speeds > 8, near-simple fractions) has
    no sharded fallback: render single-chip for the oversample form."""
    if interpolation == "linear":
        return table, pool
    if interpolation != "sinc":
        raise NotImplementedError(
            f"bounce_sharded supports interpolation='linear'/'sinc', got "
            f"{interpolation!r} (catmull is a single-chip kernel mode)")
    if not len(table) or table.fast.all():
        return table, pool
    from whitebox_tpu_torch.timeline.prerender import apply_prerender_host, plan_prerender

    plan = plan_prerender(table, pool, partial=True)
    if plan is None or plan.uncovered_rows is not None:
        raise NotImplementedError(
            "bounce_sharded(interpolation='sinc') needs full prerender "
            "coverage (|speed| <= 8, non-pathological ratios); render "
            "single-chip for the oversample fallback")
    return apply_prerender_host(table, pool, plan)


def bounce_sharded(session, sample_rate: float, mesh, *, buffer_size: int = 512, channels: int = 2,
                   master_effects=None, pdc: bool = False, interpolation: str = "linear"):
    """Render a whole session over a ('tracks', 'frames') mesh of ranks.

    Every rank calls it with the same session. Carve (host), pack, this
    rank's rows of the segment tables, the sharded mix over its frame
    shard with the ordered sum over the tracks axis, then an optional
    master chain with exact cross-shard state handoff. Returns
    ``[channels, frames]`` ``np.float32`` on every rank.

    ``interpolation="sinc"`` renders resampled clips at polyphase quality
    through the host prerender rewrite (:func:`_resolve_sinc_host`).
    ``master_effects`` defaults to the session's own master chain; on a
    plain mix it follows the clipped mix, as in the JAX package. Per-track
    chains, automation lanes, MIDI and buses render sharded too
    (:func:`_bounce_sharded_fx_2d`), on any mesh shape."""
    needs_per_track = (any(t.effects for t in session.tracks)
                       or session_has_automation(session) or session_has_midi(session)
                       or bool(getattr(session, "master_automation", None))
                       or session_has_routing(session))
    if needs_per_track:
        return _bounce_sharded_fx_2d(session, sample_rate, mesh, buffer_size=buffer_size, channels=channels,
                                     master_effects=master_effects, pdc=pdc, interpolation=interpolation)
    if master_effects is None and session.master_effects:
        ch = session.master_effects
        master_effects = list(ch.effects) if hasattr(ch, "effects") else list(ch)

    tp, fp = mesh.shape["tracks"], mesh.shape["frames"]
    table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, out_channels=channels,
                                slow_emit="runs")
    table, pool = _resolve_sinc_host(table, pool, interpolation)
    T = max(table.num_tracks, 1)
    dev = pack_device_tables(table, pool, session, channels=channels, pad_tracks_to=-(-T // tp) * tp)
    tables = shard_tables(dev.as_torch(), mesh)
    pool_dev = torch.from_numpy(pool.data).to(mesh.device)

    frames = -(-max(table.total_frames, 1) // (fp * 128)) * (fp * 128)
    local = render_chunk_sharded(pool_dev, tables, 0, frames, mesh)
    fax = mesh.axis("frames")
    if master_effects:
        stages, params = chain_program(master_effects, float(sample_rate), channels, mesh.device)
        local = chain_shard(stages, params, local[None], fax, fp, float(sample_rate))[0]
    return gather_frames(local, fax).cpu().numpy()[:, :table.total_frames]


def _pdc_latencies(fx, rfx, pdc: bool):
    """(per-group chain latency, master latency) for the PDC fetch-ahead;
    zeros when pdc is off. Latent BUS chains raise: the sharded pipeline
    runs bus chains framewise and does not carry their delay lines (the
    single-device streaming path's contract)."""
    if not pdc:
        return [0] * len(fx.groups), 0
    glat, mlat = fx_latencies(fx)
    if rfx is not None and any(stage_latency_frames(g.stages) > 0 for g in rfx.bus_groups):
        raise ValueError(
            "sharded PDC does not carry bus-chain latency; move lookahead "
            "chains to tracks or the master, or render single-chip with "
            "engine='auto'/'pallas' (the routed finisher compensates bus "
            "latency)")
    return glat, mlat


def _pad_auto_tables(auto, Tp: int):
    """Pad automation tables' track axis to ``Tp`` (padded rows: no lanes,
    muted; their contributions are zero anyway)."""
    if auto is None:
        return None
    vol, pan, mute, use_auto = auto
    padn = Tp - mute.shape[0]
    if padn == 0:
        return auto

    def padt(v):
        return torch.cat([v, torch.zeros((padn,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)])

    return ({k: padt(v) for k, v in vol.items()}, {k: padt(v) for k, v in pan.items()},
            padt(mute), padt(use_auto))


def _rows_of_params(p, a: int, b: int, C: int):
    """Rows ``[a, b)`` of a stage's parameters (leading dim B; the cascade
    coefficients ``[9, S, B*C, 1]`` by their row blocks; lane tables
    recursively)."""
    out = {}
    for k, v in p.items():
        if k == "auto":
            out[k] = {n: {kk: t[a:b] for kk, t in tab.items()} for n, tab in v.items()}
        elif k == "casc":
            out[k] = v[:, :, a * C:b * C].contiguous()
        else:
            out[k] = v[a:b]
    return out


def _exchange_group(src, rows: np.ndarray, row0: int, T_local: int, mesh):
    """Spread a chain group's track rows over the tracks axis: each rank
    sends the rows it owns and gets the group in order -> (the rows of the
    group this rank runs ``[lo, hi)``, the group's rows ``[B, C, F]``)."""
    tp = mesh.shape["tracks"]
    owner = rows // T_local
    cap = max(int(np.bincount(owner, minlength=tp).max()), 1)
    mine = np.nonzero(owner == mesh.coords["tracks"])[0]
    buf = torch.zeros((cap,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    if mine.size:
        buf[:mine.size] = src[torch.as_tensor(rows[mine] - row0, device=src.device)]
    parts = all_gather(buf, mesh.axis("tracks"))  # [tp, cap, C, F]
    full = torch.empty((len(rows),) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    for r in range(tp):
        pos = np.nonzero(owner == r)[0]
        if pos.size:
            full[torch.as_tensor(pos, device=src.device)] = parts[r, :pos.size]
    return full


def _bounce_sharded_fx_2d(session, sample_rate: float, mesh, *, buffer_size: int, channels: int,
                          master_effects=None, pdc: bool = False, interpolation: str = "linear"):
    """Effectful sharded bounce on a ('tracks', 'frames') mesh, in the
    single-device pipeline's order (``render/effects_generic.py::_chunk_step``):

    1. per-track contributions (+ MIDI synth voices) of the rank's tile;
       PDC renders latent groups' tracks that many frames ahead;
    2. each chain group, spread over the tracks axis (an explicit exchange
       of its rows; ``B/tp`` tracks a rank), runs frame-sharded with the
       exact cross-shard state handoff (``effects_sharded.chain_shard``),
       and the processed rows return to their owners;
    3. per-frame automation/fader gains on the local rows, then the routing
       products (buses) or the ordered track sum over the tracks axis, the
       bus chains, the master chain (frame-sharded) and the hard clip.

    Automation and synth are pure functions of the global frame index, so
    they shard trivially. Master latency renders further and trims the
    head (PDC). On a frames-only mesh (the JAX package's
    ``_bounce_sharded_fx``) every rank holds every track of its frame shard
    and nothing crosses the tracks axis."""
    tp, fp = mesh.shape["tracks"], mesh.shape["frames"]
    ti, fi = mesh.coords["tracks"], mesh.coords["frames"]
    fax, tax = mesh.axis("frames"), mesh.axis("tracks")
    dev = mesh.device
    rate = float(sample_rate)
    C = channels
    routed = session_has_routing(session)
    if routed:
        rfx = prepare_routed_fx(session, sample_rate, channels, device=dev)
        fx = rfx.fx
    else:
        rfx = None
        fx = prepare_generic_fx(session, sample_rate, channels)
    if master_effects is not None:  # an explicit master list overrides the session's chain
        fx.master = chain_group(master_effects, rate, channels)
    if routed:
        gparams, bparams, mparams, routing = routed_device_params(rfx, dev)
    else:
        (gparams, mparams), bparams, routing = device_params(fx, dev), [], None
    glat, mlat = _pdc_latencies(fx, rfx, pdc)

    table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, out_channels=channels,
                                slow_emit="runs")
    table, pool = _resolve_sinc_host(table, pool, interpolation)
    T = max(table.num_tracks, 1)
    Tp = -(-T // tp) * tp
    Tl = Tp // tp
    row0 = ti * Tl
    packed = pack_device_tables(table, pool, session, channels=channels, pad_tracks_to=Tp)
    tables = shard_tables(packed.as_torch(), mesh)
    pool_dev = torch.from_numpy(pool.data).to(dev)
    # shards pad to PARAM_BLOCK multiples so timed-coefficient (TV biquad)
    # param blocks align with the single-device 512-frame grid
    frames = -(-(max(table.total_frames, 1) + mlat) // (fp * 512)) * (fp * 512)
    f_local = frames // fp
    base = fi * f_local

    auto = _pad_auto_tables(prepare_automation_tables(session, sample_rate, device=dev), Tp)
    if auto is not None:
        vol, pan, mute, use = auto
        auto = ({k: v[row0:row0 + Tl] for k, v in vol.items()}, {k: v[row0:row0 + Tl] for k, v in pan.items()},
                mute[row0:row0 + Tl], use[row0:row0 + Tl])
    synth = (_prepare_synth_tables(session, sample_rate, buffer_size, max(table.total_frames // buffer_size, 1), dev)
             if session_has_midi(session) else {})
    own = [j for j, t in enumerate(synth.get("rows", ())) if row0 <= t < row0 + Tl]

    def contribs_at(off: int):
        c = _tile_contribs(pool_dev, tables, off, f_local, fi)
        if own:
            k = torch.as_tensor(own, device=dev)
            sy = render_synth_chunk({n: v[k] for n, v in synth["tables"].items()}, base + off, f_local)
            idx = torch.as_tensor([synth["rows"][j] - row0 for j in own], device=dev)
            c = c.index_add(0, idx, sy[:, None, :].expand(-1, C, -1))
        return c

    # ---- stage 1: per-track contributions (+ synth) of the tile ----
    contribs = contribs_at(0)
    shifted = {lat: contribs_at(lat) for lat in sorted({lat for lat in glat if lat > 0})}

    # ---- stage 2: chain groups, spread over the tracks axis ----
    for g, pl, lat in zip(fx.groups, gparams, glat):
        stages = [(k, s) for (k, s, _) in g.stages]
        rows = np.asarray(g.track_idx, np.int64)
        src = shifted[lat] if lat > 0 else contribs
        if tp == 1:
            idx = torch.as_tensor(rows, device=dev)
            contribs[idx] = chain_shard(stages, pl, src[idx], fax, fp, rate)
            continue
        full = _exchange_group(src, rows, row0, Tl, mesh)
        B = len(rows)
        Bl = -(-B // tp)
        lo, hi = min(ti * Bl, B), min((ti + 1) * Bl, B)
        out = torch.zeros((Bl,) + tuple(full.shape[1:]), dtype=full.dtype, device=dev)
        if hi > lo:  # every rank of this tracks column has the same rows
            out[:hi - lo] = chain_shard(stages, [_rows_of_params(p, lo, hi, C) for p in pl], full[lo:hi], fax,
                                        fp, rate)
        done = all_gather(out, tax).reshape((tp * Bl,) + tuple(full.shape[1:]))[:B]
        mine = np.nonzero(rows // Tl == ti)[0]
        if mine.size:
            contribs[torch.as_tensor(rows[mine] - row0, device=dev)] = done[torch.as_tensor(mine, device=dev)]

    # ---- stage 3: gains -> routing / ordered track sum -> buses -> master ----
    gidx = base + torch.arange(f_local, dtype=torch.int32, device=dev)
    y = contribs * _frame_gains(auto, tables["track_gain"], gidx, Tl, C)
    if routed:
        r_post, r_pre, bus_gain, k_post, k_pre = routing
        if rfx.has_key:
            r_post, r_pre = torch.cat([r_post, k_post]), torch.cat([r_pre, k_pre])

        def cols(r):  # this rank's track columns (pad columns are 0)
            return torch.nn.functional.pad(r, (0, Tp - r.shape[1]))[:, row0:row0 + Tl].contiguous()

        B = rfx.num_buses
        with full_f32_matmul():
            routed_sig = _route(cols(r_post), y)  # [1 + B (+ B keys), C, f]
            if B:
                pre = _route(cols(r_pre), contribs)
                routed_sig = torch.cat([routed_sig[:1], routed_sig[1:] + pre])
        routed_sig = ordered_sum(routed_sig, tax)
        total = routed_sig[0]
        if B:
            bus_in = routed_sig[1:1 + B].clone()
            key_in = routed_sig[1 + B:] if rfx.has_key else None
            for g, pl in zip(rfx.bus_groups, bparams):
                idx = torch.as_tensor(g.track_idx, device=dev)
                yb = chain_shard([(k, s) for (k, s, _) in g.stages], pl, bus_in[idx], fax, fp, rate,
                                 key=None if key_in is None else key_in[idx])
                bus_in.index_copy_(0, idx, yb)
            total = total + _ordered_sum(bus_in * _frame_gains(rfx.bus_auto, bus_gain, gidx, B, C))
    else:
        total = ordered_sum(_ordered_sum(y), tax)
    if fx.master is not None:
        total = chain_shard([(k, s) for (k, s, _) in fx.master.stages], mparams, total[None], fax, fp,
                            rate)[0]
    out = gather_frames(_clip(total), fax)
    return out.cpu().numpy()[:, mlat:mlat + table.total_frames]
