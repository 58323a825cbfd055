"""Offline bounce: session -> mixed audio (and WAV export) on the card.

Counterpart of ``whitebox_tpu/render/bounce.py``: audio clips (any loop
mode, fades, clip gain, speed), track volume/pan/mute, volume/pan lanes
(any of the nine curves, under a tempo map too), effect chains on tracks
and the master bus (the whole built-in family and registered user
effects), effect-parameter lanes on tracks and the master, level meters,
plugin-delay compensation, the ordered track sum and the hard clip, in
the three interpolation modes of resampled clips (``"linear"``,
``"catmull"``, ``"sinc"``). Two mixes, chosen as the JAX package chooses:

- the kernel path (``engine="auto"`` or ``"pallas"``; the JAX package's
  Pallas branch, ``bounce.py:236-442``): carve with ``slow_emit="runs"``,
  resolve the interpolation (a sinc bounce pre-renders resampled runs
  into a pool extension on the device, ``timeline/prerender.py``; runs
  that cannot ride it play a 4x oversampled copy through six polynomial
  taps, ``timeline/oversample.py``), plan the slots, then one launch of
  the CUDA mix kernel (its automation variant when a track has lanes) or,
  for a session with effects, effect lanes or meters, one launch of the
  per-track mode (K4) into ``[T, C, F]`` buffers and a finisher:
  ``effects_mode="scan"`` (the biquad cascade kernel,
  ``effects_pipeline.finish_mix``) or ``"fir"`` (``effects_fir``) for
  linear chains, ``"generic"`` (``effects_generic``) for every other
  chain or any effect-parameter lane; meters force the scan;
- the gather path (``engine="xla"``, and ``"auto"`` where the plan cannot
  hold the session: a slot overflow at the smallest tile, or per-track
  buffers above :func:`per_track_limit_bytes`; the JAX package's
  ``bounce.py:444-629``): carve with ``slow_emit="blocks"``, the chunked
  gather mix of ``ops/mix.py`` in ``chunk_frames`` chunks, with the
  finishers' streaming forms (``finish_mix_chunk``,
  ``make_generic_chunk_fn``) carrying their states from chunk to chunk.
  ``engine="xla"`` with ``interpolation="sinc"`` is the direct 32-tap
  windowed sinc. ``engine="pallas"`` raises on a slot overflow, as the
  JAX package does.

``stats.mix_path`` says which mix rendered. Routing (buses, sends,
``effects_mode="routed"``), MIDI clips, loudness and codecs raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.effects.base import UNPORTED_EFFECT_TODO, UnportedEffect
from whitebox_tpu_torch.io.wav import write_wav
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk, render_chunk_per_track
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow, build_plan
from whitebox_tpu_torch.ops.resample import design_sinc_bank
from whitebox_tpu_torch.render.effects_fir import prepare_fir_finish
from whitebox_tpu_torch.render.effects_generic import (
    auto_chunk_frames, fx_latencies, init_generic_states, make_generic_chunk_fn,
    make_generic_finisher, prepare_generic_fx, session_fx_packable,
)
from whitebox_tpu_torch.render.effects_pipeline import (
    _chains_of, finish_mix, finish_mix_chunk, init_effect_states, meters_from_partials,
    prepare_automation_tables, prepare_automation_tables_host, prepare_effect_tables,
    session_has_effects,
)
from whitebox_tpu_torch.render.metrics import DeviceTimer, RenderStats, Stopwatch, device_name
from whitebox_tpu_torch.render.roofline import device_peaks, estimate_bounce_cost, prerender_cost
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import device_pool_cached, resolve_interpolation
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_device
from whitebox_tpu_torch.timeline.transport import BlockTransport

#: off the card, per-track buffers above this many bytes take the gather
#: path: the JAX package's figure (``whitebox_tpu/render/bounce.py:314``),
#: so that both packages choose alike on the CPU
PER_TRACK_LIMIT_BYTES = 6 << 30
#: on the card, the per-track buffers may take this share of the memory
#: the process can still allocate; the rest holds the finisher's working
#: set (peaks on an H100: 1.2x the buffers for the scan finisher, 1.6x for
#: the generic one; the FIR finisher pads a copy of them)
PER_TRACK_CARD_SHARE = 1 / 3
_ROUTING = "item 6(b) (routing)"


def per_track_limit_bytes(dev: torch.device) -> int:
    """The largest per-track buffer ``[T, C, F]`` (bytes) that the kernel
    path renders on ``dev``; ``engine="auto"`` takes the gather path above
    it. On the card a share of the free memory (the allocator's cached
    blocks included), so a long session rides K4 wherever it fits."""
    if dev.type != "cuda":
        return PER_TRACK_LIMIT_BYTES
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int((free + cached) * PER_TRACK_CARD_SHARE)


def session_has_midi(session) -> bool:
    """``whitebox_tpu/render/bounce.py::_session_has_midi``."""
    return any(c.is_midi() and c.midi is not None and c.midi.asset is not None
               for t in session.tracks for c in t.clips)


#: keywords of the reference's ``bounce`` that the port takes at their
#: defaults only: name -> (default, the ROADMAP.md queue 1 item that ports
#: the feature); any other value raises ``NotImplementedError`` naming it
DEFAULT_ONLY = {
    "routed_chunk": (None, _ROUTING),
    "loudness": (False, "item 9 (loudness)"),
    "normalize": (None, "item 9 (loudness)"),
    "out_encode": (None, "item 14 (codecs)"),
}


def _check_keywords(engine: str, **given) -> None:
    """The reference's other keywords: defaults pass, anything else raises
    by name."""
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"engine must be 'auto', 'pallas' or 'xla', got {engine!r}")
    for name, value in given.items():
        default, item = DEFAULT_ONLY[name]
        if value != default:
            raise NotImplementedError(f"whitebox_tpu_torch bounce does not take {name}={value!r} "
                                      f"yet: ROADMAP.md queue 1, {item}")


def _check_supported(session: Session, interpolation: str, effects_mode: str) -> None:
    chains, master = _chains_of(session)
    unported = sorted({e.type_name for c in [*chains, master] if c is not None for e in c.effects
                       if isinstance(e, UnportedEffect)})
    if unported:
        raise NotImplementedError(f"whitebox_tpu_torch bounce cannot render the effect(s) "
                                  f"{', '.join(unported)}: {UNPORTED_EFFECT_TODO}")
    todo = [
        (effects_mode == "routed", "effects_mode='routed'", _ROUTING),
        (session_has_midi(session), "MIDI clips", "item 5 (MIDI synth)"),
        (session_has_routing(session), "bus routing", _ROUTING),
    ]
    for present, what, item in todo:
        if present:
            raise NotImplementedError(f"whitebox_tpu_torch bounce does not render {what} yet: "
                                      f"ROADMAP.md queue 1, {item}")
    if effects_mode not in ("scan", "fir", "generic"):
        raise ValueError(f"effects_mode must be 'scan', 'fir' or 'generic', got {effects_mode!r}")
    if interpolation not in ("linear", "catmull", "sinc"):
        raise ValueError(f"interpolation must be 'linear', 'catmull', or 'sinc', got {interpolation!r}")


@dataclass
class BounceResult:
    audio: np.ndarray  # [channels, frames] f32
    stats: RenderStats

    @property
    def frames(self) -> int:
        return self.audio.shape[1]


def _effects_finisher(session, renderer, plan, sample_rate, channels, effects_mode, meters, dev,
                      pdc=False):
    """Host preparation of the finisher -> ``finish(per_track)``: the chain
    tables (scan), impulse responses (fir) or grouped stages (generic: any
    chain the linear finishers cannot take, or any effect lane) and the
    lane tables, on ``dev``."""
    auto = prepare_automation_tables(session, sample_rate, device=dev)
    tg = renderer.tables["track_gain"]
    T = plan.num_tracks
    if effects_mode == "generic" or not session_fx_packable(session):
        fx = prepare_generic_fx(session, sample_rate, channels)
        finish = make_generic_finisher(fx, T, channels, with_meters=meters,
                                       valid_frames=plan.total_frames, pdc=pdc, device=dev)
        return lambda pt: finish(pt, tg, auto)
    if effects_mode == "fir":
        return prepare_fir_finish(session, sample_rate, tg, auto, channels, device=dev)
    (S, coeffs), (Sm, mcoeffs) = prepare_effect_tables(session, sample_rate, channels, device=dev)
    return lambda pt: finish_mix(pt, coeffs, mcoeffs, tg, auto, T=T, C=channels, S=S, Sm=Sm,
                                 with_meters=meters, valid_frames=plan.total_frames)


def _read_meters(stats, meters, T: int) -> None:
    tp, trms, op, orms = (np.asarray(m.cpu().numpy()) for m in meters)
    stats.track_peak, stats.track_rms = tp[:T], trms[:T]
    stats.output_peak, stats.output_rms = op, orms


def _render_kernel(session, table, pool, plan, interp, pre_pool_dev, sample_rate, channels,
                   effects_mode, meters, pdc, has_fx, dev, stats, watch) -> np.ndarray:
    """The mix kernel (or K4 and a finisher) over the slot plan."""
    finish = None
    if has_fx:
        # per-track mode (K4): lanes evaluate in the finisher's gains
        renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                   interp=interp, pool_device=pre_pool_dev)
        finish = _effects_finisher(session, renderer, plan, sample_rate, channels, effects_mode,
                                   meters, dev, pdc=pdc)
    else:
        # automation-only sessions evaluate the volume/pan lanes in the kernel
        # (the JAX package's fused single pass, bounce.py:316-333)
        renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                   interp=interp, pool_device=pre_pool_dev,
                                   auto_tables=prepare_automation_tables_host(session, sample_rate))
    stats.carve_seconds = watch.lap()
    if dev.type == "cuda":
        cuda_build.load()  # nvcc at first use in the process, not in the mix time
    stats.compile_seconds = watch.lap()

    res = None
    with DeviceTimer(dev) as timer:
        if finish is None:
            out_dev = renderer.render_device()
        else:
            pt = renderer.render_device_per_track()
            with DeviceTimer(dev) as ftimer:
                res = finish(pt)
            out_dev = res[0] if meters else res
    stats.device_seconds = timer.seconds
    if finish is not None:
        stats.finish_seconds = ftimer.seconds
    watch.lap()
    out = out_dev[:, : plan.total_frames].cpu().numpy()
    if meters:
        _read_meters(stats, res[1], len(session.tracks))
    stats.readback_seconds = watch.lap()
    return out


def _render_gather(session, table, pool, sample_rate, channels, buffer_size, num_blocks, engine,
                   interpolation, sinc_bank, interp, pre_pool_dev, chunk_frames, strict_order,
                   meters, pdc, dev, stats, watch) -> np.ndarray:
    """The chunked gather mix (``whitebox_tpu/render/bounce.py:444-629``)."""
    if engine != "xla" and len(table) and (not table.fast.all() or pre_pool_dev is not None):
        # the table was carved with slow_emit="runs" for the slot plan; the
        # gather path's parity contract needs the blockwise sequentially
        # rounded phases, so re-carve; a prerendered pool extension (on the
        # device only) is dropped and the interpolation resolved again in
        # its oversampled form
        table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, num_blocks=num_blocks,
                                    out_channels=channels, slow_emit="blocks")
        if sinc_bank is None and interpolation != "linear":
            table, pool, interp = resolve_interpolation(table, pool, interpolation)
    tables = pack_device_tables(table, pool, session, channels=channels)
    jt = tables.as_torch(dev)
    pool_dev = torch.from_numpy(pool.data).to(dev)
    F = tables.total_frames
    T = tables.num_tracks
    chunk = min(chunk_frames, max(F, 1))

    def per_track(start, tab=jt):
        return render_chunk_per_track(pool_dev, tab, start, chunk, sinc_bank=sinc_bank, interp=interp)

    fx_chunk = None
    mlat = 0
    if session_has_effects(session) or session_has_automation(session) or meters:
        auto = prepare_automation_tables(session, sample_rate, device=dev)
        tg = jt["track_gain"]
        if not session_fx_packable(session):
            gfx = prepare_generic_fx(session, sample_rate, channels)
            ahead = []  # PDC fetch-ahead: the rows of latent chains, rendered lat frames ahead
            if pdc:
                glat, mlat = fx_latencies(gfx)
                by_lat: dict = {}
                for g, lat in zip(gfx.groups, glat):
                    if lat > 0:
                        by_lat.setdefault(lat, []).extend(np.asarray(g.track_idx).tolist())
                for lat, rows in by_lat.items():
                    idx = torch.as_tensor(sorted(rows), device=dev)
                    ahead.append((lat, idx, {k: v[idx] for k, v in jt.items()}))
            chunk = auto_chunk_frames(gfx, chunk, device=dev)
            gstep = make_generic_chunk_fn(gfx, T, channels, chunk=chunk, with_meters=meters, device=dev)
            states = init_generic_states(gfx, channels, dev)

            def fx_chunk(start, states):
                pt = per_track(start)
                for lat, idx, sub in ahead:
                    pt[idx] = per_track(start + lat, sub)
                res = gstep(pt, *states, start, tg, auto)
                return res[0], res[1:3], res[3] if meters else None
        else:
            (S, coeffs), (Sm, mcoeffs) = prepare_effect_tables(session, sample_rate, channels, device=dev)
            states = init_effect_states(T, channels, S, Sm, dev)

            def fx_chunk(start, states):
                res = finish_mix_chunk(per_track(start), coeffs, mcoeffs, tg, *states, start, auto,
                                       T=T, C=channels, S=S, Sm=Sm, with_meters=meters)
                return res[0], res[1:3], res[3] if meters else None
    stats.carve_seconds = watch.lap()
    if dev.type == "cuda":
        cuda_build.load()  # the cascade kernel of the linear finisher
    stats.compile_seconds = watch.lap()

    outs, parts = [], []
    with DeviceTimer(dev) as timer:
        for start in range(0, F + mlat, chunk):  # master latency: render further, trim the head
            if fx_chunk is None:
                outs.append(render_chunk(pool_dev, jt, start, chunk, strict_order=strict_order,
                                         sinc_bank=sinc_bank, interp=interp))
            else:
                total, states, m = fx_chunk(start, states)
                outs.append(total)
                parts.append(m)
        out_dev = torch.cat(outs, dim=1)[:, mlat:mlat + F]
    stats.device_seconds = timer.seconds
    watch.lap()
    out = out_dev.cpu().numpy()
    if meters:
        # the ragged last chunk renders at full length; its extra frames count
        _read_meters(stats, meters_from_partials(parts, F), len(session.tracks))
    stats.readback_seconds = watch.lap()
    return out


def bounce(
    session: Session,
    sample_rate: float = 48000.0,
    *,
    device=None,
    buffer_size: int = 512,
    channels: int = 2,
    chunk_frames: int = 1 << 17,
    num_blocks: int | None = None,
    trim_frames: int | None = None,
    tail_seconds: float = 0.0,
    strict_order: bool = True,
    engine: str = "auto",
    interpolation: str = "linear",
    effects_mode: str = "scan",
    routed_chunk: int | None = None,
    prerender: bool | None = None,
    meters: bool = False,
    pdc: bool = False,
    loudness: bool = False,
    normalize: tuple | None = None,
    out_path=None,
    out_format: AudioFormat = AudioFormat.F32,
    out_dither: str | None = None,
    out_encode=None,
) -> BounceResult:
    """Render the whole session timeline at once on ``device`` (default: CUDA).

    ``buffer_size`` is the emulated engine block size: it defines event
    carving semantics, not the device schedule. ``tail_seconds`` renders
    past the last clip edge (ignored when ``num_blocks`` is given), so
    effect tails ring out. ``interpolation`` applies to resampled clips:
    ``"linear"`` (reference parity, sampler.cpp:34), ``"catmull"``
    (4-point Catmull-Rom, the mode the reference leaves unfinished at
    sampler.cpp:61-86) or ``"sinc"``; speed-1 clips stay bit-exact in
    every mode. ``prerender``: None lets a sinc bounce pre-render the
    resampled runs; False forces the oversampled pool and six polynomial
    taps. ``engine``: "auto" (the kernel, the gather path where the plan
    cannot hold the session), "pallas" (the kernel only; the name is the
    JAX package's) or "xla" (the gather path; a sinc bounce there is the
    direct 32-tap form). ``chunk_frames``: frames per gather-path chunk;
    ``strict_order=False`` lets that path sum the tracks in one
    ``torch.sum`` (order not fixed). ``effects_mode``: ``"scan"``,
    ``"fir"`` or ``"generic"`` (chains the first two cannot take, or any
    effect lane, finish generic regardless). ``meters``: also fill
    ``stats.track_peak``/``track_rms``/``output_peak``/``output_rms``;
    forces the scan. ``pdc``: plugin-delay compensation (chains with
    latency read their input that far ahead; master latency is rendered
    past and trimmed). On the CPU (``device="cpu"``) the plain PyTorch
    versions render the same audio. ``routed_chunk``, ``loudness``,
    ``normalize`` and ``out_encode`` are taken at their defaults; another
    value raises ``NotImplementedError`` naming the ROADMAP.md item
    (:data:`DEFAULT_ONLY`). ``stats.cost`` holds the roofline estimate,
    ``stats.roofline_fraction`` its share of the card's peaks.
    """
    _check_keywords(engine, routed_chunk=routed_chunk, loudness=loudness, normalize=normalize,
                    out_encode=out_encode)
    dev = resolve_device(device)
    _check_supported(session, interpolation, effects_mode)
    if meters:
        effects_mode = "scan"  # the spectral FIR sum never holds per-track audio
    if num_blocks is None and tail_seconds > 0.0:
        tr_ = BlockTransport(float(sample_rate), int(buffer_size), session.beat_duration,
                             session.playhead_start, tempo_map=getattr(session, "tempo_map", None))
        num_blocks = (max(tr_.blocks_for_beats(session.end_time()), 1)
                      + int(np.ceil(float(tail_seconds) * sample_rate / buffer_size)))

    stats = RenderStats(channels=channels, sample_rate=float(sample_rate), tracks=len(session.tracks),
                        device=device_name(dev), peaks=device_peaks(dev))
    watch = Stopwatch()
    # the slot plan takes resampled passes as closed-form runs; the gather
    # path the per-block rows that mirror the sampler's f64 accumulation
    table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, num_blocks=num_blocks,
                                out_channels=channels, slow_emit="blocks" if engine == "xla" else "runs")

    interp, pre_pool_dev, pplan, sinc_bank = "linear", None, None, None
    slow_rows = bool(len(table)) and not table.fast.all()
    if interpolation == "sinc" and engine != "xla" and slow_rows and prerender is not False:
        # every coverable run rendered by polyphase products into a pool
        # extension on the device; the residue through the oversampled pool
        table, pool, interp, pre_pool_dev, pplan = resolve_sinc_device(table, pool, device=dev)
        if pplan is not None:
            stats.prerender_seconds = pplan.ext_seconds
    elif interpolation == "sinc" and engine == "xla" and slow_rows:
        # the direct 32-tap windowed sinc; the cutoff follows the fastest |speed|
        max_ratio = float(np.max(np.abs(table.speed[~table.fast])))
        sinc_bank = torch.from_numpy(design_sinc_bank(max(max_ratio, 1.0))).to(dev)
    else:
        # "catmull" runs in the kernel; "sinc" becomes a 4x oversampled copy
        # of the resampled samples + six LS-optimal polynomial taps
        pool0 = pool
        table, pool, interp = resolve_interpolation(table, pool, interpolation)
        if pool is not pool0 and engine != "xla":
            pre_pool_dev = device_pool_cached(pool, dev)  # byte-identical render to render
    stats.cost = estimate_bounce_cost(table, session, table.total_frames, channels)
    for name, (b, f) in prerender_cost(pplan, channels).terms.items():
        stats.cost.add(name, b, f)

    # effect lanes ride the finisher of the chains they automate (the JAX
    # package's rule: a lane on a slot no chain fills renders nothing)
    has_fx = session_has_effects(session) or meters
    plan = None
    if engine != "xla" and sinc_bank is None:
        try:
            # oversampled rows advance U times faster -> shorter sub-slots ->
            # more slots per (tile, track); allow more
            plan = build_plan(table, pool, session, channels=channels,
                              max_slots=16 if isinstance(interp, tuple) else 8)
        except SlotOverflow as e:
            if engine == "pallas":
                raise SlotOverflow(f"{e} even at the smallest tile; engine='pallas' has no gather "
                                   "fallback (engine='auto' takes it)") from e
        if plan is not None and has_fx and (
                plan.num_tracks * channels * plan.n_tiles * plan.tile * 4 > per_track_limit_bytes(dev)):
            plan = None  # per-track buffers would not fit: the chunked gather path
    if plan is not None:
        stats.mix_path = "kernel"
        out = _render_kernel(session, table, pool, plan, interp, pre_pool_dev, sample_rate, channels,
                             effects_mode, meters, pdc, has_fx, dev, stats, watch)
    else:
        stats.mix_path = "gather"
        out = _render_gather(session, table, pool, sample_rate, channels, buffer_size, num_blocks,
                             engine, interpolation, sinc_bank, interp, pre_pool_dev, chunk_frames,
                             strict_order, meters, pdc, dev, stats, watch)

    if trim_frames is not None:
        out = out[:, :trim_frames]
    stats.frames = out.shape[1]
    stats.wall_seconds = stats.carve_seconds + stats.device_seconds
    if out_path is not None:
        write_wav(out_path, out, int(sample_rate), out_format, dither=out_dither)
    return BounceResult(audio=out, stats=stats)
