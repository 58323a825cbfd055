"""Offline bounce: session -> mixed audio (and WAV export) on the card.

Counterpart of ``whitebox_tpu/render/bounce.py``: audio clips (any loop
mode, fades, clip gain, speed), track volume/pan/mute, volume/pan lanes
(any of the nine curves, under a tempo map too), effect chains on tracks,
buses and the master bus (the whole built-in family and registered user
effects), effect-parameter lanes on tracks, buses and the master, bus
routing (group outputs, post-fader, pre-fader and sidechain sends, bus
faders and their lanes, ``render/routing.py``), MIDI clips through the
built-in synth (``midi/synth.py``), level meters, plugin-delay
compensation, the ordered track sum and the hard clip, in the three
interpolation modes of resampled clips (``"linear"``, ``"catmull"``,
``"sinc"``). Two mixes, chosen as the JAX package chooses:

- the kernel path (``engine="auto"`` or ``"pallas"``; the JAX package's
  Pallas branch, ``bounce.py:236-442``): carve with ``slow_emit="runs"``,
  resolve the interpolation (a sinc bounce pre-renders resampled runs
  into a pool extension on the device, ``timeline/prerender.py``; runs
  that cannot ride it play a 4x oversampled copy through six polynomial
  taps, ``timeline/oversample.py``), plan the slots, then one launch of
  the CUDA mix kernel (its automation variant when a track has lanes) or,
  for a session with effects, effect lanes, meters, MIDI clips or
  routing, one launch of the per-track mode (K4) into ``[T, C, F]``
  buffers, the MIDI tracks' synth added to their rows, and the finisher
  that ``render/finisher.py::choose_finisher`` names, run over the whole
  buffer: ``effects_mode="scan"`` (the biquad cascade kernel) or
  ``"fir"`` for linear chains, ``"generic"`` for every other chain or
  any effect-parameter lane, ``"routed"`` for every session with buses
  in use; meters force the scan, routing the routed finisher;
- the gather path (``engine="xla"``, and ``"auto"`` where the plan cannot
  hold the session: a slot overflow at the smallest tile, or per-track
  buffers above :func:`per_track_limit_bytes`; the JAX package's
  ``bounce.py:444-629``): carve with ``slow_emit="blocks"``, the chunked
  gather mix of ``ops/mix.py`` in ``chunk_frames`` chunks (on the card one
  launch of the gather kernel ``csrc/gather_mix.cu`` a chunk, or more with
  the PDC fetch-ahead; ``stats.gather_chunks`` counts the chunks), the synth
  added chunk by chunk, the same finishers fed those chunks by
  ``render/finisher.py::run`` (linear chains take the scan there, whatever
  ``effects_mode`` names), their states carried from chunk to chunk.
  ``engine="xla"`` with ``interpolation="sinc"`` is the direct 32-tap
  windowed sinc. ``engine="pallas"`` raises on a slot overflow, as the
  JAX package does.

``stats.mix_path`` says which mix rendered. ``normalize`` scales the
output to a true-peak or integrated-loudness target and ``loudness``
measures the final audio (``ops/loudness.py``, on the bounce's device);
``out_path`` writes WAV, or MP3/Ogg/FLAC through ``io/codec.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.effects.base import UNPORTED_EFFECT_TODO, EffectChain, UnportedEffect
from whitebox_tpu_torch.io.codec import write_compressed
from whitebox_tpu_torch.io.wav import write_wav
from whitebox_tpu_torch.log import get_logger
from whitebox_tpu_torch.midi.synth import (
    build_slot_segments, pack_slot_tables, render_synth_chunk, synth_device_tables,
)
from whitebox_tpu_torch.midi.voice import carve_midi_events
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.loudness import measure_loudness
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk, render_chunk_per_track
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer, resident_pool
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow, build_plan
from whitebox_tpu_torch.ops.readback import to_host
from whitebox_tpu_torch.ops.resample import design_sinc_bank
from whitebox_tpu_torch.render.effects_pipeline import (
    _chains_of, prepare_automation_tables_host, session_has_effects,
)
from whitebox_tpu_torch.render.finisher import choose_finisher, make_finisher, run
from whitebox_tpu_torch.render.metrics import (
    DeviceTimer, RenderStats, collect_legs, current_stats, device_name, span,
)
from whitebox_tpu_torch.render.roofline import device_peaks, estimate_bounce_cost, prerender_cost
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oversample import device_pool_cached, resolve_interpolation
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_device
from whitebox_tpu_torch.timeline.transport import BlockTransport

_log = get_logger("bounce")

#: off the card, per-track buffers above this many bytes take the gather
#: path: the JAX package's figure (``whitebox_tpu/render/bounce.py:314``),
#: so that both packages choose alike on the CPU
PER_TRACK_LIMIT_BYTES = 6 << 30
#: on the card, the per-track buffers may take this share of the memory
#: the process can still allocate; the rest holds the finisher's working
#: set (peaks on an H100: 1.2x the buffers for the scan finisher, 1.6x for
#: the generic one; the FIR finisher pads a copy of them)
PER_TRACK_CARD_SHARE = 1 / 3


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


def _prepare_synth_tables(session, sample_rate, buffer_size, num_blocks, device) -> dict:
    """The MIDI tracks' slot tables for the built-in synth, stacked on
    ``device``: {"rows": their track indices, "tables": [R, slots, S]
    tensors} (empty without a sounding MIDI track;
    ``whitebox_tpu/render/bounce.py:32-45``)."""
    if not session_has_midi(session):
        return {}
    rows, host = [], []
    for t, evs in carve_midi_events(session, sample_rate, buffer_size, num_blocks).items():
        ns, segs = build_slot_segments(evs)
        if segs is not None:
            rows.append(t)
            host.append(pack_slot_tables(segs, sample_rate, ns))
    return {"rows": rows, "tables": synth_device_tables(host, device)} if rows else {}


def _synth_subset(synth: dict, rows: list) -> dict:
    """The synth of the tracks ``rows`` (sorted), renumbered to their
    positions in ``rows``: the PDC fetch-ahead renders those rows alone."""
    pos = {t: i for i, t in enumerate(rows)}
    keep = [j for j, t in enumerate(synth.get("rows", ())) if t in pos]
    if not keep:
        return {}
    k = torch.as_tensor(keep, device=synth["tables"]["start"].device)
    return {"rows": [pos[synth["rows"][j]] for j in keep],
            "tables": {n: v[k] for n, v in synth["tables"].items()}}


def _add_synth(per_track, synth: dict, chunk_start: int, frames: int):
    """``per_track`` ``[T, C, frames]`` with each MIDI track's synth added
    to all its channels, as a new tensor: ``per_track`` is read, not
    written (a finisher may be handed the same K4 buffer again)."""
    if not synth:
        return per_track
    with span("wb.synth"):
        sy = render_synth_chunk(synth["tables"], chunk_start, frames)  # [R, frames]
        idx = torch.as_tensor(synth["rows"], device=per_track.device)
        return per_track.index_add(0, idx, sy[:, None, :].expand(-1, per_track.shape[1], -1))


def write_audio(out_path, out: np.ndarray, sample_rate: int, out_format: AudioFormat,
                dither: str | None = None, encode=None) -> None:
    """WAV by default; .mp3/.ogg/.flac go through the codec runtime
    (``io/codec.py``; ``whitebox_tpu/render/bounce.py::_write_audio``).
    ``encode`` is an ``io.codec.EncodeOptions`` with the reference's export
    properties (bitrate modes, VBR quality, FLAC level, tags); ignored for
    WAV."""
    if str(out_path).lower().endswith((".mp3", ".ogg", ".oga", ".flac")):
        write_compressed(out_path, out, int(sample_rate), options=encode)
        return
    write_wav(out_path, out, int(sample_rate), out_format, dither=dither)


def _check_supported(session: Session, engine: str, interpolation: str, effects_mode: str) -> None:
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"engine must be 'auto', 'pallas' or 'xla', got {engine!r}")
    chains, master = _chains_of(session)
    buses = [b.effects if isinstance(b.effects, EffectChain) else EffectChain(list(b.effects))
             for b in session.buses if b.effects]
    unported = sorted({e.type_name for c in [*chains, master, *buses] if c is not None for e in c.effects
                       if isinstance(e, UnportedEffect)})
    if unported:
        raise NotImplementedError(f"whitebox_tpu_torch bounce cannot render the effect(s) "
                                  f"{', '.join(unported)}: {UNPORTED_EFFECT_TODO}")
    if effects_mode not in ("scan", "fir", "generic", "routed"):
        raise ValueError(f"effects_mode must be 'scan', 'fir', 'generic' or 'routed', got {effects_mode!r}")
    if interpolation not in ("linear", "catmull", "sinc"):
        raise ValueError(f"interpolation must be 'linear', 'catmull', or 'sinc', got {interpolation!r}")


def _finalize_output(out: np.ndarray, stats, sample_rate: float, loudness: bool, normalize,
                     device) -> np.ndarray:
    """Optional output normalization + loudness measurement
    (``whitebox_tpu/render/bounce.py:57-87``), measured on ``device``.

    ``normalize``: None, ("peak", target_dbtp) — scale so the 4x-oversampled
    TRUE peak hits the target — or ("lufs", target_lufs) — scale so
    integrated loudness hits the target (delivery-spec normalization, e.g.
    -14 LUFS streaming). Gain is applied then hard-clipped to ±1 (the
    engine's output ceiling); stats.loudness measures the FINAL audio."""
    if normalize is not None:
        mode, target = normalize
        pre = measure_loudness(out, sample_rate, device=device)
        if mode == "peak":
            gain = 10.0 ** ((float(target) - pre.true_peak_dbtp) / 20.0)
        elif mode == "lufs":
            if not np.isfinite(pre.integrated_lufs):
                gain = 1.0  # silence: nothing to normalize
            else:
                gain = 10.0 ** ((float(target) - pre.integrated_lufs) / 20.0)
        else:
            raise ValueError(f"normalize mode {mode!r} (want 'peak' or 'lufs')")
        out = np.clip(out * np.float32(gain), -1.0, 1.0)
    if loudness:
        stats.loudness = measure_loudness(out, sample_rate, device=device)
    return out


@dataclass
class BounceResult:
    audio: np.ndarray  # [channels, frames] f32
    stats: RenderStats

    @property
    def frames(self) -> int:
        return self.audio.shape[1]


def _effects_finisher(session, renderer, plan, sample_rate, effects_mode, meters, dev, pdc=False,
                      routed_chunk=None, buffer_size=512):
    """Host preparation of the kernel path's finisher -> ``finish(per_track)
    -> finisher.Run``: the family that :func:`choose_finisher` names, built
    on ``dev`` (``routed_chunk`` frames a routed chunk), and the MIDI
    tracks' synth tables. ``finish`` adds the synth to a copy of
    ``per_track`` (``whitebox_tpu/render/bounce.py:344-405``), then runs
    the finisher over it, the meters over the plan's frames. The family's
    name goes to the collecting bounce's ``RenderStats.finisher``."""
    name = choose_finisher(session, effects_mode, meters)
    stats = current_stats()
    if stats is not None:
        stats.finisher = name
    fin = make_finisher(name, session, sample_rate, renderer.tables["track_gain"], meters=meters, pdc=pdc,
                        chunk=routed_chunk if name == "routed" else None, device=dev)
    synth = _prepare_synth_tables(session, sample_rate, buffer_size, plan.total_frames // buffer_size, dev)
    return lambda pt: run(fin, _add_synth(pt, synth, 0, pt.shape[-1]), pt.shape[-1],
                          valid_frames=plan.total_frames)


def _read_meters(stats, meters, T: int) -> None:
    tp, trms, op, orms = (np.asarray(m.cpu().numpy()) for m in meters)
    stats.track_peak, stats.track_rms = tp[:T], trms[:T]
    stats.output_peak, stats.output_rms = op, orms


def _load_kernels(dev, stats) -> None:
    """nvcc at first use in the process, timed apart from the host legs and the mix."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        cuda_build.load()
    stats.compile_seconds = time.perf_counter() - t0


def _render_kernel(session, table, pool, plan, interp, pre_pool_dev, sample_rate, channels,
                   effects_mode, meters, pdc, has_fx, routed_chunk, buffer_size, dev, stats,
                   call) -> np.ndarray:
    """The mix kernel (or K4 and a finisher) over the slot plan; ``call``
    is the bounce's span, whose clock ``stats.carve_seconds`` reads."""
    finish = None
    if has_fx:
        # per-track mode (K4): lanes evaluate in the finisher's gains
        renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                   interp=interp, pool_device=pre_pool_dev)
        with span("wb.fx.prepare"):
            finish = _effects_finisher(session, renderer, plan, sample_rate, effects_mode, meters, dev, pdc=pdc,
                                       routed_chunk=routed_chunk, buffer_size=buffer_size)
    else:
        # automation-only sessions evaluate the volume/pan lanes in the kernel
        # (the JAX package's fused single pass, bounce.py:316-333)
        renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                   interp=interp, pool_device=pre_pool_dev,
                                   auto_tables=prepare_automation_tables_host(session, sample_rate))
    stats.carve_seconds = call.elapsed()
    _load_kernels(dev, stats)

    res = None
    with span("wb.mix"), DeviceTimer(dev) as timer:
        if finish is None:
            out_dev = renderer.render_device()
        else:
            pt = renderer.render_device_per_track()
            with span("wb.finish"), DeviceTimer(dev) as ftimer:
                res = finish(pt)
            out_dev = res.out
    stats.device_seconds = timer.seconds
    if finish is not None:
        stats.finish_seconds = ftimer.seconds
    with span("wb.readback") as readback:
        out = to_host(out_dev[:, : plan.total_frames])
        if meters:
            _read_meters(stats, res.meters, len(session.tracks))
    stats.readback_seconds = readback.seconds
    return out


def _render_gather(session, table, pool, sample_rate, channels, buffer_size, num_blocks, engine,
                   interpolation, sinc_bank, interp, pre_pool_dev, chunk_frames, strict_order,
                   meters, pdc, has_midi, has_routing, dev, stats, call) -> np.ndarray:
    """The chunked gather mix (``whitebox_tpu/render/bounce.py:444-629``);
    ``call`` as :func:`_render_kernel`'s."""
    if engine != "xla" and len(table) and (not table.fast.all() or pre_pool_dev is not None):
        # the table was carved with slow_emit="runs" for the slot plan; the
        # gather path's parity contract needs the blockwise sequentially
        # rounded phases, so re-carve; a prerendered pool extension (on the
        # device only) is dropped and the interpolation resolved again in
        # its oversampled form
        table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, num_blocks=num_blocks,
                                    out_channels=channels, slow_emit="blocks")
        if sinc_bank is None and interpolation != "linear":
            with span("wb.plan"):
                table, pool, interp = resolve_interpolation(table, pool, interpolation)
    with span("wb.upload"):
        tables = pack_device_tables(table, pool, session, channels=channels)
        jt = tables.as_torch(dev)
        pool_dev = resident_pool(pool, dev)
    F = tables.total_frames
    T = tables.num_tracks
    chunk = min(chunk_frames, max(F, 1))

    with span("wb.fx.prepare"):
        synth = _prepare_synth_tables(session, sample_rate, buffer_size, F // buffer_size, dev)
        subsets: dict = {}

        def per_track(start, n, rows=None):
            """``n`` frames of the per-track mix from ``start`` (of ``rows``
            alone, with their rows of the tables and the synth: the PDC
            fetch-ahead), the synth added."""
            tab, syn = jt, synth
            if rows is not None:
                if tuple(rows) not in subsets:
                    idx = torch.as_tensor(rows, device=dev)
                    subsets[tuple(rows)] = ({k: v[idx] for k, v in jt.items()}, _synth_subset(synth, rows))
                tab, syn = subsets[tuple(rows)]
            pt = render_chunk_per_track(pool_dev, tab, start, n, sinc_bank=sinc_bank, interp=interp)
            return _add_synth(pt, syn, start, n)

        fin = None
        if session_has_effects(session) or session_has_automation(session) or meters or has_midi or has_routing:
            # the finishers' streaming forms: linear chains take the scan,
            # whatever effects_mode names for a whole buffer
            stats.finisher = choose_finisher(session, "scan", meters)
            fin = make_finisher(stats.finisher, session, sample_rate, jt["track_gain"], meters=meters, pdc=pdc,
                                max_chunk=chunk, device=dev)
            if getattr(fin, "bus_pdc", None) is not None:
                raise ValueError("the streaming (gather) path does not carry bus-chain latency delay "
                                 "lines; render with engine='auto'/'pallas' (the routed finisher "
                                 "compensates bus latency), or move lookahead limiters to tracks or "
                                 "the master")
    stats.carve_seconds = call.elapsed()
    _load_kernels(dev, stats)  # the cascade kernel of the linear finisher

    with span("wb.mix"), DeviceTimer(dev) as timer:
        if fin is None:
            starts = range(0, F, chunk)
            stats.gather_chunks = len(starts)
            out_dev = torch.cat([render_chunk(pool_dev, jt, a, chunk, strict_order=strict_order, sinc_bank=sinc_bank,
                                              interp=interp) for a in starts], dim=1)[:, :F]
        else:
            # master latency: the finisher renders further and trims the head
            res = run(fin, per_track, F)
            stats.gather_chunks = res.chunks
            out_dev = res.out
    stats.device_seconds = timer.seconds
    with span("wb.readback") as readback:
        out = to_host(out_dev)
        if meters:
            # the ragged last chunk renders at full length; its extra frames count
            _read_meters(stats, res.meters, len(session.tracks))
    stats.readback_seconds = readback.seconds
    return out


def kernel_plan(table, pool, session, channels: int, interp, engine: str, dev, per_track: bool):
    """The slot plan of the kernel path, or None for the gather path:
    ``engine="xla"``, a slot overflow at the smallest tile (which
    ``engine="pallas"`` raises), or, with ``per_track``, per-track buffers
    above :func:`per_track_limit_bytes`."""
    if engine == "xla":
        return None
    try:
        # oversampled rows advance U times faster -> shorter sub-slots ->
        # more slots per (tile, track); allow more
        plan = build_plan(table, pool, session, channels=channels, max_slots=16 if isinstance(interp, tuple) else 8)
    except SlotOverflow as e:
        if engine == "pallas":
            raise SlotOverflow(f"{e} even at the smallest tile; engine='pallas' has no gather "
                               "fallback (engine='auto' takes it)") from e
        return None
    if per_track and plan.num_tracks * channels * plan.n_tiles * plan.tile * 4 > per_track_limit_bytes(dev):
        return None  # per-track buffers would not fit: the chunked gather path
    return plan


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
    ``"fir"``, ``"generic"`` (chains the first two cannot take, or any
    effect lane, finish generic regardless) or ``"routed"`` (which every
    session with routing takes). ``routed_chunk``: the routed finisher's
    chunk length on the kernel path (None: ``routed_auto_chunk_frames``).
    ``meters``: also fill
    ``stats.track_peak``/``track_rms``/``output_peak``/``output_rms``;
    forces the scan (routed sessions stay routed). ``pdc``: plugin-delay
    compensation (chains with latency read their input that far ahead;
    bus latency is aligned by delay lines on the kernel path and refused
    on the gather path; master latency is rendered past and trimmed). On
    the CPU (``device="cpu"``) the plain PyTorch versions render the same
    audio. ``normalize``: ("peak", dBTP) or ("lufs", LUFS) scales the
    output to the target, then clips to ±1; ``loudness`` fills
    ``stats.loudness`` from the final audio (:func:`_finalize_output`).
    ``out_path`` ending in .mp3/.ogg/.flac encodes with ``out_encode``
    (an ``io.codec.EncodeOptions``; :func:`write_audio`). ``stats.cost``
    holds the roofline estimate, ``stats.roofline_fraction`` its share of
    the card's peaks.
    """
    dev = resolve_device(device)
    _check_supported(session, engine, interpolation, effects_mode)
    has_midi, has_routing = session_has_midi(session), session_has_routing(session)
    if num_blocks is None and tail_seconds > 0.0:
        tr_ = BlockTransport(float(sample_rate), int(buffer_size), session.beat_duration,
                             session.playhead_start, tempo_map=getattr(session, "tempo_map", None))
        num_blocks = (max(tr_.blocks_for_beats(session.end_time()), 1)
                      + int(np.ceil(float(tail_seconds) * sample_rate / buffer_size)))

    stats = RenderStats(channels=channels, sample_rate=float(sample_rate), tracks=len(session.tracks),
                        device=device_name(dev), peaks=device_peaks(dev))
    with span("wb.bounce") as call, collect_legs(stats.host_legs, stats):
        # the slot plan takes resampled passes as closed-form runs; the gather
        # path the per-block rows that mirror the sampler's f64 accumulation
        table, pool = carve_session(session, sample_rate, buffer_size=buffer_size, num_blocks=num_blocks,
                                    out_channels=channels, slow_emit="blocks" if engine == "xla" else "runs")
        _log.debug("carved %d segment rows, %d frames, %d tracks",
                   len(table), table.total_frames, table.num_tracks)

        with span("wb.plan"):
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
            has_fx = session_has_effects(session) or meters or has_midi or has_routing
            plan = kernel_plan(table, pool, session, channels, interp, engine, dev, per_track=has_fx)
        if plan is not None:
            stats.mix_path = "kernel"
            out = _render_kernel(session, table, pool, plan, interp, pre_pool_dev, sample_rate, channels,
                                 effects_mode, meters, pdc, has_fx, routed_chunk, buffer_size, dev, stats,
                                 call)
        else:
            stats.mix_path = "gather"
            out = _render_gather(session, table, pool, sample_rate, channels, buffer_size, num_blocks,
                                 engine, interpolation, sinc_bank, interp, pre_pool_dev, chunk_frames,
                                 strict_order, meters, pdc, has_midi, has_routing, dev, stats, call)

        if trim_frames is not None:
            out = out[:, :trim_frames]
        stats.frames = out.shape[1]
        stats.wall_seconds = stats.carve_seconds + stats.device_seconds
        out = _finalize_output(out, stats, sample_rate, loudness, normalize, dev)
        if out_path is not None:
            write_audio(out_path, out, int(sample_rate), out_format, dither=out_dither, encode=out_encode)
    return BounceResult(audio=out, stats=stats)
