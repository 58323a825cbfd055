"""Offline bounce: session -> mixed audio (and WAV export) on the card.

Counterpart of ``whitebox_tpu/render/bounce.py:117-442`` on the surface
ported so far: audio clips (any loop mode, fades, clip gain, speed), track
volume/pan/mute, volume/pan automation lanes (any of the nine curves,
under a tempo map too), linear effect chains on tracks and the master bus
(``Gain``, ``Biquad``, ``ParametricEQ``), level meters, the ordered track
sum and the hard clip, in the three interpolation modes of resampled
clips: ``"linear"`` (the reference's), ``"catmull"`` (4-point Catmull-Rom
in the kernel) and ``"sinc"``. A sinc bounce pre-renders every resampled
run with exact polyphase products into a pool extension on the device and
mixes speed-1 rows over it (``timeline/prerender.py``); runs that cannot
ride it, or all of them with ``prerender=False``, play a 4x oversampled
copy of their samples through six polynomial taps in the kernel
(``timeline/oversample.py``). The path is the JAX package's Pallas branch
(``bounce.py:236-276`` for the interpolation dispatch): carve with
``slow_emit="runs"``, resolve the interpolation, plan the slots, then

- a session with effect chains or ``meters=True``: one launch of the
  per-track kernel (K4) into ``[T, C, F]`` pre-gain buffers, then the
  finisher, ``effects_mode="scan"`` (the batched biquad scan,
  ``effects_pipeline.finish_mix``) or ``"fir"`` (overlap-save FFT,
  ``effects_fir``); meters force the scan (``bounce.py:305-415``);
- any other session: one launch of the mix kernel, its automation variant
  when a track has lanes (``bounce.py:316-333``);

then trim and write the WAV through ``io/wav.py``.

Every other feature raises ``NotImplementedError`` naming the ROADMAP.md
item (queue 1) that ports it: non-linear or unported effects,
effect-parameter and master lanes, routing (6) and MIDI (5). So do a slot
overflow that survives the tile backoff (at 8 slots, 16 for the
oversampled form) and per-track buffers above 6 GiB (item 1, the JAX
package's chunked XLA gather path, which also holds its ``engine="xla"``
direct 32-tap sinc): a silent switch would hide the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.io.wav import write_wav
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.automation import session_has_effect_automation
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow, build_plan
from whitebox_tpu_torch.timeline.oversample import device_pool_cached, resolve_interpolation
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_device
from whitebox_tpu_torch.render.effects_fir import prepare_fir_finish
from whitebox_tpu_torch.render.effects_generic import _chains_of, chain_is_packable
from whitebox_tpu_torch.render.effects_pipeline import (
    finish_mix, prepare_automation_tables, prepare_automation_tables_host, prepare_effect_tables,
    session_has_effects,
)
from whitebox_tpu_torch.render.metrics import DeviceTimer, RenderStats, Stopwatch, device_name
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.transport import BlockTransport

#: per-track buffers above this many bytes take the JAX package's chunked
#: XLA path (``whitebox_tpu/render/bounce.py:314``), not ported yet
PER_TRACK_LIMIT_BYTES = 6 << 30


def session_has_midi(session) -> bool:
    """``whitebox_tpu/render/bounce.py::_session_has_midi``."""
    return any(c.is_midi() and c.midi is not None and c.midi.asset is not None
               for t in session.tracks for c in t.clips)


def _unported_effects(session) -> list[str]:
    """Type names of the effects in chains the linear finishers cannot take."""
    chains, master = _chains_of(session)
    return sorted({getattr(e, "type_name", type(e).__name__)
                   for c in [*chains, master] if c is not None for e in c.effects
                   if not chain_is_packable([e])})


def _check_supported(session: Session, interpolation: str, effects_mode: str) -> None:
    generic = "item 6 (generic effects and routing)"
    unported = _unported_effects(session)
    todo = [
        (session_has_effect_automation(session), "effect-parameter or master automation lanes", generic),
        (bool(unported), f"effect chains with {', '.join(unported)}", generic),
        (effects_mode in ("routed", "generic"), f"effects_mode={effects_mode!r}", generic),
        (session_has_midi(session), "MIDI clips", "item 5 (MIDI synth)"),
        (session_has_routing(session), "bus routing", generic),
    ]
    for present, what, item in todo:
        if present:
            raise NotImplementedError(
                f"whitebox_tpu_torch bounce does not render {what} yet: "
                f"ROADMAP.md queue 1, {item}")
    if effects_mode not in ("scan", "fir"):
        raise ValueError(f"effects_mode must be 'scan' or 'fir', got {effects_mode!r}")
    if interpolation not in ("linear", "catmull", "sinc"):
        raise ValueError(f"interpolation must be 'linear', 'catmull', or 'sinc', got {interpolation!r}")


@dataclass
class BounceResult:
    audio: np.ndarray  # [channels, frames] f32
    stats: RenderStats

    @property
    def frames(self) -> int:
        return self.audio.shape[1]


def _effects_finisher(session, renderer, plan, sample_rate, channels, effects_mode, meters, dev):
    """Host preparation of the finisher -> ``finish(per_track)``: the chain
    tables (scan) or impulse responses (fir) and the lane tables, on
    ``dev``."""
    auto = prepare_automation_tables(session, sample_rate, device=dev)
    tg = renderer.tables["track_gain"]
    T = plan.num_tracks
    if effects_mode == "fir":
        return prepare_fir_finish(session, sample_rate, tg, auto, channels, device=dev)
    (S, coeffs), (Sm, mcoeffs) = prepare_effect_tables(session, sample_rate, channels, device=dev)
    return lambda pt: finish_mix(pt, coeffs, mcoeffs, tg, auto, T=T, C=channels, S=S, Sm=Sm,
                                 with_meters=meters, valid_frames=plan.total_frames)


def bounce(
    session: Session,
    sample_rate: float = 48000.0,
    *,
    device=None,
    buffer_size: int = 512,
    channels: int = 2,
    num_blocks: int | None = None,
    trim_frames: int | None = None,
    tail_seconds: float = 0.0,
    interpolation: str = "linear",
    effects_mode: str = "scan",
    prerender: bool | None = None,
    meters: bool = False,
    out_path=None,
    out_format: AudioFormat = AudioFormat.F32,
    out_dither: str | None = None,
) -> BounceResult:
    """Render the whole session timeline at once on ``device`` (default: CUDA).

    ``buffer_size`` is the emulated engine block size: it defines event
    carving semantics, not the device schedule. ``tail_seconds`` renders
    past the last clip edge (ignored when ``num_blocks`` is given), so
    effect tails ring out. ``interpolation`` applies to resampled clips
    (a 44.1 kHz sample in a 48 kHz session, a pitched clip): ``"linear"``
    (reference parity, sampler.cpp:34), ``"catmull"`` (4-point Catmull-Rom,
    the mode the reference leaves unfinished at sampler.cpp:61-86) or
    ``"sinc"`` (anti-aliased Kaiser-sinc quality); speed-1 clips stay
    bit-exact in every mode. ``prerender``: None lets a sinc bounce
    pre-render the resampled runs by the exact/Taylor polyphase path;
    False forces the oversampled pool and six polynomial taps for all of
    them. ``effects_mode``: ``"scan"`` (the eigenbasis
    biquad scan, ~1e-7 accuracy) or ``"fir"`` (chains collapsed to impulse
    responses, overlap-save FFT, ~-120 dB truncation). ``meters``: also
    fill ``stats.track_peak``/``track_rms``/``output_peak``/``output_rms``;
    forces the scan. On the CPU (``device="cpu"``) the plain PyTorch
    versions render the same audio. ``stats.carve_seconds`` includes the
    lane and chain preparation, the table upload and, for a sinc bounce,
    the prerender (its device share is ``stats.prerender_seconds``).
    """
    dev = resolve_device(device)
    _check_supported(session, interpolation, effects_mode)
    if meters:
        effects_mode = "scan"  # the spectral FIR sum never holds per-track audio
    if num_blocks is None and tail_seconds > 0.0:
        tr_ = BlockTransport(float(sample_rate), int(buffer_size),
                             session.beat_duration, session.playhead_start,
                             tempo_map=getattr(session, "tempo_map", None))
        num_blocks = (max(tr_.blocks_for_beats(session.end_time()), 1)
                      + int(np.ceil(float(tail_seconds) * sample_rate / buffer_size)))

    stats = RenderStats(channels=channels, sample_rate=float(sample_rate),
                        tracks=len(session.tracks), device=device_name(dev))
    watch = Stopwatch()
    # resampled passes as closed-form runs (what the plan's run merge
    # evaluates anyway; the JAX Pallas branch carves the same way)
    table, pool = carve_session(session, sample_rate, buffer_size=buffer_size,
                                num_blocks=num_blocks, out_channels=channels, slow_emit="runs")

    interp, pre_pool_dev = "linear", None
    slow_rows = bool(len(table)) and not table.fast.all()
    if interpolation == "sinc" and slow_rows and prerender is not False:
        # every coverable run rendered by polyphase products into a pool
        # extension on the device; the residue through the oversampled pool
        table, pool, interp, pre_pool_dev, pplan = resolve_sinc_device(table, pool, device=dev)
        if pplan is not None:
            stats.prerender_seconds = pplan.ext_seconds
    else:
        # "catmull" runs in the kernel; "sinc" becomes a 4x oversampled copy
        # of the resampled samples + six LS-optimal polynomial taps
        pool0 = pool
        table, pool, interp = resolve_interpolation(table, pool, interpolation)
        if pool is not pool0:
            # byte-identical render to render: kept on the device
            pre_pool_dev = device_pool_cached(pool, dev)
    try:
        # oversampled rows advance U times faster -> shorter sub-slots ->
        # more slots per (tile, track); allow more
        plan = build_plan(table, pool, session, channels=channels,
                          max_slots=16 if isinstance(interp, tuple) else 8)
    except SlotOverflow as e:
        raise SlotOverflow(
            f"{e} even at the smallest tile; the XLA gather fallback "
            "(whitebox_tpu/ops/mix.py) is ROADMAP.md queue 1, item 1") from e

    has_fx = session_has_effects(session) or meters
    finish = None
    if has_fx:
        per_track_bytes = plan.num_tracks * channels * plan.n_tiles * plan.tile * 4
        if per_track_bytes > PER_TRACK_LIMIT_BYTES:
            raise NotImplementedError(
                f"per-track buffers of {per_track_bytes / 2**30:.2f} GiB exceed the 6 GiB guard; "
                "the chunked XLA path (whitebox_tpu/ops/mix.py) is ROADMAP.md queue 1, item 1")
        # per-track mode (K4): lanes evaluate in the finisher's gains
        renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                                   interp=interp, pool_device=pre_pool_dev)
        finish = _effects_finisher(session, renderer, plan, sample_rate, channels, effects_mode,
                                   meters, dev)
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
        tp, trms, op, orms = (m.cpu().numpy() for m in res[1])
        T = len(session.tracks)
        stats.track_peak, stats.track_rms = tp[:T], trms[:T]
        stats.output_peak, stats.output_rms = op, orms
    stats.readback_seconds = watch.lap()

    if trim_frames is not None:
        out = out[:, :trim_frames]
    stats.frames = out.shape[1]
    stats.wall_seconds = stats.carve_seconds + stats.device_seconds
    if out_path is not None:
        write_wav(out_path, out, int(sample_rate), out_format, dither=out_dither)
    return BounceResult(audio=out, stats=stats)
