"""Offline bounce: session -> mixed audio (and WAV export) on the card.

Counterpart of ``whitebox_tpu/render/bounce.py:117-442`` on its plain
surface: audio clips (any loop mode, fades, clip gain, speed), track
volume/pan/mute, the ordered track sum and the hard clip, with
``interpolation="linear"``. The path is the JAX package's Pallas branch:
carve with ``slow_emit="runs"``, plan the slots, one launch of the CUDA mix
kernel, trim, write WAV through ``whitebox_tpu.io.wav``.

Every other feature raises ``NotImplementedError`` naming the ROADMAP.md
item (queue 1) that ports it. A slot overflow that survives the tile
backoff raises too: the JAX package's fallback to its XLA gather mix is not
ported yet, and a silent switch would hide the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.session.bus import session_has_routing
from whitebox_tpu.session.session import Session
from whitebox_tpu.timeline.carve import carve_session
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import cuda_build
from whitebox_tpu_torch.ops.mix_cuda import CudaMixRenderer
from whitebox_tpu_torch.ops.mix_plan import SlotOverflow, build_plan
from whitebox_tpu_torch.render.metrics import DeviceTimer, RenderStats, Stopwatch, device_name


def session_has_effects(session) -> bool:
    """``whitebox_tpu/render/effects_pipeline.py::session_has_effects``."""
    return bool(session.master_effects) or any(t.effects for t in session.tracks)


def session_has_automation(session) -> bool:
    """``whitebox_tpu/ops/automation.py::session_has_automation``."""
    return any(t.automation is not None for t in session.tracks)


def session_has_midi(session) -> bool:
    """``whitebox_tpu/render/bounce.py::_session_has_midi``."""
    return any(c.is_midi() and c.midi is not None and c.midi.asset is not None
               for t in session.tracks for c in t.clips)


def _check_supported(session: Session, interpolation: str) -> None:
    todo = [
        (session_has_automation(session), "automation lanes",
         "item 2 (automation lanes in the kernel, K3)"),
        (session_has_effects(session), "effect chains",
         "items 3 and 6 (per-track mode K4 + finishers; generic effects)"),
        (session_has_midi(session), "MIDI clips", "item 5 (MIDI synth)"),
        (session_has_routing(session), "bus routing", "item 6 (generic effects and routing)"),
        (interpolation != "linear", f"interpolation={interpolation!r}",
         "item 4 (catmull/poly) and item 7 (sinc/prerender)"),
    ]
    for present, what, item in todo:
        if present:
            raise NotImplementedError(
                f"whitebox_tpu_torch bounce does not render {what} yet: "
                f"ROADMAP.md queue 1, {item}")


@dataclass
class BounceResult:
    audio: np.ndarray  # [channels, frames] f32
    stats: RenderStats

    @property
    def frames(self) -> int:
        return self.audio.shape[1]


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
    out_path=None,
    out_format: AudioFormat = AudioFormat.F32,
    out_dither: str | None = None,
) -> BounceResult:
    """Render the whole session timeline at once on ``device`` (default: CUDA).

    ``buffer_size`` is the emulated engine block size: it defines event
    carving semantics, not the device schedule. ``tail_seconds`` renders
    past the last clip edge (ignored when ``num_blocks`` is given). On the
    CPU (``device="cpu"``) the plain PyTorch mix renders the same audio.
    """
    dev = resolve_device(device)
    _check_supported(session, interpolation)
    if num_blocks is None and tail_seconds > 0.0:
        from whitebox_tpu.timeline.transport import BlockTransport

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
    try:
        plan = build_plan(table, pool, session, channels=channels)
    except SlotOverflow as e:
        raise SlotOverflow(
            f"{e} even at the smallest tile; the XLA gather fallback "
            "(whitebox_tpu/ops/mix.py) is ROADMAP.md queue 1, item 1") from e
    renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan)
    stats.carve_seconds = watch.lap()
    if dev.type == "cuda":
        cuda_build.load()  # nvcc at first use in the process, not in the mix time
    stats.compile_seconds = watch.lap()

    with DeviceTimer(dev) as timer:
        out_dev = renderer.render_device()
    stats.device_seconds = timer.seconds
    watch.lap()
    out = out_dev[:, : plan.total_frames].cpu().numpy()
    stats.readback_seconds = watch.lap()

    if trim_frames is not None:
        out = out[:, :trim_frames]
    stats.frames = out.shape[1]
    stats.wall_seconds = stats.carve_seconds + stats.device_seconds
    if out_path is not None:
        from whitebox_tpu.io.wav import write_wav

        write_wav(out_path, out, int(sample_rate), out_format, dither=out_dither)
    return BounceResult(audio=out, stats=stats)
