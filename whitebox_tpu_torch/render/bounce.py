"""Offline bounce: session -> mixed audio (and WAV export) on the card.

Counterpart of ``whitebox_tpu/render/bounce.py:117-442`` on the surface
ported so far: audio clips (any loop mode, fades, clip gain, speed), track
volume/pan/mute, volume/pan automation lanes (any of the nine curves,
under a tempo map too), the ordered track sum and the hard clip, with
``interpolation="linear"``. The path is the JAX package's Pallas branch:
carve with ``slow_emit="runs"``, plan the slots, one launch of the CUDA mix
kernel (its automation variant when a track has lanes,
``bounce.py:316-333``), trim, write WAV through ``io/wav.py``.

Every other feature raises ``NotImplementedError`` naming the ROADMAP.md
item (queue 1) that ports it: effect chains, effect-parameter and master
lanes, MIDI, routing, and other interpolations. A slot overflow that
survives the tile backoff raises too: the JAX package's fallback to its
XLA gather mix is not ported yet, and a silent switch would hide the
kernel.
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
from whitebox_tpu_torch.render.effects_pipeline import (
    prepare_automation_tables_host, session_has_effects,
)
from whitebox_tpu_torch.render.metrics import DeviceTimer, RenderStats, Stopwatch, device_name
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.transport import BlockTransport


def session_has_midi(session) -> bool:
    """``whitebox_tpu/render/bounce.py::_session_has_midi``."""
    return any(c.is_midi() and c.midi is not None and c.midi.asset is not None
               for t in session.tracks for c in t.clips)


def _check_supported(session: Session, interpolation: str) -> None:
    todo = [
        (session_has_effect_automation(session), "effect-parameter or master automation lanes",
         "items 3 and 6 (per-track mode K4 + finishers; generic effects)"),
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
    ``stats.carve_seconds`` includes the lane packing and table upload.
    """
    dev = resolve_device(device)
    _check_supported(session, interpolation)
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
    try:
        plan = build_plan(table, pool, session, channels=channels)
    except SlotOverflow as e:
        raise SlotOverflow(
            f"{e} even at the smallest tile; the XLA gather fallback "
            "(whitebox_tpu/ops/mix.py) is ROADMAP.md queue 1, item 1") from e
    # automation-only sessions evaluate the volume/pan lanes in the kernel
    # (the JAX package's fused single pass, bounce.py:316-333)
    renderer = CudaMixRenderer(table, pool, session, device=dev, channels=channels, plan=plan,
                               auto_tables=prepare_automation_tables_host(session, sample_rate))
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
        write_wav(out_path, out, int(sample_rate), out_format, dither=out_dither)
    return BounceResult(audio=out, stats=stats)
