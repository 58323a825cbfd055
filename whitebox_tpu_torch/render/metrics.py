"""Render performance metrics.

Counterpart of ``whitebox_tpu/render/metrics.py``. The reference's only
perf instrument is a duty-cycle EMA over audio blocks (PerformanceMeasurer,
src/core/timing.h:54-67: block_ms / budget_ms). The offline analogue is the
realtime factor (RTF = rendered seconds per wall second; duty cycle = 1/RTF)
plus track-sample throughput.

Every result names the device it ran on. On a CUDA card ``device_seconds``
is the kernel's time between two CUDA events; on the CPU it is the host
clock around the plain PyTorch mix, and ``device`` says ``cpu``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class RenderStats:
    frames: int = 0
    channels: int = 2
    tracks: int = 0
    sample_rate: float = 48000.0
    #: what rendered: ``torch.cuda.get_device_name`` of the card, or "cpu"
    device: str = ""
    #: carve_seconds + device_seconds (readback and the one-time kernel
    #: build are reported apart)
    wall_seconds: float = 0.0
    #: host carve + interpolation resolve (a sinc bounce's prerender) +
    #: slot plan + upload of the plan tables and the pool
    carve_seconds: float = 0.0
    #: kernel build/load at first use in the process (0 once built)
    compile_seconds: float = 0.0
    #: the mix kernel, plus the effects finisher when the session has one
    device_seconds: float = 0.0
    #: the effects finisher's share of ``device_seconds`` (0 without one,
    #: and on the gather path, whose finisher interleaves with the mix)
    finish_seconds: float = 0.0
    #: which mix rendered: "kernel" (the CUDA mix kernel, or its plain twin
    #: on the CPU) or "gather" (the chunked gather mix, ``ops/mix.py``)
    mix_path: str = ""
    #: device time of the sinc prerender's pool extension (0 without one);
    #: it runs before the mix, inside the window of ``carve_seconds``
    prerender_seconds: float = 0.0
    readback_seconds: float = 0.0
    #: level meters (``bounce(meters=True)``): per-track peak and RMS
    #: ``[T, C]`` post chain + volume/pan, pre sum (track.cpp:728-733), and
    #: the output's ``[C]`` post master and clip; None otherwise
    track_peak: np.ndarray | None = None
    track_rms: np.ndarray | None = None
    output_peak: np.ndarray | None = None
    output_rms: np.ndarray | None = None
    #: roofline cost estimate (``render/roofline.py`` CostEstimate): the
    #: least bytes and operations this render must spend, on every path
    cost: object = None
    #: the card's ``(HBM bytes/s, f32 operations/s)`` peaks
    #: (``roofline.device_peaks``); None off the card
    peaks: tuple | None = None
    #: EBU R128 measurement of the output (``bounce(loudness=True)``,
    #: ``ops/loudness.py::LoudnessStats``)
    loudness: object = None

    @property
    def roofline_fraction(self) -> float:
        """The cost estimate's speed-of-light time on this card over the
        device time it covers, ``device_seconds`` + ``prerender_seconds``
        (the estimate holds the prerender's products; 1.0 = at the hardware
        bound); NaN off the card, on a card without known peaks, or without
        an estimate."""
        seconds = self.device_seconds + self.prerender_seconds
        if self.cost is None or self.peaks is None or seconds <= 0:
            return float("nan")
        return self.cost.utilization(seconds, *self.peaks)

    @property
    def audio_seconds(self) -> float:
        return self.frames / self.sample_rate

    @property
    def rtf(self) -> float:
        """Realtime factor; the engine's implicit budget is rtf >= 1."""
        return self.audio_seconds / self.wall_seconds if self.wall_seconds > 0 else float("inf")

    @property
    def duty_cycle(self) -> float:
        """PerformanceMeasurer-equivalent: fraction of the realtime budget used."""
        return 1.0 / self.rtf if self.rtf > 0 else float("inf")

    @property
    def msamples_per_sec(self) -> float:
        """Track-samples processed per second (tracks x channels x frames)."""
        total = self.frames * self.channels * max(self.tracks, 1)
        return total / self.wall_seconds / 1e6 if self.wall_seconds > 0 else float("inf")

    def summary(self) -> str:
        return (
            f"rendered {self.audio_seconds:.2f}s ({self.frames} frames, {self.tracks} tracks) "
            f"on {self.device} in {self.wall_seconds:.4f}s wall = {self.rtf:.1f}x realtime "
            f"[carve+plan {self.carve_seconds:.4f}s, build {self.compile_seconds:.3f}s, "
            f"mix {self.device_seconds:.4f}s, readback {self.readback_seconds:.4f}s, "
            f"{self.msamples_per_sec:.0f} Msamples/s]"
        ) + (f" [{self.cost.summary(self.peaks, self.device_seconds + self.prerender_seconds)}]"
             if self.cost is not None else "")


class Stopwatch:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


class DeviceTimer:
    """``with DeviceTimer(dev) as t: ...`` -> ``t.seconds``.

    On a CUDA device: CUDA events recorded on the current stream around the
    block, then a wait for the end event, so ``seconds`` is the device time
    of the work the block enqueued. On the CPU: the host clock.
    """

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.seconds = float("nan")

    def __enter__(self) -> DeviceTimer:
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.seconds = self._start.elapsed_time(self._end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
