"""Render performance metrics.

Counterpart of ``whitebox_tpu/render/metrics.py``. The reference's only
perf instrument is a duty-cycle EMA over audio blocks (PerformanceMeasurer,
src/core/timing.h:54-67: block_ms / budget_ms). The offline analogue is the
realtime factor (RTF = rendered seconds per wall second; duty cycle = 1/RTF)
plus track-sample throughput.

Every result names the device it ran on. On a CUDA card ``device_seconds``
is the kernel's time between two CUDA events; on the CPU it is the host
clock around the plain PyTorch mix, and ``device`` says ``cpu``.

The host legs of a render are spans (:class:`span`): named ``wb.<leg>``,
timed by the host clock, summed into the legs that :func:`collect_legs`
made current (``bounce`` collects into ``RenderStats.host_legs``), and,
while a ``torch.profiler`` records, opened as its ``record_function``
ranges, so the legs land on the device trace's clock. Nesting gives parent and
child; a call's outermost span (``wb.bounce``, ``wb.stems``) identifies it.
The finishers' counters (:func:`count`) add to the stats that the same
:func:`collect_legs` names.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function


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
    #: host clock from the call to the end of the host legs: carve (the
    #: pool flatten within), interpolation resolve (a sinc bounce's
    #: prerender), cost estimate, slot plan, upload of the plan tables and
    #: the pool, chain preparation; ``host_legs`` splits it
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
    #: chunks the gather path rendered (0 on the kernel path); on the card
    #: each is one launch of the gather kernel or more
    gather_chunks: int = 0
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
    #: which effects finisher ran: "scan", "generic", "fir" or "routed" ("" without one)
    finisher: str = ""
    #: chunks the finisher's step ran (on the gather path one per gather chunk)
    finish_chunks: int = 0
    #: dynamics stage calls (compressor, limiter, gate; one a group and chunk),
    #: counted on the host on either device
    dynamics_calls: int = 0
    #: host seconds of each span the call opened, by name, inclusive of the
    #: spans nested in it (``wb.carve`` holds ``wb.pool.flatten``; the
    #: finisher's per-stage ranges sit inside ``wb.finish`` or ``wb.mix``)
    host_legs: dict = field(default_factory=dict)

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
        ) + (f" [host legs {', '.join(f'{k[3:]} {v:.4f}s' for k, v in self.host_legs.items())}]"
             if self.host_legs else "") + (
            f" [finisher {self.finisher}: {self.finish_chunks} chunks, {self.dynamics_calls} dynamics calls]"
            if self.finisher else "") + (
            f" [{self.cost.summary(self.peaks, self.device_seconds + self.prerender_seconds)}]"
            if self.cost is not None else "")


#: the legs dict that closing spans add their seconds to (None: no call collects)
_LEGS: contextvars.ContextVar = contextvars.ContextVar("wb_legs", default=None)
#: the stats whose counters :func:`count` adds to (None: no call collects)
_STATS: contextvars.ContextVar = contextvars.ContextVar("wb_stats", default=None)
#: True while a ``torch.profiler`` records (a flag read, ~0.2 us; an
#: unrecorded ``record_function`` costs ~11 us)
_profiling = torch._C._autograd._profiler_enabled


class span:
    """``with span("wb.<leg>") as s: ...``: one host leg of a render.

    Always times the block by the host clock (``s.seconds`` after it,
    :meth:`elapsed` inside it) and adds the seconds to the legs of the
    enclosing :func:`collect_legs`, if any; opens a ``record_function``
    range of the same name only while a profiler records.
    """

    __slots__ = ("name", "t0", "seconds", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> span:
        if _profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        legs = _LEGS.get()
        if legs is not None:
            legs[self.name] = legs.get(self.name, 0.0) + self.seconds

    def elapsed(self) -> float:
        """Host seconds since the span opened."""
        return time.perf_counter() - self.t0


@contextmanager
def collect_legs(legs: dict, stats: RenderStats | None = None):
    """Spans closed inside the block add their seconds to ``legs`` (by name),
    and :func:`count` to the counters of ``stats``."""
    token, stoken = _LEGS.set(legs), _STATS.set(stats)
    try:
        yield
    finally:
        _STATS.reset(stoken)
        _LEGS.reset(token)


def current_stats() -> RenderStats | None:
    """The stats of the enclosing :func:`collect_legs`, if any."""
    return _STATS.get()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of :func:`current_stats`, if any."""
    stats = _STATS.get()
    if stats is not None:
        setattr(stats, name, getattr(stats, name) + n)


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
