"""Roofline cost model: the least bytes and operations a render must spend.

Counterpart of ``whitebox_tpu/render/roofline.py``. For a render we
estimate its speed-of-light device time: the memory traffic it must move
and the operations it must execute, over the card's peak memory rate and
peak f32 rate. ``RenderStats.roofline_fraction`` is that time over the
measured device time.

The model and its term names are the JAX package's, so the two packages'
estimates compare term by term:

- the timeline mix reads every touched source-pool sample once
  (resampled rows touch ``length x |speed|`` source frames) and writes
  the output once;
- finishing reads the ``[T, C, F]`` per-track buffer once (the sum), and
  each stateful effect stage streams its block in and out; memoryless
  stages (gain, saturator, width) are charged nothing;
- FFT convolution and the sinc prerender's banded products count their
  multiply-adds in ``mxu_flops`` (the field keeps the JAX package's name;
  here it holds f32 operations).

The peaks are the card's (:func:`device_peaks`): read from
``torch.cuda.get_device_properties`` where it gives them, the data-sheet
figures of the named card otherwise. Off the card, or on a card neither
knows, there are none and the fraction is NaN.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: published peaks by card name (NVIDIA H100 SXM data sheet, 700 W): HBM
#: bytes/s and f32 operations/s outside the tensor cores
DATASHEET_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
HBM_BYTES_PER_S, F32_OPS_PER_S = DATASHEET_PEAKS["NVIDIA H100 80GB HBM3"]
#: f32 lanes per streaming multiprocessor by compute capability (an FMA
#: counts as two operations)
_F32_LANES_PER_SM = {(9, 0): 128}


def device_peaks(device) -> tuple[float, float] | None:
    """``(HBM bytes/s, f32 operations/s)`` of a CUDA ``device``, or None.

    The memory rate from the memory clock and bus width, and the f32 rate
    from the SM clock, SM count and the lanes of the compute capability,
    where the properties give them; the data-sheet figures of the named
    card for what they do not. None on the CPU and on a card with
    neither."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    sheet = DATASHEET_PEAKS.get(props.name)
    mem_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    sm_khz = getattr(props, "clock_rate", None)
    lanes = _F32_LANES_PER_SM.get((props.major, props.minor))
    bw = 2.0 * mem_khz * 1e3 * bus_bits / 8.0 if mem_khz and bus_bits else None
    ops = 2.0 * sm_khz * 1e3 * props.multi_processor_count * lanes if sm_khz and lanes else None
    bw = bw or (sheet[0] if sheet else None)
    ops = ops or (sheet[1] if sheet else None)
    return (bw, ops) if bw and ops else None


@dataclass
class CostEstimate:
    """Bytes and operations a render must spend; speed-of-light seconds
    against a card's peaks."""

    hbm_bytes: float = 0.0
    mxu_flops: float = 0.0  # f32 operations of the matmul and FFT stages
    terms: dict = field(default_factory=dict)  # name -> (bytes, flops)

    def add(self, name: str, hbm_bytes: float = 0.0, mxu_flops: float = 0.0) -> None:
        self.hbm_bytes += hbm_bytes
        self.mxu_flops += mxu_flops
        b, f = self.terms.get(name, (0.0, 0.0))
        self.terms[name] = (b + hbm_bytes, f + mxu_flops)

    def sol_seconds(self, hbm_bytes_s: float, f32_flops: float) -> float:
        """Speed-of-light device time: memory and arithmetic overlap, so
        the bound is the larger of the two budgets."""
        return max(self.hbm_bytes / hbm_bytes_s, self.mxu_flops / f32_flops)

    def utilization(self, device_seconds: float, hbm_bytes_s: float, f32_flops: float) -> float:
        """Fraction of the roofline achieved (1.0 = at the hardware bound)."""
        if device_seconds <= 0:
            return float("nan")
        return self.sol_seconds(hbm_bytes_s, f32_flops) / device_seconds

    def bound(self, hbm_bytes_s: float, f32_flops: float) -> str:
        """Which resource sets the floor: "bytes" or "operations"."""
        return "bytes" if self.hbm_bytes / hbm_bytes_s >= self.mxu_flops / f32_flops else "operations"

    def summary(self, peaks=None, device_seconds: float | None = None) -> str:
        parts = [f"~{self.hbm_bytes / 1e6:.1f} MB moved"]
        if self.mxu_flops > 0:
            parts.append(f"{self.mxu_flops / 1e9:.2f} G f32 operations")
        s = ", ".join(parts)
        if peaks is not None:
            s += f" -> sol {self.sol_seconds(*peaks) * 1e3:.2f} ms ({self.bound(*peaks)}-bound)"
            if device_seconds and device_seconds > 0:
                s += f"; achieved {100.0 * self.utilization(device_seconds, *peaks):.0f}% of the card's roofline"
        return s


def mix_cost(table, frames: int, channels: int) -> CostEstimate:
    """Timeline-mix traffic from a carve SegmentTable: touched pool frames
    read once per output channel + the mixed output written once."""
    est = CostEstimate()
    if len(table):
        length = np.asarray(table.length, np.float64)
        speed = np.abs(np.asarray(table.speed, np.float64))
        touched = float(np.sum(length * np.maximum(speed, 1.0)))
        est.add("mix.pool_read", hbm_bytes=touched * channels * 4.0)
    est.add("mix.out_write", hbm_bytes=float(frames) * channels * 4.0)
    return est


#: memoryless stage kinds, charged nothing (they ride a neighbour's stream)
_FUSED_KINDS = frozenset({"gain", "saturator", "width"})


def _stage_cost(est: CostEstimate, kind: str, static: tuple, B: int, channels: int,
                frames: int) -> None:
    """One chain stage over [B, C, F]."""
    block = float(B) * channels * frames * 4.0
    if kind in _FUSED_KINDS:
        return
    if kind in ("convreverb", "linphase"):
        # overlap-add FFT: stream in/out + 5*N*log2(N) real-FFT operations
        # per block pair (forward + inverse), N ~ 2*ir_len
        L = int(static[0]) if static else 1024
        n = max(float(2 * L), 1024.0)
        nblocks = max(frames / max(L, 1), 1.0)
        est.add(f"fx.{kind}", hbm_bytes=2.0 * block,
                mxu_flops=B * channels * nblocks * 5.0 * n * np.log2(n))
        return
    # stateful scan stages (biquad/eq/dynamics/delay/chorus): the block in and out
    est.add(f"fx.{kind}", hbm_bytes=2.0 * block)


def _stages_for_cost(chain, sample_rate: float):
    """(kind, static) per stage, tolerating unprepared effects (a designed
    room's IR length depends on the sample rate); nothing is mutated."""
    from whitebox_tpu_torch.effects.base import EffectChain
    from whitebox_tpu_torch.render.effects_generic import _kind_of, _stage_kind

    effs = chain.effects if isinstance(chain, EffectChain) else list(chain)
    out = []
    for e in effs:
        try:
            kind, static = _stage_kind(e)
        except Exception:
            kind = _kind_of(e)
            ir = getattr(e, "ir_host", None)
            if ir is not None:
                static = (int(np.asarray(ir).shape[-1]),)
            elif getattr(e, "room_seconds", None) is not None:
                static = (max(int(float(e.room_seconds) * sample_rate), 1),)
            else:
                static = ()
        out.append((kind, static))
    return out


def fx_cost(session, frames: int, channels: int) -> CostEstimate:
    """Finishing traffic: the per-track buffer read for the sum + per-stage
    streams for every track/bus/master chain."""
    from whitebox_tpu_torch.render.effects_pipeline import _chains_of

    est = CostEstimate()
    T = len(session.tracks)
    sr = float(getattr(session, "sample_rate", 48000.0))
    est.add("finish.pt_read", hbm_bytes=float(T) * channels * frames * 4.0)
    chains, master = _chains_of(session)
    for c in [*chains, master, *[b.effects for b in getattr(session, "buses", []) or []
                                 if getattr(b, "effects", None)]]:
        if c is None:
            continue
        for (kind, static) in _stages_for_cost(c, sr):
            _stage_cost(est, kind, static, 1, channels, frames)
    est.add("finish.out_write", hbm_bytes=float(frames) * channels * 4.0)
    return est


def routing_cost(session, frames: int, channels: int) -> CostEstimate:
    """The routed finisher's routing products (``render/routing.py``):
    ``r_post [1+NB, T]`` and ``r_pre [NB, T]`` against ``[T, C*F]``."""
    est = CostEstimate()
    buses = getattr(session, "buses", []) or []
    if not buses:
        return est
    T = len(session.tracks)
    NB = len(buses)
    cf = float(channels) * frames
    est.add("route.matmul", mxu_flops=2.0 * (1 + 2 * NB) * T * cf, hbm_bytes=(T + 2 * NB + 1) * cf * 4.0)
    return est


def prerender_cost(pplan, channels: int = 2) -> CostEstimate:
    """The sinc prerender's banded products (timeline/prerender.py): one
    row of ``taps`` coefficients per output sample, the extension written
    and read back by the mix."""
    est = CostEstimate()
    if pplan is None:
        return est
    out = float(pplan.ext_len) * channels
    est.add("prerender.einsum", mxu_flops=2.0 * out * float(pplan.taps), hbm_bytes=2.0 * out * 4.0)
    return est


def estimate_bounce_cost(table, session, frames: int, channels: int) -> CostEstimate:
    """Whole-render estimate from the carve table + session structure
    (stored on ``RenderStats.cost``)."""
    from whitebox_tpu_torch.ops.automation import session_has_automation
    from whitebox_tpu_torch.render.effects_pipeline import session_has_effects
    from whitebox_tpu_torch.session.bus import session_has_routing

    est = mix_cost(table, frames, channels)
    if session_has_effects(session) or session_has_automation(session) or session_has_routing(session):
        for sub in (fx_cost(session, frames, channels), routing_cost(session, frames, channels)):
            for name, (b, f) in sub.terms.items():
                est.add(name, b, f)
    return est
