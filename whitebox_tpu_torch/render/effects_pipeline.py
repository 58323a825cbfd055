"""Effects finishing: per-track buffers -> chains -> gains -> ordered sum ->
master chain -> hard clip.

Counterpart of ``whitebox_tpu/render/effects_pipeline.py``. The order is
the engine's: each track's chain runs on the track buffer before
volume/pan (track.cpp:600,648-662); the master-bus chain runs after the
track sum and before the hard clip (engine.cpp:1627).

All per-track chains are packed into one batched biquad cascade
(``ops.biquad.pack_chain_sections``) and evaluated chunk by chunk with the
section states carried exactly from chunk to chunk. The JAX package runs
the chunks inside one jitted ``lax.scan``; here they are a Python loop on
the per-track buffers' device. The cascade is ``ops/biquad_cuda.py::
biquad_cascade``: a hand CUDA kernel on the card, the plain per-section
prefix scan on the CPU; the gains, sum, clip and meters are torch ops. On
the card a chunk is :data:`CUDA_CHUNK` frames (the kernel is not bound to
the chunk, and each chunk costs ``T`` launches of the ordered sum); on the
CPU 65,536, which bounds the scan's temporaries. The ordered track sum is
a loop over tracks in index order (the ``lax.scan`` add), never
``sum(dim=0)``, whose order is not fixed; each f32 multiply and add is its
own op.

Also here: the host lane tables the CUDA mix kernel's automation variant
reads (:func:`prepare_automation_tables_host`), their device form for the
finisher's per-frame gains (:func:`prepare_automation_tables`), and the f64
host reference of the whole finish stage (:func:`reference_finish_mix`).
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.effects import Biquad, EffectChain, Gain, ParametricEQ
from whitebox_tpu_torch.ops.automation import (
    HALF_PI, SQRT2, eval_lane_numpy, eval_lanes, pack_session_automation, pan_coef,
    session_has_automation,
)
from whitebox_tpu_torch.ops.biquad import biquad_sequential, pack_chain_sections
from whitebox_tpu_torch.ops.biquad_cuda import biquad_cascade
from whitebox_tpu_torch.ops.mix import _ordered_sum  # noqa: F401 - the finishers import it from here

#: frames per finisher chunk on the card and on the CPU (finish_mix's
#: default): on the card the cascade kernel takes any length and each
#: chunk costs T launches of the ordered sum; on the CPU the plain scan's
#: temporaries grow with the chunk
CUDA_CHUNK, CPU_CHUNK = 1 << 20, 1 << 16


def _chains_of(session):
    """Per-track chains (an EffectChain or None per track) and the master
    chain (or None); a list of effects is wrapped as a chain."""
    def as_chain(effects):
        if not effects:
            return None
        return effects if isinstance(effects, EffectChain) else EffectChain(list(effects))

    return [as_chain(t.effects) for t in session.tracks], as_chain(session.master_effects)


def session_has_effects(session) -> bool:
    return bool(session.master_effects) or any(t.effects for t in session.tracks)


def prepare_effect_tables(session, sample_rate: float, channels: int = 2, device="cpu"):
    """Prepare and pack all chains -> ``((S, coeffs), (Sm, mcoeffs))`` with
    coefficient tensors ``[9, S, T*C, 1]`` / ``[9, Sm, C, 1]`` f32 on
    ``device``."""
    chains, master = _chains_of(session)
    for c in chains:
        if c is not None:
            c.prepare(sample_rate, channels)
    S, coeffs = pack_chain_sections(chains, channels)
    if master is not None:
        master.prepare(sample_rate, channels)
    Sm, mcoeffs = pack_chain_sections([master], channels)
    return ((S, torch.from_numpy(coeffs).to(device)), (Sm, torch.from_numpy(mcoeffs).to(device)))


def _frame_gains(auto, track_gain: torch.Tensor, g: torch.Tensor, T: int, C: int) -> torch.Tensor:
    """Per-frame track gains ``[T, C, F]`` at global frames ``g`` ``[F]``:
    the automation lanes where a track uses them, its constant fader gain
    elsewhere (bit for bit)."""
    F = g.shape[0]
    if auto is None:
        return torch.broadcast_to(track_gain[:, :, None], (T, C, F))
    vol_t, pan_t, mute, use_auto = auto
    vol = eval_lanes(vol_t, g)  # [T, F]
    panv = eval_lanes(pan_t, g)
    chans = []
    for ch in range(C):
        gain_ch = (vol * pan_coef(panv, ch)) * mute[:, None]
        const = torch.broadcast_to(track_gain[:, ch:ch + 1], gain_ch.shape)
        chans.append(torch.where(use_auto[:, None], gain_ch, const))
    return torch.stack(chans, dim=1)


def _finish_chunk(xc, coeffs, mcoeffs, track_gain, states, mstates, g, auto, T, C, S, Sm,
                  with_meters, valid_frames):
    """One chunk ``xc`` ``[T*C, Fc]`` at global frames ``g``: chains, gains,
    ordered sum, master chain, clip; meters over frames ``< valid_frames``
    (all frames when None)."""
    xc, new_states = biquad_cascade(xc, coeffs, states)
    y = xc.reshape(T, C, -1) * _frame_gains(auto, track_gain, g, T, C)
    total, new_mstates = biquad_cascade(_ordered_sum(y), mcoeffs, mstates)
    total = torch.where(total > 1.0, 1.0, total)
    total = torch.where(total < -1.0, -1.0, total)
    meters = None
    if with_meters:
        ym, tm = y, total
        if valid_frames is not None:
            # the pad tail is chain ring-out, not audio
            valid = g < valid_frames
            ym = torch.where(valid, y, 0.0)
            tm = torch.where(valid, total, 0.0)
        meters = (ym.abs().amax(dim=-1), (ym * ym).sum(dim=-1),
                  tm.abs().amax(dim=-1), (tm * tm).sum(dim=-1))
    return total, new_states, new_mstates, meters


def init_effect_states(T: int, C: int, S: int, Sm: int, device="cpu"):
    return ([torch.zeros((T * C, 2), dtype=torch.float32, device=device) for _ in range(S)],
            [torch.zeros((C, 2), dtype=torch.float32, device=device) for _ in range(Sm)])


def finish_mix(per_track, coeffs, mcoeffs, track_gain, auto=None, *, T, C, S, Sm, chunk=None,
               with_meters=False, valid_frames=None):
    """per_track ``[T, C, F]`` f32 -> mixed ``[C, F]`` f32 (chains, gains,
    ordered sum, master chain, clip), chunk by chunk with the states
    carried; ``chunk`` frames each (default :data:`CUDA_CHUNK` on the card,
    :data:`CPU_CHUNK` on the CPU). ``per_track`` is read, not written.

    With ``with_meters``, also returns level meters taken where the engine
    feeds its VU meters, post chain + volume/pan and pre track sum
    (track.cpp:728-733): ``(track_peak [T, C], track_rms [T, C],
    output_peak [C], output_rms [C])``; the output meters are post-master,
    post-clip, over the first ``valid_frames`` frames."""
    F = per_track.shape[-1]
    dev = per_track.device
    if chunk is None:
        chunk = CUDA_CHUNK if dev.type == "cuda" else CPU_CHUNK
    Fv = F if valid_frames is None else int(valid_frames)
    x = per_track.reshape(T * C, F)
    states, mstates = init_effect_states(T, C, S, Sm, dev)
    outs, parts = [], []
    for start in range(0, F, chunk):
        xc = x[:, start:start + chunk]  # a strided view; the last chunk may be shorter
        g = start + torch.arange(xc.shape[1], dtype=torch.int32, device=dev)
        total, states, mstates, m = _finish_chunk(xc, coeffs, mcoeffs, track_gain, states, mstates,
                                                  g, auto, T, C, S, Sm, with_meters, Fv)
        outs.append(total)
        parts.append(m)
    mixed = torch.cat(outs, dim=1)
    if not with_meters:
        return mixed
    return mixed, meters_from_partials(parts, Fv)


def meters_from_partials(parts, valid_frames: int):
    """Chunk meter partials ``(track_peak, track_sumsq, out_peak,
    out_sumsq)`` -> ``(track_peak, track_rms, output_peak, output_rms)``,
    the RMS over ``valid_frames`` frames (frames past them were zeroed in
    the partials, or are silence and ring-out, as the JAX package counts
    them)."""
    pk, sq, opk, osq = (torch.stack(p) for p in zip(*parts))
    denom = float(max(valid_frames, 1))
    return (pk.amax(dim=0), torch.sqrt(sq.sum(dim=0) / denom),
            opk.amax(dim=0), torch.sqrt(osq.sum(dim=0) / denom))


def finish_mix_chunk(pt_chunk, coeffs, mcoeffs, track_gain, states, mstates, chunk_start=0, auto=None,
                     *, T, C, S, Sm, with_meters=False):
    """Single-chunk finishing step with explicit state in and out (for
    callers that stream per-track buffers chunk by chunk). ``with_meters``
    appends the chunk partials (track_peak, track_sumsq, out_peak,
    out_sumsq) for aggregation by the caller."""
    Fc = pt_chunk.shape[-1]
    g = chunk_start + torch.arange(Fc, dtype=torch.int32, device=pt_chunk.device)
    total, ns, nms, meters = _finish_chunk(pt_chunk.reshape(T * C, Fc), coeffs, mcoeffs, track_gain,
                                           states, mstates, g, auto, T, C, S, Sm, with_meters, None)
    return (total, ns, nms, meters) if with_meters else (total, ns, nms)


def prepare_automation_tables_host(session, sample_rate: float):
    """Host lane tables ``(vol, pan, mute, use)`` for the automation kernel,
    or None when no track has automation. ``vol``/``pan`` are dicts of
    ``[T, P]`` arrays (``xs`` i32, ``ys`` f32, ``cv`` i32, ``tn`` f32),
    ``mute`` ``[T]`` f32 and ``use`` ``[T]`` bool: only tracks with a
    volume or pan lane take per-frame gains, the rest keep their constant
    fader gains bit for bit."""
    if not session_has_automation(session):
        return None
    vol, pan, mute = pack_session_automation(session, sample_rate)
    use = np.array([t.automation is not None and t.automation.has_track_lanes()
                    for t in session.tracks], dtype=bool)
    return (vol, pan, mute, use)


def prepare_automation_tables(session, sample_rate: float, device="cpu"):
    """The lane tables as tensors on ``device`` for :func:`_frame_gains`
    (None without automation): ``(vol, pan, mute, use)``."""
    host = prepare_automation_tables_host(session, sample_rate)
    if host is None:
        return None
    vol, pan, mute, use = host

    def lane(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}

    return (lane(vol), lane(pan), torch.from_numpy(mute).to(device), torch.from_numpy(use).to(device))


def _run_chain_f64(chain, x: np.ndarray, sample_rate: float, channels: int) -> np.ndarray:
    """A prepared LTI chain on ``x`` ``[C, F]`` in f64 (``biquad_sequential``)."""
    if chain is None:
        return x
    chain.prepare(sample_rate, channels)
    for e in chain.effects:
        if isinstance(e, Biquad):
            x, _ = biquad_sequential(x, e.coeffs)
        elif isinstance(e, ParametricEQ):
            for c in e.coeffs:
                x, _ = biquad_sequential(x, c)
        elif isinstance(e, Gain):
            x = x * float(e.gain_linear)
        else:
            raise TypeError(e)
    return x


def reference_finish_mix(per_track: np.ndarray, session, sample_rate: float, channels: int = 2) -> np.ndarray:
    """f64 host reference: per-track buffers ``[T, C, F]`` -> mix ``[C, F]``.

    Each track's chain in f64 (``biquad_sequential``); automated tracks take
    the f32 lane values (``eval_lane_numpy``) and the f32 pan law per
    frame, the others their constant f32 fader gain. The sum and the master
    chain run in f64, then the hard clip and one rounding to f32."""
    chains, master = _chains_of(session)
    T, C, F = per_track.shape
    g = np.arange(F, dtype=np.int64)
    auto_tables = pack_session_automation(session, sample_rate) if session_has_automation(session) else None
    total = np.zeros((C, F), dtype=np.float64)
    for t, track in enumerate(session.tracks):
        buf = _run_chain_f64(chains[t], per_track[t].astype(np.float64), sample_rate, channels)
        if track.automation is not None and track.automation.has_track_lanes():
            vol_t, pan_t, mute = auto_tables
            volv = eval_lane_numpy(vol_t["xs"][t], vol_t["ys"][t], vol_t["cv"][t], vol_t["tn"][t], g)
            panv = eval_lane_numpy(pan_t["xs"][t], pan_t["ys"][t], pan_t["cv"][t], pan_t["tn"][t], g)
            for ch in range(C):
                x = np.float32(0.5) * (panv + np.float32(1.0))
                arg = (np.float32(1.0) - x) if ch % 2 == 0 else x
                coef = (np.sin(HALF_PI * arg) * SQRT2).astype(np.float32)
                total[ch] += buf[ch] * ((volv * coef) * mute[t]).astype(np.float64)
        else:
            vol = np.float32(0.0) if track.mute else track.volume_linear
            pan = track.pan_coeffs
            for ch in range(C):
                total[ch] += buf[ch] * float(np.float32(vol * np.float32(pan[ch % 2])))
    total = _run_chain_f64(master, total, sample_rate, channels)
    return np.clip(total, -1.0, 1.0).astype(np.float32)
