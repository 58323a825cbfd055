"""The built-in polyphonic synth, spec'd from the reference's TestSynth.

Counterpart of ``whitebox_tpu/midi/synth.py``: the host halves
(:func:`build_slot_segments`, :func:`step32_for_key`,
:func:`pack_slot_tables` and the NumPy spec :func:`render_synth_numpy`)
are the JAX package's, copied; :func:`render_synth_chunk`, an XLA program
there, is torch ops here, on the device of its tables.

TestSynth (test_synth.cpp:33-58) is a 64-voice square-wave synth with a
linear decay envelope. The production numerics (the JAX package's):

- phase: a 32-bit fixed-point accumulator, ``phase32(n) = n * step32 mod
  2^32`` with ``step32 = round(freq/rate * 2^32)``; the square output is
  the top bit. Note 69 plays 440 Hz;
- envelope: ``amp(n) = max(1 - n * (5/44100), 0)`` in f32;
- per frame, the voices sum in slot order from zero, added to every
  output channel before the track's volume and pan.

Voice events channelize into at most 64 slots with non-overlapping
segments per slot (``midi/voice.py``); a frame's segment in its slot is a
sorted search of the slot's segment starts. :func:`render_synth_chunk`
is bit-equal to :func:`render_synth_numpy`: ``n * step32`` runs in int64
and keeps its low 32 bits (torch's ``uint32`` lacks the arithmetic; the
product is below 2^54, as ``n`` is below the session's frames), every
multiply and add is its own op in the spec's order, and the slots add in
order, not by a reduction tree.
"""

from __future__ import annotations

import numpy as np
import torch

from whitebox_tpu_torch.core.math import note_to_hz
from whitebox_tpu_torch.midi.voice import VoiceEvent

ENV_SPEED = np.float32(5.0 / 44100.0)
#: (slot, frame) cells per piece of :func:`render_synth_chunk`: its int64
#: temporaries stay at 64 MB (the synth is elementwise per frame, so the
#: pieces change no bit)
SYNTH_PIECE_ELEMENTS = 1 << 23


def build_slot_segments(events: list[VoiceEvent], num_slots: int = 64):
    """Voice events -> per-slot non-overlapping segments.

    Returns (num_slots_used, dict of arrays): seg_slot, seg_start, seg_end,
    seg_step32 (uint32), seg_vel (f32), sorted by (slot, start).
    """
    opens: dict[int, VoiceEvent] = {}
    rows = []
    max_slot = -1
    for ev in events:
        if ev.on:
            prev = opens.pop(ev.slot, None)
            if prev is not None and ev.frame > prev.frame:  # defensive close
                rows.append((prev.slot, prev.frame, ev.frame, prev.key, prev.velocity))
            opens[ev.slot] = ev
            max_slot = max(max_slot, ev.slot)
        else:
            on = opens.pop(ev.slot, None)
            if on is not None and ev.frame > on.frame:
                rows.append((on.slot, on.frame, ev.frame, on.key, on.velocity))
    for slot, on in opens.items():  # unterminated: ring to +inf (caller clips)
        rows.append((slot, on.frame, 2**31 - 1, on.key, on.velocity))
    rows.sort(key=lambda r: (r[0], r[1]))
    if not rows:
        return 0, None
    seg_slot = np.array([r[0] for r in rows], dtype=np.int32)
    seg_start = np.array([r[1] for r in rows], dtype=np.int32)
    seg_end = np.array([r[2] for r in rows], dtype=np.int32)
    seg_key = np.array([r[3] for r in rows], dtype=np.int32)
    seg_vel = np.array([r[4] for r in rows], dtype=np.float32)
    return max_slot + 1, {
        "slot": seg_slot, "start": seg_start, "end": seg_end,
        "key": seg_key, "vel": seg_vel,
    }


def step32_for_key(key, sample_rate: float) -> np.ndarray:
    """Fixed-point phase step: round(note_hz/rate * 2^32) as uint32."""
    freq = note_to_hz(np.asarray(key, dtype=np.float64))
    step = np.round(freq / sample_rate * 4294967296.0)
    return (step.astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32)


def pack_slot_tables(segs: dict, sample_rate: float, num_slots: int, max_per_slot: int | None = None):
    """Per-slot padded arrays [num_slots, S] for the device renderer."""
    counts = np.bincount(segs["slot"], minlength=num_slots)
    S = max(int(counts.max()), 1) if max_per_slot is None else max_per_slot
    start = np.full((num_slots, S), np.int32(2**31 - 1), dtype=np.int32)
    end = np.zeros((num_slots, S), dtype=np.int32)
    step = np.zeros((num_slots, S), dtype=np.uint32)
    vel = np.zeros((num_slots, S), dtype=np.float32)
    pos = np.zeros(num_slots, dtype=np.int64)
    st32 = step32_for_key(segs["key"], sample_rate)
    for i in range(segs["slot"].shape[0]):
        sl = int(segs["slot"][i])
        j = int(pos[sl])
        pos[sl] += 1
        start[sl, j] = segs["start"][i]
        end[sl, j] = segs["end"][i]
        step[sl, j] = st32[i]
        vel[sl, j] = segs["vel"][i]
    return {"start": start, "end": end, "step": step, "vel": vel}


def synth_device_tables(tables: list, device="cpu") -> dict:
    """R tracks' :func:`pack_slot_tables` host arrays stacked as tensors
    ``[R, slots, S]`` on ``device``: ``start``/``end`` int32 (sorted rows,
    ``INT32_MAX`` padding), ``step`` int64 (the uint32 steps), ``vel`` f32;
    every track padded to the most slots and segments (a padded slot never
    sounds, and adding its +0.0 changes no bit)."""
    slots = max(t["start"].shape[0] for t in tables)
    S = max(t["start"].shape[1] for t in tables)
    fill = {"start": (np.int32, 2**31 - 1), "end": (np.int32, 0), "step": (np.int64, 0), "vel": (np.float32, 0.0)}
    out = {}
    for k, (dt, pad) in fill.items():
        a = np.full((len(tables), slots, S), pad, dt)
        for i, t in enumerate(tables):
            a[i, :t[k].shape[0], :t[k].shape[1]] = t[k]
        out[k] = torch.from_numpy(a).to(device)
    return out


def _synth_piece(tables: dict, g: torch.Tensor) -> torch.Tensor:
    """The synth at global frames ``g`` ``[F]`` int32 -> ``[R, F]`` f32."""
    start, end = tables["start"], tables["end"]
    R, slots, S = start.shape
    gs = g.expand(R, slots, -1).contiguous()
    idx = torch.clamp(torch.searchsorted(start, gs, right=True) - 1, 0, S - 1)
    s0 = torch.gather(start, -1, idx)
    valid = (gs >= s0) & (gs < torch.gather(end, -1, idx))
    n = torch.where(valid, gs - s0, 0)
    phase = (n.to(torch.int64) * torch.gather(tables["step"], -1, idx)) & 0xFFFFFFFF
    osc = torch.where(phase >= 0x80000000, 1.0, -1.0)
    amp = torch.clamp(1.0 - n.to(torch.float32) * float(ENV_SPEED), min=0.0)
    contrib = torch.where(valid, (osc * amp) * (torch.gather(tables["vel"], -1, idx) * 0.5), 0.0)
    total = torch.zeros_like(contrib[:, 0])
    for s in range(slots):  # slot order, from zero
        total = total + contrib[:, s]
    return total


def render_synth_chunk(tables: dict, chunk_start: int, frames: int) -> torch.Tensor:
    """R tracks' synth over frames ``[chunk_start, chunk_start + frames)``
    -> ``[R, frames]`` f32 on the tables' device (:func:`synth_device_tables`),
    in pieces of about :data:`SYNTH_PIECE_ELEMENTS` (slot, frame) cells."""
    start = tables["start"]
    piece = max(SYNTH_PIECE_ELEMENTS // (start.shape[0] * start.shape[1]), 1024)
    pieces = []
    for a in range(0, frames, piece):
        g = int(chunk_start) + a + torch.arange(min(piece, frames - a), dtype=torch.int32, device=start.device)
        pieces.append(_synth_piece(tables, g))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def render_synth_numpy(segs: dict, sample_rate: float, total_frames: int, num_slots: int) -> np.ndarray:
    """Host reference (bit-identical spec) -> [total_frames] f32."""
    out = np.zeros(total_frames, dtype=np.float32)
    st32 = step32_for_key(segs["key"], sample_rate)
    order = np.lexsort((segs["start"], segs["slot"]))
    for sl in range(num_slots):
        acc = np.zeros(total_frames, dtype=np.float32)
        for i in order:
            if segs["slot"][i] != sl:
                continue
            a = int(segs["start"][i])
            b = min(int(segs["end"][i]), total_frames)
            if b <= a or a >= total_frames:
                continue
            n = np.arange(b - a, dtype=np.int64)
            phase = (n.astype(np.uint64) * np.uint64(st32[i])) & np.uint64(0xFFFFFFFF)
            osc = np.where(phase >= 0x80000000, np.float32(1.0), np.float32(-1.0))
            amp = np.maximum(np.float32(1.0) - n.astype(np.float32) * ENV_SPEED, np.float32(0.0))
            acc[a:b] += (osc * amp) * (np.float32(segs["vel"][i]) * np.float32(0.5))
        out += acc
    return out
