"""The chunked gather mix: the timeline over ``[tracks, channels, frames]``.

Counterpart of ``whitebox_tpu/ops/mix.py``, the JAX package's portable
XLA path. The port's ``bounce`` takes it for sessions the slot plan
cannot hold (a slot overflow, per-track buffers above
``render/bounce.py::per_track_limit_bytes``) and for ``engine="xla"``; the
preview, the streamed bounce, stems past the per-track limit and the
sharded mix render from it too. Each chunk of frames looks up every
track's segment row per frame (a sorted search over the track's padded
``dst_start`` table), fetches the source samples, interpolates resampled
rows (linear as the reference sampler, Catmull-Rom, polynomial taps over
an oversampled pool, or the direct 32-tap windowed sinc), applies clip
gain and fades, track volume*pan, the ordered track sum and the hard clip.

:func:`render_chunk` and :func:`render_chunk_per_track` dispatch by the
pool's device: on a CUDA tensor one launch of the hand kernel
``csrc/gather_mix.cu`` (``ops/gather_cuda.py``; a failed build or launch
raises, nothing falls back), on the CPU :func:`gather_plain`, the plain
torch ops. The plain version is the kernel's specification: every
multiply and add is its own op (no FMA contraction: no ``lerp``,
``addcmul`` or compile), so speed-1 rows are bit-exact, and with
``strict_order=True`` the tracks sum in index order from +0.0; the kernel
is the plain version bit for bit on the card. ``strict_order=False`` is
one ``torch.sum`` over the track axis in the plain version, whose order is
not fixed (associativity relaxed, as the JAX docstring says); the kernel
always sums in index order, one admissible order.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import gather_cuda, sum_cuda
from whitebox_tpu_torch.ops.dsarith import phase_eval, split_f64

_I32_SENTINEL = np.int32(2**31 - 1)
#: frames the plain version renders at once (its per-frame temporaries are
#: ``[T, frames]`` int64 and f32)
PLAIN_FRAMES = 1 << 16


@dataclass
class DeviceTables:
    """Segment tables padded per track: all [T, S] (src_base [T, S, C])."""

    dst_start: np.ndarray  # [T, S] i32, padded with INT32_MAX (sorted per track)
    length: np.ndarray  # [T, S] i32 (0 padding)
    src_base: np.ndarray  # [T, S, C] i32: channel_base + src_int
    frac_hi: np.ndarray  # [T, S] f32
    frac_lo: np.ndarray  # [T, S] f32
    speed_hi: np.ndarray  # [T, S] f32
    speed_lo: np.ndarray  # [T, S] f32
    gain: np.ndarray  # [T, S] f32
    fast: np.ndarray  # [T, S] bool
    clamp: np.ndarray  # [T, S] bool
    fin_start: np.ndarray  # [T, S] i32 fade-in ramp start (global frame)
    fin_inv: np.ndarray  # [T, S] f32
    fout_end: np.ndarray  # [T, S] i32 fade-out ramp end
    fout_inv: np.ndarray  # [T, S] f32
    track_gain: np.ndarray  # [T, C] f32 (volume * pan per channel)
    total_frames: int
    num_tracks: int
    channels: int

    def as_torch(self, device="cpu") -> dict:
        """The tables as tensors on ``device``; the integer fields the
        gathers index with (``src_base``) widened to int64."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[f.name] = (t.to(torch.int64) if f.name == "src_base" else t).to(device)
        return out


def pack_device_tables(table, pool, session, channels: int = 2,
                       pad_tracks_to: int | None = None) -> DeviceTables:
    """Host packing of a carve table (``whitebox_tpu/ops/mix.py:75-149``,
    array for array): each track's rows in ``dst_start`` order, padded to
    the longest track with rows no frame reaches."""
    T = table.num_tracks if pad_tracks_to is None else max(pad_tracks_to, table.num_tracks)
    counts = np.bincount(table.track, minlength=T) if len(table) else np.zeros(T, dtype=np.int64)
    S = max(int(counts.max()) if counts.size else 1, 1)

    dst_start = np.full((T, S), _I32_SENTINEL, dtype=np.int32)
    length = np.zeros((T, S), dtype=np.int32)
    src_base = np.zeros((T, S, channels), dtype=np.int32)
    frac_hi = np.zeros((T, S), dtype=np.float32)
    frac_lo = np.zeros((T, S), dtype=np.float32)
    speed_hi = np.ones((T, S), dtype=np.float32)
    speed_lo = np.zeros((T, S), dtype=np.float32)
    gain = np.zeros((T, S), dtype=np.float32)
    fast = np.ones((T, S), dtype=bool)
    clamp = np.zeros((T, S), dtype=bool)
    fin_start = np.full((T, S), -(1 << 30), dtype=np.int32)
    fin_inv = np.ones((T, S), dtype=np.float32)
    fout_end = np.full((T, S), 1 << 30, dtype=np.int32)
    fout_inv = np.ones((T, S), dtype=np.float32)

    if len(table):
        fh, fl = split_f64(table.src_frac)
        sh, sl = split_f64(table.speed)
        # rows come sorted by (track, dst_start); slot = rank within track
        trk = table.track.astype(np.int64)
        if trk.size > 1 and np.any(np.diff(trk) < 0):
            order = np.argsort(trk, kind="stable")  # defensive; normally a no-op
        else:
            order = np.arange(trk.size)
        t_idx = trk[order]
        row_offset = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(np.bincount(t_idx, minlength=T), out=row_offset[1:])
        slot = np.arange(t_idx.size) - row_offset[t_idx]

        dst_start[t_idx, slot] = table.dst_start[order]
        length[t_idx, slot] = table.length[order]
        sid = table.sample_id[order].astype(np.int64)
        src_base[t_idx, slot, :] = (
            pool.channel_base[sid][:, :channels].astype(np.int64) + table.src_int[order][:, None])
        frac_hi[t_idx, slot] = fh[order]
        frac_lo[t_idx, slot] = fl[order]
        speed_hi[t_idx, slot] = sh[order]
        speed_lo[t_idx, slot] = sl[order]
        gain[t_idx, slot] = table.gain[order]
        fast[t_idx, slot] = table.fast[order]
        clamp[t_idx, slot] = table.clamp[order]
        fin_start[t_idx, slot] = table.fin_start[order]
        fin_inv[t_idx, slot] = table.fin_inv[order]
        fout_end[t_idx, slot] = table.fout_end[order]
        fout_inv[t_idx, slot] = table.fout_inv[order]

    track_gain = np.zeros((T, channels), dtype=np.float32)
    for t, track in enumerate(session.tracks):
        vol = np.float32(0.0) if track.mute else track.volume_linear
        pan = track.pan_coeffs
        for ch in range(channels):
            track_gain[t, ch] = vol * np.float32(pan[ch % 2])

    return DeviceTables(
        dst_start=dst_start, length=length, src_base=src_base,
        frac_hi=frac_hi, frac_lo=frac_lo, speed_hi=speed_hi, speed_lo=speed_lo,
        gain=gain, fast=fast, clamp=clamp,
        fin_start=fin_start, fin_inv=fin_inv, fout_end=fout_end, fout_inv=fout_inv,
        track_gain=track_gain, total_frames=table.total_frames, num_tracks=T, channels=channels,
    )


def _row_index(dst_start: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Index of each frame's row, [T, F] int64: the last row whose
    ``dst_start`` is <= the frame (-1 before the first). The JAX package's
    branchless ``_bisect_right`` - 1; the ``INT32_MAX`` padding is never
    <= a frame, as there."""
    v = torch.broadcast_to(g, (dst_start.shape[0], g.shape[0])).contiguous()
    return torch.searchsorted(dst_start, v, right=True) - 1


def track_contrib_plain(pool: torch.Tensor, tables: dict, g: torch.Tensor, sinc_bank=None,
                        interp="linear") -> torch.Tensor:
    """Every track's contribution at global frames ``g`` [F] -> [T, C, F]
    (``whitebox_tpu/ops/mix.py:175-256`` vmapped over the tracks).

    ``sinc_bank`` [phases+1, taps]: windowed-sinc taps for resampled rows
    (the direct form); ``interp``: "linear", "catmull" or ("poly", coeffs)
    for resampled rows over an oversampled pool. Speed-1 rows are a copy
    in every mode."""
    dst_start = tables["dst_start"]
    S = dst_start.shape[1]
    idx = _row_index(dst_start, g)
    idx_c = torch.clamp(idx, 0, S - 1)

    def row(name):
        return torch.gather(tables[name], 1, idx_c)

    ds0 = row("dst_start")
    valid = (idx >= 0) & (g >= ds0) & (g < ds0 + row("length"))
    j = torch.where(valid, g - ds0, 0).to(torch.int32)
    row_fast, row_clamp, row_gain = row("fast"), row("clamp"), row("gain")
    # clip fade envelope (identity rows use +-2^30 anchors: env == 1 exactly)
    env = torch.clamp((g - row("fin_start")).to(torch.float32) * row("fin_inv"), 0.0, 1.0)
    env = env * torch.clamp((row("fout_end") - g).to(torch.float32) * row("fout_inv"), 0.0, 1.0)

    ixl, fx = phase_eval(j, row("frac_hi"), row("frac_lo"), row("speed_hi"), row("speed_lo"))
    ixl = torch.where(row_fast, j, ixl).to(torch.int64)
    fx = torch.where(row_fast, 0.0, fx)

    limit = pool.shape[0] - 2
    clamp_row = row_fast & row_clamp
    if sinc_bank is not None:
        phases, taps = sinc_bank.shape[0] - 1, sinc_bank.shape[1]
        half = taps // 2
        pf = fx * phases
        p0 = torch.clamp(pf.to(torch.int32), 0, phases - 1).to(torch.int64)
        pl = pf - p0.to(torch.float32)
    src_base = tables["src_base"]
    outs = []
    for ch in range(src_base.shape[2]):
        src = torch.clamp(torch.gather(src_base[:, :, ch], 1, idx_c) + ixl, 0, limit)
        a = pool[src]
        a_eff = torch.where(clamp_row, torch.clamp(a, -1.0, 1.0), a)
        if sinc_bank is None and isinstance(interp, tuple) and interp and interp[0] == "poly":
            # LS-optimal polynomial taps over an oversampled pool
            coeffs = interp[1]
            k0 = -(len(coeffs) // 2 - 1)
            acc = torch.zeros_like(a)
            for ki, krow in enumerate(coeffs):
                wk = torch.full_like(fx, float(np.float32(krow[-1])))
                for mm in range(len(krow) - 2, -1, -1):
                    wk = wk * fx + float(np.float32(krow[mm]))
                acc = acc + wk * pool[torch.clamp(src + (k0 + ki), 0, limit)]
            s = torch.where(row_fast, a_eff, acc)
        elif sinc_bank is None and interp == "catmull":
            pm1 = pool[torch.clamp(src - 1, 0, limit)]
            b = pool[src + 1]
            p2 = pool[torch.clamp(src + 2, 0, limit)]
            # uniform Catmull-Rom over (p[-1], p[0], p[1], p[2])
            c1 = 0.5 * (b - pm1)
            c2 = pm1 - 2.5 * a + 2.0 * b - 0.5 * p2
            c3 = 0.5 * (p2 - pm1) + 1.5 * (a - b)
            cr = a + fx * (c1 + fx * (c2 + fx * c3))
            s = torch.where(row_fast, a_eff, cr)
        elif sinc_bank is None:
            b = pool[src + 1]
            s = torch.where(row_fast, a_eff, a + fx * (b - a))
        else:
            acc = torch.zeros_like(a)
            for k in range(taps):
                col = sinc_bank[:, k]
                w0 = col[p0]
                w = w0 + pl * (col[p0 + 1] - w0)
                acc = acc + w * pool[torch.clamp(src + (k - half + 1), 0, limit)]
            s = torch.where(row_fast, a_eff, acc)
        outs.append(torch.where(valid, (s * row_gain) * env, 0.0))
    return torch.stack(outs, dim=1)  # [T, C, F]


def _ordered_sum(y: torch.Tensor) -> torch.Tensor:
    """``y[0] + y[1] + ...`` from zeros, in track order (``[T, ...]`` ->
    ``[...]``): one launch of ``csrc/ordered_sum.cu`` for an f32 CUDA tensor
    (bit-equal), else one add a track."""
    if y.device.type == "cuda" and y.dtype == torch.float32:
        return sum_cuda.ordered_sum_cuda(y)
    total = torch.zeros(y.shape[1:], dtype=y.dtype, device=y.device)
    for t in range(y.shape[0]):
        total = total + y[t]
    return total


def _frames(chunk_start: int, frames: int, device) -> torch.Tensor:
    return int(chunk_start) + torch.arange(frames, dtype=torch.int32, device=device)


def _clip(total: torch.Tensor) -> torch.Tensor:
    """The hard clip (engine.cpp:1627-1636) in the select form: NaN passes."""
    total = torch.where(total > 1.0, 1.0, total)
    return torch.where(total < -1.0, -1.0, total)


def gather_plain(pool: torch.Tensor, tables: dict, chunk_start: int, frames: int, form: str = "sum",
                 strict_order: bool = True, sinc_bank=None, interp="linear") -> torch.Tensor:
    """The plain version of the gather kernel, in torch ops on any device,
    :data:`PLAIN_FRAMES` frames at a time -> ``[T, C, frames]``
    (``form="per_track"``: contributions before track gain) or ``[C, frames]``
    (``"sum"``: contributions times track volume*pan summed over the tracks,
    then the hard clip; ``"sum_unclipped"``: without the clip)."""
    if form not in gather_cuda.FORMS:
        raise ValueError(f"unknown form {form!r}: want one of {tuple(gather_cuda.FORMS)}")
    parts = []
    for a in range(0, frames, PLAIN_FRAMES):
        n = min(PLAIN_FRAMES, frames - a)
        contribs = track_contrib_plain(pool, tables, _frames(chunk_start + a, n, pool.device), sinc_bank, interp)
        if form == "per_track":
            parts.append(contribs)
            continue
        scaled = contribs * tables["track_gain"][:, :, None]
        parts.append(_ordered_sum(scaled) if strict_order else torch.sum(scaled, dim=0))
    if not parts:
        T, _, C = tables["src_base"].shape
        return torch.zeros((T, C, 0) if form == "per_track" else (C, 0), dtype=torch.float32, device=pool.device)
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return _clip(out) if form == "sum" else out


def gather(pool: torch.Tensor, tables: dict, chunk_start: int, frames: int, form: str = "sum",
           strict_order: bool = True, sinc_bank=None, interp="linear") -> torch.Tensor:
    """The gather mix of ``frames`` frames from ``chunk_start`` in ``form``
    (see :func:`gather_plain`): the hand kernel on a CUDA pool (index-order
    sum whatever ``strict_order``), the plain torch ops on the CPU."""
    if pool.device.type == "cuda":
        return gather_cuda.gather_mix_cuda(pool, tables, chunk_start, frames, form, sinc_bank=sinc_bank,
                                           interp=interp)
    if pool.device.type != "cpu":
        raise ValueError(f"no gather mix for device {pool.device}")
    return gather_plain(pool, tables, chunk_start, frames, form, strict_order, sinc_bank, interp)


def render_chunk(pool: torch.Tensor, tables: dict, chunk_start: int, frames: int,
                 strict_order: bool = True, sinc_bank=None, interp="linear", clip: bool = True) -> torch.Tensor:
    """Render ``frames`` output frames from ``chunk_start`` -> [C, frames]:
    contributions, track volume*pan, the track sum (index order from +0.0,
    or one ``torch.sum`` with ``strict_order=False`` on the CPU), the hard
    clip (engine.cpp:1627-1636; ``clip=False`` leaves it to the caller)."""
    return gather(pool, tables, chunk_start, frames, "sum" if clip else "sum_unclipped", strict_order,
                  sinc_bank, interp)


def render_chunk_per_track(pool: torch.Tensor, tables: dict, chunk_start: int, frames: int,
                           sinc_bank=None, interp="linear") -> torch.Tensor:
    """Per-track pre-gain contributions [T, C, frames] (for the finishers)."""
    return gather(pool, tables, chunk_start, frames, "per_track", sinc_bank=sinc_bank, interp=interp)


def render_timeline(table, pool, session, channels: int = 2, chunk_frames: int = 1 << 16,
                    strict_order: bool = True, device=None) -> np.ndarray:
    """Render the whole carved timeline chunk by chunk on ``device``
    (default: the CUDA card; ``"cpu"`` by name) -> [C, total] f32."""
    device = resolve_device(device)
    dev = pack_device_tables(table, pool, session, channels=channels)
    jt = dev.as_torch(device)
    pool_dev = torch.from_numpy(pool.data).to(device)
    F = dev.total_frames
    out = np.empty((channels, F), dtype=np.float32)
    for start in range(0, F, chunk_frames):
        n = min(chunk_frames, F - start)
        chunk = render_chunk(pool_dev, jt, start, chunk_frames, strict_order=strict_order)
        out[:, start:start + n] = chunk[:, :n].cpu().numpy()
    return out
