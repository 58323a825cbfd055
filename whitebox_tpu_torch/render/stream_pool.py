"""Sessions whose sample pool exceeds the card: offline bounce with a
bounded, streamed pool.

Counterpart of ``whitebox_tpu/render/stream_pool.py``. The resident paths
upload the whole sample pool once (``timeline/pool.py``) — an hour-scale
multitrack recording project with many distinct takes can exceed device
memory. This module streams instead, at timeline scale (the reference
streams per clip from the heap, sampler.cpp:88):

- the timeline splits into fixed windows (multiples of the engine block
  and the effects PARAM_BLOCK);
- per window, only the source SPANS its rows actually read are packed
  into a bounded sub-pool (span bases are remapped via channel_base, so
  rows keep their global src offsets — no row rewriting beyond the
  window filter);
- effect/automation state threads across windows with the same chunk-state
  machinery the resident gather path uses, so streamed output matches the
  resident render.

The host half (``_row_src_bounds``, :func:`plan_stream_windows`,
``_window_pool``, ``_sub_table``) is the JAX package's. The device half
differs where PyTorch allows it: the JAX package pads every sub-pool to
the cap and every table to one slot count so that XLA compiles one
program, and relies on ``device_put``'s asynchrony for the prefetch. Here
two device buffers are allocated once, at the cap; each window's
``pool_bytes`` are written straight into one of two reusable page-locked
host buffers and copied on a side stream while the card renders the
previous window. CUDA events order the copies against the renders, and
the host refills a staging buffer only after its last copy has finished.
Rows never read past a span's pad and the tail guard, so the unwritten
rest of a device buffer is never read.

The streamed render rides the gather mix (``ops/mix.py``) and, for
sessions with effects, the finishers' streaming forms (the linear one
through the biquad cascade kernel on the card): a pool that exceeds the
card's memory is bound by the transfer, not by the mix.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops.automation import session_has_automation
from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk, render_chunk_per_track
from whitebox_tpu_torch.render.bounce import _add_synth, _prepare_synth_tables, session_has_midi
from whitebox_tpu_torch.render.effects_pipeline import session_has_effects
from whitebox_tpu_torch.render.finisher import choose_finisher, make_finisher, run
from whitebox_tpu_torch.session.bus import session_has_routing
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.timeline.carve import SegmentTable, carve_session
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation
from whitebox_tpu_torch.timeline.pool import SamplePool
from whitebox_tpu_torch.timeline.prerender import resolve_sinc_host

_SPAN_PAD = 48  # interp taps (sinc half=16, poly/catmull) + clamp guards
_ALIGN = 128


@dataclass
class _Window:
    start: int           # global frame
    frames: int
    row_idx: np.ndarray  # rows overlapping the window
    spans: list          # [(sid, ch, lo, hi, local_base)]
    pool_bytes: int


def _row_src_bounds(table: SegmentTable, idx: np.ndarray, w0: int, w1: int):
    """Source index range each row reads inside [w0, w1) (f64, inclusive)."""
    dst = table.dst_start[idx].astype(np.int64)
    ln = table.length[idx].astype(np.int64)
    sp = table.speed[idx]
    x0 = table.src_int[idx].astype(np.float64) + table.src_frac[idx]
    j0 = np.maximum(w0 - dst, 0)
    j1 = np.minimum(np.minimum(w1, dst + ln) - dst - 1, ln - 1)
    a = x0 + j0 * sp
    b = x0 + j1 * sp
    lo = np.floor(np.minimum(a, b)) - _SPAN_PAD
    hi = np.ceil(np.maximum(a, b)) + _SPAN_PAD
    return lo.astype(np.int64), hi.astype(np.int64)


def plan_stream_windows(table: SegmentTable, pool: SamplePool, window_frames: int,
                        channels: int, max_pool_bytes: int):
    """Partition the timeline; per window compute the touched source spans
    and the bounded sub-pool layout. Raises if one window alone exceeds
    the cap (lower window_frames)."""
    total = table.total_frames
    windows: list[_Window] = []
    n_win = max(-(-total // window_frames), 1)
    dst = table.dst_start.astype(np.int64)
    dend = dst + table.length.astype(np.int64)
    for w in range(n_win):
        w0 = w * window_frames
        w1 = min(w0 + window_frames, total)
        idx = np.nonzero((dst < w1) & (dend > w0))[0]
        spans: dict[tuple[int, int], list[int]] = {}
        if idx.size:
            lo, hi = _row_src_bounds(table, idx, w0, w1)
            sids = table.sample_id[idx]
            for i in range(idx.size):
                sid = int(sids[i])
                for ch in range(channels):
                    key = (sid, int(pool.channel_base[sid, ch]))
                    if key in spans:
                        spans[key][0] = min(spans[key][0], int(lo[i]))
                        spans[key][1] = max(spans[key][1], int(hi[i]))
                    else:
                        spans[key] = [int(lo[i]), int(hi[i])]
        # layout: [guard][span0][span1]...[guard]
        off = _ALIGN  # small lead guard for clamped reads
        entries = []
        for (sid, base), (lo_s, hi_s) in sorted(spans.items()):
            lo_s = max(lo_s, -_SPAN_PAD)
            n = max(hi_s - lo_s + 1, 0)
            n += (-n) % _ALIGN
            entries.append((sid, base, lo_s, n, off))
            off += n
        off += _ALIGN  # tail guard
        pool_bytes = off * 4
        if pool_bytes > max_pool_bytes:
            raise ValueError(
                f"window {w} needs {pool_bytes} pool bytes > cap {max_pool_bytes}; "
                f"lower window_frames (currently {window_frames})"
            )
        windows.append(_Window(start=w0, frames=w1 - w0, row_idx=idx,
                               spans=entries, pool_bytes=pool_bytes))
    return windows


def _window_pool(pool: SamplePool, win: _Window, pool_elems: int, channels: int, out=None):
    """Materialize the window's sub-pool [pool_elems] f32 + remapped
    channel_base (rows keep their global src offsets). With ``out`` (a
    host buffer of at least ``win.pool_bytes // 4`` elements) the sub-pool
    is written into its head instead, the spans and the zeros between and
    around them, nothing past ``win.pool_bytes``; returns that head."""
    used = win.pool_bytes // 4
    data = np.zeros(pool_elems, dtype=np.float32) if out is None else out[:used]
    cb = pool.channel_base.copy()
    base_of: dict[tuple[int, int], int] = {}
    done = 0  # elements of ``out`` written so far
    for (sid, base, lo_s, n, off) in win.spans:
        src_lo = base + lo_s
        src_hi = src_lo + n
        s0 = max(src_lo, 0)
        s1 = min(src_hi, pool.data.shape[0])
        if s1 > s0:
            a, b = off + (s0 - src_lo), off + (s1 - src_lo)
            if out is not None:
                data[done:a] = 0.0
                done = b
            data[a:b] = pool.data[s0:s1]
        base_of[(sid, base)] = off - lo_s  # so base' + src == local position
    if out is not None:
        data[done:used] = 0.0
    for (sid, base), newb in base_of.items():
        for ch in range(channels):
            if int(pool.channel_base[sid, ch]) == base:
                cb[sid, ch] = newb
    return data, cb


def _sub_table(table: SegmentTable, idx: np.ndarray) -> SegmentTable:
    fields = ("track", "dst_start", "length", "sample_id", "src_int", "src_frac",
              "speed", "gain", "fast", "clamp", "clip_id",
              "fin_start", "fin_inv", "fout_end", "fout_inv")
    return SegmentTable(
        **{f: getattr(table, f)[idx] for f in fields},
        num_tracks=table.num_tracks, total_frames=table.total_frames,
        buffer_size=table.buffer_size,
    )


def bounce_streamed(
    session: Session,
    sample_rate: float = 48000.0,
    *,
    max_pool_bytes: int = 1 << 30,
    window_frames: int = 1 << 17,
    buffer_size: int = 512,
    channels: int = 2,
    interpolation: str = "linear",
    device=None,
    stats: dict | None = None,
) -> np.ndarray:
    """Offline bounce with bounded device pool residency -> [C, F] f32,
    rendered on ``device`` (default: the CUDA card; ``"cpu"`` by name).

    Device footprint: two sub-pool buffers (the window being rendered and
    the next, each the largest window's ``pool_bytes``, at most
    ``max_pool_bytes``) + one window of per-track buffers + the output. Output matches ``bounce(engine="xla")`` (bit-exact for
    speed-1 material; resampled rows inside the documented contract; the
    window split re-bases closed-form phases by <= 1 f64 ulp).
    ``stats``, when a dict, receives the timings: ``host_build_s`` (the
    windows' sub-pools and tables on the host), ``copy_s`` and
    ``render_s`` (the card's time in the pool copies and in the windows'
    renders, by CUDA events; on the CPU ``copy_s`` is 0 and ``render_s``
    the host's), ``span_s`` (the card's first render to its last),
    ``windows`` and ``pool_bytes`` (the bytes copied)."""
    if window_frames % 512:
        raise ValueError(f"window_frames {window_frames} must be a multiple of 512 "
                         "(windows stay PARAM_BLOCK-aligned)")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    table, pool = carve_session(session, sample_rate, buffer_size=buffer_size,
                                out_channels=channels, slow_emit="blocks")
    if interpolation == "sinc":
        # exact-polyphase quality under the pool cap: the host prerender
        # rewrite is SMALLER than the 4x oversampled copies (ext ~= output
        # length) and the windows span-pack it like any other content
        table, pool, interp = resolve_sinc_host(table, pool)
    else:
        table, pool, interp = resolve_interpolation(table, pool, interpolation)
    windows = plan_stream_windows(table, pool, window_frames, channels, max_pool_bytes)
    elems = max(w.pool_bytes for w in windows) // 4

    T = max(table.num_tracks, 1)
    F = table.total_frames
    has_fx = (session_has_effects(session) or session_has_automation(session)
              or session_has_midi(session) or session_has_routing(session))
    synth = _prepare_synth_tables(session, sample_rate, buffer_size, max(F // buffer_size, 1), dev) if has_fx else {}

    # two page-locked staging buffers and two device sub-pools (the CPU
    # renders from the staging buffers), at the largest window's size
    staging = [torch.empty(elems, dtype=torch.float32, pin_memory=on_card) for _ in range(2)]
    pools = [torch.empty(elems, dtype=torch.float32, device=dev) for _ in range(2)] if on_card else staging
    side = torch.cuda.Stream(dev) if on_card else None
    copied = [None, None]    # event: the copy out of staging[k] into pools[k] is done
    rendered = [None, None]  # event: the render reading pools[k] is done
    copy_events = []
    host_build = 0.0

    def stage(i):
        """Build window ``i`` into staging buffer ``i % 2`` and start its
        copy -> (slot, elements, tables on the device)."""
        nonlocal host_build
        k, win = i % 2, windows[i]
        if copied[k] is not None:
            copied[k].synchronize()  # the staging buffer's last copy has finished
        t0 = time.perf_counter()
        data, cb = _window_pool(pool, win, elems, channels, out=staging[k].numpy())
        tables = pack_device_tables(_sub_table(table, win.row_idx),
                                    replace(pool, data=data, channel_base=cb), session,
                                    channels=channels, pad_tracks_to=T).as_torch(dev)
        host_build += time.perf_counter() - t0
        n = data.shape[0]
        if not on_card:
            return k, n, tables
        with torch.cuda.stream(side):
            if rendered[k] is not None:
                side.wait_event(rendered[k])  # the device buffer's last reader has finished
            t_copy = torch.cuda.Event(enable_timing=True)
            t_copy.record(side)
            pools[k][:n].copy_(staging[k][:n], non_blocking=True)
            copied[k] = torch.cuda.Event(enable_timing=True)
            copied[k].record(side)
        copy_events.append((t_copy, copied[k]))
        return k, n, tables

    out = torch.empty((channels, F), dtype=torch.float32, device=dev)
    render_events = []
    render_host = 0.0
    staged = stage(0)
    fin = states = None
    if has_fx:
        # the finisher's states carry from window to window; its chunk
        # (the family's, up to a window) must divide the window
        fin = make_finisher(choose_finisher(session), session, sample_rate, staged[2]["track_gain"],
                            max_chunk=window_frames, device=dev)
        states = fin.init()
        if window_frames % fin.chunk:
            raise ValueError(f"window_frames {window_frames} must be a multiple of the finisher's "
                             f"chunk ({fin.chunk})")
    for i, win in enumerate(windows):
        k, n, jt = staged
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.current_stream(dev).wait_event(copied[k])
            render_events.append(torch.cuda.Event(enable_timing=True))
            render_events[-1].record()
        pdev = pools[k][:n]
        w0 = win.start
        if fin is None:
            chunk = render_chunk(pdev, jt, w0, window_frames, strict_order=True, interp=interp)
        else:
            pt = _add_synth(render_chunk_per_track(pdev, jt, w0, window_frames, interp=interp), synth, w0,
                            window_frames)
            res = run(fin, pt, window_frames, start=w0, states=states)
            chunk, states = res.out, res.states
        out[:, w0:w0 + win.frames] = chunk[:, :win.frames]
        if on_card:
            rendered[k] = torch.cuda.Event(enable_timing=True)
            rendered[k].record()
            render_events.append(rendered[k])
        render_host += time.perf_counter() - t0
        if i + 1 < len(windows):
            staged = stage(i + 1)  # the host builds the next window while the card renders
    result = out.cpu().numpy()  # waits for the last window
    if stats is not None:
        def ms(pairs):
            return sum(a.elapsed_time(b) for a, b in pairs) / 1e3

        stats.update(windows=len(windows), pool_bytes=sum(w.pool_bytes for w in windows),
                     host_build_s=host_build,
                     copy_s=ms(copy_events) if on_card else 0.0,
                     render_s=ms(zip(render_events[::2], render_events[1::2])) if on_card else render_host,
                     span_s=ms([(render_events[0], render_events[-1])]) if on_card else render_host)
    return result
