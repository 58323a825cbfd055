"""Event carving: compile the clip timeline into per-track segment tables.

This is the timeline-at-once inversion of ``Track::process_event``
(track.cpp:258-451) + the event-segmented render loop (track.cpp:664-724):
instead of a stateful per-block cursor feeding a streaming sampler, the whole
render is precompiled on the host into flat **segment rows** — each row says
"destination frames [dst, dst+len) of track T read sample S starting at
source phase (src_int + src_frac) advancing by `speed` per frame, scaled by
`gain`". The TPU mix kernel consumes these rows data-parallel.

Exactness contract (BASELINE.md: 1-ulp parity vs the block engine):

- All event *positions* use the exact f64 block-transport grids
  (timeline.transport) and the same formulas as the C++ engine, including
  its (uint64)%buffer_size truncation quirks — positions are bit-identical
  to the oracle by construction.
- speed == 1.0 rows are merged into maximal runs: integer phase, bit-exact.
- speed != 1.0 rows are split **per block**, each carrying the exact f64
  sampler offset the C++ engine would hold at that block (reproduced with
  sequentially-rounded accumulation, sampler.cpp:103,209). Within a block
  the device evaluates x = src_frac + j*speed in double-single arithmetic
  (~2^-48), which can differ from the engine's f64-after-rebase by at most
  1 f32 ulp of the interpolation fraction.

Offline renders start at the playhead with fresh playback state
(Engine::play semantics); the refresh_voice / internal_state_changed
mid-playback edit paths (track.cpp:289-345,396-417) are live-preview
concerns and do not arise in a fresh render.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.core.math import beat_to_samples
from whitebox_tpu_torch.session.session import Session
from whitebox_tpu_torch.session.track import Track
from whitebox_tpu_torch.timeline.pool import SamplePool, build_sample_pool
from whitebox_tpu_torch.timeline.transport import BlockTransport


@dataclass
class SegmentTable:
    """Flat struct-of-arrays segment rows, sorted by (track, dst_start)."""

    track: np.ndarray  # int32
    dst_start: np.ndarray  # int32 global frame
    length: np.ndarray  # int32
    sample_id: np.ndarray  # int32 pool index
    src_int: np.ndarray  # int32 integer source phase at dst_start
    src_frac: np.ndarray  # float64 fractional source phase at dst_start
    speed: np.ndarray  # float64 source advance per destination frame
    gain: np.ndarray  # float32 clip gain
    fast: np.ndarray  # bool — speed==1.0 fast path (clamped normalize)
    clamp: np.ndarray  # bool — format clamps on the fast path (fmt != F32)
    clip_id: np.ndarray  # int32 (debugging / introspection)
    # clip fade envelope (a framework extension — the reference stores
    # fade_start/fade_end but never applies them, SURVEY §2.9):
    # env(g) = clamp((g - fin_start)*fin_inv, 0, 1) * clamp((fout_end - g)*fout_inv, 0, 1)
    fin_start: np.ndarray  # int32 global frame where the fade-in ramp starts
    fin_inv: np.ndarray  # f32 1/fade_in_frames (no fade: start=-2^30, inv=1)
    fout_end: np.ndarray  # int32 global frame where the fade-out ramp ends
    fout_inv: np.ndarray  # f32 1/fade_out_frames (no fade: end=2^30, inv=1)
    num_tracks: int
    total_frames: int
    buffer_size: int

    def __len__(self) -> int:
        return self.track.shape[0]

    def for_track(self, t: int) -> np.ndarray:
        return np.nonzero(self.track == t)[0]


def _u64_trunc(x: float) -> int:
    """(uint64_t)(double) with sane clamping of the negative-UB case."""
    return int(x) if x > 0.0 else 0


def _carve_track_audio(
    track: Track,
    transport: BlockTransport,
    P: np.ndarray,
    S: np.ndarray,
    num_blocks: int,
    pool: SamplePool,
    rows: list,
    slow_cols: list,
    track_idx: int,
    slow_emit: str = "blocks",
) -> None:
    bs = transport.buffer_size
    rate = transport.sample_rate
    bd = transport.beat_duration
    end_frame = num_blocks * bs
    clips = track.clips

    for a, b in zip(clips, clips[1:]):
        if b.min_time < a.max_time:
            # The engine's edit API (reserve_track_region) forbids overlaps;
            # its playback of overlapping clips is undefined (SURVEY §3.2).
            raise ValueError(
                f"track {track.name!r}: overlapping clips [{a.min_time},{a.max_time}) and "
                f"[{b.min_time},{b.max_time}) — use Session.delete_region/add APIs"
            )

    ci = track.find_next_clip(float(P[0]))
    if ci is None:
        return
    first = True

    while ci < len(clips):
        clip = clips[ci]
        if not clip.is_audio() or clip.audio is None or clip.audio.asset is None:
            ci += 1
            first = False
            continue

        sample = clip.audio.asset.sample
        sid = pool.index_of[id(clip.audio.asset)]
        count = float(sample.count)
        clip_speed = clip.audio.speed
        playback_speed = (float(sample.sample_rate) / rate) * clip_speed  # sampler.h:24

        # ---- Play event position + initial sampler offset ----
        # block ownership of event times: the unmapped searchsorted side
        # "left" mirrors the reference's closed-interval walk; mapped grids
        # hit beats exactly, so ownership is half-open [P[k], P[k+1]) —
        # side "right" — matching the oracle's mapped walk (see
        # oracle._process_event for the full rationale)
        side = "right" if transport.mapped else "left"
        first_mid_start = first and float(P[0]) > clip.min_time
        if first_mid_start:
            # partial start (track.cpp:372-388); delta_samples ==
            # beat_to_samples(P[0]-min_time, rate, bd) bit-for-bit when
            # unmapped, the exact tempo-map integral when mapped
            sample_pos = transport.delta_samples(clip.min_time, float(P[0]))
            o0 = float(int(clip.start_offset + sample_pos * clip_speed))
            play_global = 0
        else:
            ka = int(np.searchsorted(P[1:], clip.min_time, side=side))
            if ka >= num_blocks:
                break  # starts after the render window; later clips too
            so = float(S[ka]) + transport.delta_samples(float(P[ka]), clip.min_time)
            play_global = ka * bs + (_u64_trunc(so) % bs)
            o0 = float(int(clip.start_offset))  # (size_t) cast, track.cpp:366
        first = False

        # ---- Stop event position ----
        ke = int(np.searchsorted(P[1:], clip.max_time, side=side))
        if ke >= num_blocks:
            stop_global = end_frame
        else:
            so = float(S[ke]) + transport.delta_samples(float(P[ke]), clip.max_time)
            stop_global = ke * bs + (_u64_trunc(so) % bs)

        gs, ge = play_global, min(stop_global, end_frame)
        if ge > gs and o0 < count and playback_speed > 0.0:
            gain = np.float32(clip.audio.gain)
            clampf = sample.format != AudioFormat.F32

            # fade envelope anchors (framework extension; frame-domain linear
            # ramps over the clip's [min_time, max_time) span)
            NOFADE = 1 << 30
            if clip.audio.fade_start > 0.0 or clip.audio.fade_end > 0.0:
                elapsed = 0
                if first_mid_start:
                    elapsed = int(round(transport.delta_samples(clip.min_time, float(P[0]))))
                clip_begin = play_global - elapsed
                clip_frames = int(round(transport.delta_samples(clip.min_time, clip.max_time)))
                clip_end = clip_begin + clip_frames
                if transport.mapped:
                    # fades are beat SPANS anchored at the clip edges — under
                    # a map their frame lengths follow the local tempo there
                    fin_frames = int(round(transport.delta_samples(
                        clip.min_time, clip.min_time + clip.audio.fade_start)))
                    fout_frames = int(round(transport.delta_samples(
                        clip.max_time - clip.audio.fade_end, clip.max_time)))
                else:
                    fin_frames = int(round(beat_to_samples(clip.audio.fade_start, rate, bd)))
                    fout_frames = int(round(beat_to_samples(clip.audio.fade_end, rate, bd)))
                fin_start = clip_begin if fin_frames > 0 else -NOFADE
                fin_inv = np.float32(1.0 / fin_frames) if fin_frames > 0 else np.float32(1.0)
                fout_end = clip_end if fout_frames > 0 else NOFADE
                fout_inv = np.float32(1.0 / fout_frames) if fout_frames > 0 else np.float32(1.0)
            else:
                fin_start, fin_inv = -NOFADE, np.float32(1.0)
                fout_end, fout_inv = NOFADE, np.float32(1.0)
            fade = (fin_start, fin_inv, fout_end, fout_inv)
            # Loop-mode extensions (the reference enums clip.h:21 modes but
            # never honors them in playback; whitebox_tpu implements all
            # five): LOOP_STRAIGHT tiles full forward source passes over the
            # clip span; *_REVERSE plays x = (count-1-v) - j*speed backward
            # (v = the same virtual forward offset the sampler would hold);
            # LOOP_BIDIRECTIONAL alternates full forward/reverse passes, each
            # pass after the first starting one `speed` step past the
            # turn-around so the endpoint frame isn't doubled at the seam.
            # The oracle mirrors every rule (oracle._stream_clip).
            from whitebox_tpu_torch.session.clip import ClipMode

            mode = clip.audio.mode

            def emit_slow_span(span_gs: int, span_ge: int, span_o0: float) -> int:
                """Emit per-block rows for one source pass starting at
                (span_gs, span_o0); returns the global frame where the source
                exhausts (wrap point), or span_ge if it never does. The wrap
                point comes from the same blockwise sequentially-rounded
                offsets the engine would hold, not a single-step ceil."""
                if slow_emit == "runs":
                    # one run row when the pass provably never exhausts
                    # (1e-6 source-sample margin guards rounding flips);
                    # otherwise fall through to the exact blockwise path
                    total = span_ge - span_gs
                    if span_o0 + (total - 1) * playback_speed < count - 1e-6:
                        oi = np.floor(span_o0)
                        slow_cols.append((
                            1,
                            np.asarray([span_gs], np.int32),
                            np.asarray([total], np.int32),
                            np.asarray([oi], np.int32),
                            np.asarray([span_o0 - oi], np.float64),
                            (track_idx, sid, playback_speed, gain, clip.id, *fade),
                        ))
                        return span_ge
                # per-block rows with exact accumulated f64 offsets
                # stream-call boundaries: span start, block edges, span end
                first_edge = min(span_ge, (span_gs // bs + 1) * bs)
                n_mid = max((span_ge - first_edge + bs - 1) // bs, 0)
                edges = np.empty(n_mid + 2, dtype=np.int64)
                edges[0] = span_gs
                edges[1] = first_edge
                if n_mid:
                    edges[2:] = np.minimum(first_edge + bs * np.arange(1, n_mid + 1), span_ge)
                lengths = np.diff(edges)
                # o_{i+1} = o_i + L_i * speed, sequentially rounded (sampler.cpp:103)
                incs = np.empty(lengths.shape[0], dtype=np.float64)
                incs[0] = span_o0
                if lengths.shape[0] > 1:
                    incs[1:] = lengths[:-1].astype(np.float64) * playback_speed
                offs = np.add.accumulate(incs)
                live = offs < count  # sampler frozen past the end (sampler.cpp:99)
                num_actual = np.minimum(
                    lengths, np.ceil((count - offs) / playback_speed).astype(np.int64)
                )
                exhausted = (~live) | (num_actual < lengths)
                any_exh = bool(exhausted.any())
                idx = int(np.argmax(exhausted)) if any_exh else lengths.shape[0]
                scalars = (track_idx, sid, playback_speed, gain, clip.id, *fade)
                if slow_emit == "runs":
                    # prefix blocks [0, idx) are fully live: one closed-form
                    # run row (what mix_pallas._merge_slow_runs reconstructs
                    # from the per-block rows anyway); the exhaust block
                    # keeps its exact sequentially-rounded offset + length
                    if idx > 0:
                        oi = np.floor(span_o0)
                        slow_cols.append((
                            1, np.asarray([edges[0]], np.int32),
                            np.asarray([edges[idx] - edges[0]], np.int32),
                            np.asarray([oi], np.int32),
                            np.asarray([span_o0 - oi], np.float64),
                            scalars,
                        ))
                    if any_exh and live[idx] and num_actual[idx] > 0:
                        o_k = offs[idx]
                        oi = np.floor(o_k)
                        slow_cols.append((
                            1, np.asarray([edges[idx]], np.int32),
                            np.asarray([num_actual[idx]], np.int32),
                            np.asarray([oi], np.int32),
                            np.asarray([o_k - oi], np.float64),
                            scalars,
                        ))
                else:
                    keep = live & (num_actual > 0)
                    if keep.any():
                        o_k = offs[keep]
                        oi = np.floor(o_k)
                        n = int(keep.sum())
                        # per-row arrays + per-span scalars; scalars expand
                        # once at assembly via np.repeat (a per-span np.full
                        # here was ~30% of carve at 128-trk resampled scale)
                        slow_cols.append((
                            n,
                            edges[:-1][keep].astype(np.int32),
                            num_actual[keep].astype(np.int32),
                            oi.astype(np.int32),
                            (o_k - oi).astype(np.float64),
                            scalars,
                        ))
                if not any_exh:
                    return span_ge
                if live[idx]:
                    return int(edges[:-1][idx] + num_actual[idx])
                return int(edges[:-1][idx])

            def emit_reverse_span(span_gs: int, span_ge: int, v0: float) -> int:
                """Reverse pass: per-block rows at x = (count-1-v) - j*speed,
                with v accumulated per block exactly like the forward
                sampler; returns the global frame where the source exhausts
                (x would go below 0), or span_ge if it never does."""
                if slow_emit == "runs":
                    total = span_ge - span_gs
                    x0 = (count - 1.0) - v0
                    if x0 - (total - 1) * playback_speed > 1e-6:
                        xi = np.floor(x0)
                        slow_cols.append((
                            1,
                            np.asarray([span_gs], np.int32),
                            np.asarray([total], np.int32),
                            np.asarray([xi], np.int32),
                            np.asarray([x0 - xi], np.float64),
                            (track_idx, sid, -playback_speed, gain, clip.id, *fade),
                        ))
                        return span_ge

                first_edge = min(span_ge, (span_gs // bs + 1) * bs)
                n_mid = max((span_ge - first_edge + bs - 1) // bs, 0)
                edges = np.empty(n_mid + 2, dtype=np.int64)
                edges[0] = span_gs
                edges[1] = first_edge
                if n_mid:
                    edges[2:] = np.minimum(first_edge + bs * np.arange(1, n_mid + 1), span_ge)
                lengths = np.diff(edges)
                incs = np.empty(lengths.shape[0], dtype=np.float64)
                incs[0] = v0
                if lengths.shape[0] > 1:
                    incs[1:] = lengths[:-1].astype(np.float64) * playback_speed
                vs = np.add.accumulate(incs)
                x0s = (count - 1.0) - vs
                live = x0s >= 0.0
                with np.errstate(invalid="ignore"):
                    num_actual = np.minimum(
                        lengths,
                        np.where(live, np.floor(x0s / playback_speed), -1.0).astype(np.int64) + 1,
                    )
                keep = live & (num_actual > 0)
                if keep.any():
                    x_k = x0s[keep]
                    xi = np.floor(x_k)
                    n = int(keep.sum())
                    slow_cols.append((
                        n,
                        edges[:-1][keep].astype(np.int32),
                        num_actual[keep].astype(np.int32),
                        xi.astype(np.int32),
                        (x_k - xi).astype(np.float64),
                        (track_idx, sid, -playback_speed, gain, clip.id, *fade),
                    ))
                exhausted = (~live) | (num_actual < lengths)
                if not exhausted.any():
                    return span_ge
                idx = int(np.argmax(exhausted))
                if live[idx]:
                    return int(edges[:-1][idx] + num_actual[idx])
                return int(edges[:-1][idx])

            if mode in (ClipMode.ONE_SHOT, ClipMode.LOOP_STRAIGHT):
                looping = mode == ClipMode.LOOP_STRAIGHT
                if playback_speed == 1.0:
                    pos, o = gs, int(o0)
                    while pos < ge:
                        # merged run: integer phase, exact
                        length = min(ge - pos, int(count) - o)
                        if length <= 0:
                            break
                        rows.append(
                            (track_idx, pos, length, sid, o, 0.0, 1.0, gain, True, clampf, clip.id, *fade)
                        )
                        if not looping:
                            break
                        pos += length
                        o = 0
                else:
                    pos, o = gs, float(o0)
                    while pos < ge:
                        nxt = emit_slow_span(pos, ge, o)
                        if not looping or nxt >= ge or nxt <= pos:
                            break
                        pos = nxt
                        o = 0.0
            elif mode in (ClipMode.ONE_SHOT_REVERSE, ClipMode.LOOP_REVERSE):
                looping = mode == ClipMode.LOOP_REVERSE
                if playback_speed == 1.0:
                    pos, v = gs, int(o0)
                    while pos < ge:
                        x0 = int(count) - 1 - v
                        if x0 < 0:
                            if not looping:
                                break
                            v, x0 = 0, int(count) - 1
                        # merged reverse run: integer phase, exact
                        length = min(ge - pos, x0 + 1)
                        if length <= 0:
                            break
                        rows.append(
                            (track_idx, pos, length, sid, x0, 0.0, -1.0, gain, False, False, clip.id, *fade)
                        )
                        if not looping:
                            break
                        pos += length
                        v = 0
                else:
                    pos, v = gs, float(o0)
                    while pos < ge:
                        nxt = emit_reverse_span(pos, ge, v)
                        if not looping or nxt >= ge or nxt <= pos:
                            break
                        pos = nxt
                        v = 0.0
            elif mode == ClipMode.LOOP_BIDIRECTIONAL:
                rev = False
                pos, o = gs, float(o0)
                stalls = 0
                while pos < ge and stalls <= 2:
                    if playback_speed == 1.0:
                        if not rev:
                            length = min(ge - pos, int(count) - int(o))
                            if length <= 0:
                                rev, o = True, playback_speed
                                stalls += 1
                                continue
                            rows.append(
                                (track_idx, pos, length, sid, int(o), 0.0, 1.0, gain, True, clampf, clip.id, *fade)
                            )
                            pos += length
                            rev, o, stalls = True, playback_speed, 0
                        else:
                            x0 = int(count) - 1 - int(o)
                            if x0 < 0:
                                rev, o = False, playback_speed
                                stalls += 1
                                continue
                            length = min(ge - pos, x0 + 1)
                            if length <= 0:
                                break
                            rows.append(
                                (track_idx, pos, length, sid, x0, 0.0, -1.0, gain, False, False, clip.id, *fade)
                            )
                            pos += length
                            rev, o, stalls = False, playback_speed, 0
                    else:
                        nxt = emit_slow_span(pos, ge, o) if not rev else emit_reverse_span(pos, ge, o)
                        if nxt >= ge:
                            break
                        if nxt <= pos:
                            # zero-progress pass (degenerate clip: speed >
                            # count-1 exhausts the source within one frame);
                            # flip direction like the oracle / speed==1
                            # branch, up to the same 2-stall limit
                            rev, o = not rev, playback_speed
                            stalls += 1
                            continue
                        pos = nxt
                        rev, o, stalls = not rev, playback_speed, 0
            else:  # pragma: no cover
                raise ValueError(f"unknown clip mode {mode!r}")

        ci += 1


def carve_session(
    session: Session,
    sample_rate: float,
    buffer_size: int = 512,
    num_blocks: int | None = None,
    playhead_start: float | None = None,
    pool: SamplePool | None = None,
    out_channels: int = 2,
    slow_emit: str = "blocks",
    native: bool | None = None,
) -> tuple[SegmentTable, SamplePool]:
    """Compile a session into (SegmentTable, SamplePool) for rendering.

    ``slow_emit``: how resampled (slow) source passes become rows.
    "blocks" (default) emits one row per engine block with the exact
    sequentially-rounded f64 offsets — the bit-mirror of the C++ sampler's
    per-block accumulation (sampler.cpp:103) that the oracle-parity
    contract rests on. "runs" emits ONE row per source pass with the
    closed-form phase x0 + (g - dst0)*speed whenever the pass provably
    never exhausts its sample — mathematically identical to what the
    Pallas plan's run merge evaluates anyway (mix_pallas._merge_slow_runs
    re-bases phase closed-form), but ~two orders of magnitude fewer rows
    to assemble/pack at 128-track resampled scale. Passes that reach the
    sample end (including every loop-mode wrap) keep the exact blockwise
    path, so wrap points are bit-identical in both modes.

    ``native``: use the C++ carve walk (``csrc/host/wb_carve.cpp``, bit-equal
    to the Python walk; ``tests/test_torch_host.py`` holds the two against
    the JAX package's carve) when ``io.native`` built the host library (it
    needs ``g++``); the Python walk otherwise, or with ``native=False``.
    ``native=None`` (the default) takes the C++ walk unless the environment
    sets ``WBTPU_NO_NATIVE_CARVE`` or ``WBTPU_NO_NATIVE``.
    """
    start = session.playhead_start if playhead_start is None else playhead_start
    transport = BlockTransport(float(sample_rate), int(buffer_size), session.beat_duration, start,
                               tempo_map=getattr(session, "tempo_map", None))
    if num_blocks is None:
        num_blocks = max(transport.blocks_for_beats(session.end_time()), 1)

    P = transport.playhead_grid(num_blocks)
    S = transport.sample_position_grid(num_blocks)
    # one edit-stamp computation serves both content caches (pool + the
    # native flatten) — the stamp walk itself is ~1/3 of a warm carve
    stamp = session.edit_stamp()
    if pool is None:
        pool = build_sample_pool(session, out_channels=out_channels, _stamp=stamp)

    if native is None:
        native = not (os.environ.get("WBTPU_NO_NATIVE_CARVE") or os.environ.get("WBTPU_NO_NATIVE"))
    native_out = None
    if native:
        # tempo-mapped sessions ride the C++ walk too: every beat->sample
        # conversion is precomputed host-side by carve_native (the v3 ABI),
        # so the walk itself is map-agnostic sample arithmetic
        from whitebox_tpu_torch.timeline import carve_native

        native_out = carve_native.carve_audio_tracks(
            session, P, S, num_blocks, buffer_size, transport.sample_rate,
            transport.beat_duration, pool, slow_emit, transport=transport,
            _stamp=stamp)

    fast_arrays = None
    slow_arrays = None
    slow_cols: list = []
    if native_out is not None:
        fast_arrays, fast_flags, clamp_flags, slow_arrays = native_out
    else:
        rows: list = []
        for t, track in enumerate(session.tracks):
            _carve_track_audio(track, transport, P, S, num_blocks, pool, rows, slow_cols, t,
                               slow_emit=slow_emit)

        # combine scalar fast rows + vectorized slow-row blocks, sort by (track, dst)
        if rows:
            rows.sort(key=lambda r: (r[0], r[1]))
            c = list(zip(*rows))
            fast_arrays = (
                np.asarray(c[0], np.int32), np.asarray(c[1], np.int32), np.asarray(c[2], np.int32),
                np.asarray(c[3], np.int32), np.asarray(c[4], np.int32), np.asarray(c[5], np.float64),
                np.asarray(c[6], np.float64), np.asarray(c[7], np.float32),
                np.asarray(c[10], np.int32),
                np.asarray(c[11], np.int32), np.asarray(c[12], np.float32),
                np.asarray(c[13], np.int32), np.asarray(c[14], np.float32),
            )
            fast_flags = np.asarray(c[8], bool)
            clamp_flags = np.asarray(c[9], bool)

    if slow_cols or slow_arrays is not None or fast_arrays is not None:
        # expand slow spans: per-row arrays concatenate; per-span scalars
        # expand in one np.repeat per column (not one np.full per span)
        if slow_cols:
            counts = np.asarray([sc[0] for sc in slow_cols], np.int64)
            scal = np.asarray([sc[5] for sc in slow_cols], np.float64)  # [S, 9]
            rep = lambda col, dt: np.repeat(scal[:, col], counts).astype(dt)
            slow_arrays = (
                rep(0, np.int32),  # track
                np.concatenate([sc[1] for sc in slow_cols]),  # dst_start
                np.concatenate([sc[2] for sc in slow_cols]),  # length
                rep(1, np.int32),  # sample_id
                np.concatenate([sc[3] for sc in slow_cols]),  # src_int
                np.concatenate([sc[4] for sc in slow_cols]),  # src_frac
                rep(2, np.float64),  # speed
                rep(3, np.float32),  # gain
                rep(4, np.int32),  # clip_id
                rep(5, np.int32),  # fin_start
                rep(6, np.float32),  # fin_inv
                rep(7, np.int32),  # fout_end
                rep(8, np.float32),  # fout_inv
            )
        parts = []
        if fast_arrays is not None:
            parts.append(fast_arrays + (fast_flags, clamp_flags))
        if slow_arrays is not None:
            n = slow_arrays[0].shape[0]
            # clamp flag for slow rows is irrelevant (linear path never
            # clamps) but kept consistent
            parts.append(slow_arrays + (np.zeros(n, bool), np.ones(n, bool)))

        def cat(i):
            return np.concatenate([p[i] for p in parts]) if len(parts) > 1 else parts[0][i]

        trk_a, dst_a = cat(0), cat(1)
        order = np.lexsort((dst_a, trk_a))
        cols15 = [cat(i)[order] for i in range(15)]
        (trk_a, dst_a, len_a, sid_a, si_a, sf_a, sp_a, gn_a, cid_a,
         fis_a, fii_a, foe_a, foi_a, fast_a, clamp_a) = cols15
    else:
        z = np.zeros(0)
        trk_a = dst_a = len_a = sid_a = si_a = cid_a = fis_a = foe_a = z.astype(np.int32)
        sf_a = sp_a = z.astype(np.float64)
        gn_a = fii_a = foi_a = z.astype(np.float32)
        fast_a = clamp_a = z.astype(bool)

    total_frames = num_blocks * buffer_size
    if total_frames >= 2**31:
        raise ValueError("render window exceeds int32 frame addressing")

    table = SegmentTable(
        track=trk_a, dst_start=dst_a, length=len_a, sample_id=sid_a,
        src_int=si_a, src_frac=sf_a, speed=sp_a, gain=gn_a,
        fast=fast_a, clamp=clamp_a, clip_id=cid_a,
        fin_start=fis_a, fin_inv=fii_a, fout_end=foe_a, fout_inv=foi_a,
        num_tracks=len(session.tracks),
        total_frames=total_frames,
        buffer_size=buffer_size,
    )
    return table, pool


def render_segments_per_track_numpy(table: SegmentTable, pool: SamplePool, out_channels: int = 2,
                                    interp: str = "linear") -> np.ndarray:
    """Per-track pre-gain buffers [T, C, F] f32 (exact f64 phase; host).

    ``interp="catmull"`` mirrors the device's 4-point Catmull-Rom mode for
    resampled rows — the interpolation the reference starts but never
    finishes (sampler.cpp:61-86); ``("poly", coeffs)`` the LS-optimal
    polynomial taps of ``ops/resample.design_poly_interp``."""
    F = table.total_frames
    out = np.zeros((table.num_tracks, out_channels, F), dtype=np.float32)
    for r in range(len(table)):
        t = int(table.track[r])
        dst = int(table.dst_start[r])
        L = int(table.length[r])
        sid = int(table.sample_id[r])
        gain = table.gain[r]
        g = np.arange(dst, dst + L, dtype=np.int64)
        env = np.clip((g - table.fin_start[r]).astype(np.float32) * table.fin_inv[r], 0.0, 1.0)
        env *= np.clip((table.fout_end[r] - g).astype(np.float32) * table.fout_inv[r], 0.0, 1.0)
        env = env.astype(np.float32)
        for ch in range(out_channels):
            base = int(pool.channel_base[sid, ch])
            if table.fast[r]:
                seg = pool.data[base + table.src_int[r] : base + table.src_int[r] + L]
                v = np.clip(seg, np.float32(-1.0), np.float32(1.0)) if table.clamp[r] else seg
                out[t, ch, dst : dst + L] += (v * gain) * env
            else:
                j = np.arange(L, dtype=np.float64)
                x = (table.src_int[r] + table.src_frac[r]) + j * table.speed[r]
                ix = np.trunc(x).astype(np.int64)
                fx = (x - ix.astype(np.float64)).astype(np.float32)
                limit = pool.data.shape[0] - 2
                src = np.clip(base + ix, 0, limit)
                a = pool.data[src]
                b = pool.data[src + 1]
                if interp == "catmull":
                    pm1 = pool.data[np.clip(src - 1, 0, limit)]
                    p2 = pool.data[np.clip(src + 2, 0, limit)]
                    c1 = np.float32(0.5) * (b - pm1)
                    c2 = pm1 - np.float32(2.5) * a + np.float32(2.0) * b - np.float32(0.5) * p2
                    c3 = np.float32(0.5) * (p2 - pm1) + np.float32(1.5) * (a - b)
                    s = a + fx * (c1 + fx * (c2 + fx * c3))
                elif isinstance(interp, tuple) and interp and interp[0] == "poly":
                    # LS-optimal polynomial taps (ops/resample.design_poly_interp)
                    coeffs = interp[1]
                    s = np.zeros_like(a)
                    # tap k of the table sits at offset k - (taps//2 - 1)
                    # (ops/resample.poly_interp_offsets)
                    for k, krow in enumerate(coeffs):
                        wk = np.full_like(fx, np.float32(krow[-1]))
                        for m in range(len(krow) - 2, -1, -1):
                            wk = wk * fx + np.float32(krow[m])
                        off = k - (len(coeffs) // 2 - 1)
                        s = s + wk * pool.data[np.clip(src + off, 0, limit)]
                else:
                    s = a + fx * (b - a)
                out[t, ch, dst : dst + L] += (s * gain) * env
    return out


def render_segments_numpy(table: SegmentTable, pool: SamplePool, session: Session, out_channels: int = 2,
                          interp: str = "linear") -> np.ndarray:
    """Host-side exact segment renderer (validation reference for the carve).

    Applies the same f32 math as Sampler::stream over the segment rows, then
    track volume/pan and the ordered track sum + hard clip. Exact f64 phase
    (no double-single approximation) — used to prove the carve itself is
    bit-identical to the oracle.
    """
    per_track = render_segments_per_track_numpy(table, pool, out_channels, interp=interp)
    F = table.total_frames
    out = np.zeros((out_channels, F), dtype=np.float32)
    for t, track in enumerate(session.tracks):
        vol = np.float32(0.0) if track.mute else track.volume_linear
        pan = track.pan_coeffs
        for ch in range(out_channels):
            out[ch] += per_track[t, ch] * (vol * np.float32(pan[ch % 2]))

    np.copyto(out, np.where(out > 1.0, np.float32(1.0), out))
    np.copyto(out, np.where(out < -1.0, np.float32(-1.0), out))
    return out
