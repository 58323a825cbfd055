#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Runs from the root of a checkout. It drives the port's main paths through
``bounce(device="cuda")``: the offline bounce of a 128-track, 60 s, 48 kHz
session through the hand-written CUDA mix kernel, automated sessions
through its automation variant (K3), and the same 128-track session with
an EQ on every track and a highpass on the master through its per-track
mode (K4) and the linear finishers (the scan finisher through the second
hand kernel, the biquad cascade), and 128-track sessions of resampled
clips in the export-quality interpolation modes: Catmull-Rom and six
polynomial taps in the kernel (K2-catmull, K2-poly) and the sinc
prerender, which extends the sample pool on the card and mixes speed-1
rows over it with the same kernel, the bench suite's 8-track session and
config 3's session in linear interpolation, forward and bidirectional, a
routed session on group buses with a sidechain duck, and an arrangement
with MIDI tracks through the synth;
then the export deliverables: stems and bus stems (K4 and the cascade
kernel), EBU R128 loudness and normalize, the phase-vocoder stretch and
the waveform peak pyramid (of 10 minutes, and of an hour's codes); then
the render cache over K1 and K3, the block-pull preview and the streamed
bounce of a pool past its cap (the gather mix and the cascade kernel);
then the feature checks of ``whitebox_tpu_torch/tools/verify.py`` and the
port's examples; then the sharded render (``whitebox_tpu_torch.parallel``)
on a world of one rank over NCCL and on four ranks that share the card
over gloo. It checks the results by the repo's
own references. It imports nothing of JAX or of the JAX package and reads
no ``.wb`` project. Phases, one or more lines each:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, whether ninja and triton are present, and which
   carve walk runs (the native host library or NumPy);
2. build: the CUDA kernels from ``whitebox_tpu_torch/csrc`` with nvcc and
   the native host library from ``csrc/host`` with g++, side by side;
3. kernel vs plain version on small sessions: the mix kernel bit-equal to
   the plain PyTorch mix on the card; against the NumPy segment reference
   bit-equal at speed 1 and within the resampling contract (<= 2 ulp or
   <= 2.4e-7) otherwise; the per-track kernel on the same sessions against
   its plain version and ``render_segments_per_track_numpy`` (bit-equal at
   speed 1, the resampling contract otherwise); an 8-track speed-1 bounce
   bit-equal to the NumPy oracle; the automation variant within atol 3e-6
   / rtol 1e-5 of its plain version (linear lanes, all nine curves, fades,
   a muted automated track) and within relative RMS 1e-5 of the f64 host
   reference, and a constant-0 volume lane bit-equal to a muted track; the
   Catmull-Rom and polynomial-tap modes of all three variants on the
   resampled, reverse and faded sessions within the resampling contract
   of their plain versions (0 ulp expected) and atol 3e-6 of
   ``render_segments_numpy(interp=...)``, frames and tracks of speed-1
   rows bit-equal; the sinc prerender on small sessions (rational,
   Taylor, reverse runs): the extension built on the card within 1e-6 of
   ``apply_prerender_host``, the bounce within 3e-6 of ``resolve_sinc_host``
   + ``render_segments_numpy``, and a 1 kHz sine at speed 44100/48000 and
   at 2^(1/12) above 90 dB SNR; the summing kernel's staged walk in its
   other shapes against the plain version (0 ulp): one and three channels
   in all three interpolations and variants, a tile that ends inside a
   block of frames, and all three variants on a 64-track session in the
   oversampled form whose kept slot list two staging passes fill and with
   a 4 x 4 polynomial table (the kernels' general polynomial path; 6 x 6
   tables take an unrolled one);
   each line prints the mean and the most slots a block keeps beside the
   ``T*K`` of its tile (the host model ``mix_plan.block_slot_mask``); then
   the biquad cascade kernel on small rows (EQ bands, the 25 Hz highpass,
   FIR, gain and identity rows, a state handed over between two calls, a
   six-section chain, a row shorter than a block, an unaligned row view,
   40 rows of 25 tiles each) within relative RMS 5e-6 per row of its plain
   version, identity rows exact, each call's time printed; then the
   dynamics kernel: its unfused kinds (the release and attack alone, the
   RMS detector's one-pole: the sharded stages' form) on 1, 2, 7, 64 and
   256 rows, frames fewer than a tile and not a multiple of one,
   per-frame coefficients, states over two calls, the gate's floor,
   within relative RMS 5e-6 per row of the f64 oracle and of its plain
   version (plus the Hillis scans' own distance), bit-equal to its host
   model; its fused kinds (one launch a compressor, limiter or gate call)
   at the paths' shapes (64 stereo compressor rows, the master limiter,
   16 gate rows, 2^18 frames; timed by CUDA events around 20 launches in
   a row, with their bounds) and on small cases: keys and silent keys,
   lanes, lookahead, hysteresis, two chunks, mono, a row shorter than a
   tile, against the oracle, the plain version, the host model (1e-6)
   and the f64 sequential references (5e-5; 2e-4 with lanes); two runs of
   every call bit-equal;
4. headline and headline_resampled: ``bounce(device="cuda")`` of the
   128-track session with the launch counts reset just before, bit-equal
   to the NumPy segment reference; then 5 warm carve+plan+upload+kernel
   iterations, the kernel's time by CUDA events and the plain version's;
5. automation_32trk and automation_tempo_128trk (the JAX package's
   benchmark configs 2 and 7): the same through the automation variant,
   held to relative RMS 1e-5 of the f64 host reference (config 7's over
   the first 15 s of the session: the reference is per-sample Python on
   the host; the timing stays at 60 s), lane packing counted in the host
   legs;
6. effects_eq_128trk (config 5): ``bounce(device="cuda")`` with
   ``effects_mode="fir"``, ``"scan"`` and ``meters=True``, per-track and
   cascade launches counted (the scan and the meters through the cascade
   kernel, no Hillis scan); the per-track buffers bit-equal to
   ``render_segments_per_track_numpy`` track by track; both modes against
   an f64 reference (scipy ``sosfilt``) within relative RMS 2e-4 (fir) and
   5e-5 (scan), and within 5e-4 of each other; the meters within 1e-5 of
   the plain finisher's; 5 warm iterations in each mode with the IR or
   chain-table preparation; the per-track kernel, both finishers, the
   cascade kernel on the main path's chunk (against its plain version,
   relative RMS 5e-6 per row) and the plain versions timed;
7. catmull_128trk, sinc_prerender_128trk, sinc_irrational_128trk and
   sinc_oversample_128trk (the JAX package's benchmark config 3 and its
   two sinc extras): ``bounce(device="cuda", interpolation=...)`` with the
   launch counts reset just before (one mix launch, in the expected
   mode); the prerender cells read the extended pool back once, hold the
   kernel's mix over it bit-equal to ``render_segments_numpy`` on the
   rewritten table and the extension of the first two tracks' runs within
   1e-6 of the f64 host extension; the Catmull-Rom and oversampled cells
   hold a 5 s head against ``render_segments_numpy(interp=...)``; 5 warm
   iterations with the host legs, the extension's build and the kernel
   by CUDA events, the plain version, the bounds, peak memory, and a
   sweep of the extension's slab size;
8. config1_8trk, config3_linear_128trk and reverse_bidir_128trk (the JAX
   package's ``benchmarks/run_all.py`` config 1, config 3's session under
   linear interpolation and its extra of ``LOOP_BIDIRECTIONAL`` clips):
   ``bounce(device="cuda")`` with the launch counts reset just before (one
   summing-kernel launch, linear), the whole render against
   ``render_segments_numpy`` (bit-equal at speed 1, the resampling contract
   otherwise), then :func:`measure_cell`; and peaks_1h (config 4): the peak
   pyramid over one hour of seeded int32 codes on the card, by CUDA events
   (median and best of 5) in Gsamples/s, every level bit-identical to the
   C++ scalar walk;
9. the gather mix (``ops/mix.py``: on the card the hand kernel
   ``csrc/gather_mix.cu``, the plain torch ops on the CPU) on small
   sessions with the launch counts reset just before each bounce: no
   slot-plan kernel launch and a gather-kernel launch or more a chunk,
   bit-equal to the same bounce on the CPU, bit-equal to
   ``render_segments_numpy`` at speed 1 and within the resampling
   contract otherwise, the dense session whose slots overflow taken by
   ``engine="auto"``; each generic effect stage kind on the card within
   relative RMS 1e-5 of the same finisher on the CPU and 5e-5 (2e-4 with
   lanes) of the f64 ``reference_generic_finish``; then the gather kernel
   itself (:func:`phase_gather_kernel`) in its three forms (per-track,
   summed, summed unclipped) on those sessions in every interpolation
   mode (linear, Catmull-Rom, polynomial taps, the direct sinc bank), one
   and three channels, ragged chunks, a chunk past the end, a track
   subset and 300 tracks, bit-equal to its plain version on the card
   (``strict_order=False`` within 1e-6, within the reordering bound on
   300 tracks); every other gather check below (the headline through
   ``engine="xla"``, the 6 GiB rule, the routed and MIDI cells through
   ``engine="xla"``, the preview, the stream, the sharded mix) requires
   a gather-kernel launch or more a chunk or window beside its zero
   slot-plan kernel launches, and phase 4 times the kernel's three forms
   over the headline's chunks beside the plain version and the bounds;
10. generic_fx_128trk (config 6's chains on the flat mix): one K4 launch,
    the cascade kernel for the static EQ stages, one fused dynamics launch
    a compressor and master limiter call and no unfused one (the fused
    stage and its ballistics alone held to their plain versions at the
    first compressor group's full width, timed with their bounds; the
    ``wb.track.compressor`` and ``wb.master.limiter`` ranges' busy time,
    the fused kernel alone in them); the finisher's first 10 s
    against the CPU's, one track per signature and the master over 2 s
    against the f64 chains; 5 warm iterations, the device time per stage
    kind from a ``torch.profiler`` trace of the shipped finisher (its
    ``wb.*`` ranges), and the chunk sweep;
11. effects_eq_240s_128trk (config 5's chains, 240 s): one K4 launch
    within the card's per-track limit, and the same bounce under the JAX
    package's 6 GiB rule through the gather path (no mix-kernel launch),
    held to each other (relative RMS 1e-5); 3 warm iterations of each;
    the headline through ``engine="xla"`` is checked and timed in phase 4;
12. the routed finisher on a small session with every routing feature
    (groups, post/pre/sidechain sends, a ducking bus, a generic bus with a
    fader lane, PDC): on the card within relative RMS 1e-5 of the CPU's
    and 5e-5 of the f64 ``reference_routed_finish``; its bounce one K4
    launch, the gather path none;
13. routed_sidechain_128trk (the JAX package's config 6 exactly: 8 group
    buses, a sidechain duck, sends, a master limiter): one K4 launch,
    then the routed finisher (the cascade kernel and the fused dynamics
    kernel launched, the ``wb.bus.compressor`` and ``wb.master.limiter``
    ranges' busy time, the fused kernel alone in them); its first 10 s
    against the CPU's (1e-5), its first 2 s against the f64 reference
    (5e-5), ``engine="xla"`` (no mix-kernel launch, within 1e-6 of the K4
    path at equal chunks); 5
    warm iterations, the stages by ``torch.profiler`` (``wb.route.matmul``,
    ``wb.bus.<kind>``, ...) and the chunk sweep (2^15-2^20);
14. midi_synth_128trk (112 audio tracks and 16 MIDI tracks of 960 notes):
    one K4 launch, the synth on the card bit-equal to
    ``render_synth_numpy``, the first 10 s bit-equal to the CPU bounce,
    ``engine="xla"`` (no mix-kernel launch) bit-equal to the K4 path; 5
    warm iterations, the synth's and the finisher's device times;
15. the export deliverables, each 128 tracks x 60 s at 48 kHz with the
    launch counts reset just before: stems_eq_128trk and
    stems_generic_128trk (``render_stems``: one K4 launch, then the stems
    finisher, the EQ cell's through the cascade kernel, the generic cell's
    compressors one fused dynamics launch a call, their ranges' busy time
    printed; the stems' sum
    within atol 5e-5 of the pre-master bounce, the first 10 s of a stem of
    each chain within relative RMS 1e-5 of the CPU's), bus_stems_routed_128trk
    (``render_bus_stems`` of config 6: one K4 launch, the master chain over
    direct + buses within 1e-5 of the routed bounce, the first 2 s within
    1e-5 of the CPU's), loudness_headline (``bounce(loudness=True)``: one
    mix-kernel and one cascade launch, the readings within 0.02 LU / 0.05
    LU LRA / 0.05 dB true peak of the f64 host reference, the cascade at
    that shape against its plain version, ``normalize`` to -14 LUFS and
    -1 dBTP), stretch_60s (the vocoder at 1.25 and a +3 semitone shift of
    a seeded 60 s programme: bit-equal across card runs, 1e-5 off the
    CPU's) and peaks_10min (``build_mipmaps`` of 28.8 M stereo frames in
    F32 and I16, both qualities, bit-identical to the C++ scalar walk);
    e2e, the kernels and finishers by CUDA events, the readback, peak
    memory;
16. cached_headline and cached_automation_tempo_128trk
    (``render/cached.py::SessionRenderCache`` on the headline and config
    7, launch counts reset just before each render): every render one K1
    (K3) launch and bit-equal to ``bounce`` on the card; the first render,
    the unchanged re-render (``render_device`` synchronised and
    ``render`` with its readback, medians of 20), a re-render after a
    clip-gain edit (the pool on the card kept) and after an edit that adds
    an asset (rebuilt), the edit stamp alone;
17. preview_32trk (the JAX package's config 8: ``PreviewStream`` with
    512-frame blocks and 64 of lookahead): no mix-kernel launch, the
    cascade kernel launched, the first 10 s within relative RMS 1e-5 of
    ``bounce`` on the card; the cascade kernel against its plain version
    on the window's track rows and master over two windows, the states
    carried; the duty of a pulled block and of the card's window against
    the 10.67 ms block budget, a seek and an edit;
18. stream_takes_128trk (``render/stream_pool.py::bounce_streamed`` of
    128 seeded 60 s takes, a 2.95 GB pool, under a 256 MiB cap in windows
    of 2^17 frames): bit-equal to ``bounce(engine="xla")``, no mix-kernel
    launch, peak memory below the resident bounce's; e2e, the host's
    window builds, the page-locked copies, the renders and the card's busy
    time; with config 5's chains (the cascade kernel) within relative RMS
    1e-5 of the resident bounce, and the cascade kernel against its plain
    version on a window's 256 track rows and master over two windows, the
    states carried;
19. the feature checks of ``whitebox_tpu_torch/tools/verify.py`` (the JAX
    package's ``tools/tpu_verify.py``) with ``device="cuda"``: one line each
    with its value, its bar and the kernels it launched (each check that
    renders requires a mix-kernel launch, and a cascade launch where a
    cascade stage sits in its path); any miss or exception fails;
20. the port's examples (``examples/torch_{mixdown,tempo_ramp,extending}.py``)
    on the card in this process, each with its launches; any assertion they
    make fails;
21. the sharded render (``parallel/``, :func:`phase_sharded`): a world of
    one rank over NCCL (``make_render_mesh()``, a 1x1 mesh): the headline
    bit-equal to ``bounce(engine="xla")`` on the card, ``generic_fx_128trk``
    and ``routed_sidechain_128trk`` within atol 3e-6 / rtol 1e-4 of it, no
    mix-kernel launch, the cascade kernel launched; four ranks sharing the
    card over gloo with host staging (``parallel/launch.py::run_world``),
    1x4 and 2x2: the headline bit-equal on 1x4 and within atol 2e-6 /
    rtol 1e-5 on 2x2, ``generic_fx_128trk`` within the bar above, the
    ranks' audio identical, each rank's wall, staged bytes and copy time,
    peak memory (below a quarter of the card) and cascade launches; the
    two-pass cascade at the 1x4 shard's shape (256 rows) with the incoming
    state folded, against its plain version (relative RMS 5e-6 a row);
22. each phase's seconds, the script's wall time, one JSON line of
    kernels (each entry's ``cell_launches`` the counts read in those
    cells; the gather kernel's forms as ``gather_mix_sum``,
    ``gather_mix_per_track`` and ``gather_mix_sum_unclipped``), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
port is not beside it, or when any phase fails.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATE = 48000.0
ULP_MAX, ABS_TOL = 2, 2.4e-7  # the JAX package's resampling contract (tests/test_bounce.py)
AUTO_ATOL, AUTO_RTOL = 3e-6, 1e-5  # its automation-kernel contract (tests/test_auto_kernel.py)
AUTO_REL_RMS = 1e-5  # against the f64 host reference (tests/test_fades_automation.py)
# Catmull-Rom, polynomial taps and the sinc prerender against the NumPy segment
# reference (tests/test_catmull.py:28, tests/test_prerender.py:142,258); the
# prerendered extension on the device against the host's (test_prerender.py:129)
INTERP_ATOL, EXT_ATOL, SINE_SNR_DB = 3e-6, 1e-6, 90.0
# the generic finisher on the card against the same function on the CPU, and
# against the f64 host oracles (tests/test_effects_family.py:295)
GENERIC_REL_RMS, GENERIC_F64_REL_RMS, LANES_F64_REL_RMS = 1e-5, 5e-5, 2e-4
#: chunk lengths swept for the generic finisher on the card (CUDA_CHUNK_CAP)
GENERIC_CHUNK_SWEEP = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21)
#: chunk lengths swept for the routed finisher on the card
ROUTED_CHUNK_SWEEP = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sh(cmd: list[str]) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (r.stdout or r.stderr).strip()


def ulp_contract(got, ref):
    """-> (ok, max ulp, max abs) under the resampling contract."""
    import numpy as np

    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    absd = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    ok = not ((ulps > ULP_MAX) & (absd > ABS_TOL)).any()
    return ok, int(ulps.max()), float(absd.max())


def rel_rms(got, ref) -> float:
    import numpy as np

    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    scale = max(float(np.sqrt(np.mean(np.asarray(ref, np.float64) ** 2))), 1e-9)
    return float(np.sqrt(np.mean(d ** 2))) / scale


def host_reference(session, mode="linear", seconds=None, channels=2):
    """The f64 host reference of an automated bounce: the per-track NumPy
    segment render (resampled rows in ``mode``, see :func:`resolve_mode`) +
    the finish stage's gains, sum and clip; of the first ``seconds`` of the
    session only, when given."""
    from whitebox_tpu_torch.render.effects_pipeline import reference_finish_mix
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    blocks = None if seconds is None else int(seconds * RATE) // 512
    table, pool = carve_session(session, RATE, buffer_size=512, num_blocks=blocks, out_channels=channels)
    table, pool, interp = resolve_mode(table, pool, mode)
    return reference_finish_mix(render_segments_per_track_numpy(table, pool, channels, interp=interp),
                                session, RATE, channels)


def resolve_mode(table, pool, mode):
    """-> (table, pool, interp) for the kernel's interpolation ``mode``:
    "linear" and "catmull" as they are; "poly" rewrites the resampled rows
    onto a 4x oversampled copy of their samples and gives the six
    LS-optimal taps (what ``bounce(interpolation="sinc", prerender=False)``
    renders)."""
    from whitebox_tpu_torch.timeline.oversample import resolve_interpolation

    if mode == "poly":
        return resolve_interpolation(table, pool, "sinc")
    return table, pool, mode


def make_renderer(session, mode="linear", tile=None, auto=False, seconds=None, channels=2):
    """-> (renderer, table, pool, interp): the carve of ``session`` for
    ``channels`` output channels resolved to ``mode`` and a
    ``CudaMixRenderer`` on the card (16 slots for the oversampled rows, as
    ``bounce`` allows them)."""
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
    from whitebox_tpu_torch.timeline.carve import carve_session

    blocks = None if seconds is None else int(seconds * RATE) // 512
    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs", num_blocks=blocks,
                                out_channels=channels)
    table, pool, interp = resolve_mode(table, pool, mode)
    plan = build_plan(table, pool, session, channels=channels, tile=tile,
                      max_slots=16 if mode == "poly" else 8)
    r = mix_cuda.CudaMixRenderer(
        table, pool, session, device="cuda", channels=channels, plan=plan, interp=interp,
        auto_tables=prepare_automation_tables_host(session, RATE) if auto else None)
    return r, table, pool, interp


def kept_slots(plan) -> dict:
    """What the summing kernel's staged walk shrank to: the mean and the
    most slots a block of frames keeps, of the ``T*K`` raw slots of its tile
    (the host model ``mix_plan.block_slot_mask``)."""
    from whitebox_tpu_torch.ops.mix_plan import FRAMES_PER_BLOCK, block_slot_mask

    per_block = block_slot_mask(plan).sum(axis=2)
    return {"raw_slots": plan.num_tracks * plan.max_slots, "block_frames": FRAMES_PER_BLOCK,
            "kept_slots_mean": float(per_block.mean()), "kept_slots_max": int(per_block.max())}


def kept_slots_note(plan) -> str:
    k = kept_slots(plan)
    return f"kept/block mean {k['kept_slots_mean']:.1f} max {k['kept_slots_max']} of {k['raw_slots']}"


def slow_frames(table, n):
    """Mask [n] of the frames that a resampled row of ``table`` covers."""
    import numpy as np

    m = np.zeros(n, bool)
    for i in np.nonzero(~table.fast)[0]:
        m[int(table.dst_start[i]) : int(table.dst_start[i]) + int(table.length[i])] = True
    return m


def reset_launches() -> None:
    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda, gather_cuda, mix_cuda

    biquad_cuda.biquad_cascade_launches = 0
    gather_cuda.gather_launches = 0
    for form in gather_cuda.form_launches:
        gather_cuda.form_launches[form] = 0
    dynamics_cuda.dynamics_scan_launches = 0
    dynamics_cuda.dynamics_fused_launches = 0
    mix_cuda.mix_kernel_launches = 0
    mix_cuda.mix_auto_launches = 0
    mix_cuda.mix_per_track_launches = 0
    for mode in mix_cuda.interp_launches:
        mix_cuda.interp_launches[mode] = 0


# ---------------------------------------------------------------- sessions


def _sample(rng, fmt, channels, n):
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session.sample import Sample

    if fmt == AudioFormat.I16:
        data = rng.integers(-32768, 32768, size=(channels, n)).astype(np.int16)
    elif fmt == AudioFormat.I24:
        data = rng.integers(-(1 << 23), 1 << 23, size=(channels, n)).astype(np.int32)
    else:
        data = (rng.standard_normal((channels, n)) * 0.4).astype(np.float32)
    return Sample.from_planar(data, 48000, fmt)


def int_formats_session(seed=11, n_tracks=6):
    """Speed-1 clips of I16/I24/F32 sources (the clamp path) with fades."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session

    rng = np.random.default_rng(seed)
    s = Session(bpm=120.0)
    fmts = (AudioFormat.I16, AudioFormat.I24, AudioFormat.F32)
    for t in range(n_tracks):
        asset = s.sample_table.add_sample(
            _sample(rng, fmts[t % 3], 1 + t % 2, int(rng.integers(20000, 60000))), key=f"s{t}")
        tr = s.add_track(f"t{t}", volume_db=float(rng.uniform(-6, 6)), pan=float(rng.uniform(-1, 1)))
        pos = float(rng.uniform(0, 1))
        for c in range(4):
            length = float(rng.uniform(0.5, 2.0))
            s.add_audio_clip(tr, f"c{c}", pos, pos + length, start_offset=float(rng.integers(0, 5000)),
                             asset=asset, gain=float(rng.uniform(0.3, 1.2)),
                             fade_start=length * 0.2, fade_end=length * 0.3)
            pos += length + float(rng.uniform(0.0, 0.5))
    return s


def reverse_session(seed=12):
    """Reverse and bidirectional loops at speed 1 and resampled."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.clip import ClipMode

    rng = np.random.default_rng(seed)
    s = Session(bpm=120.0)
    modes = [(ClipMode.LOOP_REVERSE, 1.0), (ClipMode.LOOP_REVERSE, 0.75),
             (ClipMode.ONE_SHOT_REVERSE, 44100 / 48000), (ClipMode.LOOP_BIDIRECTIONAL, 1.3)]
    for t, (mode, speed) in enumerate(modes):
        asset = s.sample_table.add_sample(_sample(rng, AudioFormat.F32, 2, 9000), key=f"r{t}")
        tr = s.add_track(f"r{t}", volume_db=-3.0, pan=float(rng.uniform(-0.5, 0.5)))
        s.add_audio_clip(tr, "c", 0.25 * t, 0.25 * t + 6.0, start_offset=float(100 * t),
                         asset=asset, gain=0.8, speed=speed)
        tr.clips[0].audio.mode = mode
    return s


def many_tracks_session():
    """64 tracks of resampled, faded clips, every other one with a volume
    lane: in the oversampled form a tile holds more raw slots than one
    staging pass of the summing kernel looks at."""
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=64, duration_seconds=6.0, seed=13, sample_seconds=1.0, fades=True,
                          clip_speeds=(1.0, 44100 / 48000, 0.5, 1.37))
    for tr in s.tracks[::2]:
        tr.automation = TrackAutomation(volume=AutomationLane().add(0.0, 0.9).add(4.0, 0.3).add(9.0, 1.0))
    return s


def staging_passes(plan) -> int:
    """The most staging passes (of ``FRAMES_PER_BLOCK`` raw slots each)
    that hold a kept slot of one block."""
    import numpy as np

    from whitebox_tpu_torch.ops.mix_plan import FRAMES_PER_BLOCK, block_slot_mask

    mask = block_slot_mask(plan)
    mask = np.pad(mask, ((0, 0), (0, 0), (0, (-mask.shape[2]) % FRAMES_PER_BLOCK)))
    per_pass = mask.reshape(*mask.shape[:2], -1, FRAMES_PER_BLOCK).any(axis=3)
    return int(per_pass.sum(axis=2).max())


#: (curve, tension) per segment of the all-curves lane: every CurveType,
#: both tension signs, and the near-zero tensions that take the linear
#: branch of the exponential eases
NINE_CURVES = ((1, 0.0), (2, 2.0), (3, -1.5), (4, 0.9), (5, -0.6), (6, 1.0), (7, -1.0),
               (2, 0.004), (0, 0.0), (8, 0.0), (3, 0.005), (6, -0.5))


def auto_session(seed=3, n_tracks=4, curves=False, fades=False, mute_first=False):
    """Automated tracks in the shapes of ``tests/test_auto_kernel.py::
    _auto_session``: every track but the last gets a volume lane, every
    other one a pan lane; ``curves`` walks the volume lanes of the even
    tracks through all nine curve types."""
    from whitebox_tpu_torch.ops.automation import AutomationLane, CurveType, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=n_tracks, duration_seconds=6.0, seed=seed, fades=fades,
                          sample_seconds=1.0, clip_speeds=(1.0, 44100 / 48000))
    for i, tr in enumerate(s.tracks[:-1]):  # the last track keeps its constant gain
        vol = AutomationLane().add(0.0, 1.0)
        if curves and i % 2 == 0:
            for j, (curve, tension) in enumerate(NINE_CURVES):
                vol.add(0.25 + 0.9 * j, float(0.2 + 0.6 * ((i + j) % 3) / 2),
                        curve=CurveType(curve), tension=tension)
            # an earlier point's curve shapes the segment after it
            vol.points[0].curve = CurveType((i + 4) % 9)
        else:
            vol.add(2.0, 0.4).add(5.0, 0.9)
        pan = (AutomationLane().add(0.0, -0.8 + 0.2 * i).add(8.0, 0.8 - 0.2 * i)
               if i % 2 == 0 else None)
        tr.automation = TrackAutomation(volume=vol, pan=pan)
    if mute_first:
        s.tracks[0].mute = True
    return s


def automation_32trk(duration=60.0):
    """The JAX package's benchmark config 2 (``benchmarks/run_all.py:244-257``):
    32 tracks with volume + pan lanes and clip fades."""
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=32, duration_seconds=duration, sample_rate=48000, seed=2, fades=True)
    beats = duration / s.beat_duration
    for i, tr in enumerate(s.tracks):
        tr.automation = TrackAutomation(
            volume=AutomationLane().add(0.0, 1.0).add(beats * 0.5, 0.4).add(beats, 0.9),
            pan=AutomationLane().add(0.0, -0.8 + 0.05 * i).add(beats, 0.8 - 0.05 * i),
        )
    return s


def automation_tempo_128trk(duration=60.0):
    """The JAX package's benchmark config 7 (``benchmarks/run_all.py:489-506``):
    128 tracks under a piecewise tempo map (step + linear ramp) with fader
    lanes."""
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=48000, seed=11)
    beats = duration / s.beat_duration
    s.set_tempo_point(0.0, 120.0)
    s.set_tempo_point(beats * 0.25, 90.0, curve="linear", bpm_end=140.0)
    s.set_tempo_point(beats * 0.6, 128.0)
    for tr in s.tracks:
        tr.automation = TrackAutomation(
            volume=AutomationLane().add(0.0, 1.0).add(beats * 0.5, 0.5).add(beats, 0.9),
        )
    return s


def effects_eq_128trk(duration=60.0):
    """The JAX package's benchmark config 5 (``benchmarks/run_all.py:362-374``):
    the headline session (128 tracks, seed 7) with a 3-band ParametricEQ on
    every track and a 25 Hz highpass on the master bus."""
    from whitebox_tpu_torch.effects import Biquad, EffectChain
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=48000, seed=7)
    add_eq_chains(s)
    s.master_effects = EffectChain([Biquad("highpass", 25.0)])
    return s


def add_eq_chains(s):
    """Config 5's track chains: a 3-band ParametricEQ on every track, the
    peak band at 1000 + 37 * track Hz."""
    from whitebox_tpu_torch.effects import EffectChain, ParametricEQ

    for i, tr in enumerate(s.tracks):
        tr.effects = EffectChain([ParametricEQ([
            ("lowshelf", 100.0, 0.707, 2.0), ("peak", 1000.0 + 37.0 * i, 1.0, -1.5),
            ("highshelf", 8000.0, 0.707, 1.0),
        ])])


# ---------------------------------------------------------------- phases


def phase_environment(torch) -> dict:
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    from whitebox_tpu_torch.ops import cuda_build

    nvcc = cuda_build.find_nvcc()
    env = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvcc": nvcc,
        "nvcc_version": sh([nvcc, "--version"]).splitlines()[-1],
        "gxx": shutil.which("g++"),
        "ninja": shutil.which("ninja") is not None,
        "triton": importlib.util.find_spec("triton") is not None,
        "smi": smi,
    }
    print("[env] " + json.dumps(env))
    return env


def phase_build() -> None:
    """nvcc (the mix kernel) and g++ (the host library) side by side."""
    from whitebox_tpu_torch.io import native
    from whitebox_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        cuda = ex.submit(cuda_build.load)
        host = ex.submit(native.load)
        cuda.result()
        host_lib = host.result()
    print(f"[build] {cuda_build.build_dir() / cuda_build.LIB_NAME}: nvcc "
          f"{cuda_build.last_build_seconds:.2f} s ({' '.join(cuda_build.NVCC_FLAGS)}); "
          f"host: {host_lib._name if host_lib else 'no g++'} {native.last_build_seconds:.2f} s; "
          f"both {time.perf_counter() - t0:.2f} s")
    carve = "native (csrc/host, g++)" if host_lib is not None else "numpy (no g++)"
    print(f"[env] carve walk: {carve}")


def kernel_vs_plain(name, session, tile=None, mode="linear", channels=2):
    """Kernel vs plain version on the card, and vs the NumPy reference. In
    the Catmull-Rom and polynomial modes: the resampling contract against
    the plain version (0 ulp expected), atol 3e-6 against
    ``render_segments_numpy(interp=...)``, and bit-equal to it on every
    frame that only speed-1 rows cover. -> max abs of kernel - plain"""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.timeline.carve import render_segments_numpy

    r, table, pool, interp = make_renderer(session, mode, tile, channels=channels)
    p = r.plan
    before = mix_cuda.interp_launches[mode]
    got = r.render_device()
    check(mix_cuda.interp_launches[mode] == before + 1, f"{name}: the {mode} kernel did not launch")
    plain = mix_cuda.mix_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels,
                                   interp=interp)
    torch.cuda.synchronize()
    kp_abs = float((got - plain).abs().max())
    if mode == "linear":
        check(torch.equal(got, plain), f"{name}: kernel != plain version (max abs {kp_abs:.3g})")
        kp = "bit-equal"
    else:
        ok, ku, ka = ulp_contract(got.cpu().numpy(), plain.cpu().numpy())
        check(ok, f"{name}: {mode} kernel {ku} ulp / {ka:.3g} abs off its plain version")
        kp = f"max {ku} ulp"
    out = got[:, : p.total_frames].cpu().numpy()
    ref = render_segments_numpy(table, pool, session, channels, interp=interp)
    fast = bool(table.fast.all())
    if fast:
        check(np.array_equal(out, ref), f"{name}: kernel != render_segments_numpy at speed 1")
        vs = "bit-equal"
    elif mode == "linear":
        ok, mu, ma = ulp_contract(out, ref)
        check(ok, f"{name}: {mu} ulp / {ma:.3g} abs off render_segments_numpy")
        vs = f"max {mu} ulp / {ma:.3g} abs"
    else:
        ma = float(np.abs(out.astype(np.float64) - ref).max())
        check(ma <= INTERP_ATOL, f"{name}: {mode} {ma:.3g} abs off render_segments_numpy(interp)")
        keep = ~slow_frames(table, p.total_frames)
        check(keep.any() and np.array_equal(out[:, keep], ref[:, keep]),
              f"{name}: {mode} moved frames that only speed-1 rows cover")
        vs = f"max {ma:.3g} abs (atol {INTERP_ATOL}), speed-1 frames bit-equal"
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent render")
    print(f"[kernel-vs-plain] {name} {mode}: tracks={p.num_tracks} C={channels} tile={p.tile} "
          f"n_tiles={p.n_tiles} K={p.max_slots} {kept_slots_note(p)} slow_slots={int((p.is_slow * (p.me > p.ms)).sum())} "
          f"kernel vs plain {kp}; vs render_segments_numpy {vs}")
    return kp_abs


def per_track_vs_plain(name, session, tile=None, mode="linear", channels=2):
    """The per-track kernel (K4) vs its plain version on the card, and vs
    the NumPy per-track segment reference: bit-equal at speed 1, within
    the resampling contract otherwise (atol 3e-6 in the Catmull-Rom and
    polynomial modes, where tracks of speed-1 rows only stay bit-equal)."""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.timeline.carve import render_segments_per_track_numpy

    r, table, pool, interp = make_renderer(session, mode, tile, channels=channels)
    p = r.plan
    before = mix_cuda.mix_per_track_launches
    got = r.render_device_per_track()
    check(mix_cuda.mix_per_track_launches == before + 1, f"{name}: the per-track kernel did not launch")
    plain = mix_cuda.mix_per_track_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels,
                                             interp=interp)
    torch.cuda.synchronize()
    g, q = got.cpu().numpy(), plain.cpu().numpy()
    fast = bool(table.fast.all())
    if fast:
        check(np.array_equal(g, q), f"{name}: per-track kernel != plain version at speed 1")
    else:
        ok, mu, ma = ulp_contract(g, q)
        check(ok, f"{name}: per-track kernel {mu} ulp / {ma:.3g} abs off its plain version")
    out = g[:, :, : p.total_frames]
    ref = render_segments_per_track_numpy(table, pool, channels, interp=interp)
    if fast:
        check(np.array_equal(out, ref), f"{name}: per-track kernel != render_segments_per_track_numpy")
        mu, ma = 0, 0.0
    elif mode == "linear":
        ok, mu, ma = ulp_contract(out, ref)
        check(ok, f"{name}: per-track kernel {mu} ulp / {ma:.3g} abs off render_segments_per_track_numpy")
    else:
        mu, ma = -1, float(np.abs(out.astype(np.float64) - ref).max())
        check(ma <= INTERP_ATOL, f"{name}: {mode} per-track {ma:.3g} abs off the NumPy reference")
        speed1 = [t for t in range(p.num_tracks) if table.fast[table.track == t].all()]
        check(all(np.array_equal(out[t], ref[t]) for t in speed1),
              f"{name}: {mode} moved a track of speed-1 rows only")
    check(not g[:, :, p.total_frames:].any(), f"{name}: per-track padding not silent")
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent per-track render")
    kp_ulps = int(np.abs(g.view(np.int32).astype(np.int64) - q.view(np.int32).astype(np.int64)).max())
    print(f"[kernel-vs-plain] {name}_per_track {mode}: tracks={p.num_tracks} tile={p.tile} "
          f"out={tuple(got.shape)} kernel vs plain max {kp_ulps} ulp; vs "
          f"render_segments_per_track_numpy "
          f"{'bit-equal' if fast else f'max {mu} ulp / {ma:.3g} abs' if mode == 'linear' else f'max {ma:.3g} abs'}")


def auto_vs_plain(name, session, tile=None, mode="linear", channels=2):
    """The automation variant vs its plain version on the card (atol/rtol),
    and vs the f64 host reference (relative RMS), resampled rows in
    ``mode``."""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda

    r, table, pool, interp = make_renderer(session, mode, tile, auto=True, channels=channels)
    p = r.plan
    before = mix_cuda.mix_auto_launches, mix_cuda.interp_launches[mode]
    got = r.render_device()
    check((mix_cuda.mix_auto_launches, mix_cuda.interp_launches[mode]) == (before[0] + 1, before[1] + 1),
          f"{name}: the {mode} automation kernel did not launch")
    plain = mix_cuda.mix_auto_reference(r.pool_device, r.tables, r.auto, p.n_tiles, p.tile,
                                        p.channels, interp=interp)
    torch.cuda.synchronize()
    g, q = got.cpu().numpy(), plain.cpu().numpy()
    ulps = int(np.abs(g.view(np.int32).astype(np.int64) - q.view(np.int32).astype(np.int64)).max())
    max_abs = float(np.abs(g.astype(np.float64) - q).max())
    check(np.allclose(g, q, atol=AUTO_ATOL, rtol=AUTO_RTOL),
          f"{name}: automation kernel vs plain max abs {max_abs:.3g} ({ulps} ulp)")
    out = g[:, : p.total_frames]
    rr = rel_rms(out, host_reference(session, mode, channels=channels))
    check(rr < AUTO_REL_RMS, f"{name}: relative RMS {rr:.3g} off the f64 host reference")
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent render")
    print(f"[kernel-vs-plain] {name} {mode}: tracks={p.num_tracks} C={channels} tile={p.tile} P={r.auto['vxs'].shape[1]} "
          f"automated={int(r.auto['use'].sum())} kernel vs plain max {ulps} ulp / {max_abs:.3g} abs "
          f"(atol {AUTO_ATOL}, rtol {AUTO_RTOL}); vs f64 host reference relative RMS {rr:.3g}")


def variants_vs_plain(name, session, coeffs=None):
    """All three kernel variants against their plain versions on the card,
    from one renderer of ``session`` in the oversampled form, under the
    resampling contract (0 ulp expected; the automation variant within its
    atol/rtol). ``coeffs``: a polynomial table in place of the designer's
    6 x 6 one; another shape takes the kernels' general polynomial path.
    -> the plan."""
    import torch

    from whitebox_tpu_torch.ops import mix_cuda

    r, _, _, interp = make_renderer(session, "poly", auto=True)
    if coeffs is not None:
        interp = ("poly", coeffs)
    p = r.plan
    args = (p.n_tiles, p.tile, p.channels)
    pairs = {
        "sum": (mix_cuda.mix_cuda(r.pool_device, r.tables, *args, interp=interp),
                mix_cuda.mix_reference(r.pool_device, r.tables, *args, interp=interp)),
        "per_track": (mix_cuda.mix_per_track_cuda(r.pool_device, r.tables, *args, interp=interp),
                      mix_cuda.mix_per_track_reference(r.pool_device, r.tables, *args, interp=interp)),
        "auto": (mix_cuda.mix_auto_cuda(r.pool_device, r.tables, r.auto, *args, interp=interp),
                 mix_cuda.mix_auto_reference(r.pool_device, r.tables, r.auto, *args, interp=interp)),
    }
    torch.cuda.synchronize()
    ulps = {}
    for variant, (got, plain) in pairs.items():
        g, q = got.cpu().numpy(), plain.cpu().numpy()
        ok, ulps[variant], _ = ulp_contract(g, q)
        if variant == "auto":
            ok = bool(torch.allclose(got, plain, atol=AUTO_ATOL, rtol=AUTO_RTOL))
        check(ok and float(abs(g).max()) > 0.01, f"{name}: {variant} kernel off its plain version")
    taps = f"{len(interp[1])} x {len(interp[1][0])} taps"
    print(f"[kernel-vs-plain] {name} poly ({taps}): tracks={p.num_tracks} tile={p.tile} K={p.max_slots} "
          f"{kept_slots_note(p)} automated={int(r.auto['use'].sum())} kernel vs plain max ulp {ulps}")
    return p


def sinc_small(name, session):
    """The sinc prerender on a small session: the extension built on the
    card against the host's, and the bounce against the NumPy mix of the
    host-prerendered table, one mix launch."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline import prerender as pre
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    plan = pre.plan_prerender(table, pool, partial=True)
    check(plan is not None and plan.uncovered_rows is None, f"{name}: the prerender does not cover the session")
    _, p2 = pre.apply_prerender_host(table, pool, plan)
    _, _, full = pre.apply_prerender_device(table, pool, plan, device="cuda")
    ext_err = float(np.abs(full.cpu().numpy() - p2.data).max())
    check(full.shape[0] == p2.data.shape[0] and ext_err < EXT_ATOL,
          f"{name}: extension on the card {ext_err:.3g} off apply_prerender_host")
    reset_launches()
    res = bounce(session, RATE, device="cuda", interpolation="sinc")
    check((mix_cuda.mix_kernel_launches, mix_cuda.mix_auto_launches, mix_cuda.mix_per_track_launches)
          == (1, 0, 0), f"{name}: a sinc bounce must launch the mix kernel once")
    t2, p2, interp = pre.resolve_sinc_host(table, pool)
    ref = render_segments_numpy(t2, p2, session, interp=interp)
    err = float(np.abs(res.audio.astype(np.float64) - ref).max())
    check(res.audio.shape == ref.shape and err < INTERP_ATOL,
          f"{name}: sinc bounce {err:.3g} off resolve_sinc_host + render_segments_numpy")
    kinds = sorted({g[0] for g in plan.groups})
    print(f"[kernel-vs-plain] {name}: {len(plan.runs)} runs in groups {kinds}, reverse "
          f"{sum(r.rev for r in plan.runs)}; extension on the card vs apply_prerender_host max "
          f"{ext_err:.3g} abs (< {EXT_ATOL}); bounce(interpolation='sinc') vs resolve_sinc_host + "
          f"render_segments_numpy max {err:.3g} abs (< {INTERP_ATOL}); mix launches=1; "
          f"prerender {res.stats.prerender_seconds * 1e3:.3f} ms")


def sinc_sine_snr():
    """A 1 kHz sine from a 44.1 kHz sample (speed 44100/48000, the exact
    polyphase path, hard left) and from a 48 kHz sample at a semitone (the
    Taylor path, hard right): each against its ideal resampled sine."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.sample import Sample

    irr = 2.0 ** (1.0 / 12.0)
    s = Session(bpm=120.0)
    for i, (rate, speed, pan) in enumerate(((44100, 1.0, -1.0), (48000, irr, 1.0))):
        x = (0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(rate * 2) / rate)).astype(np.float32)
        asset = s.sample_table.add_sample(Sample.from_planar(x[None], rate, AudioFormat.F32), key=f"sine{i}")
        s.add_audio_clip(s.add_track(f"t{i}", volume_db=0.0, pan=pan), "c", 0.0, 3.0, asset=asset, speed=speed)
    out = bounce(s, RATE, device="cuda", interpolation="sinc").audio
    m = np.arange(out.shape[1]) / RATE
    amp = 0.5 * float(np.sqrt(2.0))  # the -3 dB pan law on the hard side
    lo, hi = 2000, int(1.4 * RATE)
    snrs = []
    for ch, freq in ((0, 1000.0), (1, 1000.0 * irr)):
        ideal = amp * np.sin(2 * np.pi * freq * m)
        noise = out[ch, lo:hi] - ideal[lo:hi]
        snrs.append(10 * np.log10(np.mean(ideal[lo:hi] ** 2) / max(np.mean(noise ** 2), 1e-30)))
        check(snrs[-1] > SINE_SNR_DB, f"sinc sine at {freq:.1f} Hz: SNR {snrs[-1]:.1f} dB")
    print(f"[kernel-vs-plain] sinc_sine_snr: 1 kHz sine at speed 44100/48000 {snrs[0]:.1f} dB, at "
          f"2^(1/12) {snrs[1]:.1f} dB (> {SINE_SNR_DB} dB)")


def phase_kernel_vs_plain() -> None:
    import numpy as np

    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.resample import design_poly_interp
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.demo import make_demo_session
    from whitebox_tpu_torch.timeline.oracle import OracleRenderer

    small = {
        "speed1_i16_i24_f32_fades": (int_formats_session(), None),
        "speed1_i16_i24_f32_fades_tile1024": (int_formats_session(), 1024),
        "mixed_speeds_fades": (make_demo_session(
            n_tracks=8, duration_seconds=10.0, seed=3, fades=True,
            clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37)), None),
        "reverse_bidirectional": (reverse_session(), None),
    }
    for name, (session, tile) in small.items():
        kernel_vs_plain(name, session, tile=tile)
        per_track_vs_plain(name, session, tile=tile)
    # the Catmull-Rom and polynomial-tap slots (K2-catmull, K2-poly) in all
    # three variants, on the resampled, reverse and faded sessions
    for mode in ("catmull", "poly"):
        for name in ("mixed_speeds_fades", "reverse_bidirectional"):
            kernel_vs_plain(name, small[name][0], mode=mode)
            per_track_vs_plain(name, small[name][0], mode=mode)
        kernel_vs_plain("mixed_speeds_fades_tile1024", small["mixed_speeds_fades"][0], tile=1024, mode=mode)
        auto_vs_plain("auto_fades", auto_session(seed=5, fades=True), mode=mode)
    # the staged walk's other shapes: one and three channels (a channel pair
    # and a single channel per launch), a tile that ends inside a block, and
    # a kept list that more than one staging pass fills (many tracks x the
    # oversampled form's slots)
    short = make_demo_session(n_tracks=4, duration_seconds=4.0, seed=3, fades=True,
                              clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37))
    for channels in (1, 3):
        for mode in ("linear", "catmull", "poly"):
            kernel_vs_plain("mixed_speeds_fades_4trk", short, mode=mode, channels=channels)
        auto_vs_plain("auto_nine_curves", auto_session(seed=4, curves=True), channels=channels)
        per_track_vs_plain("reverse_bidirectional", reverse_session(), channels=channels)
    kernel_vs_plain("mixed_speeds_fades_4trk_tile1152", short, tile=1152)
    auto_vs_plain("auto_fades_tile1152", auto_session(seed=5, fades=True), tile=1152, mode="catmull")
    check(staging_passes(variants_vs_plain("many_tracks_two_passes", many_tracks_session())) > 1,
          "many_tracks: no block's kept list spans two staging passes")
    variants_vs_plain("auto_fades_4x4", auto_session(seed=5, fades=True),
                      coeffs=design_poly_interp(4, taps=4, degree=3))
    sinc_small("sinc_rational_taylor", make_demo_session(
        n_tracks=4, duration_seconds=6.0, seed=9, sample_seconds=1.0, fades=True,
        clip_speeds=(1.0, 44100 / 48000, 2 ** (1 / 12), 0.5)))
    sinc_small("sinc_reverse_bidirectional", reverse_session())
    sinc_sine_snr()

    s = make_demo_session(n_tracks=8, duration_seconds=10.0, seed=5)
    oracle = OracleRenderer(s, RATE, buffer_size=512).render()
    got = bounce(s, RATE, device="cuda").audio
    n = min(oracle.shape[1], got.shape[1])
    check(n > 0 and np.array_equal(got[:, :n], oracle[:, :n]), "8-track bounce != OracleRenderer")
    print(f"[kernel-vs-plain] oracle_8trk_10s: bounce(device='cuda') bit-equal to OracleRenderer "
          f"over {n} frames")

    auto_vs_plain("auto_linear_lanes", auto_session())
    auto_vs_plain("auto_nine_curves", auto_session(seed=4, curves=True))
    auto_vs_plain("auto_nine_curves_tile1024", auto_session(seed=4, curves=True), tile=1024)
    auto_vs_plain("auto_fades", auto_session(seed=5, fades=True))
    auto_vs_plain("auto_muted_automated_track", auto_session(seed=6, mute_first=True))

    # tracks without lanes keep their constant gains bit for bit: a
    # constant-0 volume lane silences track 0 exactly as muting it does
    # (test_fades_automation.py:147-158), through the two kernel variants
    zero = make_demo_session(n_tracks=3, duration_seconds=4.0, seed=8, sample_seconds=1.0)
    zero.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 0.0))
    muted = make_demo_session(n_tracks=3, duration_seconds=4.0, seed=8, sample_seconds=1.0)
    muted.tracks[0].mute = True
    reset_launches()
    a = bounce(zero, RATE, device="cuda").audio
    check(mix_cuda.mix_auto_launches == 1 and mix_cuda.mix_kernel_launches == 0,
          "constant-0 lane session did not take the automation kernel")
    b = bounce(muted, RATE, device="cuda").audio
    check(mix_cuda.mix_kernel_launches == 1, "muted session did not take the plain kernel")
    check(np.array_equal(a, b) and float(np.abs(b).max()) > 0.01,
          "constant-0 volume lane != muted track (tracks without lanes must stay bit-equal)")
    print("[kernel-vs-plain] auto_zero_lane_vs_mute: automation kernel with a constant-0 volume "
          "lane bit-equal to the plain kernel with the track muted")


def _event_ms(torch, fn, iters):
    """Median device ms of ``fn`` over ``iters`` calls, CUDA events around each."""
    from whitebox_tpu_torch.render.metrics import DeviceTimer

    ts = []
    for _ in range(iters):
        with DeviceTimer(torch.device("cuda")) as t:
            fn()
        ts.append(t.seconds * 1e3)
    return statistics.median(ts), ts


#: f32 operations of a resampled slot's sample beyond a copy's, by mode: the
#: double-single phase (17) plus the lerp (3), the Catmull-Rom cubic (19) or
#: six Horner chains of degree 5 and their weighted sum (6 * 10 + 12)
SLOW_OPS = {"linear": 17 + 3, "catmull": 17 + 19, "poly": 17 + 72}


def _event_ms_batch(torch, fn, n):
    """Device ms of one call of ``fn``: CUDA events around ``n`` calls in a
    row after a warm one, over ``n``. The host's part of each call hides
    behind the queued device work while it is the shorter."""
    from whitebox_tpu_torch.render.metrics import DeviceTimer

    fn()
    with DeviceTimer(torch.device("cuda")) as t:
        for _ in range(n):
            fn()
    return t.seconds * 1e3 / n


def card_peaks() -> tuple[float, float]:
    """The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
    bytes/s and f32 operations/s outside the tensor cores, as the port's
    roofline model holds them."""
    from whitebox_tpu_torch.render.roofline import F32_OPS_PER_S, HBM_BYTES_PER_S

    return HBM_BYTES_PER_S, F32_OPS_PER_S


def least_ms(bytes_, ops) -> dict:
    """The larger of bytes over the memory peak and operations over the f32
    peak, in ms, and which of the two bounds it."""
    hbm, f32 = card_peaks()
    t_bytes, t_ops = bytes_ / hbm, ops / f32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound(plan, pool_bytes: int, table_bytes: int, auto=None, per_track: bool = False,
          mode: str = "linear") -> dict:
    """The least time the card could take for one mix of ``plan``: the
    larger of the bytes it must move (each input read once, the output
    written once; ``pool_bytes`` is the pool the kernel reads, extended or
    oversampled where it is) over HBM bandwidth and the f32 operations this
    run's data needs over the f32 peak. Operations counted per covered
    (slot, frame, channel): 5 for a speed-1 slot (gain, 2 envelope
    multiplies, track gain, the add; 4 in the per-track mode, which has no
    track gain), plus :data:`SLOW_OPS` of ``mode`` for a resampled one; per
    automated (track, frame) covered by a slot: 2 lane evaluations of 3
    (divide and lerp), 2 for the pan position, and per channel a sine
    counted as 1 plus 3 multiplies. The per-track mode writes ``[T, C, F]``."""
    import numpy as np

    act = plan.me > plan.ms
    span = np.where(act, plan.me - plan.ms, 0).astype(np.int64)
    slow = plan.is_slow == 1
    C = plan.channels
    ops = C * ((4 if per_track else 5) * int(span.sum()) + SLOW_OPS[mode] * int(span[slow].sum()))
    if auto is not None:
        use = auto["use"].cpu().numpy().astype(bool)
        ops += (3 * 2 + 2 + 4 * C) * int(span[:, use].sum())
    out_bytes = (plan.num_tracks if per_track else 1) * C * plan.n_tiles * plan.tile * 4
    bytes_ = out_bytes + pool_bytes + table_bytes
    return {**least_ms(bytes_, ops), "bound_bytes": bytes_, "bound_ops": ops}


def ext_bound(plan, pool_bytes: int, channels: int) -> dict:
    """The least time the card could take for the prerender's extension as
    it is computed: the f32 operations of its banded products (two per
    multiply-add of each group's einsum, plus the Taylor correction's 5 per
    sample) over the f32 peak, or its bytes (the pool and each group's
    matrix read once, the extension written once) over HBM bandwidth.
    ``banded_flops`` counts the taps alone (32 multiply-adds per sample, 96
    for a Taylor group): what the zeros inside the matrices cost shows as
    the ratio of the two."""
    from whitebox_tpu_torch.timeline import prerender as pre

    flops = banded = mat_bytes = 0
    for kind, Pp, Qp, _, n_sub in plan.groups:
        if kind == "taylor":
            _, _, _, Wb = pre._taylor_matrices(Pp, Qp, plan.taps, plan.atten_db)
            flops += channels * n_sub * Qp * (2 * 3 * Wb + 5)
            banded += channels * n_sub * Qp * (2 * 3 * plan.taps + 5)
            mat_bytes += 3 * Qp * Wb * 4
        else:
            flops += channels * n_sub * pre._QF * Qp * 2 * (Pp + plan.taps)
            banded += channels * n_sub * pre._QF * Qp * 2 * plan.taps
            mat_bytes += Qp * (Pp + plan.taps) * 4
    bytes_ = pool_bytes + mat_bytes + plan.ext_len * 4
    b = least_ms(bytes_, flops)
    return {"ext_bound_ms": b["bound_ms"], "ext_bound_by": b["bound_by"],
            "ext_bound_bytes": bytes_, "ext_matmul_flops": flops, "ext_banded_flops": banded}


def measure_cell(torch, name: str, session, duration: float, automated: bool = False,
                 mode: str = "linear") -> dict:
    """5 warm carve+(lane packing)+(resolve)+plan+upload+kernel iterations
    (samples resident on the card, as bench.py keeps them), the kernel's
    and the plain version's device times by CUDA events, and kernel vs
    plain at full size (bit-equal without lanes, atol/rtol with them; the
    resampling contract in the Catmull-Rom and polynomial modes).

    ``mode`` is the interpolation as the bounce resolves it: "linear",
    "catmull", "poly" (``interpolation="sinc", prerender=False``: each
    iteration oversamples the resampled samples on the host and finds the
    4x pool on the card by its hash) or "prerender"
    (``interpolation="sinc"``: each iteration plans the prerender on the
    host and builds the pool extension on the card, then mixes speed-1
    rows over it with the linear kernel)."""

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
    from whitebox_tpu_torch.timeline import prerender as pre
    from whitebox_tpu_torch.timeline.carve import carve_session
    from whitebox_tpu_torch.timeline.oversample import device_pool_cached

    def lanes():
        return prepare_automation_tables_host(session, RATE) if automated else None

    def resolve(table, pool, base_dev):
        """-> (table, pool, interp, pool on the card, prerender plan)"""
        if mode == "prerender":
            pplan = pre.plan_prerender(table, pool, partial=True)
            check(pplan is not None and pplan.uncovered_rows is None,
                  f"{name}: the prerender does not cover every run")
            t2, p2, full = pre.apply_prerender_device(table, pool, pplan, pool_device=base_dev)
            return t2, p2, "linear", full, pplan
        t2, p2, interp = resolve_mode(table, pool, mode)
        return t2, p2, interp, base_dev if p2 is pool else device_pool_cached(p2, base_dev.device), None

    slots = 16 if mode == "poly" else 8
    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    base_dev = torch.from_numpy(pool.data).to("cuda")
    t2, p2, interp, pool_dev, pplan = resolve(table, pool, base_dev)
    warm = mix_cuda.CudaMixRenderer(t2, p2, session, device="cuda", auto_tables=lanes(), interp=interp,
                                    pool_device=pool_dev,
                                    plan=build_plan(t2, p2, session, max_slots=slots))
    del t2, p2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, ext_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_, p_ = carve_session(session, RATE, buffer_size=512, pool=pool, slow_emit="runs")
        t1 = time.perf_counter()
        auto_tables = lanes()
        t2 = time.perf_counter()
        t_, p_, interp_, pool_dev_, pplan_ = resolve(t_, p_, base_dev)
        t3 = time.perf_counter()
        plan = build_plan(t_, p_, session, max_slots=slots)
        t4 = time.perf_counter()
        r = mix_cuda.CudaMixRenderer(t_, p_, session, device="cuda", plan=plan, interp=interp_,
                                     pool_device=pool_dev_, auto_tables=auto_tables)
        t5 = time.perf_counter()
        r.render_device()
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5, t6 - t0))
        if pplan_ is not None:
            ext_ms.append(pplan_.ext_seconds * 1e3)
        del r, pool_dev_
    carve_s, lanes_s, resolve_s, plan_s, upload_s, launch_s, e2e_med = (
        statistics.median(c) for c in zip(*rows))
    e2e_best = min(row[-1] for row in rows)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p = warm.plan
    args = (warm.pool_device, warm.tables, p.n_tiles, p.tile, p.channels)
    if automated:
        def kernel():
            return mix_cuda.mix_auto_cuda(warm.pool_device, warm.tables, warm.auto, *args[2:], interp=interp)

        def plain():
            return mix_cuda.mix_auto_reference(warm.pool_device, warm.tables, warm.auto, *args[2:],
                                               interp=interp)
    else:
        def kernel():
            return mix_cuda.mix_cuda(*args, interp=interp)

        def plain():
            return mix_cuda.mix_reference(*args, interp=interp)
    kernel_ms, kernel_all = _event_ms(torch, kernel, 20)
    plain_ms, _ = _event_ms(torch, plain, 3)
    got, ref = kernel(), plain()
    max_abs = float((got - ref).abs().max())
    if automated:
        check(torch.allclose(got, ref, atol=AUTO_ATOL, rtol=AUTO_RTOL),
              f"{name}: automation kernel vs plain max abs {max_abs:.3g}")
    elif mode in ("catmull", "poly"):
        ok, ku, ka = ulp_contract(got.cpu().numpy(), ref.cpu().numpy())
        check(ok, f"{name}: {mode} kernel {ku} ulp / {ka:.3g} abs off its plain version")
    else:
        check(torch.equal(got, ref), f"{name}: kernel != plain version (max abs {max_abs:.3g})")
    table_bytes = sum(t.numel() * t.element_size() for t in warm.tables.values())
    if automated:
        table_bytes += sum(t.numel() * t.element_size() for t in warm.auto.values())
    pool_bytes = warm.pool_device.numel() * 4
    stats = {
        "cell": name, "mode": mode, "tracks": p.num_tracks, "audio_seconds": duration,
        "frames": int(p.total_frames), "tile": p.tile, "n_tiles": p.n_tiles, "K": p.max_slots,
        "active_slots": int((p.me > p.ms).sum()),
        "slow_slots": int(((p.me > p.ms) & (p.is_slow == 1)).sum()), **kept_slots(p),
        "pool_mb": pool_bytes / 1e6,
        "e2e_ms_median": e2e_med * 1e3, "e2e_ms_best": e2e_best * 1e3,
        "rtf_median": duration / e2e_med, "rtf_best": duration / e2e_best,
        "carve_ms": carve_s * 1e3, "lanes_ms": lanes_s * 1e3, "resolve_ms": resolve_s * 1e3,
        "plan_ms": plan_s * 1e3, "upload_ms": upload_s * 1e3,
        "launch_to_sync_ms": launch_s * 1e3,
        "kernel_ms_median": kernel_ms, "kernel_ms_min": min(kernel_all), "plain_ms_median": plain_ms,
        "output_gb_per_s": got.numel() * 4 / (kernel_ms * 1e-3) / 1e9,
        "kernel_vs_plain_max_abs": max_abs, "peak_mem_gb": peak_gb,
        **bound(p, pool_bytes, table_bytes, warm.auto, mode="linear" if mode == "prerender" else mode),
    }
    if automated:
        stats["lane_points"] = int(warm.auto["vxs"].shape[1])
    if pplan is not None:
        # resolve_ms holds the host plan and the extension's build (which
        # waits for the card); prerender_ms is the build's device time
        stats.update(prerender_ms=statistics.median(ext_ms), prerender_runs=len(pplan.runs),
                     prerender_groups=[list(g[:3]) + [g[4]] for g in pplan.groups],
                     ext_mb=pplan.ext_len * 4 / 1e6,
                     **ext_bound(pplan, pool.data.nbytes, p.channels))
    print(f"[{name}] " + json.dumps(stats))
    return stats


def _kernel_entry(cell: dict, launches: int) -> dict:
    return {"launches": launches, "max_abs_err": cell["kernel_vs_plain_max_abs"],
            "ms": cell["kernel_ms_median"], "plain_ms": cell["plain_ms_median"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
            # no single PyTorch call computes the slot mix
            "library_ms": None}


def gather_bound(torch, tables, pool, frames: int, form: str, mode: str = "linear") -> dict:
    """The least time the card could take for the gather mix of ``frames``
    frames in ``form``: the larger of the bytes it must move (the pool and
    the tables read once, the output written once: ``[T, C, frames]`` per
    track, ``[C, frames]`` summed) over HBM bandwidth and the f32 operations
    this run's rows need over the f32 peak. Operations per covered (track,
    frame, channel) as :func:`bound` counts them for a covering slot: 4 in
    the per-track form, 5 summed, plus :data:`SLOW_OPS` of ``mode`` on a
    resampled row; the row search, the rows' loads and the uncovered
    frames' zeros are overhead."""
    length = tables["length"].to(torch.int64)
    slow = ~tables["fast"]
    T, _, C = tables["src_base"].shape
    covered, resampled = int(length.sum()), int(length[slow].sum())
    per_track = form == "per_track"
    ops = C * ((4 if per_track else 5) * covered + SLOW_OPS[mode] * resampled)
    table_bytes = sum(v.numel() * v.element_size() for v in tables.values())
    bytes_ = (T if per_track else 1) * C * frames * 4 + pool.numel() * 4 + table_bytes
    return {**least_ms(bytes_, ops), "bound_bytes": bytes_, "bound_ops": ops}


def gather_cell(torch, name: str, session, chunk: int = 1 << 17, iters: int = 5) -> dict:
    """The gather kernel at the main path's shapes: the whole session in
    ``bounce``'s chunks of ``chunk`` frames, each form timed by CUDA events
    around ``iters`` renders after a warm one, the plain version's time once
    (for the record: it repeats the kernel's arithmetic in ~100 torch ops a
    chunk), the largest difference of the two, the bound -> {form: entry}."""
    from whitebox_tpu_torch.ops import gather_cuda, mix

    pool, tables, F, bank, interp = gather_inputs(torch, session)
    starts = range(0, F, chunk)
    out = {}
    for form in GATHER_FORMS:
        err = 0.0
        for a in starts:
            k = gather_cuda.gather_mix_cuda(pool, tables, a, chunk, form)
            p = mix.gather_plain(pool, tables, a, chunk, form)
            err = max(err, float((k - p).abs().max()))
            check(same_bits(torch, k, p), f"{name} {form} [{a}, +{chunk}): kernel != plain version")
        del k, p

        def kernel():
            for a in starts:
                gather_cuda.gather_mix_cuda(pool, tables, a, chunk, form)

        def plain():
            for a in starts:
                mix.gather_plain(pool, tables, a, chunk, form)
        ms = _event_ms_batch(torch, kernel, iters)
        plain_ms = _event_ms(torch, plain, 1)[0]
        b = gather_bound(torch, tables, pool, len(starts) * chunk, form)
        out[form] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"],
                     # no PyTorch call computes the gather mix (searchsorted and
                     # the gathers are pieces of it)
                     "library_ms": None, "bound_bytes": b["bound_bytes"], "bound_ops": b["bound_ops"],
                     "chunks": len(starts), "chunk": chunk}
        smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
        print(f"[gather-kernel] {name} {form} ({smi}): {len(starts)} chunks of {chunk}, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.2f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
              f"x{ms / b['bound_ms']:.1f} the bound, bit-equal (max abs {err})")
    return out


def phase_headline(torch) -> dict:
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.demo import make_demo_session
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

    duration, n_tracks = 60.0, 128
    session = make_demo_session(n_tracks=n_tracks, duration_seconds=duration,
                                sample_rate=int(RATE), seed=7)

    # the main path, through the entry point a user calls
    reset_launches()
    res = bounce(session, RATE, device="cuda")
    launches = mix_cuda.mix_kernel_launches
    check(launches > 0, "bounce never launched the CUDA mix kernel")
    check(mix_cuda.mix_auto_launches == 0, "a session without lanes took the automation kernel")
    print(f"[headline] bounce(device='cuda'): {res.stats.summary()}; mix kernel launches={launches}")

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    ref = render_segments_numpy(table, pool, session)
    check(res.audio.shape == ref.shape and np.isfinite(res.audio).all(), "headline shape/finite")
    check(np.array_equal(res.audio, ref), "headline bounce != render_segments_numpy")
    print(f"[headline] audio {res.audio.shape} bit-equal to render_segments_numpy "
          f"(peak {float(np.abs(res.audio).max()):.4f})")

    # the same session through the gather path (engine="xla"): no slot-plan
    # kernel, the gather kernel once a chunk, bit-equal to the kernel's headline
    reset_launches()
    xr = bounce(session, RATE, device="cuda", engine="xla")
    xla_launches = mix_launches()
    check(xr.stats.mix_path == "gather" and not any(xla_launches.values()),
          f"headline (xla): path {xr.stats.mix_path}, mix launches {xla_launches}")
    gk = check_gather_launches("headline (xla)", xr.stats.gather_chunks, forms=("sum",))
    check(np.array_equal(xr.audio, res.audio), "headline: the gather path != the kernel's bounce")
    gather_ms = []
    for _ in range(3):
        gather_ms.append(bounce(session, RATE, device="cuda", engine="xla").stats.device_seconds * 1e3)
    cost = xr.stats.cost
    forms = gather_cell(torch, "headline", session)
    gather = {"gather_ms_median": statistics.median(gather_ms), "gather_ms_all": gather_ms,
              "gather_cost_bound_ms": least_ms(cost.hbm_bytes, cost.mxu_flops)["bound_ms"],
              "gather_bound_ms": {f: forms[f]["bound_ms"] for f in forms},
              "gather_kernel_ms": {f: forms[f]["ms"] for f in forms},
              "gather_plain_ms": {f: forms[f]["plain_ms"] for f in forms},
              "gather_cost_bytes": cost.hbm_bytes, "gather_carve_pack_ms": xr.stats.carve_seconds * 1e3,
              "gather_chunks": xr.stats.gather_chunks, "gather_launches": gk}
    print(f"[headline] bounce(device='cuda', engine='xla'): gather path, 0 slot-plan kernel launches, "
          f"{gk['sum']} gather-kernel launches for {xr.stats.gather_chunks} chunks, bit-equal to the "
          f"kernel's bounce; {xr.stats.summary()}; " + json.dumps(gather))
    for f in forms:
        forms[f]["launches"] = gk[f]

    k = measure_cell(torch, "headline", session, duration)
    print("[headline] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                              "temperature.gpu", "--format=csv,noheader"]))

    # the same session with linear-resampled clips (a 44.1 kHz source in a
    # 48 kHz session): the plan's slow path and the kernel's phase + lerp
    resampled = make_demo_session(n_tracks=n_tracks, duration_seconds=duration,
                                  sample_rate=int(RATE), seed=7, clip_speeds=(1.0, 44100 / 48000))
    measure_cell(torch, "headline_resampled", resampled, duration)
    return _kernel_entry(k, launches), xla_launches, forms


def automation_cell(torch, name: str, session, duration: float,
                    reference_seconds=None) -> tuple[dict, int]:
    """``bounce(device="cuda")`` of an automated session with the launch
    counts reset just before, held to the f64 host reference (of the first
    ``reference_seconds`` of the session where given: the reference is
    per-sample Python on the host), then timed at full length."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce

    reset_launches()
    res = bounce(session, RATE, device="cuda")
    launches = mix_cuda.mix_auto_launches
    check(launches > 0, f"{name}: bounce never launched the automation kernel")
    check(mix_cuda.mix_kernel_launches == 0, f"{name}: an automated session took the plain kernel")
    t0 = time.perf_counter()
    ref = host_reference(session, seconds=reference_seconds)
    ref_s = time.perf_counter() - t0
    check(res.audio.shape[0] == ref.shape[0] and 0 < ref.shape[1] <= res.audio.shape[1]
          and (reference_seconds is not None or ref.shape == res.audio.shape)
          and np.isfinite(res.audio).all(), f"{name}: shape/finite")
    rr = rel_rms(res.audio[:, : ref.shape[1]], ref)
    check(rr < AUTO_REL_RMS, f"{name}: relative RMS {rr:.3g} off the f64 host reference")
    check(float(np.abs(res.audio).max()) > 0.01, f"{name}: silent render")
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; automation kernel "
          f"launches={launches}; vs f64 host reference relative RMS {rr:.3g} over "
          f"{'the whole session' if reference_seconds is None else f'its first {reference_seconds:g} s'} "
          f"(reference {ref_s:.1f} s on the host)")
    return measure_cell(torch, name, session, duration, automated=True), launches


def phase_automation(torch) -> dict:
    automation_cell(torch, "automation_32trk", automation_32trk(), 60.0)
    k, launches = automation_cell(torch, "automation_tempo_128trk", automation_tempo_128trk(), 60.0,
                                  reference_seconds=15.0)
    return _kernel_entry(k, launches)


#: the JAX package's bars against the f64 reference (tests/test_effects.py:83,
#: tests/test_effects_pipeline.py:43,91,98): scan and FIR relative RMS, and
#: scan vs FIR absolute
SCAN_REL_RMS, FIR_REL_RMS, SCAN_FIR_ATOL = 5e-5, 2e-4, 5e-4


def _run_chain_sosfilt(chain, x, sample_rate: float):
    """A prepared LTI chain on ``x`` ``[C, F]`` f64 by ``scipy.signal.sosfilt``
    (transposed direct form II in f64, a C loop) -> f64."""
    import numpy as np
    from scipy.signal import sosfilt

    from whitebox_tpu_torch.effects import Biquad, Gain, ParametricEQ

    if chain is None:
        return x
    chain.prepare(sample_rate, x.shape[0])
    for e in chain.effects:
        if isinstance(e, Gain):
            x = x * float(e.gain_linear)
            continue
        secs = [e.coeffs] if isinstance(e, Biquad) else list(e.coeffs) if isinstance(e, ParametricEQ) else None
        check(secs is not None, f"no f64 reference for effect {e!r}")
        sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in secs], dtype=np.float64)
        x = sosfilt(sos, x, axis=-1)
    return x


def effects_reference(session, per_track_dev, table, pool):
    """The f64 reference of an effects bounce at full width, track by track
    to bound host memory: each track's per-track kernel buffer read back,
    held bit-equal to ``render_segments_per_track_numpy``, filtered by its
    chain in f64 (sosfilt), times its constant f32 fader gain, summed in
    f64; then the master chain, the clip and one rounding to f32 (the
    arithmetic of ``reference_finish_mix``, whose per-sample Python filter
    cannot take 128 x 2 x 2.88 M frames)."""
    import numpy as np

    from whitebox_tpu_torch.render.effects_pipeline import _chains_of
    from whitebox_tpu_torch.timeline.carve import render_segments_per_track_numpy

    check(not any(t.automation is not None for t in session.tracks), "lanes need reference_finish_mix")
    pt_ref = render_segments_per_track_numpy(table, pool)
    T, C, F = pt_ref.shape
    chains, master = _chains_of(session)
    total = np.zeros((C, F), dtype=np.float64)
    for t, track in enumerate(session.tracks):
        buf = per_track_dev[t, :, :F].cpu().numpy()
        check(np.array_equal(buf, pt_ref[t]),
              f"track {t}: per-track kernel != render_segments_per_track_numpy")
        y = _run_chain_sosfilt(chains[t], buf.astype(np.float64), RATE)
        vol = np.float32(0.0) if track.mute else track.volume_linear
        pan = track.pan_coeffs
        for ch in range(C):
            total[ch] += y[ch] * float(np.float32(vol * np.float32(pan[ch % 2])))
    total = _run_chain_sosfilt(master, total, RATE)
    return np.clip(total, -1.0, 1.0).astype(np.float32)


#: the cascade kernel against its plain version (the per-section Hillis
#: scan), relative RMS per row: both round in f32, in different orders
CASCADE_REL_RMS = 5e-6


def cascade_rows(chains):
    """``[9, S, B, 1]`` f32 coefficients of one chain of sections per row."""
    import numpy as np

    from whitebox_tpu_torch.ops.biquad import eig_section_params

    c = np.zeros((9, len(chains[0]), len(chains), 1), np.float32)
    for r, secs in enumerate(chains):
        for k, sec in enumerate(secs):
            c[:, k, r, 0] = eig_section_params(sec)
    return c


def row_rel_rms(got, ref):
    """Relative RMS of each row of ``got`` against ``ref`` ([B, F] tensors)."""
    d = (got.double() - ref.double()).pow(2).mean(dim=1).sqrt()
    return (d / ref.double().pow(2).mean(dim=1).sqrt().clamp_min(1e-30)).cpu().numpy()


def cascade_vs_plain(name, torch, x, coeffs, states, pieces=(None,), host_model=False):
    """The cascade kernel on ``x`` [B, F] (in calls over the frame ranges
    ``pieces`` splits it at, each handing its states to the next) against
    the plain version in one call: relative RMS per row, states out; with
    ``host_model``, also against the torch model of the blocked recurrence
    (the same f32 operations in the same order). Prints the kernel's time
    for the calls (CUDA events, median of 5). -> (max row rel RMS, max abs)"""
    from whitebox_tpu_torch.ops import biquad_cuda

    before = biquad_cuda.biquad_cascade_launches
    edges = [0, *[p for p in pieces if p is not None], x.shape[1]]

    def calls():
        ys, st = [], states
        for a, b in zip(edges, edges[1:]):
            y, st = biquad_cuda.biquad_cascade(x[:, a:b], coeffs, st)
            ys.append(y)
        return ys, st
    ys, st = calls()
    got = torch.cat(ys, dim=1)
    check(biquad_cuda.biquad_cascade_launches == before + len(edges) - 1,
          f"{name}: the cascade kernel did not launch")
    ms, _ = _event_ms(torch, calls, 5)
    ref, ref_st = biquad_cuda.biquad_cascade_reference(x, coeffs, states)
    torch.cuda.synchronize()
    rr = row_rel_rms(got, ref)
    max_abs = float((got - ref).abs().max())
    check(bool((rr < CASCADE_REL_RMS).all()), f"{name}: cascade kernel rows {rr.max():.3g} relative RMS "
          f"off the plain scan (bar {CASCADE_REL_RMS})")
    st_err = max(float((a - b).abs().max()) for a, b in zip(st, ref_st))
    scale = max(float(b.abs().max()) for b in ref_st)
    check(st_err <= 1e-4 * scale + 1e-6, f"{name}: states out {st_err:.3g} off the plain scan's")
    note = ""
    if host_model:
        model, _ = biquad_cuda.biquad_cascade_blocked(x.cpu(), coeffs.cpu(), [q.cpu() for q in states])
        note = f"; vs the host model of the blocked recurrence max abs {float((got.cpu() - model).abs().max()):.3g}"
    l = biquad_cuda.block_frames(*x.shape)
    print(f"[cascade-vs-plain] {name}: rows={x.shape[0]} frames={x.shape[1]} sections={coeffs.shape[1]} "
          f"calls={len(edges) - 1} sub-block {l} max row relative RMS {rr.max():.3g} (< {CASCADE_REL_RMS}), "
          f"max abs {max_abs:.3g}, states out {st_err:.3g}{note}; kernel {ms:.4f} ms")
    return float(rr.max()), max_abs


def phase_cascade_small(torch) -> None:
    """The cascade kernel on small rows: EQ bands, the 25 Hz highpass
    (poles at radius 0.9977), FIR and gain sections, identity rows (exact),
    ragged last blocks, a state handed in and out over two calls, a
    six-section chain (two groups of sections) and one shorter than a
    block."""
    import numpy as np

    from whitebox_tpu_torch.ops.biquad import IDENTITY_COEFFS, BiquadCoeffs, design_biquad
    from whitebox_tpu_torch.ops import biquad_cuda

    def d(ftype, freq, *rest):
        return design_biquad(ftype, freq, RATE, *rest)

    chains = [[d("lowshelf", 100.0, 0.707, 2.0), d("peak", 1000.0, 1.0, -1.5), d("highshelf", 8000.0, 0.707, 1.0)],
              [d("highpass", 25.0), d("lowpass", 200.0, 4.0), IDENTITY_COEFFS],
              [IDENTITY_COEFFS] * 3,
              [BiquadCoeffs(0.5, 0.0, 0.0, 0.0, 0.0), BiquadCoeffs(0.3, 0.2, 0.1, 0.0, 0.0), d("notch", 3000.0, 4.0)],
              [d("highpass", 30.0, 0.6), d("bandpass", 5000.0, 2.0), d("allpass", 40.0, 0.6)]]
    rng = np.random.default_rng(31)
    coeffs = torch.from_numpy(cascade_rows(chains)).cuda()
    x = torch.from_numpy((rng.standard_normal((5, 50000)) * 0.3).astype(np.float32)).cuda()
    zero = [torch.zeros((5, 2), device="cuda") for _ in range(3)]
    cascade_vs_plain("eq_highpass_fir_identity_rows", torch, x, coeffs, zero, host_model=True)
    y, _ = biquad_cuda.biquad_cascade(x, coeffs, zero)
    check(torch.equal(y[2], x[2]), "identity row: the cascade kernel changed its input")
    carried = [torch.from_numpy(rng.standard_normal((5, 2)).astype(np.float32) * 0.1).cuda() for _ in range(3)]
    cascade_vs_plain("state_over_two_calls", torch, x, coeffs, carried, pieces=(20000,), host_model=True)
    six = torch.from_numpy(cascade_rows([c + c[::-1] for c in chains])).cuda()
    cascade_vs_plain("six_sections_two_groups", torch, x, six, zero * 2)
    cascade_vs_plain("shorter_than_a_block", torch, x[:, :700].contiguous(), coeffs, carried)
    # an unaligned row-strided view (4-byte copies in, 4-byte stores out: 49,999 frames)
    cascade_vs_plain("unaligned_view", torch, x[:, 1:], coeffs, carried, host_model=True)
    # 40 rows take 128-frame sub-blocks: 25 tiles a row, the look-back over them
    many = torch.from_numpy(cascade_rows(chains * 8)).cuda()
    x40 = torch.from_numpy((rng.standard_normal((40, 100000)) * 0.3).astype(np.float32)).cuda()
    st40 = [torch.from_numpy(rng.standard_normal((40, 2)).astype(np.float32) * 0.1).cuda() for _ in range(3)]
    cascade_vs_plain("forty_rows_many_tiles", torch, x40, many, st40, pieces=(61440,), host_model=True)


#: the dynamics kernel against the f64 oracle (``dynamics_cuda.ballistics_f64``:
#: the plain scans in f64; for a fused stage its torch form on those scans),
#: relative RMS per row (the cascade's bar); against its plain version (the
#: f32 Hillis scans) this plus the plain version's own distance from the
#: oracle, which reaches ~6e-6 over a 2^18-frame chunk
DYNAMICS_REL_RMS = 5e-6
#: frames of the dynamics paths' chunks (``CUDA_CHUNK_CAP``), the shape the
#: timed cases of :func:`phase_dynamics_small` take
DYNAMICS_PATH_FRAMES = 1 << 18


def dynamics_bound(B: int, F: int, framewise: int, max_decay: bool = True) -> dict:
    """The unfused dynamics kernel's least time on ``[B, F]``: v read and y
    written once (4 B a frame each, 4 B more per frame-wise coefficient row),
    its f32 operations (``OPS_PER_FRAME`` a frame; the one-pole alone 4)."""
    from whitebox_tpu_torch.ops.dynamics_cuda import OPS_PER_FRAME

    return least_ms(B * F * 4 * (2 + framewise), B * F * (OPS_PER_FRAME if max_decay else 4))


def fused_bound(kind: str, B: int, C: int, F: int, *, key: bool = False, lanes: int = 0, lookahead: int = 0,
                detector: str = "peak") -> dict:
    """A fused dynamics stage's least time on ``[B, C, F]``: x (and the key)
    read and the output written once (4 B a sample each), each per-frame
    lane read once (4 B a frame), the states in and out (3 floats a row
    each way; the limiter's look and xdelay, ``L (1 + C)`` floats a row each
    way); its f32 operations (``dynamics_cuda.FUSED_OPS`` of the kind, the
    ballistics' ``OPS_PER_FRAME``, 3 a channel and, with a lookahead, a max
    per doubling pass of the window, a frame)."""
    import math

    from whitebox_tpu_torch.ops.dynamics_cuda import FUSED_OPS, OPS_PER_FRAME

    ops = FUSED_OPS["compressor_rms" if kind == "compressor" and detector == "rms" else kind] + OPS_PER_FRAME + 3 * C
    if kind == "limiter" and lookahead:
        ops += int(math.ceil(math.log2(lookahead + 1)))
    state = 3 + (lookahead * (1 + C) if kind == "limiter" else 0)
    return least_ms(B * F * 4 * (C * (2 + int(key)) + lanes) + B * 4 * 2 * state, B * F * ops)


def _frames_of(c, F) -> bool:
    import torch

    return torch.is_tensor(c) and c.dim() > 0 and c.shape[-1] == F and F > 1


def dynamics_vs_plain(name, torch, v, rho, a, e0, y0, floor=None, pieces=(None,), onepole=False,
                      host_model=False, time_it=True) -> dict:
    """The unfused dynamics kernel (``dynamics_cuda.ballistics`` /
    ``onepole``) on ``v`` [B, F] (in calls over the frame ranges ``pieces``
    splits it at, each handing its states to the next) against the f64
    oracle (the plain scans in f64, one call) within
    :data:`DYNAMICS_REL_RMS` relative RMS per row, its states out within
    5e-6 of the oracle's scale; against the plain version (the f32 Hillis
    scans, one call) within that bar plus the plain version's own distance
    from the oracle, row by row (all three printed); a second run bit-equal
    to the first; with ``host_model``, bit-equal to the torch model of the
    kernel's tiles and look-back on the host; the kernel's time by CUDA
    events around the launch alone (one call over all frames, prepared
    once: 20 in a row, and the median of 20 each bracketed) and around the
    wrapper, its plain version's and its bound. ``onepole``: the RMS detector's one-pole alone over v."""
    from whitebox_tpu_torch.ops import dynamics_cuda as dc

    before = dc.dynamics_scan_launches
    F = v.shape[-1]
    edges = [0, *[p for p in pieces if p is not None], F]

    def part(c, a0, b0):
        return c[..., a0:b0] if _frames_of(c, F) else c

    def calls():
        ys, es, yl = [], e0, y0
        for a0, b0 in zip(edges, edges[1:]):
            if onepole:
                y, yl = dc.onepole(v[..., a0:b0], part(a, a0, b0), yl)
            else:
                fl = None if floor is None else part(floor, a0, b0)
                y, es, yl = dc.ballistics(v[..., a0:b0], part(rho, a0, b0), part(a, a0, b0), es, yl, fl)
            ys.append(y)
        return torch.cat(ys, dim=-1), es, yl
    got, e_last, y_last = calls()
    check(dc.dynamics_scan_launches == before + len(edges) - 1, f"{name}: the dynamics kernel did not launch")
    again = calls()
    plain = dc.onepole_reference(v, a, y0)[0] if onepole else dc.ballistics_reference(v, rho, a, e0, y0, floor)[0]
    ref, ref_e, ref_y = dc.ballistics_f64(v, rho, a, 0.0 if onepole else e0, y0, floor, max_decay=not onepole)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.shape == v.shape, f"{name}: output {tuple(got.shape)}")
    check(torch.equal(got, again[0]) and torch.equal(y_last, again[2])
          and (onepole or torch.equal(e_last, again[1])), f"{name}: two runs of the dynamics kernel differ")
    rows2 = (-1, F)
    rr = row_rel_rms(got.reshape(rows2), ref.reshape(rows2))
    rr_plain = row_rel_rms(got.reshape(rows2), plain.reshape(rows2))
    rr_plain_f64 = row_rel_rms(plain.reshape(rows2), ref.reshape(rows2))
    max_abs = float((got - plain).abs().max())
    check(bool((rr < DYNAMICS_REL_RMS).all()), f"{name}: dynamics kernel rows {rr.max():.3g} relative RMS off "
          f"the f64 oracle (bar {DYNAMICS_REL_RMS})")
    check(bool((rr_plain <= rr_plain_f64 + DYNAMICS_REL_RMS).all()),
          f"{name}: dynamics kernel rows {rr_plain.max():.3g} relative RMS off the plain scans, which are "
          f"{rr_plain_f64.max():.3g} off the f64 oracle (bar {DYNAMICS_REL_RMS} + that)")
    pairs = [(y_last, ref_y)] + ([] if onepole else [(e_last, ref_e)])
    st_err = max(float((g.double() - r).abs().max()) for g, r in pairs)
    scale = max(float(r.abs().max()) for _, r in pairs)
    check(st_err <= DYNAMICS_REL_RMS * scale + 1e-6, f"{name}: states out {st_err:.3g} off the f64 oracle's")
    out = {"rows": int(v.numel() // F), "frames": F, "calls": len(edges) - 1,
           "max_row_rel_rms_vs_f64": float(rr.max()), "max_row_rel_rms_vs_plain": float(rr_plain.max()),
           "plain_max_row_rel_rms_vs_f64": float(rr_plain_f64.max()), "max_abs_err": max_abs,
           "states_err_vs_f64": st_err, "two_runs_bit_equal": True}
    if host_model:
        v2 = v.reshape(-1, F).cpu()

        def rows(c):
            t = torch.as_tensor(c, dtype=torch.float32, device=v.device)
            return torch.broadcast_to(t, v.shape[:-1] + (t.shape[-1] if _frames_of(c, F) else 1,)) \
                .reshape(v2.shape[0], -1).cpu()

        def state(c):
            return torch.as_tensor(c, dtype=torch.float32, device=v.device).reshape(-1).cpu()
        ys, ye, yl = [], state(0.0 if onepole else e0), state(y0)
        for a0, b0 in zip(edges, edges[1:]):  # the model over the same calls, states handed on
            cut = (lambda c: None if c is None else (c[:, a0:b0] if c.shape[-1] == F and F > 1 else c))
            y, e_m, yl, _ = dc.ballistics_model(v2[:, a0:b0], None if onepole else cut(rows(rho)), cut(rows(a)), ye,
                                                yl, None if floor is None else cut(rows(floor)),
                                                max_decay=not onepole)
            ye = ye if onepole else e_m
            ys.append(y)
        model = torch.cat(ys, dim=-1)
        out["vs_host_model_max_abs"] = float((got.reshape(-1, F).cpu() - model).abs().max())
        check(out["vs_host_model_max_abs"] == 0.0 and torch.equal(y_last.reshape(-1).cpu(), yl),
              f"{name}: the dynamics kernel is {out['vs_host_model_max_abs']:.3g} off its host model (bit-equal "
              "expected)")
    if time_it:
        framewise = sum(1 for c in ((a,) if onepole else (rho, a, floor)) if c is not None and _frames_of(c, F))
        call = dc.prepare_scan(v, rho, a, 0.0 if onepole else e0, y0, floor, max_decay=not onepole)
        out["ms"] = _event_ms_batch(torch, call, 20)  # the launch alone, 20 in a row
        out["ms_each"], _ = _event_ms(torch, call, 20)  # each bracketed by its own events
        out["wrapper_ms"], _ = _event_ms(torch, calls, 20)
        plain = (lambda: dc.onepole_reference(v, a, y0)) if onepole else \
            (lambda: dc.ballistics_reference(v, rho, a, e0, y0, floor))
        out["plain_ms"], _ = _event_ms(torch, plain, 3)
        out.update(dynamics_bound(out["rows"], F, framewise, not onepole))
        out["sub_frames"] = dc.sub_frames(out["rows"], F)
    print(f"[dynamics-vs-plain] {name}: " + json.dumps(out))
    return out


def _stage_ref(kind, x, params, kw, row):
    """The f64 sequential reference (``ops/dynamics.py::*_ref``) of row
    ``row`` of a stage on ``x`` [B, C, F] with ``params`` [B, 1] / [B, F]."""
    import numpy as np

    from whitebox_tpu_torch.ops import dynamics as dyn

    F = x.shape[-1]

    def prm(name, default=0.0):
        c = params.get(name, default)
        t = torch_row(c, row, F)
        return t

    def torch_row(c, r, F):
        if not hasattr(c, "shape") or c.dim() == 0:
            return float(c)
        c = c.reshape(-1, c.shape[-1])
        c = c[r if c.shape[0] > 1 else 0]
        return c.cpu().double().numpy() if c.shape[-1] == F and F > 1 else float(c[0])
    xr = x[row].cpu().double().numpy()
    key = kw.get("key")
    key = key[row].cpu().double().numpy() if key is not None else (np.zeros_like(xr) if kw.get("silent_key")
                                                                    else None)
    if kind == "compressor":
        return dyn.compressor_ref(xr, threshold_db=prm("threshold_db"), ratio=prm("ratio"), knee_db=prm("knee_db"),
                                  attack=prm("attack"), release=prm("release"), makeup_db=prm("makeup_db"),
                                  detector=kw.get("detector", "peak"), det_avg=prm("det_avg"), key=key)
    if kind == "limiter":
        return dyn.limiter_ref(xr, ceiling_db=prm("ceiling_db"), attack=prm("attack"), release=prm("release"),
                               lookahead=kw.get("lookahead", 0))
    return dyn.gate_ref(xr, threshold_db=prm("threshold_db"), range_db=prm("range_db"), attack=prm("attack"),
                        release=prm("release"), hysteresis_db=prm("hyst_db"), key=key)


def fused_vs_plain(name, torch, kind, x, params, state, pieces=(None,), host_model=False, ref_rows=(),
                   ref_bar=5e-5, time_it=True, **kw) -> dict:
    """A fused dynamics stage (``ops/dynamics.py``'s processor of ``kind``:
    one launch of the kernel a call) on ``x`` [B, C, F] (in calls over the
    frame ranges ``pieces`` splits it at, each handing its states to the
    next) against its oracle (its torch form on the scans in f64, one call)
    within :data:`DYNAMICS_REL_RMS` relative RMS per row and its states out
    within 5e-6 of the oracle's scale; against its plain version (the torch
    form on the f32 Hillis scans, one call) within that bar plus the plain
    version's own distance from the oracle; a second run bit-equal; with
    ``host_model``, against the torch model of the kernel on the host
    (``dynamics_cuda.stage_model``, which shares its elementwise math with
    the host's libm: within 1e-6 relative RMS, bit-equality printed); from
    zero states, the rows ``ref_rows`` against the f64 sequential
    references within ``ref_bar``; the launch alone by CUDA events (prepared
    once: 20 in a row, and the median of 20 each bracketed), the plain
    version's time and the stage's bound (:func:`fused_bound`)."""
    import numpy as np

    from whitebox_tpu_torch.ops import dynamics as dyn
    from whitebox_tpu_torch.ops import dynamics_cuda as dc

    proc = {"compressor": dyn.compressor_process, "limiter": dyn.limiter_process, "gate": dyn.gate_process}[kind]
    B, C, F = x.shape
    edges = [0, *[p for p in pieces if p is not None], F]

    def part(c, a0, b0):
        return c[..., a0:b0] if _frames_of(c, F) else c

    def calls():
        ys, st = [], state
        for a0, b0 in zip(edges, edges[1:]):
            y, st = proc(x[..., a0:b0], {k: part(c, a0, b0) for k, c in params.items()}, st,
                         **{k: part(c, a0, b0) for k, c in kw.items()})
            ys.append(y)
        return torch.cat(ys, dim=-1), st
    before = dc.dynamics_fused_launches
    got, st = calls()
    check(dc.dynamics_fused_launches == before + len(edges) - 1, f"{name}: the fused dynamics kernel did not launch")
    again, st2 = calls()
    plain, _ = dc.stage_torch(kind, x, params, state, **kw)
    oracle, ost = dc.stage_torch(kind, x, params, state, dc.oracle_scans(), **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.shape == x.shape, f"{name}: output {tuple(got.shape)}")
    check(torch.equal(got, again) and all(torch.equal(st[k], st2[k]) for k in st),
          f"{name}: two runs of the fused dynamics kernel differ")
    rows = (-1, C * F)
    rr = row_rel_rms(got.reshape(rows), oracle.reshape(rows))
    rr_plain = row_rel_rms(got.reshape(rows), plain.reshape(rows))
    rr_plain_f64 = row_rel_rms(plain.reshape(rows), oracle.reshape(rows))
    check(bool((rr < DYNAMICS_REL_RMS).all()), f"{name}: fused kernel rows {rr.max():.3g} relative RMS off "
          f"the f64 oracle (bar {DYNAMICS_REL_RMS})")
    check(bool((rr_plain <= rr_plain_f64 + DYNAMICS_REL_RMS).all()),
          f"{name}: fused kernel rows {rr_plain.max():.3g} relative RMS off the plain version, which is "
          f"{rr_plain_f64.max():.3g} off the f64 oracle (bar {DYNAMICS_REL_RMS} + that)")
    keys = [k for k in st if st[k].numel()]  # the limiter's look and xdelay are empty without a lookahead
    st_err = max(float((st[k].double() - ost[k].double()).abs().max()) for k in keys)
    scale = max(float(ost[k].abs().max()) for k in keys)
    check(st_err <= DYNAMICS_REL_RMS * scale + 1e-6, f"{name}: states out {st_err:.3g} off the f64 oracle's")
    out = {"kind": kind, "rows": B, "channels": C, "frames": F, "calls": len(edges) - 1,
           "max_row_rel_rms_vs_f64": float(rr.max()), "max_row_rel_rms_vs_plain": float(rr_plain.max()),
           "plain_max_row_rel_rms_vs_f64": float(rr_plain_f64.max()),
           "max_abs_err": float((got - plain).abs().max()), "states_err_vs_f64": st_err,
           "two_runs_bit_equal": True}
    if host_model:
        cpu = (lambda d: {k: c.cpu() if torch.is_tensor(c) else c for k, c in d.items()})
        ys, mst = [], cpu(state)
        for a0, b0 in zip(edges, edges[1:]):
            y, mst = dc.stage_model(kind, x[..., a0:b0].cpu(), cpu({k: part(c, a0, b0) for k, c in params.items()}),
                                    mst, **cpu({k: part(c, a0, b0) for k, c in kw.items()}))
            ys.append(y)
        model = torch.cat(ys, dim=-1)
        got_h = got.cpu()
        out["vs_host_model_max_abs"] = float((got_h - model).abs().max())
        out["vs_host_model_bit_equal"] = bool(torch.equal(got_h, model))
        rr_m = float(row_rel_rms(got_h.reshape(rows), model.reshape(rows)).max())
        out["vs_host_model_max_row_rel_rms"] = rr_m
        check(rr_m < 1e-6, f"{name}: the fused kernel is {rr_m:.3g} off its host model (bar 1e-6)")
    if ref_rows:  # the references start from silence: one more call from zero states
        got_np = proc(x, params, {k: torch.zeros_like(c) for k, c in state.items()}, **kw)[0].cpu().double().numpy()
        worst = 0.0
        for r in ref_rows:
            worst = max(worst, rel_rms(got_np[r], _stage_ref(kind, x, params, kw, r)))
        out["max_row_rel_rms_vs_f64_reference"] = worst
        check(worst < ref_bar, f"{name}: {worst:.3g} off the f64 sequential reference (bar {ref_bar})")
    if time_it:
        call = dc.prepare_stage(kind, x, params, state, **kw)
        out["ms"] = _event_ms_batch(torch, call, 20)  # the launch alone, 20 in a row
        out["ms_each"], _ = _event_ms(torch, call, 20)  # each bracketed by its own events
        out["plain_ms"], _ = _event_ms(torch, lambda: dc.stage_torch(kind, x, params, state, **kw), 3)
        lanes = sum(1 for c in params.values() if _frames_of(c, F))
        out.update(fused_bound(kind, B, C, F, key=kw.get("key") is not None, lanes=lanes,
                               lookahead=kw.get("lookahead", 0), detector=kw.get("detector", "peak")))
        out["sub_frames"] = dc.sub_frames(B, F, fused=True)
    print(f"[dynamics-fused-vs-plain] {name}: " + json.dumps(out))
    return out


def dynamics_inputs(torch, kind, B, C, F, seed, *, lanes=(), key=False, silent_key=False, lookahead=0,
                    detector="peak", hyst=0.0):
    """Seeded inputs of a fused stage on the card: noise swelling from quiet
    to loud on each row, parameters one a row (``lanes``: those one a
    frame), random states -> (x, params, state, kw)."""
    import numpy as np

    from whitebox_tpu_torch.ops import dynamics as dyn

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    swell = np.linspace(0.02, 1.6, F)[None, None, :]
    x = t(rng.standard_normal((B, C, F)) * swell * rng.uniform(0.5, 1.5, (B, 1, 1)))

    def row(lo, hi):
        return t(rng.uniform(lo, hi, (B, 1)))

    def tc(lo, hi):
        return t(dyn.time_coef(rng.uniform(lo, hi, (B, 1)), RATE))
    if kind == "compressor":
        params = {"threshold_db": row(-30.0, -12.0), "ratio": row(2.0, 8.0), "knee_db": row(0.0, 8.0),
                  "attack": tc(0.001, 0.02), "release": tc(0.05, 0.3), "makeup_db": row(-2.0, 4.0),
                  "det_avg": tc(0.01, 0.05)}
        state = {"red": row(0.0, 6.0)[:, 0], "att": row(0.0, 6.0)[:, 0], "det": row(0.0, 0.2)[:, 0]}
    elif kind == "limiter":
        params = {"ceiling_db": row(-6.0, -0.3), "attack": tc(0.0005, 0.002), "release": tc(0.02, 0.1)}
        state = {"red": row(0.0, 3.0)[:, 0], "att": row(0.0, 3.0)[:, 0],
                 "look": t(rng.uniform(0.0, 2.0, (B, lookahead))),
                 "xdelay": t(rng.standard_normal((B, C, lookahead)) * 0.3)}
    else:
        params = {"threshold_db": row(-30.0, -10.0), "range_db": row(20.0, 80.0), "hyst_db": row(hyst, hyst),
                  "attack": tc(0.0005, 0.005), "release": tc(0.05, 0.2)}
        state = {"open": row(0.0, 1.0)[:, 0], "att": row(0.0, 1.0)[:, 0]}
    for name in lanes:  # automation lanes: the parameter moves over the frames
        base = params[name]
        if name in ("attack", "release", "det_avg"):
            params[name] = base ** t(np.linspace(0.5, 2.0, F))[None, :]
        else:
            params[name] = base + t(np.sin(np.linspace(0.0, 6.0, F)) * 4.0)[None, :]
    kw = {}
    if kind == "compressor":
        kw["detector"] = detector
    if kind == "limiter":
        kw["lookahead"] = lookahead
    if key:
        kw["key"] = t(rng.standard_normal((B, C, F)) * swell[:, :, ::-1] * 0.8)
    if silent_key:
        kw["silent_key"] = True
    return x, params, state, kw


def phase_dynamics_small(torch) -> None:
    """The dynamics kernel against its plain versions. The unfused kinds
    (the ballistics and the one-pole of ``parallel/effects_sharded.py``) on
    1, 2, 7, 64 and 256 rows: frames fewer than a tile and not a multiple of
    one, per-row and per-frame coefficients (automation lanes), states
    handed over between two calls, the gate's floor, the RMS detector's
    one-pole; relative RMS 5e-6 per row, the states out, two runs bit-equal,
    and on the small cases bit-equal to the host model. The fused kinds
    (one launch a compressor, limiter or gate call): at the paths' shapes
    (64 stereo compressor rows and the master limiter, 2^18 frames), timed
    with their bounds; a peak and an RMS compressor with a key and a
    silent key, per-frame lanes, a limiter with and without lookahead, a
    gate with hysteresis and a keyed one with a per-frame range, states
    over two chunks, mono, a row shorter than a tile; against the oracle
    and the plain version, on the small cases the host model and the f64
    sequential references (5e-5; 2e-4 with lanes)."""
    import numpy as np

    from whitebox_tpu_torch.ops import dynamics_cuda as dc

    rng = np.random.default_rng(41)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def target(B, F):  # gain reductions in dB: runs of over-threshold levels, zeros between
        env = np.abs(rng.standard_normal((B, F))) * 6.0 * (rng.random((B, F)) < 0.3)
        return t(env)

    def coefs(B, lo, hi):
        return t(rng.uniform(lo, hi, (B, 1)))

    T = 32 * 32  # a tile of the few-row calls
    cases = [("one_row_short", 1, 700), ("two_rows_ragged", 2, 5 * T + 333), ("seven_rows", 7, 3 * T),
             ("rows_64", 64, DYNAMICS_PATH_FRAMES), ("rows_256", 256, DYNAMICS_PATH_FRAMES)]
    for name, B, F in cases:
        v = target(B, F)
        e0, y0 = t(rng.uniform(0, 3, B)), t(rng.uniform(0, 3, B))
        dynamics_vs_plain(name, torch, v, coefs(B, 0.99, 0.99999), coefs(B, 0.9, 0.9999), e0, y0,
                          host_model=B <= 7, time_it=F == DYNAMICS_PATH_FRAMES)
    B, F = 7, 4 * T + 77
    v = target(B, F)
    lanes = (t(rng.uniform(0.995, 0.99999, (B, F))), t(rng.uniform(0.95, 0.9999, (B, F))))
    zeros = torch.zeros(B, device=dev)
    dynamics_vs_plain("per_frame_coefficients", torch, v, *lanes, zeros, zeros, host_model=True, time_it=False)
    dynamics_vs_plain("states_over_two_calls", torch, v, *lanes, t(rng.uniform(0, 3, B)), t(rng.uniform(0, 3, B)),
                      pieces=(T + 500,), host_model=True, time_it=False)
    gate = t(np.clip(rng.random((B, F)) * 1.3, 0.05, 1.0))
    floor = coefs(B, 0.05, 0.3)
    dynamics_vs_plain("gate_floor", torch, gate, coefs(B, 0.999, 0.9999), coefs(B, 0.9, 0.999), zeros, zeros,
                      floor=floor, pieces=(2 * T,), host_model=True, time_it=False)
    dynamics_vs_plain("gate_floor_per_frame", torch, gate, coefs(B, 0.999, 0.9999), lanes[1], zeros, zeros,
                      floor=t(rng.uniform(0.05, 0.3, (B, F))), host_model=True, time_it=False)
    power = t(rng.standard_normal((B, F)) ** 2)
    dynamics_vs_plain("rms_detector_onepole", torch, power, None, coefs(B, 0.99, 0.9999), None,
                      t(rng.uniform(0, 1, B)), pieces=(3000,), onepole=True, host_model=True, time_it=False)
    # leading batch dims as the generic finisher passes them (rows of a group), and a 1-D row
    dynamics_vs_plain("one_dimensional_row", torch, v[0], 0.9995, 0.99, 0.5, 0.25, time_it=False)

    # the fused kinds: the paths' shapes first, then the small cases
    P = DYNAMICS_PATH_FRAMES
    fused = [("compressor_peak_64x2x2^18", "compressor", 64, 2, P, {}, {}),
             ("limiter_lookahead_1x2x2^18", "limiter", 1, 2, P, {"lookahead": 240}, {}),
             ("gate_16x2x2^18", "gate", 16, 2, P, {"hyst": 3.0}, {}),
             ("compressor_rms_key", "compressor", 4, 2, 20000, {"detector": "rms", "key": True},
              {"host_model": True, "ref_rows": (0, 3), "pieces": (7000,)}),
             ("compressor_peak_silent_key", "compressor", 3, 2, 9000, {"silent_key": True},
              {"host_model": True, "ref_rows": (1,)}),
             ("compressor_rms_silent_key", "compressor", 3, 2, 9000, {"detector": "rms", "silent_key": True},
              {"host_model": True, "ref_rows": (2,)}),
             ("compressor_lanes", "compressor", 3, 2, 30000, {"lanes": ("threshold_db", "release")},
              {"host_model": True, "ref_rows": (0,), "ref_bar": 2e-4, "pieces": (11111,)}),
             ("limiter_lookahead_two_chunks", "limiter", 2, 2, 50000, {"lookahead": 240},
              {"host_model": True, "ref_rows": (1,), "pieces": (20000,)}),
             ("limiter_lookahead_lanes", "limiter", 2, 2, 30000, {"lookahead": 97, "lanes": ("ceiling_db",)},
              {"host_model": True, "ref_rows": (0,), "ref_bar": 2e-4}),
             ("limiter_no_lookahead", "limiter", 5, 2, 12000, {}, {"host_model": True, "ref_rows": (4,)}),
             ("gate_hysteresis", "gate", 8, 2, 30000, {"hyst": 6.0},
              {"host_model": True, "ref_rows": (0, 7), "pieces": (9999,)}),
             ("gate_key_range_lane", "gate", 3, 2, 20000, {"key": True, "lanes": ("range_db", "attack")},
              {"host_model": True, "ref_rows": (1,), "ref_bar": 2e-4}),
             ("mono_row_shorter_than_a_tile", "compressor", 2, 1, 700, {"detector": "rms"},
              {"host_model": True, "ref_rows": (0, 1)})]
    for i, (name, kind, B, C, F, inputs, opts) in enumerate(fused):
        x, params, state, kw = dynamics_inputs(torch, kind, B, C, F, 100 + i, **inputs)
        fused_vs_plain(name, torch, kind, x, params, state, time_it=F == P, **opts, **kw)


def phase_effects(torch) -> dict:
    """``effects_eq_128trk`` (config 5): ``bounce(device="cuda")`` in "fir"
    and "scan" mode and with ``meters=True``, the launch counts reset just
    before each (the scan and the meters through the cascade kernel, no
    Hillis scan), all held to the f64 reference; then 5 warm
    carve+plan+upload+(IR or chain tables)+K4+finisher iterations in each
    of "fir" and "scan", the per-track kernel (K4), both
    finishers, the cascade kernel on the main path's chunk, and their plain
    versions timed by CUDA events."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad as biquad_mod
    from whitebox_tpu_torch.ops import biquad_cuda, mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan, per_track_block_slots
    from whitebox_tpu_torch.render import effects_pipeline
    from whitebox_tpu_torch.render.bounce import _effects_finisher, bounce
    from whitebox_tpu_torch.render.effects_fir import prepare_fir_finish
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, duration = "effects_eq_128trk", 60.0
    session = effects_eq_128trk(duration)
    hillis = [0]
    scan_fn = biquad_mod.hillis_scan

    def counted_scan(*a, **kw):
        hillis[0] += 1
        return scan_fn(*a, **kw)

    runs = {}
    biquad_mod.hillis_scan = counted_scan
    try:
        for mode, kw in (("fir", {"effects_mode": "fir"}), ("scan", {"effects_mode": "scan"}),
                         ("meters", {"meters": True})):
            reset_launches()
            hillis[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = bounce(session, RATE, device="cuda", **kw)
            n, nc = mix_cuda.mix_per_track_launches, biquad_cuda.biquad_cascade_launches
            check(n > 0, f"{name} ({mode}): bounce never launched the per-track kernel")
            check(mix_cuda.mix_kernel_launches == 0 and mix_cuda.mix_auto_launches == 0,
                  f"{name} ({mode}): an effects session took a summing kernel")
            if mode == "fir":
                check(nc == 0, f"{name} (fir): the FIR finisher ran the cascade kernel")
            else:
                check(nc > 0 and hillis[0] == 0, f"{name} ({mode}): cascade kernel launches={nc}, "
                      f"Hillis scans={hillis[0]}")
            check(np.isfinite(res.audio).all(), f"{name} ({mode}): non-finite output")
            runs[mode] = (res, n, nc, torch.cuda.max_memory_allocated() / 1e9)
            print(f"[{name}] bounce(device='cuda', {', '.join(f'{k}={v!r}' for k, v in kw.items())}): "
                  f"{res.stats.summary()}; finisher {res.stats.finish_seconds * 1e3:.3f} ms; per-track "
                  f"kernel launches={n}; cascade kernel launches={nc}; peak memory {runs[mode][3]:.2f} GB")
    finally:
        biquad_mod.hillis_scan = scan_fn
    launches, cascade_launches = runs["scan"][1], runs["scan"][2]
    check(np.array_equal(runs["meters"][0].audio, runs["scan"][0].audio),
          f"{name}: the metered bounce's audio != the scan bounce's")

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = warm.plan
    pt = warm.render_device_per_track()
    empty = int((~per_track_block_slots(p).any(axis=3)).sum())
    t0 = time.perf_counter()
    ref = effects_reference(session, pt, table, pool)
    ref_s = time.perf_counter() - t0
    fir, scan = runs["fir"][0].audio, runs["scan"][0].audio
    check(fir.shape == ref.shape == scan.shape, f"{name}: shapes {fir.shape} {scan.shape} {ref.shape}")
    rr_scan, rr_fir = rel_rms(scan, ref), rel_rms(fir, ref)
    scan_fir = float(np.abs(scan.astype(np.float64) - fir).max())
    check(rr_scan < SCAN_REL_RMS, f"{name}: scan relative RMS {rr_scan:.3g} off the f64 reference")
    check(rr_fir < FIR_REL_RMS, f"{name}: fir relative RMS {rr_fir:.3g} off the f64 reference")
    check(scan_fir <= SCAN_FIR_ATOL, f"{name}: scan vs fir max abs {scan_fir:.3g}")
    check(float(np.abs(fir).max()) > 0.01, f"{name}: silent render")
    print(f"[{name}] per-track kernel bit-equal to render_segments_per_track_numpy on all "
          f"{p.num_tracks} tracks ({empty} (block, track) cells zero-filled); vs f64 reference "
          f"(sosfilt) relative RMS scan {rr_scan:.3g} (< {SCAN_REL_RMS}), fir {rr_fir:.3g} "
          f"(< {FIR_REL_RMS}); scan vs fir max abs {scan_fir:.3g} (<= {SCAN_FIR_ATOL}); reference "
          f"{ref_s:.1f} s on the host")

    dev = torch.device("cuda")
    legs = {}
    for mode in ("fir", "scan"):  # the FIR rows are the cell's; the scan rows the default mode's
        rows = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_, p_ = carve_session(session, RATE, buffer_size=512, pool=pool, slow_emit="runs")
            t1 = time.perf_counter()
            plan = build_plan(t_, p_, session)
            t2 = time.perf_counter()
            r = mix_cuda.CudaMixRenderer(t_, p_, session, device="cuda", plan=plan,
                                         pool_device=warm.pool_device)
            t3 = time.perf_counter()
            finish = _effects_finisher(session, r, plan, RATE, mode, False, dev)
            t4 = time.perf_counter()
            finish(r.render_device_per_track())
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0))
            del r, finish
        legs[mode] = [statistics.median(c) for c in zip(*rows)] + [min(row[-1] for row in rows)]
    carve_s, plan_s, upload_s, ir_s, launch_s, e2e_med, e2e_best = legs["fir"]

    args = (warm.pool_device, warm.tables, p.n_tiles, p.tile, p.channels)
    fir_finish = prepare_fir_finish(session, RATE, warm.tables["track_gain"], None, p.channels,
                                    device="cuda")
    scan_finish = _effects_finisher(session, warm, p, RATE, "scan", False, dev)
    metered_finish = _effects_finisher(session, warm, p, RATE, "scan", True, dev)
    kernel_ms, kernel_all = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(*args), 20)
    fir_ms, _ = _event_ms(torch, lambda: fir_finish(pt), 5)
    scan_ms, scan_all = _event_ms(torch, lambda: scan_finish(pt), 5)
    metered_ms, _ = _event_ms(torch, lambda: metered_finish(pt), 3)
    plain_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_reference(*args), 1)
    got, plain = mix_cuda.mix_per_track_cuda(*args), mix_cuda.mix_per_track_reference(*args)
    max_abs = float((got - plain).abs().max())
    check(torch.equal(got, plain), f"{name}: per-track kernel != plain version (max abs {max_abs:.3g})")
    del got, plain

    # the finisher with the plain cascade (the per-section Hillis scan, in
    # chunks of CPU_CHUNK frames as before the kernel): its time, and the
    # kernel path's meters against its meters
    metered = metered_finish(pt)
    effects_pipeline.biquad_cascade = biquad_cuda.biquad_cascade_reference
    try:
        plain_fin = make_finisher("scan", session, RATE, warm.tables["track_gain"], meters=True,
                                  chunk=effects_pipeline.CPU_CHUNK, device=dev)
        S, coeffs, Sm, mcoeffs = plain_fin.S, plain_fin.coeffs, plain_fin.Sm, plain_fin.mcoeffs
        held = {}

        def plain_metered():
            held["out"] = run(plain_fin, pt, pt.shape[-1], valid_frames=p.total_frames)

        plain_scan_ms, _ = _event_ms(torch, plain_metered, 1)
        plain_out = held.pop("out")
    finally:
        effects_pipeline.biquad_cascade = biquad_cuda.biquad_cascade
    meter_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    for a, b in zip(metered.meters, plain_out.meters))
    check(meter_err <= 1e-5, f"{name}: meters {meter_err:.3g} (relative) off the plain finisher's")
    mix_rr = rel_rms(metered.out.cpu().numpy(), plain_out.out.cpu().numpy())
    print(f"[{name}] metered scan finisher vs the plain one (Hillis scan): meters max relative "
          f"{meter_err:.3g} (<= 1e-05), mix relative RMS {mix_rr:.3g}")
    del metered, plain_out

    # the cascade kernel on the main path's chunk: the tracks' [T*C, CUDA_CHUNK]
    # rows (a strided view of the per-track buffer) and the master's [C, CUDA_CHUNK]
    Fc = min(effects_pipeline.CUDA_CHUNK, pt.shape[-1])
    xc = pt.reshape(p.num_tracks * p.channels, -1)[:, :Fc]
    zeros = [torch.zeros((xc.shape[0], 2), device=dev) for _ in range(S)]
    casc_rr, casc_abs = cascade_vs_plain("tracks_full_width", torch, xc, coeffs, zeros)
    casc_ms, casc_all = _event_ms(torch, lambda: biquad_cuda.biquad_cascade(xc, coeffs, zeros), 20)
    casc_plain_ms, _ = _event_ms(torch, lambda: biquad_cuda.biquad_cascade_reference(xc, coeffs, zeros), 1)
    master_x = pt[0, :, :Fc].contiguous()
    mzeros = [torch.zeros((p.channels, 2), device=dev) for _ in range(Sm)]
    cascade_vs_plain("master_full_width", torch, master_x, mcoeffs, mzeros)
    master_ms, _ = _event_ms(torch, lambda: biquad_cuda.biquad_cascade(master_x, mcoeffs, mzeros), 20)
    casc_bytes = 2 * xc.numel() * 4 + coeffs.numel() * 4 + 4 * S * xc.shape[0] * 2 * 2
    casc_ops = 15 * S * xc.numel()  # 15 f32 operations per section and frame
    cascade = {"launches": cascade_launches, "max_abs_err": casc_abs, "ms": casc_ms,
               "plain_ms": casc_plain_ms, **least_ms(casc_bytes, casc_ops),
               # no installed PyTorch call runs an IIR cascade
               "library_ms": None}

    table_bytes = sum(t.numel() * t.element_size() for t in warm.tables.values())
    pt_bytes = p.num_tracks * p.channels * p.n_tiles * p.tile * 4
    stats = {
        "cell": name, "tracks": p.num_tracks, "audio_seconds": duration,
        "frames": int(p.total_frames), "tile": p.tile, "n_tiles": p.n_tiles, "K": p.max_slots,
        "active_slots": int((p.me > p.ms).sum()), "pool_mb": pool.data.nbytes / 1e6,
        "per_track_gb": pt_bytes / 1e9, "zero_filled_cells": empty,
        "e2e_ms_median": e2e_med * 1e3, "e2e_ms_best": e2e_best * 1e3,
        "rtf_median": duration / e2e_med, "rtf_best": duration / e2e_best,
        "carve_ms": carve_s * 1e3, "plan_ms": plan_s * 1e3, "upload_ms": upload_s * 1e3,
        "ir_ms": ir_s * 1e3, "launch_to_sync_ms": launch_s * 1e3,
        "scan_e2e_ms_median": legs["scan"][5] * 1e3, "scan_e2e_ms_best": legs["scan"][6] * 1e3,
        "scan_rtf_median": duration / legs["scan"][5], "scan_tables_ms": legs["scan"][3] * 1e3,
        "scan_launch_to_sync_ms": legs["scan"][4] * 1e3,
        "kernel_ms_median": kernel_ms, "kernel_ms_min": min(kernel_all), "plain_ms_median": plain_ms,
        "fir_finish_ms": fir_ms, "scan_finish_ms": scan_ms, "scan_finish_ms_all": scan_all,
        "metered_finish_ms": metered_ms, "plain_scan_finish_ms": plain_scan_ms,
        # the finisher's least time: the per-track buffer read once, the mix written once
        "scan_finish_bound_ms": least_ms(pt_bytes + p.channels * p.n_tiles * p.tile * 4, 0)["bound_ms"],
        "cascade_chunk": list(xc.shape), "cascade_ms": casc_ms, "cascade_ms_min": min(casc_all),
        "cascade_plain_ms": casc_plain_ms, "cascade_bound_ms": cascade["bound_ms"],
        "cascade_rel_rms_max": casc_rr, "master_cascade_ms": master_ms,
        "cascade_launches_per_bounce": cascade_launches,
        "scan_bounce_peak_mem_gb": runs["scan"][3], "meters_bounce_peak_mem_gb": runs["meters"][3],
        "output_gb_per_s": pt_bytes / (kernel_ms * 1e-3) / 1e9,
        "kernel_vs_plain_max_abs": max_abs, "scan_rel_rms": rr_scan, "fir_rel_rms": rr_fir,
        "scan_vs_fir_max_abs": scan_fir, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **bound(p, pool.data.nbytes, table_bytes, per_track=True),
    }
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return {"mix_per_track": _kernel_entry(stats, launches), "biquad_cascade": cascade}


#: the sessions of the four interpolation cells: the JAX package's benchmark
#: config 3 (``benchmarks/run_all.py:260-324``: 44.1 kHz material and
#: half-speed clips in a 48 kHz session) and its irrational-speed extra
#: (``run_all.py:423-433``: a semitone up, a semitone down, the golden ratio)
CONFIG3_SPEEDS = (1.0, 1.088435374149660, 0.5)
IRRATIONAL_SPEEDS = (2 ** (1 / 12), 2 ** (-1 / 12), 1.6180339887498949)
#: slab sizes swept for the extension's build (``prerender._EXT_SLAB_BYTES``)
SLAB_SWEEP_MIB = (64, 256, 1024, 8192)


def prerender_check(torch, name: str, session) -> None:
    """The prerender at full width: the extended pool read back once, the
    kernel's mix over it bit-equal to ``render_segments_numpy`` on the
    rewritten table (its rows are speed-1 copies; a reverse run's speed
    -1.0 rows fall under the resampling contract), and the extension of
    the first two tracks' runs within 1e-6 of the f64 host extension."""
    import dataclasses

    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.timeline import prerender as pre
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    plan = pre.plan_prerender(table, pool, partial=True)
    check(plan is not None and plan.uncovered_rows is None, f"{name}: the prerender does not cover every run")
    t2, p2, full = pre.apply_prerender_device(table, pool, plan, device="cuda")
    r = mix_cuda.CudaMixRenderer(t2, p2, session, device="cuda", pool_device=full,
                                 plan=build_plan(t2, p2, session))
    got = r.render()
    data = full.cpu().numpy()  # the one read-back of the extended pool
    t0 = time.perf_counter()
    ref = render_segments_numpy(t2, dataclasses.replace(p2, data=data), session)
    if t2.fast.all():
        check(np.array_equal(got, ref), f"{name}: mix over the extended pool != render_segments_numpy")
        vs = "bit-equal"
    else:
        ok, mu, ma = ulp_contract(got, ref)
        check(ok, f"{name}: {mu} ulp / {ma:.3g} abs off render_segments_numpy on the rewritten table")
        vs = f"max {mu} ulp / {ma:.3g} abs"
    ref_s = time.perf_counter() - t0
    check(float(np.abs(got).max()) > 0.01, f"{name}: silent render")

    C = pool.channel_base.shape[1]
    sub = pre.restrict_plan(plan, lambda run: run.trk < 2, C)
    t0 = time.perf_counter()
    _, p64 = pre.apply_prerender_host(table, pool, sub, f64=True)
    origin = pool.data.shape[0] + (-pool.data.shape[0]) % 128
    err = 0.0
    for a, b in zip([run for run in plan.runs if run.trk < 2], sub.runs):
        n = a.nsub * (a.Qp if a.taylor else pre._QF * a.Qp)
        for ch in range(C):
            x = data[origin + a.ext_base + ch * a.stride_group:][:n]
            y = p64.data[origin + b.ext_base + ch * b.stride_group:][:n]
            err = max(err, float(np.abs(x.astype(np.float64) - y).max()))
    check(len(sub.runs) > 0 and err < EXT_ATOL,
          f"{name}: extension {err:.3g} off the f64 host extension on the first two tracks")
    print(f"[{name}] extended pool {data.nbytes / 1e9:.3f} GB read back once: kernel mix over it vs "
          f"render_segments_numpy on the rewritten table {vs} ({ref_s:.1f} s on the host); "
          f"{len(sub.runs)} runs of tracks 0-1 (of {len(plan.runs)}) vs apply_prerender_host(f64) "
          f"max {err:.3g} abs (< {EXT_ATOL}, {time.perf_counter() - t0:.1f} s on the host)")


def head_check(name: str, session, mode: str, seconds: float = 5.0) -> None:
    """The first ``seconds`` of the session in ``mode`` on the card against
    ``render_segments_numpy(interp=...)``."""
    import numpy as np

    from whitebox_tpu_torch.timeline.carve import render_segments_numpy

    r, table, pool, interp = make_renderer(session, mode, seconds=seconds)
    got = r.render()
    ref = render_segments_numpy(table, pool, session, interp=interp)
    ma = float(np.abs(got.astype(np.float64) - ref).max())
    check(got.shape == ref.shape and ma <= INTERP_ATOL,
          f"{name}: {mode} head {ma:.3g} abs off render_segments_numpy(interp)")
    keep = ~slow_frames(table, got.shape[1])
    check(np.array_equal(got[:, keep], ref[:, keep]), f"{name}: {mode} moved speed-1 frames")
    print(f"[{name}] first {seconds:g} s ({got.shape[1]} frames) vs render_segments_numpy(interp={mode}) "
          f"max {ma:.3g} abs (<= {INTERP_ATOL}); frames of speed-1 rows only bit-equal")


def slab_sweep(torch, name: str, session) -> None:
    """The extension's build at several slab sizes: device ms (median of 3)
    and peak memory on the card."""
    from whitebox_tpu_torch.timeline import prerender as pre
    from whitebox_tpu_torch.timeline.carve import carve_session

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    plan = pre.plan_prerender(table, pool, partial=True)
    base = torch.from_numpy(pool.data).to("cuda")
    default, out = pre._EXT_SLAB_BYTES, {}
    try:
        for mib in SLAB_SWEEP_MIB:
            pre._EXT_SLAB_BYTES = mib << 20
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(4):
                full = pre.apply_prerender_device(table, pool, plan, pool_device=base)[2]
                ms.append(plan.ext_seconds * 1e3)
                del full
            out[f"{mib}MiB"] = {"ext_ms": statistics.median(ms[1:]),
                                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        pre._EXT_SLAB_BYTES = default
    print(f"[{name}] slab sweep (default {default >> 20} MiB) " + json.dumps(out))


def interpolation_cell(torch, name: str, session, duration: float, mode: str) -> tuple[dict, int]:
    """One interpolation cell: ``bounce(device="cuda")`` with the launch
    counts reset just before (one mix launch, in the expected mode), its
    checks, then the timing."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce

    kw = {"catmull": {"interpolation": "catmull"}, "prerender": {"interpolation": "sinc"},
          "poly": {"interpolation": "sinc", "prerender": False}}[mode]
    kernel_mode = "linear" if mode == "prerender" else mode
    reset_launches()
    res = bounce(session, RATE, device="cuda", **kw)
    launches = mix_cuda.mix_kernel_launches
    check(launches == 1 and mix_cuda.mix_auto_launches == 0 and mix_cuda.mix_per_track_launches == 0,
          f"{name}: bounce must launch the summing kernel once, got {launches}")
    check(mix_cuda.interp_launches == {**dict.fromkeys(mix_cuda.interp_launches, 0), kernel_mode: 1},
          f"{name}: launched in modes {mix_cuda.interp_launches}, expected one {kernel_mode}")
    check(np.isfinite(res.audio).all() and float(np.abs(res.audio).max()) > 0.01,
          f"{name}: silent or non-finite render")
    check((res.stats.prerender_seconds > 0) == (mode == "prerender"), f"{name}: prerender_seconds")
    print(f"[{name}] bounce(device='cuda', {', '.join(f'{k}={v!r}' for k, v in kw.items())}): "
          f"{res.stats.summary()}; prerender {res.stats.prerender_seconds * 1e3:.3f} ms; mix kernel "
          f"launches={launches} ({kernel_mode})")
    if mode == "prerender":
        prerender_check(torch, name, session)
    else:
        head_check(name, session, mode)
    return measure_cell(torch, name, session, duration, mode=mode), launches


def phase_interpolation(torch) -> dict:
    """The export-quality interpolation modes at full width: Catmull-Rom
    in the kernel, the sinc prerender on rational and on irrational
    speeds, and the oversampled sinc through the polynomial taps."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    duration = 60.0
    config3 = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=44100, seed=7,
                                clip_speeds=CONFIG3_SPEEDS)
    irrational = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=int(RATE), seed=7,
                                   clip_speeds=IRRATIONAL_SPEEDS)
    out = {}
    for name, session, mode, kernel in (
            ("catmull_128trk", config3, "catmull", "mix_catmull"),
            ("sinc_prerender_128trk", config3, "prerender", "mix_prerendered"),
            ("sinc_irrational_128trk", irrational, "prerender", None),
            ("sinc_oversample_128trk", config3, "poly", "mix_poly")):
        cell, launches = interpolation_cell(torch, name, session, duration, mode)
        if kernel is not None:
            out[kernel] = _kernel_entry(cell, launches)
    slab_sweep(torch, "sinc_prerender_128trk", config3)
    slab_sweep(torch, "sinc_irrational_128trk", irrational)
    print("[interpolation] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                                   "temperature.gpu", "--format=csv,noheader"]))
    return out


# ---------------------------------------------------------------- gather path and generic effects


def dense_session():
    """One track, twelve short clips at distinct speeds squeezed into one
    1024-frame tile: twelve runs overflow the slot plan's 8 slots at the
    smallest tile (the tests' dense session), so ``engine="auto"`` takes the
    gather path."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.sample import Sample

    rng = np.random.default_rng(42)
    s = Session(bpm=120.0)
    data = (rng.standard_normal((1, 4000)) * 0.3).astype(np.float32)
    asset = s.sample_table.add_sample(Sample.from_planar(data, 48000, AudioFormat.F32, name="d"), key="d")
    tr = s.add_track("t0")
    for c in range(12):
        s.add_audio_clip(tr, f"c{c}", c * 0.003, c * 0.003 + 0.0025, start_offset=0.0, asset=asset,
                         speed=0.9 + 0.017 * c)
    return s


def generic_fx_128trk(duration=60.0):
    """The JAX package's benchmark config 6 chains (``benchmarks/run_all.py:
    451-475``) on the flat mix, without buses or sends: track t carries bus
    ``t // 16``'s chain (even groups a two-band ParametricEQ, group 1 a
    -24 dB 4:1 compressor, not a sidechain one, the other odd groups -18 dB
    3:1), the master a 25 Hz highpass and a -0.5 dB lookahead limiter."""
    from whitebox_tpu_torch.effects import Biquad, Compressor, EffectChain, Limiter, ParametricEQ
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=48000, seed=9)
    for t, tr in enumerate(s.tracks):
        i = t // 16
        if i == 1:
            chain = [Compressor(-24.0, 4.0)]
        elif i % 2 == 0:
            chain = [ParametricEQ([("lowshelf", 90.0, 0.707, 1.5), ("peak", 900.0 + 200.0 * i, 1.0, -2.0)])]
        else:
            chain = [Compressor(-18.0, 3.0)]
        tr.effects = EffectChain(chain)
    s.master_effects = EffectChain([Biquad("highpass", 25.0), Limiter(-0.5)])
    return s


def routed_sidechain_128trk(duration=60.0):
    """The JAX package's benchmark config 6 (``benchmarks/run_all.py:451-475``)
    exactly: 128 tracks, 16 to each of 8 group buses (even buses a two-band
    ParametricEQ, bus 1 a -24 dB 4:1 sidechain compressor keyed by track
    127's sidechain send, buses 3, 5 and 7 a -18 dB 3:1 compressor), a
    post-fader send from track 3 to bus 5 (-6 dB), a pre-fader send from
    track 40 to bus 7 (-9 dB), a 25 Hz highpass and a -0.5 dB limiter on
    the master."""
    from whitebox_tpu_torch.effects import Biquad, Compressor, EffectChain, Limiter, ParametricEQ
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=48000, seed=9)
    for i in range(8):
        b = s.add_bus(f"grp{i}", volume_db=-1.5, pan=0.05 * (i - 4))
        if i == 1:
            b.effects = EffectChain([Compressor(-24.0, 4.0, sidechain=True)])
        elif i % 2 == 0:
            b.effects = EffectChain([ParametricEQ([("lowshelf", 90.0, 0.707, 1.5),
                                                   ("peak", 900.0 + 200.0 * i, 1.0, -2.0)])])
        else:
            b.effects = EffectChain([Compressor(-18.0, 3.0)])
    for t in range(128):
        s.set_track_output(t, t // 16)
    s.add_send(127, 1, gain_db=0.0, sidechain=True)
    s.add_send(3, 5, gain_db=-6.0)
    s.add_send(40, 7, gain_db=-9.0, pre_fader=True)
    s.master_effects = EffectChain([Biquad("highpass", 25.0), Limiter(-0.5)])
    return s


def add_midi_tracks(s, n_tracks: int, seed: int, duration: float, bpm: float = 120.0):
    """``n_tracks`` MIDI tracks, each one clip over ``duration`` seconds:
    4-voice chords on every eighth note, each note 0.75 beat long (two
    chords overlap: 8 voices sound), keys 36-96 and velocities 0.3-1.0
    from ``seed``."""
    import numpy as np

    from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer

    rng = np.random.default_rng(seed)
    beats = duration * bpm / 60.0
    for m in range(n_tracks):
        notes = [MidiNote(0.5 * i, 0.5 * i + 0.75, key=int(k), velocity=float(v))
                 for i in range(int(beats / 0.5))
                 for k, v in zip(rng.integers(36, 97, 4), rng.uniform(0.3, 1.0, 4))]
        tr = s.add_track(f"midi{m}", volume_db=-6.0, pan=float(rng.uniform(-0.7, 0.7)))
        s.add_midi_clip(tr, "chords", 0.0, beats, asset=s.midi_table.create_midi(MidiNoteBuffer(notes)))
    return s


def midi_synth_128trk(duration=60.0):
    """``make_demo_session(n_tracks=112, 60 s, 48 kHz, seed 7)`` plus 16 MIDI
    tracks (:func:`add_midi_tracks`, seed 13): 960 notes a track."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=112, duration_seconds=duration, sample_rate=48000, seed=7)
    return add_midi_tracks(s, 16, 13, duration)


def routed_small(seed=5):
    """A small routed session: 6 tracks, a ducking bus keyed by a sidechain
    send, a generic bus fed by post- and pre-fader sends with a fader lane,
    an EQ group, a master highpass and lookahead limiter."""
    from whitebox_tpu_torch.effects import (
        Biquad, Compressor, Delay, EffectChain, Limiter, NoiseGate, ParametricEQ,
    )
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=6, duration_seconds=3.0, sample_rate=48000, seed=seed)
    eq = s.add_bus("eq", volume_db=-2.0, pan=0.2)
    eq.effects = EffectChain([ParametricEQ([("lowshelf", 120.0, 0.707, 2.5), ("peak", 2500.0, 1.2, -2.0)])])
    duck = s.add_bus("duck")
    duck.effects = EffectChain([Compressor(-30.0, 8.0, attack_s=0.002, release_s=0.08, sidechain=True),
                                NoiseGate(-50.0, sidechain=True)])
    fxb = s.add_bus("fx", volume_db=-6.0)
    fxb.effects = EffectChain([Delay(0.03, 0.35), Compressor(-18.0, 3.0)])
    fxb.automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(4.0, 0.2))
    s.set_track_output(0, 0)
    s.set_track_output(1, 0)
    s.set_track_output(2, 1)
    s.add_send(5, 1, gain_db=0.0, sidechain=True)
    s.add_send(3, 2, gain_db=-3.0)
    s.add_send(4, 2, gain_db=-4.5, pre_fader=True)
    s.master_effects = EffectChain([Biquad("highpass", 30.0), Limiter(-1.0, lookahead_s=0.001)])
    return s


def midi_small(seed=6):
    """4 audio tracks and 2 MIDI tracks of overlapping chords, 3 s."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=4, duration_seconds=3.0, sample_rate=48000, seed=seed)
    return add_midi_tracks(s, 2, seed, 3.0)


def synth_rows_numpy(session, frames: int, buffer_size: int = 512) -> dict:
    """{MIDI track: its synth by ``render_synth_numpy``} on the grid of
    ``frames // buffer_size`` blocks, as ``bounce`` carves it."""
    from whitebox_tpu_torch.midi.synth import build_slot_segments, render_synth_numpy
    from whitebox_tpu_torch.midi.voice import carve_midi_events

    out = {}
    for t, evs in carve_midi_events(session, RATE, buffer_size, frames // buffer_size).items():
        ns, segs = build_slot_segments(evs)
        if segs is not None:
            out[t] = render_synth_numpy(segs, RATE, frames, ns)
    return out


def mix_launches() -> dict:
    from whitebox_tpu_torch.ops import mix_cuda

    return {"mix": mix_cuda.mix_kernel_launches, "auto": mix_cuda.mix_auto_launches,
            "per_track": mix_cuda.mix_per_track_launches}


def gather_counts() -> dict:
    """The gather kernel's launches by form (kept apart from :func:`mix_launches`,
    the slot-plan kernels')."""
    from whitebox_tpu_torch.ops import gather_cuda

    return dict(gather_cuda.form_launches)


def check_gather_launches(name: str, chunks: int, forms=("sum", "per_track")) -> dict:
    """At least one gather-kernel launch per rendered chunk or window, in
    ``forms`` together -> the counts by form."""
    counts = gather_counts()
    n = sum(counts[f] for f in forms)
    check(chunks > 0 and n >= chunks, f"{name}: {n} gather-kernel launches ({counts}) for {chunks} chunks")
    return counts


def gather_vs_reference(name, session, interpolation="linear", engine="xla", chunk_frames=8192):
    """``bounce(device="cuda", engine=...)`` through the gather path with the
    launch counts reset just before: no mix kernel launched, the audio
    bit-equal to the same bounce on the CPU (the same torch ops), and to
    ``render_segments_numpy`` of the blocks carve at speed 1 (the
    resampling contract otherwise; atol 3e-6 in the other modes). -> the
    mix launch counts read just after the bounce"""
    import numpy as np

    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy
    from whitebox_tpu_torch.timeline.oversample import resolve_interpolation

    reset_launches()
    res = bounce(session, RATE, device="cuda", engine=engine, interpolation=interpolation,
                 chunk_frames=chunk_frames)
    launches = mix_launches()
    check(res.stats.mix_path == "gather", f"{name}: took the {res.stats.mix_path} path")
    check(not any(launches.values()), f"{name}: the gather path launched a mix kernel {launches}")
    gk = check_gather_launches(name, res.stats.gather_chunks)
    cpu = bounce(session, RATE, device="cpu", engine=engine, interpolation=interpolation,
                 chunk_frames=chunk_frames).audio
    ok, ku, ka = ulp_contract(res.audio, cpu)
    check(ok, f"{name}: gather on the card {ku} ulp / {ka:.3g} abs off the CPU's")
    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="blocks")
    fast = bool(table.fast.all())
    note = "speed 1"
    if interpolation == "linear":
        ref = render_segments_numpy(table, pool, session)
        if fast:
            check(np.array_equal(res.audio, ref), f"{name}: gather != render_segments_numpy")
        else:
            ok, ru, ra = ulp_contract(res.audio, ref)
            check(ok, f"{name}: gather {ru} ulp / {ra:.3g} abs off render_segments_numpy")
            note = f"resampled, {ru} ulp / {ra:.3g} abs"
    elif interpolation == "catmull" or (interpolation == "sinc" and engine != "xla"):
        t2, p2, interp = resolve_interpolation(table, pool, interpolation)
        ref = render_segments_numpy(t2, p2, session, interp=interp)
        d = float(np.abs(res.audio.astype(np.float64) - ref).max())
        check(d <= INTERP_ATOL, f"{name}: {interpolation} gather {d:.3g} off render_segments_numpy")
        note = f"{interpolation}, max abs {d:.3g}"
    else:
        note = "direct sinc bank, held to the CPU only"
    print(f"[gather-small] {name}: bounce(device='cuda', engine={engine!r}, interpolation="
          f"{interpolation!r}) gather path, 0 slot-plan kernel launches, gather-kernel launches {gk} "
          f"for {res.stats.gather_chunks} chunks, bit-equal to the CPU's ({ku} ulp); vs "
          f"render_segments_numpy: {note}; {res.stats.summary()}")
    return launches


#: one chain per generic stage kind, and the automated forms
def _kind_chains():
    import numpy as np

    from whitebox_tpu_torch import effects as fx
    from whitebox_tpu_torch.ops.automation import AutomationLane

    ir = (np.exp(-np.arange(700) / 150.0) * 0.25).astype(np.float32)

    def lane(*pts):
        out = AutomationLane()
        for p in pts:
            out.add(*p)
        return out

    return {
        "compressor": ([fx.Compressor(-20.0, 4.0, attack_s=0.004, release_s=0.09)], None),
        "compressor_rms_sidechain": ([fx.Compressor(-30.0, 3.0, detector="rms", sidechain=True)], None),
        "limiter": ([fx.Limiter(-4.0, lookahead_s=0.002)], None),
        "gate": ([fx.NoiseGate(-30.0, hysteresis_db=2.0)], None),
        "delay": ([fx.Delay(0.03, 0.5, wet=0.5)], None),
        "pingpong": ([fx.Delay(0.02, 0.4, mode="pingpong")], None),
        "chorus": ([fx.Chorus(voices=3)], None),
        "flanger": ([fx.Flanger()], None),
        "convreverb": ([fx.ConvolutionReverb(ir, wet=0.35)], None),
        "saturator_biquad": ([fx.Saturator(8.0), fx.Biquad("lowpass", 5000.0)], None),
        "width_gain": ([fx.StereoWidth(1.3), fx.Gain(-2.0)], None),
        "linphase": ([fx.LinearPhaseEQ([("peak", 1000.0, 1.0, 6.0)], taps=255)], None),
        "eq": ([fx.ParametricEQ([("lowshelf", 90.0, 0.7, 1.5), ("peak", 900.0, 1.0, -2.0)])], None),
        "tv_biquad": ([fx.Biquad("peak", 800.0, 2.0, 6.0)],
                      {(0, "freq_hz"): lane((0.0, 200.0), (0.05, 6000.0)), (0, "q"): lane((0.0, 0.6), (0.1, 3.0))}),
        "lanes": ([fx.Compressor(-18.0, 4.0), fx.Delay(0.01, 0.4), fx.Saturator(6.0)],
                  {(0, "threshold_db"): lane((0.0, -6.0), (0.05, -30.0)), (1, "wet"): lane((0.0, 0.0), (0.05, 0.8)),
                   (2, "drive_db"): lane((0.0, 0.0), (0.05, 14.0))}),
    }


def generic_kind_vs_cpu_and_f64(torch, name, chain, lanes, frames=16 * 512, chunk=4096):
    """Two tracks of one chain (one group) and a plain track, seeded noise
    as their per-track buffers: the generic finisher on the card against
    the same finisher on the CPU (relative RMS 1e-5) and against the f64
    ``reference_generic_finish`` (5e-5; 2e-4 with lanes). -> max |card - cpu|"""
    import copy

    import numpy as np

    from whitebox_tpu_torch.effects import EffectChain
    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda
    from whitebox_tpu_torch.ops.automation import TrackAutomation
    from whitebox_tpu_torch.render import effects_generic as gen
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.session import Session

    s = Session(bpm=120.0)
    for t in range(3):
        tr = s.add_track(f"t{t}", volume_db=-3.0 + t, pan=0.3 * (t - 1))
        if t != 1:
            tr.effects = EffectChain(copy.deepcopy(chain))
            if lanes:
                tr.automation = TrackAutomation(effects=dict(lanes))
    rng = np.random.default_rng(61)
    pt = (rng.standard_normal((3, 2, frames)) * 0.4).astype(np.float32)
    tg = np.array([[np.float32(t.volume_linear * np.float32(t.pan_coeffs[c])) for c in range(2)]
                   for t in s.tracks], np.float32)
    outs = {}
    before, dyn_before = biquad_cuda.biquad_cascade_launches, dynamics_cuda.dynamics_fused_launches
    for dev in ("cuda", "cpu"):
        fin = make_finisher("generic", s, RATE, torch.from_numpy(tg).to(dev), chunk=chunk, device=dev)
        outs[dev] = run(fin, torch.from_numpy(pt).to(dev), frames).out.cpu().numpy()
    cascades = biquad_cuda.biquad_cascade_launches - before
    dynamics = dynamics_cuda.dynamics_fused_launches - dyn_before
    ref = gen.reference_generic_finish(pt, s, RATE)
    rr_cpu, rr_f64 = rel_rms(outs["cuda"], outs["cpu"]), rel_rms(outs["cuda"], ref)
    bar = LANES_F64_REL_RMS if lanes else GENERIC_F64_REL_RMS
    check(np.isfinite(outs["cuda"]).all() and float(np.abs(outs["cuda"]).max()) > 1e-3, f"{name}: output")
    check(rr_cpu < GENERIC_REL_RMS, f"{name}: card vs CPU relative RMS {rr_cpu:.3g}")
    check(rr_f64 < bar, f"{name}: card vs f64 reference relative RMS {rr_f64:.3g} (bar {bar})")
    static_iir = any(type(e).__name__ in ("Biquad", "ParametricEQ") for e in chain) and not lanes
    check(cascades > 0 if static_iir else cascades == 0,
          f"{name}: {cascades} cascade launches for its static biquad stages")
    has_dynamics = any(type(e).__name__ in ("Compressor", "Limiter", "NoiseGate") for e in chain)
    check(dynamics > 0 if has_dynamics else dynamics == 0,
          f"{name}: {dynamics} fused dynamics kernel launches for its dynamics stages")
    print(f"[generic-small] {name}: finisher on the card vs CPU relative RMS {rr_cpu:.3g} "
          f"(< {GENERIC_REL_RMS}), vs f64 reference {rr_f64:.3g} (< {bar}); cascade kernel launches "
          f"{cascades}, dynamics kernel launches {dynamics}")
    return float(np.abs(outs["cuda"] - outs["cpu"]).max())


def phase_gather_small(torch) -> dict:
    """The gather mix and the generic finisher on small sessions -> the
    dense overflow session's mix launch counts."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    gather_vs_reference("speed1_int_formats", int_formats_session(n_tracks=4))
    resampled = make_demo_session(n_tracks=4, duration_seconds=4.0, seed=3, fades=True,
                                  clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37))
    gather_vs_reference("resampled_fades", resampled)
    gather_vs_reference("resampled_catmull", resampled, interpolation="catmull")
    gather_vs_reference("resampled_sinc_bank", resampled, interpolation="sinc")
    gather_vs_reference("reverse_bidirectional", reverse_session(), chunk_frames=10007)
    dense = gather_vs_reference("dense_overflow", dense_session(), engine="auto")
    for name, (chain, lanes) in _kind_chains().items():
        generic_kind_vs_cpu_and_f64(torch, name, chain, lanes)
    return dense


GATHER_FORMS = ("per_track", "sum", "sum_unclipped")
#: strict_order=False (one torch.sum in the plain version) against the
#: kernel's index-order sum on the small sessions (tests/test_torch_gather_mix.py's bar)
GATHER_FAST_SUM_ATOL = 1e-6


def reorder_bound(torch, per_track, track_gain):
    """Per (channel, frame), the most two summation orders of the tracks'
    ``contrib * track_gain`` can differ by: each order is within
    ``(T - 1) u sum |x|`` of the exact sum (u = 2^-24), so two are within
    twice that. The bar of strict_order=False on many tracks, where 1e-6
    is less than the rounding of a few hundred terms."""
    T = per_track.shape[0]
    return 2 * max(T - 1, 0) * 2.0 ** -24 * (per_track * track_gain[:, :, None]).abs().sum(dim=0)


def gather_inputs(torch, session, interpolation="linear", channels=2, seconds=None):
    """The gather path's inputs for ``session`` on the card, as ``bounce``
    builds them: the blocks carve for ``channels`` outputs, resolved to
    Catmull-Rom, to the 4x oversampled pool with polynomial taps ("poly"),
    or with the direct sinc bank ("sinc_bank") -> (pool, tables, total
    frames, sinc_bank, interp)."""
    import numpy as np

    from whitebox_tpu_torch.ops.mix import pack_device_tables
    from whitebox_tpu_torch.ops.resample import design_sinc_bank
    from whitebox_tpu_torch.timeline.carve import carve_session

    blocks = None if seconds is None else int(seconds * RATE) // 512
    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="blocks", num_blocks=blocks,
                                out_channels=channels)
    bank, interp = None, "linear"
    if interpolation == "sinc_bank":
        ratio = float(np.max(np.abs(table.speed[~table.fast])))
        bank = torch.from_numpy(design_sinc_bank(max(ratio, 1.0))).cuda()
    else:
        table, pool, interp = resolve_mode(table, pool, interpolation)
    tables = pack_device_tables(table, pool, session, channels=channels).as_torch("cuda")
    return torch.from_numpy(pool.data).cuda(), tables, table.total_frames, bank, interp


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 and \
        torch.equal(a.view(torch.int32), b.view(torch.int32))


def gather_kernel_vs_plain(torch, name, session, interpolation="linear", chunk=8192, channels=2,
                           fast_sum_atol=GATHER_FAST_SUM_ATOL) -> dict:
    """The gather kernel against its plain version on the card, chunk by
    chunk over the whole timeline and one chunk past its end, in every
    form: bit-equal; ``strict_order=False`` of the plain version within
    ``fast_sum_atol`` of the kernel's sum (None: within
    :func:`reorder_bound`); the per-track and summed forms on a subset
    of the tables' track rows (the PDC fetch-ahead's ``{k: v[idx]}``) bit-equal;
    the chunk past the end all +0.0."""
    from whitebox_tpu_torch.ops import gather_cuda, mix

    pool, tables, F, bank, interp = gather_inputs(torch, session, interpolation, channels)
    T = tables["dst_start"].shape[0]
    starts = list(range(0, F, chunk))
    past = F + chunk  # a chunk wholly past the end (the master latency's extra chunk)
    reset_launches()
    fast_sum = 0.0
    for start in starts + [past]:
        outs = {}
        for form in GATHER_FORMS:
            outs[form] = gather_cuda.gather_mix_cuda(pool, tables, start, chunk, form, sinc_bank=bank, interp=interp)
            want = mix.gather_plain(pool, tables, start, chunk, form, sinc_bank=bank, interp=interp)
            check(same_bits(torch, outs[form], want), f"{name} [{start}, +{chunk}) {form}: kernel != plain version "
                  f"(max abs {float((outs[form] - want).abs().max()):.3g})")
        loose = mix.gather_plain(pool, tables, start, chunk, "sum", strict_order=False, sinc_bank=bank,
                                 interp=interp)
        diff = (outs["sum"] - loose).abs()
        fast_sum = max(fast_sum, float(diff.max()))
        if fast_sum_atol is None:
            bar = reorder_bound(torch, outs["per_track"], tables["track_gain"])
            check(bool((diff <= bar).all()), f"{name} [{start}, +{chunk}): strict_order=False off the kernel's "
                  f"sum beyond the reordering bound")
        if start == past:
            check(all(not torch.any(o.view(torch.int32) != 0) for o in outs.values()),
                  f"{name}: a chunk past the end is not all +0.0")
    check(fast_sum_atol is None or fast_sum <= fast_sum_atol,
          f"{name}: strict_order=False {fast_sum:.3g} off the kernel's sum")
    counts = gather_counts()
    check(counts == {f: len(starts) + 1 for f in GATHER_FORMS}, f"{name}: gather launches {counts}")
    rows = torch.as_tensor(sorted({0, T - 1, T // 2}), device=pool.device)
    sub = {k: v[rows] for k, v in tables.items()}
    for form in ("per_track", "sum"):
        got = gather_cuda.gather_mix_cuda(pool, sub, 0, chunk, form, sinc_bank=bank, interp=interp)
        want = mix.gather_plain(pool, sub, 0, chunk, form, sinc_bank=bank, interp=interp)
        check(same_bits(torch, got, want), f"{name}: {form} on the track subset {rows.tolist()} != plain version")
    print(f"[gather-kernel] {name}: {interpolation}, T={T}, C={channels}, {F} frames in chunks of {chunk} + one "
          f"past the end: per_track, sum and sum_unclipped bit-equal to the plain version on the card; "
          f"strict_order=False within {fast_sum:.3g} ("
          f"{'<= the reordering bound' if fast_sum_atol is None else f'<= {fast_sum_atol}'}); track subset "
          f"{rows.tolist()} bit-equal; launches {counts}")
    return {"launches": counts, "fast_sum_max_abs": fast_sum}


def gather_kernel_cases() -> dict:
    """The gather phase's small sessions for the kernel -> name -> (a
    function making the session, interpolation, chunk, channels): speed-1 int formats (one, two
    and three channels), resampled with fades in every interpolation mode,
    the reverse session in ragged chunks, the dense overflow."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    def resampled():
        return make_demo_session(n_tracks=4, duration_seconds=4.0, seed=3, fades=True,
                                 clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37))

    def ints():
        return int_formats_session(n_tracks=4)
    return {"speed1_int_formats": (ints, "linear", 8192, 2),
            "speed1_mono": (ints, "linear", 8192, 1),
            "speed1_three_channels": (ints, "linear", 8192, 3),
            "resampled_fades": (resampled, "linear", 8192, 2),
            "resampled_catmull": (resampled, "catmull", 8192, 2),
            "resampled_poly": (resampled, "poly", 8192, 2),
            "resampled_sinc_bank": (resampled, "sinc_bank", 8192, 2),
            "resampled_three_channels_catmull": (resampled, "catmull", 8192, 3),
            "reverse_bidirectional": (reverse_session, "linear", 10007, 2),
            "dense_overflow": (dense_session, "linear", 1000, 2)}


def many_tracks_gather_session():
    """300 tracks of short faded clips, a quarter of them resampled: two
    staging passes of the summed forms' row ranges."""
    from whitebox_tpu_torch.render.demo import make_demo_session

    return make_demo_session(n_tracks=300, duration_seconds=2.0, seed=19, fades=True, clip_speeds=(1.0, 0.75))


def phase_gather_kernel(torch) -> dict:
    """The gather kernel (``csrc/gather_mix.cu``) against its plain version
    on :func:`gather_kernel_cases`, in every form, and on 300 tracks
    (strict_order=False there within the reordering bound of its 300
    terms) -> the largest strict_order=False distance of the small sessions."""
    worst = 0.0
    for name, (build, interpolation, chunk, channels) in gather_kernel_cases().items():
        worst = max(worst, gather_kernel_vs_plain(torch, name, build(), interpolation, chunk, channels)
                    ["fast_sum_max_abs"])
    gather_kernel_vs_plain(torch, "tracks_300", many_tracks_gather_session(), chunk=1 << 15, fast_sum_atol=None)
    return {"fast_sum_max_abs": worst}


def card_busy_ms(torch, fn, names=None):
    """One profiled call of ``fn`` after a warm one -> (busy_ms, stage_ms).
    ``names``, a dict when given, gets for each ``wb.*`` range label the set
    of the device kernels' names that ran inside its span.
    ``busy_ms``: the card's busy time, the sum of the device kernels
    ``torch.profiler`` records (the operators' device time repeats them,
    so only the kernels' own events count; None when it records none).
    ``stage_ms``: for each of the generic finisher's ``wb.*`` ranges
    (``effects_generic._apply_group`` per stage, ``_chunk_step``'s gains
    and sum), the busy time of the kernels that ran inside the range's span
    on the card's timeline, summed over the stream (kernels launched
    outside a torch operator, as the cascade kernel is, count too), and
    ``other`` for the rest of ``busy_ms`` (chunk slices, the groups'
    gathers and scatters, the clip); ``span:*`` the spans themselves,
    which hold the card's idle time under the profiler as well. Prints the
    profiler's table of the busiest."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.key.startswith("wb."))
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            if e.name.startswith("wb."):
                spans.append((e.time_range.start, e.time_range.end, e.name[3:]))
            else:
                kernels.append((e.time_range.start, e.time_range.end, e.name))
    kernels.sort()
    stages, span_ms = {}, {}
    for a, b, label in spans:
        inside = 0.0
        for k0, k1, kname in kernels[bisect.bisect_left(kernels, (a,)):]:
            if k0 >= b:
                break
            inside += min(k1, b) - k0
            if names is not None:
                names.setdefault(label, set()).add(kname)
        stages[label] = stages.get(label, 0.0) + inside / 1e3
        span_ms[f"span:{label}"] = span_ms.get(f"span:{label}", 0.0) + (b - a) / 1e3
    if busy_us > 0:
        stages["other"] = busy_us / 1e3 - sum(stages.values())
    stages.update(span_ms)
    print("[profile] " + events.table(sort_by="device_time_total", row_limit=14,
                                       max_name_column_width=60).replace("\n", "\n[profile] "))
    return (busy_us / 1e3 if busy_us > 0 else None), stages


def dynamics_stages(name, parts, names) -> dict:
    """The busy ms of the dynamics stages' ``wb.*`` ranges (compressor,
    limiter, gate) in a :func:`card_busy_ms` trace, each checked to run the
    fused dynamics kernel and nothing but it and the memset of its flags:
    no torch-op detector, curve or gain."""
    out = {}
    for label, ms in parts.items():
        if label.startswith("span:") or label.split(".")[-1] not in ("compressor", "limiter", "gate"):
            continue
        ran = names.get(label, set())
        others = sorted(k for k in ran if "dyn_kernel" not in k and "memset" not in k.lower())
        check(any("dyn_kernel" in k for k in ran), f"{name}: {label} ran no fused dynamics kernel")
        check(not others, f"{name}: {label} ran {others} beside the fused dynamics kernel")
        out[label] = ms
    print(f"[{name}] dynamics stages' busy ms (profiler, the fused kernel alone in each range): " + json.dumps(out))
    return out


def phase_generic(torch) -> dict:
    """``generic_fx_128trk``: ``bounce(device="cuda")`` (one K4 launch, the
    cascade kernel for the EQ group and the master highpass), the
    finisher's first 10 s on the card against the same finisher on the
    CPU, one track of each signature and the master over 2 s against the
    f64 chains, 5 warm iterations, the time per stage kind and the chunk
    sweep."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda, mix_cuda
    from whitebox_tpu_torch.ops import dynamics as dyn
    from whitebox_tpu_torch.render import effects_generic as gen
    from whitebox_tpu_torch.render.bounce import _effects_finisher, bounce
    from whitebox_tpu_torch.render.effects_pipeline import _chains_of
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.render.roofline import fx_cost
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, duration = "generic_fx_128trk", 60.0
    session = generic_fx_128trk(duration)
    dev = torch.device("cuda")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = bounce(session, RATE, device="cuda")
    bounce_peak = torch.cuda.max_memory_allocated() / 1e9
    k4, casc = mix_cuda.mix_per_track_launches, biquad_cuda.biquad_cascade_launches
    dyn_launches = dynamics_cuda.dynamics_fused_launches
    check(k4 == 1 and mix_cuda.mix_kernel_launches == 0 and mix_cuda.mix_auto_launches == 0,
          f"{name}: mix launches {mix_launches()} (want one K4)")
    check(casc > 0, f"{name}: the static EQ and highpass stages never ran the cascade kernel")
    check(dyn_launches > 0 and dynamics_cuda.dynamics_scan_launches == 0,
          f"{name}: the compressor and limiter stages ran the fused dynamics kernel {dyn_launches} times and "
          f"the unfused one {dynamics_cuda.dynamics_scan_launches} (want one fused launch a call)")
    check(res.stats.mix_path == "kernel" and np.isfinite(res.audio).all()
          and float(np.abs(res.audio).max()) > 0.01, f"{name}: output")
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; finisher "
          f"{res.stats.finish_seconds * 1e3:.3f} ms; K4 launches={k4}; cascade kernel launches={casc}; "
          f"fused dynamics kernel launches={dyn_launches}; peak memory {bounce_peak:.2f} GB")

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = warm.plan
    pt = warm.render_device_per_track()
    tg = warm.tables["track_gain"]
    T, C = p.num_tracks, p.channels
    fx = gen.prepare_generic_fx(session, RATE, C)
    chunk = gen.auto_chunk_frames(fx, device=dev)
    f10, f2 = int(10 * RATE), int(2 * RATE)
    # the dynamics kernel at full width on the first compressor group's first
    # chunk: the fused stage, and its ballistics alone on the group's gain
    # reductions (the frame-sharded stages' form), against their plain versions
    gp, _ = gen.device_params(fx, dev)
    group, static, prm = next((g, static, prm) for g, plist in zip(fx.groups, gp)
                              for (kind, static, _), prm in zip(g.stages, plist) if kind == "compressor")
    col = {k: v[:, None] for k, v in prm.items() if k != "auto"}
    xg = pt[torch.as_tensor(np.asarray(group.track_idx), device=dev), :, :chunk]
    zrow = torch.zeros(xg.shape[0], device=dev)
    fused_full = fused_vs_plain(f"{name}_compressor_stage_full_width", torch, "compressor", xg, col,
                                {"red": zrow, "att": zrow, "det": zrow}, detector=static[0])
    r_db = dyn.compressor_reduction_db(dyn._level_db(xg.abs().amax(dim=-2)), col["threshold_db"], col["ratio"],
                                       col["knee_db"])
    dyn_full = dynamics_vs_plain(f"{name}_compressor_ballistics_full_width", torch, r_db, col["release"],
                                 col["attack"], zrow, zrow)
    del xg, r_db
    t0 = time.perf_counter()
    on_card = run(make_finisher("generic", session, RATE, tg, chunk=chunk, device=dev), pt[:, :, :f10], f10,
                  valid_frames=f10).out.cpu().numpy()
    on_cpu = run(make_finisher("generic", session, RATE, tg.cpu(), chunk=chunk), pt[:, :, :f10].cpu(), f10,
                 valid_frames=f10).out.numpy()
    cpu_s = time.perf_counter() - t0
    rr_cpu = rel_rms(on_card, on_cpu)
    check(rr_cpu < GENERIC_REL_RMS, f"{name}: finisher on the card {rr_cpu:.3g} off the CPU's")
    n = min(on_card.shape[1], res.frames)
    check(rel_rms(on_card[:, :n], res.audio[:, :n]) < GENERIC_REL_RMS, f"{name}: the bounce's first 10 s "
          "differ from the finisher's")

    # one track of each signature (an EQ group track, a compressor group
    # track) and the master against the f64 chains over the first 2 s
    chains, master = _chains_of(session)
    stems = run(make_finisher("generic", session, RATE, tg, form="stems", chunk=chunk, device=dev),
                pt[:, :, :f2], f2).out
    stems = stems.cpu().double().numpy()
    x = pt[:, :, :f2].cpu().double().numpy()
    tgh = tg.cpu().double().numpy()
    sig = {}
    for t in (0, 16, 48):
        ref = gen.reference_run_chain(chains[t], x[t], None, RATE, C, session.time_base) * tgh[t][:, None]
        sig[t] = rel_rms(stems[t], ref)
        check(sig[t] < GENERIC_F64_REL_RMS, f"{name}: track {t} chain {sig[t]:.3g} off the f64 chain")
    mref = np.clip(gen.reference_run_chain(master, stems.sum(axis=0), None, RATE, C, session.time_base), -1, 1)
    rr_master = rel_rms(on_card[:, :f2], mref)
    check(rr_master < GENERIC_F64_REL_RMS, f"{name}: master {rr_master:.3g} off the f64 master chain")
    print(f"[{name}] finisher's first 10 s on the card vs the CPU relative RMS {rr_cpu:.3g} (< "
          f"{GENERIC_REL_RMS}; CPU {cpu_s:.1f} s); first 2 s vs f64 chains: tracks "
          f"{ {t: f'{v:.3g}' for t, v in sig.items()} }, master {rr_master:.3g} (< {GENERIC_F64_REL_RMS})")
    del stems, x, on_cpu

    legs = _finisher_rows(torch, session, pool, warm.pool_device, "scan")
    finish = _effects_finisher(session, warm, p, RATE, "scan", False, dev)
    k4_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(warm.pool_device, warm.tables, p.n_tiles,
                                                                    p.tile, C), 10)
    finish_ms, finish_all = _event_ms(torch, lambda: finish(pt), 3)
    names = {}
    busy_ms, parts = card_busy_ms(torch, lambda: finish(pt), names)
    dyn_stages = dynamics_stages(name, parts, names)
    sweep = {}
    for c in GENERIC_CHUNK_SWEEP:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fin = make_finisher("generic", session, RATE, tg, chunk=c, device=dev)
        ms, _ = _event_ms(torch, lambda: run(fin, pt, pt.shape[-1], valid_frames=p.total_frames), 3)
        sweep[c] = {"ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    fcost = fx_cost(session, p.total_frames, C)
    stats = {
        "cell": name, "tracks": T, "audio_seconds": duration, "frames": int(p.total_frames),
        "groups": [[len(g.track_idx), [k for k, _, _ in g.stages]] for g in fx.groups],
        "master": [k for k, _, _ in fx.master.stages], "chunk": chunk, **legs,
        "rtf_median": duration / (legs["e2e_ms_median"] / 1e3), "k4_ms": k4_ms, "finish_ms": finish_ms, "finish_ms_all": finish_all,
        "stage_ms": parts, "chunk_sweep": {str(c): v for c, v in sweep.items()},
        # the card's busy time in one finisher call (torch.profiler, kernels'
        # own device time), against the call's event time: its idle share
        "finish_busy_ms": busy_ms,
        "finish_idle_share": None if busy_ms is None else 1.0 - busy_ms / finish_ms,
        # the finisher is torch ops (and the cascade kernel), not a kernel: its
        # least time by the cost model's finish and stage terms
        "finish_bound_ms": least_ms(fcost.hbm_bytes, fcost.mxu_flops)["bound_ms"],
        "finish_bound_bytes": fcost.hbm_bytes,
        "bounce_peak_mem_gb": bounce_peak, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "k4_launches": k4, "cascade_launches": casc, "dynamics_launches": dyn_launches,
        "dynamics_full_width": dyn_full, "dynamics_fused_full_width": fused_full, "dynamics_stage_ms": dyn_stages,
    }
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return stats


def phase_long(torch) -> dict:
    """``effects_eq_240s_128trk``: config 5's chains on a 240 s session
    (11.8 GB of per-track buffers). ``bounce`` keeps it on K4 (one launch)
    and the scan finisher, since the buffers fit the card's share of free
    memory (``render/bounce.py::per_track_limit_bytes``); the same bounce
    under the JAX package's 6 GiB rule takes the gather path and the
    streaming scan finisher (no mix-kernel launch, the cascade kernel per
    chunk), held to the K4 path (relative RMS 1e-5); 3 warm iterations of
    each."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    name, duration = "effects_eq_240s_128trk", 240.0
    session = effects_eq_128trk(duration)
    dev = torch.device("cuda")
    limit_gb = bounce_mod.per_track_limit_bytes(dev) / 1e9
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4 = bounce_mod.bounce(session, RATE, device="cuda")
    k4_peak = torch.cuda.max_memory_allocated() / 1e9
    k4_launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    check(k4.stats.mix_path == "kernel" and k4_launches == {"mix": 0, "auto": 0, "per_track": 1},
          f"{name}: path {k4.stats.mix_path}, mix launches {k4_launches} (want one K4 within the "
          f"card's {limit_gb:.1f} GB per-track limit)")
    check(casc > 0, f"{name}: the scan finisher never ran the cascade kernel")
    check(np.isfinite(k4.audio).all() and float(np.abs(k4.audio).max()) > 0.01, f"{name}: output")
    print(f"[{name}] bounce(device='cuda'): {k4.stats.summary()}; per-track limit on this card "
          f"{limit_gb:.1f} GB; K4 launches={k4_launches['per_track']}; cascade kernel launches={casc}; "
          f"peak memory {k4_peak:.2f} GB")

    def jax_rule(dev):  # the JAX package's 6 GiB, as on the CPU
        return bounce_mod.PER_TRACK_LIMIT_BYTES

    card_rule = bounce_mod.per_track_limit_bytes
    bounce_mod.per_track_limit_bytes = jax_rule
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = bounce_mod.bounce(session, RATE, device="cuda")
        gather_peak = torch.cuda.max_memory_allocated() / 1e9
        gather_launches, gcasc = mix_launches(), biquad_cuda.biquad_cascade_launches
        check(res.stats.mix_path == "gather", f"{name} (6 GiB rule): took the {res.stats.mix_path} path")
        check(not any(gather_launches.values()), f"{name} (6 GiB rule): mix kernel launches {gather_launches}")
        gk = check_gather_launches(f"{name} (6 GiB rule)", res.stats.gather_chunks)
        check(gcasc > 0, f"{name} (6 GiB rule): the streaming finisher never ran the cascade kernel")
        rr = rel_rms(res.audio, k4.audio)
        check(res.audio.shape == k4.audio.shape and rr < 1e-5, f"{name}: gather vs K4 relative RMS {rr:.3g}")
        print(f"[{name}] the same bounce under the 6 GiB rule: {res.stats.summary()}; gather path, mix "
              f"launches {gather_launches}, gather-kernel launches {gk} for {res.stats.gather_chunks} chunks, "
              f"cascade kernel launches={gcasc}; peak memory {gather_peak:.2f} GB; "
              f"vs the K4 path relative RMS {rr:.3g} (< 1e-05)")
        gather_rows = _long_rows(torch, bounce_mod, session)
    finally:
        bounce_mod.per_track_limit_bytes = card_rule
    k4_rows = _long_rows(torch, bounce_mod, session)
    stats = {"cell": name, "tracks": 128, "audio_seconds": duration, "frames": k4.frames,
             "per_track_gb": 128 * 2 * k4.frames * 4 / 1e9, "per_track_limit_gb": limit_gb}
    for path, rows, r, peak in (("k4", k4_rows, k4, k4_peak), ("gather", gather_rows, res, gather_peak)):
        wall, carve_s, dev_s, read_s = (statistics.median(c) for c in zip(*rows))
        cost = r.stats.cost
        stats[path] = {"e2e_ms_median": wall * 1e3, "e2e_ms_best": min(row[0] for row in rows) * 1e3,
                       "rtf_median": duration / wall, "carve_pack_ms": carve_s * 1e3,
                       "device_ms": dev_s * 1e3, "readback_ms": read_s * 1e3,
                       "device_bound_ms": least_ms(cost.hbm_bytes, cost.mxu_flops)["bound_ms"],
                       "cost_bytes": cost.hbm_bytes, "peak_mem_gb": peak}
    stats.update({"gather_vs_k4_rel_rms": rr, "k4_launches": k4_launches, "cascade_launches": casc,
                  "gather_launches": gather_launches, "gather_kernel_launches": gk,
                  "gather_cascade_launches": gcasc})
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return stats


def _long_rows(torch, bounce_mod, session, n=3):
    """``n`` warm bounces -> [(wall, carve, device, readback) seconds]."""
    rows = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = bounce_mod.bounce(session, RATE, device="cuda")
        rows.append((time.perf_counter() - t0, r.stats.carve_seconds, r.stats.device_seconds,
                     r.stats.readback_seconds))
    return rows


def _finisher_rows(torch, session, pool, pool_dev, effects_mode, n=5):
    """``n`` warm carve+plan+upload+preparation+K4+finisher iterations ->
    medians and best (seconds): carve, plan, upload, prep, launch-to-sync, e2e."""
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.render.bounce import _effects_finisher
    from whitebox_tpu_torch.timeline.carve import carve_session

    dev = torch.device("cuda")
    rows = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_, p_ = carve_session(session, RATE, buffer_size=512, pool=pool, slow_emit="runs")
        t1 = time.perf_counter()
        plan = build_plan(t_, p_, session)
        t2 = time.perf_counter()
        r = mix_cuda.CudaMixRenderer(t_, p_, session, device="cuda", plan=plan, pool_device=pool_dev)
        t3 = time.perf_counter()
        finish = _effects_finisher(session, r, plan, RATE, effects_mode, False, dev)
        t4 = time.perf_counter()
        finish(r.render_device_per_track())
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0))
        del r, finish
    med = [statistics.median(c) for c in zip(*rows)]
    return {"e2e_ms_median": med[5] * 1e3, "e2e_ms_best": min(r[-1] for r in rows) * 1e3,
            "carve_ms": med[0] * 1e3, "plan_ms": med[1] * 1e3, "upload_ms": med[2] * 1e3,
            "fx_prep_ms": med[3] * 1e3, "launch_to_sync_ms": med[4] * 1e3}


def phase_routed_small(torch) -> None:
    """The routed finisher on the card against the CPU (relative RMS 1e-5)
    and the f64 reference (5e-5) on a small session with every routing
    feature, and its bounce: one K4 launch, the gather path none."""
    import numpy as np

    from whitebox_tpu_torch.render import routing as rt
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    s = routed_small()
    table, pool = carve_session(s, RATE, buffer_size=512)
    pt = render_segments_per_track_numpy(table, pool)
    tg = np.array([[np.float32((np.float32(0.0) if t.mute else t.volume_linear) * np.float32(t.pan_coeffs[c]))
                    for c in range(2)] for t in s.tracks], np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        fin = make_finisher("routed", s, RATE, torch.from_numpy(tg).to(dev), pdc=True, chunk=4096, device=dev)
        outs[dev] = run(fin, torch.from_numpy(pt).to(dev), pt.shape[-1]).out.cpu().numpy()
    ref = rt.reference_routed_finish(pt, s, RATE, pdc=True)
    rr_cpu, rr_f64 = rel_rms(outs["cuda"], outs["cpu"]), rel_rms(outs["cuda"], ref)
    check(float(np.abs(ref).max()) > 0.01, "routed_small: silent reference")
    check(rr_cpu < GENERIC_REL_RMS, f"routed_small: card vs CPU relative RMS {rr_cpu:.3g}")
    check(rr_f64 < GENERIC_F64_REL_RMS, f"routed_small: card vs f64 relative RMS {rr_f64:.3g}")
    reset_launches()
    k4 = bounce(s, RATE, device="cuda", pdc=True)
    k4_launches = mix_launches()
    reset_launches()
    gather = bounce(s, RATE, device="cuda", engine="xla", chunk_frames=8192)
    gather_launches = mix_launches()
    check(k4.stats.mix_path == "kernel" and k4_launches == {"mix": 0, "auto": 0, "per_track": 1},
          f"routed_small: mix launches {k4_launches} (want one K4)")
    check(gather.stats.mix_path == "gather" and not any(gather_launches.values()),
          f"routed_small: the gather path launched {gather_launches}")
    gk = check_gather_launches("routed_small (xla)", gather.stats.gather_chunks)
    cpu = bounce(s, RATE, device="cpu", engine="xla", chunk_frames=8192).audio
    rr_gather = rel_rms(gather.audio, cpu)
    check(rr_gather < GENERIC_REL_RMS, f"routed_small: gather bounce card vs CPU {rr_gather:.3g}")
    print(f"[routed-small] routed finisher (PDC) on the card vs CPU relative RMS {rr_cpu:.3g} (< "
          f"{GENERIC_REL_RMS}), vs f64 reference_routed_finish {rr_f64:.3g} (< {GENERIC_F64_REL_RMS}); "
          f"bounce: K4 launches {k4_launches['per_track']}, gather path launches {gather_launches} "
          f"(gather kernel {gk}), "
          f"gather card vs CPU {rr_gather:.3g}")


def phase_routed(torch) -> dict:
    """``routed_sidechain_128trk`` (config 6): one K4 launch then the routed
    finisher; its first 10 s on the card against the CPU's (1e-5), its
    first 2 s against the f64 ``reference_routed_finish`` (5e-5); the same
    session through ``engine="xla"`` (no mix-kernel launch, 1e-6 off the
    K4 path at equal chunks); 5 warm iterations, the stages by
    ``torch.profiler`` (``wb.route.matmul``, ``wb.bus.<kind>``, ...) and
    the chunk sweep that chose the card's default."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda, mix_cuda
    from whitebox_tpu_torch.render import routing as rt
    from whitebox_tpu_torch.render.bounce import _effects_finisher, bounce
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.render.roofline import fx_cost, routing_cost
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, duration = "routed_sidechain_128trk", 60.0
    session = routed_sidechain_128trk(duration)
    dev = torch.device("cuda")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = bounce(session, RATE, device="cuda")
    bounce_peak = torch.cuda.max_memory_allocated() / 1e9
    k4_launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    dyn_launches = dynamics_cuda.dynamics_fused_launches
    check(res.stats.mix_path == "kernel" and k4_launches == {"mix": 0, "auto": 0, "per_track": 1},
          f"{name}: path {res.stats.mix_path}, mix launches {k4_launches} (want one K4)")
    check(casc > 0, f"{name}: the EQ buses and the master highpass never ran the cascade kernel")
    check(dyn_launches > 0 and dynamics_cuda.dynamics_scan_launches == 0,
          f"{name}: the bus compressors and the master limiter ran the fused dynamics kernel {dyn_launches} "
          f"times and the unfused one {dynamics_cuda.dynamics_scan_launches} (want one fused launch a call)")
    check(np.isfinite(res.audio).all() and float(np.abs(res.audio).max()) > 0.01, f"{name}: output")
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; finisher "
          f"{res.stats.finish_seconds * 1e3:.3f} ms; K4 launches={k4_launches['per_track']}; "
          f"cascade kernel launches={casc}; fused dynamics kernel launches={dyn_launches}; "
          f"peak memory {bounce_peak:.2f} GB")

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = warm.plan
    pt = warm.render_device_per_track()
    tg = warm.tables["track_gain"]
    T, C = p.num_tracks, p.channels
    rfx = rt.prepare_routed_fx(session, RATE, C, device=dev)
    chunk = rt.routed_auto_chunk_frames(rfx, device=dev)
    f10, f2 = int(10 * RATE), int(2 * RATE)
    t0 = time.perf_counter()
    on_card = run(make_finisher("routed", session, RATE, tg, chunk=chunk, device=dev), pt[:, :, :f10], f10,
                  valid_frames=f10).out.cpu().numpy()
    on_cpu = run(make_finisher("routed", session, RATE, tg.cpu(), chunk=chunk), pt[:, :, :f10].cpu(), f10,
                 valid_frames=f10).out.numpy()
    cpu_s = time.perf_counter() - t0
    rr_cpu = rel_rms(on_card, on_cpu)
    check(rr_cpu < GENERIC_REL_RMS, f"{name}: routed finisher on the card {rr_cpu:.3g} off the CPU's")
    rr_bounce = rel_rms(on_card, res.audio[:, :f10])
    check(rr_bounce < GENERIC_REL_RMS, f"{name}: the bounce's first 10 s {rr_bounce:.3g} off the finisher's")
    t0 = time.perf_counter()
    ref = rt.reference_routed_finish(pt[:, :, :f2].cpu().numpy(), session, RATE, C)
    ref_s = time.perf_counter() - t0
    short = run(make_finisher("routed", session, RATE, tg, chunk=chunk, device=dev), pt[:, :, :f2],
                f2).out.cpu().numpy()
    rr_f64 = rel_rms(short, ref)
    check(rr_f64 < GENERIC_F64_REL_RMS, f"{name}: first 2 s {rr_f64:.3g} off reference_routed_finish")
    print(f"[{name}] routed finisher's first 10 s on the card vs the CPU relative RMS {rr_cpu:.3g} (< "
          f"{GENERIC_REL_RMS}; CPU {cpu_s:.1f} s), the bounce's {rr_bounce:.3g}; first 2 s vs the f64 "
          f"reference_routed_finish {rr_f64:.3g} (< {GENERIC_F64_REL_RMS}; {ref_s:.1f} s)")
    del on_cpu, ref, short

    reset_launches()
    xla = bounce(session, RATE, device="cuda", engine="xla", chunk_frames=chunk)
    xla_launches = mix_launches()
    rr_xla = rel_rms(xla.audio, res.audio)
    check(xla.stats.mix_path == "gather" and not any(xla_launches.values()),
          f"{name}: engine='xla' took {xla.stats.mix_path}, mix launches {xla_launches}")
    xla_gather = check_gather_launches(f"{name} (xla)", xla.stats.gather_chunks)
    check(xla.audio.shape == res.audio.shape and rr_xla < 1e-6,
          f"{name}: engine='xla' {rr_xla:.3g} off the K4 path")
    print(f"[{name}] bounce(engine='xla', chunk_frames={chunk}): {xla.stats.summary()}; mix launches "
          f"{xla_launches}, gather-kernel launches {xla_gather}; vs the K4 path relative RMS {rr_xla:.3g} "
          f"(< 1e-06)")

    torch.cuda.reset_peak_memory_stats()
    legs = _finisher_rows(torch, session, pool, warm.pool_device, "routed")
    peak = torch.cuda.max_memory_allocated() / 1e9
    finish = _effects_finisher(session, warm, p, RATE, "routed", False, dev)
    k4_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(warm.pool_device, warm.tables, p.n_tiles,
                                                                    p.tile, C), 10)
    finish_ms, finish_all = _event_ms(torch, lambda: finish(pt), 3)
    names = {}
    busy_ms, parts = card_busy_ms(torch, lambda: finish(pt), names)
    dyn_stages = dynamics_stages(name, parts, names)
    sweep = {}
    for c in ROUTED_CHUNK_SWEEP:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fin = make_finisher("routed", session, RATE, tg, chunk=c, device=dev)
        ms, _ = _event_ms(torch, lambda: run(fin, pt, pt.shape[-1], valid_frames=p.total_frames), 3)
        sweep[c] = {"ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    cost = fx_cost(session, p.total_frames, C)
    for k, (b, f) in routing_cost(session, p.total_frames, C).terms.items():
        cost.add(k, b, f)
    stats = {
        "cell": name, "tracks": T, "buses": rfx.num_buses, "audio_seconds": duration,
        "frames": int(p.total_frames),
        "bus_groups": [[np.asarray(g.track_idx).tolist(), [k for k, _, _ in g.stages]] for g in rfx.bus_groups],
        "master": [k for k, _, _ in rfx.fx.master.stages], "chunk": chunk, **legs,
        "rtf_median": duration / (legs["e2e_ms_median"] / 1e3),
        "k4_ms": k4_ms, "finish_ms": finish_ms, "finish_ms_all": finish_all,
        "finish_busy_ms": busy_ms, "stage_ms": parts,
        "finish_idle_share": None if busy_ms is None else 1.0 - busy_ms / finish_ms,
        "card_idle_share": 1.0 - (k4_ms + (finish_ms if busy_ms is None else busy_ms)) / legs["e2e_ms_median"],
        "finish_bound_ms": least_ms(cost.hbm_bytes, cost.mxu_flops)["bound_ms"],
        "finish_bound_bytes": cost.hbm_bytes, "chunk_sweep": {str(c): v for c, v in sweep.items()},
        "xla_device_ms": xla.stats.device_seconds * 1e3, "xla_wall_ms": xla.stats.wall_seconds * 1e3,
        "bounce_peak_mem_gb": bounce_peak, "peak_mem_gb": peak,
        "k4_launches": k4_launches["per_track"], "cascade_launches": casc, "dynamics_launches": dyn_launches,
        "dynamics_stage_ms": dyn_stages, "xla_launches": xla_launches, "xla_gather_launches": xla_gather,
    }
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return stats


def phase_midi(torch) -> dict:
    """``midi_synth_128trk``: one K4 launch, the synth added on the card,
    the scan finisher; the synth rows bit-equal to ``render_synth_numpy``,
    the first 10 s bit-equal to the same bounce on the CPU, the same
    session through ``engine="xla"`` (no mix-kernel launch) bit-equal to
    the K4 path; 5 warm iterations, the synth's and the finisher's device
    times."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda, mix_cuda
    from whitebox_tpu_torch.render.bounce import (
        _add_synth, _effects_finisher, _prepare_synth_tables, bounce,
    )
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, duration = "midi_synth_128trk", 60.0
    session = midi_synth_128trk(duration)
    dev = torch.device("cuda")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = bounce(session, RATE, device="cuda")
    bounce_peak = torch.cuda.max_memory_allocated() / 1e9
    k4_launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    check(res.stats.mix_path == "kernel" and k4_launches == {"mix": 0, "auto": 0, "per_track": 1},
          f"{name}: path {res.stats.mix_path}, mix launches {k4_launches} (want one K4)")
    check(np.isfinite(res.audio).all() and float(np.abs(res.audio).max()) > 0.01, f"{name}: output")
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; finisher (synth + scan) "
          f"{res.stats.finish_seconds * 1e3:.3f} ms; K4 launches={k4_launches['per_track']}; "
          f"cascade kernel launches={casc} (the scan finisher's identity sections); "
          f"peak memory {bounce_peak:.2f} GB")

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = warm.plan
    F = p.n_tiles * p.tile
    synth = _prepare_synth_tables(session, RATE, 512, p.total_frames // 512, dev)
    t0 = time.perf_counter()
    want = synth_rows_numpy(session, p.total_frames)
    host_s = time.perf_counter() - t0
    check(sorted(want) == synth["rows"] and len(want) == 16, f"{name}: MIDI tracks {synth['rows']}")
    rows = _add_synth(torch.zeros((len(session.tracks), 1, F), device=dev), synth, 0, F)
    rows = rows[synth["rows"], 0, :p.total_frames].cpu().numpy()
    for i, t in enumerate(synth["rows"]):
        check(np.array_equal(rows[i], want[t]), f"{name}: track {t}'s synth on the card != render_synth_numpy")
    f10 = int(10 * RATE)
    cpu = bounce(session, RATE, device="cpu", num_blocks=f10 // 512).audio
    check(np.array_equal(cpu, res.audio[:, :cpu.shape[1]]), f"{name}: first 10 s on the card != the CPU's")
    reset_launches()
    xla = bounce(session, RATE, device="cuda", engine="xla")
    xla_launches = mix_launches()
    check(xla.stats.mix_path == "gather" and not any(xla_launches.values()),
          f"{name}: engine='xla' took {xla.stats.mix_path}, mix launches {xla_launches}")
    xla_gather = check_gather_launches(f"{name} (xla)", xla.stats.gather_chunks)
    check(np.array_equal(xla.audio, res.audio), f"{name}: engine='xla' != the K4 path")
    voices = int(synth["tables"]["start"].shape[1])
    print(f"[{name}] synth of {len(want)} tracks ({voices} voice slots) on the card bit-equal to "
          f"render_synth_numpy ({host_s:.1f} s on the host); first 10 s bit-equal to the CPU bounce; "
          f"engine='xla' ({xla.stats.summary()}) mix launches {xla_launches}, gather-kernel launches "
          f"{xla_gather}, bit-equal to the K4 path")
    del cpu, rows

    torch.cuda.reset_peak_memory_stats()
    legs = _finisher_rows(torch, session, pool, warm.pool_device, "scan")
    peak = torch.cuda.max_memory_allocated() / 1e9
    pt = warm.render_device_per_track()
    finish = _effects_finisher(session, warm, p, RATE, "scan", False, dev)
    k4_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(warm.pool_device, warm.tables, p.n_tiles,
                                                                    p.tile, p.channels), 10)
    synth_ms, _ = _event_ms(torch, lambda: _add_synth(pt, synth, 0, F), 5)
    finish_ms, finish_all = _event_ms(torch, lambda: finish(pt), 5)
    busy_ms, parts = card_busy_ms(torch, lambda: finish(pt))
    cells = len(synth["rows"]) * voices * p.total_frames
    stats = {
        "cell": name, "tracks": p.num_tracks, "midi_tracks": len(synth["rows"]), "voice_slots": voices,
        "notes_per_track": 960, "audio_seconds": duration, "frames": int(p.total_frames), **legs,
        "rtf_median": duration / (legs["e2e_ms_median"] / 1e3),
        "k4_ms": k4_ms, "synth_ms": synth_ms, "finish_ms": finish_ms, "finish_ms_all": finish_all,
        "finish_busy_ms": busy_ms, "stage_ms": parts,
        "finish_idle_share": None if busy_ms is None else 1.0 - busy_ms / finish_ms,
        "card_idle_share": 1.0 - (k4_ms + (finish_ms if busy_ms is None else busy_ms)) / legs["e2e_ms_median"],
        # the synth: per (slot, frame) cell ~20 int and f32 operations and
        # the tables read; it writes its rows into a copy of the buffers
        # (read and written once) -> its least time
        "synth_bound_ms": least_ms(2 * p.num_tracks * p.channels * F * 4, 20 * cells)["bound_ms"],
        "xla_device_ms": xla.stats.device_seconds * 1e3, "xla_wall_ms": xla.stats.wall_seconds * 1e3,
        "bounce_peak_mem_gb": bounce_peak, "peak_mem_gb": peak,
        "k4_launches": k4_launches["per_track"], "cascade_launches": casc, "xla_launches": xla_launches,
        "xla_gather_launches": xla_gather,
    }
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return stats


# ---------------------------------------------------- export deliverables

#: loudness bars of the card's measurement against the f64 host reference:
#: LU for the three loudness readings and LRA, dB for the true peak
LOUDNESS_BARS = {"integrated_lufs": 0.02, "momentary_max_lufs": 0.02, "shortterm_max_lufs": 0.02,
                 "lra_lu": 0.05, "true_peak_dbtp": 0.05}
#: seconds of each export held against the same finisher on the CPU
STEMS_CPU_SECONDS, BUS_STEMS_CPU_SECONDS = 10.0, 2.0
#: frames of the peaks cell's sample: 10 minutes at 48 kHz
PEAKS_FRAMES = 28_800_000


def program_signal(seconds: float, seed: int = 17):
    """A seeded stereo programme: two tones with vibrato and a third tone
    under a moving level, a hum, and noise bursts on every beat at 120 bpm."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    level = 0.6 + 0.4 * np.sin(2 * np.pi * 0.05 * t)
    x = np.stack([0.25 * np.sin(2 * np.pi * f * t + d * np.sin(2 * np.pi * 5.0 * t))
                  + 0.12 * np.sin(2 * np.pi * 1244.5 * t + c) + 0.05 * np.sin(2 * np.pi * 55.0 * t)
                  for c, (f, d) in enumerate(((220.0, 0.6), (330.0, 0.9)))])
    burst = np.exp(-(t % 0.5) * 30.0)
    return (x * level + 0.15 * burst * rng.standard_normal((2, n))).astype(np.float32)


def peaks_sample(fmt, n: int, seed: int = 23):
    """A seeded stereo sample of ``n`` frames in ``fmt`` (F32 or I16): noise
    under a slow envelope, with ties (a frame repeated every 4096)."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session.sample import Sample

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n), dtype=np.float32) * np.float32(0.3)
    x *= np.float32(0.5) + np.float32(0.5) * np.sin(np.arange(n, dtype=np.float32) * np.float32(2e-5))
    x[:, ::4096] = x[:, 1::4096]
    x = np.clip(x, -1.0, 1.0)
    data = x if fmt == AudioFormat.F32 else np.round(x * 32767.0).astype(np.int16)
    return Sample.from_planar(np.ascontiguousarray(data), int(RATE), fmt)


def check_mipmaps(got, sample, quality: str) -> None:
    """Every level of ``got`` bit-identical to the C++ scalar walk
    (``io/native.py::peaks_level``) over the host's quantized codes."""
    import numpy as np

    from whitebox_tpu_torch.io import native
    from whitebox_tpu_torch.ops import peaks

    mips = peaks.mip_levels_for(sample.count)
    check([lv.mip_level for lv in got.levels] == mips, f"peaks {quality}: levels != {mips}")
    for c in range(sample.channels):
        codes = peaks.quantize_codes(sample.data[c], sample.format, quality)
        for lv in got.levels:
            walk = native.peaks_level(codes, lv.mip_level, peaks.level_out_count(sample.count, lv.mip_level))
            check(walk is not None, "peaks: no native host library (no g++) for the scalar walk")
            check(np.array_equal(walk.astype(lv.data.dtype), lv.data[c]),
                  f"peaks {sample.format.name} {quality}: mip {lv.mip_level} channel {c} != the C++ walk")


def _wall_ms(torch, fn, n=3):
    """``n`` calls of ``fn``, each synchronised -> (median ms by the host
    clock, all ms, the results)."""
    ts, outs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts, outs


def _pinned_readback(torch, t) -> dict:
    """What the readback of ``t`` would take into page-locked host memory
    (not what the port does: ``render_stems`` returns pageable NumPy): the
    allocation once, then the copy (median of 3)."""
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    alloc_ms = (time.perf_counter() - t0) * 1e3
    copy_ms, _, _ = _wall_ms(torch, lambda: host.copy_(t).shape)
    return {"pinned_alloc_ms": alloc_ms, "pinned_readback_ms": copy_ms,
            "pinned_readback_gb_per_s": t.numel() * t.element_size() / 1e9 / (copy_ms / 1e3)}


def _without_master(session):
    """``session`` with no master chain: its bounce is the pre-master mix,
    clipped."""
    import copy

    s = copy.copy(session)
    s.master_effects = None
    return s


def _k4_buffer(torch, session):
    """K4's per-track buffer of ``session`` on the card (``[T, C, F]``, a
    view of the padded one), its time by CUDA events (median of 10)."""
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.timeline.carve import carve_session

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = r.plan
    k4_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(r.pool_device, r.tables, p.n_tiles,
                                                                    p.tile, p.channels), 10)
    return r.render_device_per_track()[..., :p.total_frames], k4_ms


def _stems_finisher(session, kind: str, track_gain):
    """The stems finisher ``render_stems`` runs for ``kind`` ("eq": the
    scan's stems form, cascade and gains; "generic": the generic stems
    form), on ``track_gain``'s device -> fn(per_track) -> [T, C, F]."""
    from whitebox_tpu_torch.render.finisher import make_finisher, run

    fin = make_finisher("scan" if kind == "eq" else "generic", session, RATE, track_gain, form="stems",
                        device=track_gain.device)
    return lambda pt: run(fin, pt, pt.shape[-1]).out


def stems_cell(torch, name: str, session, kind: str, rows: list) -> dict:
    """``render_stems(device="cuda")`` with the launch counts reset just
    before: one K4 launch; the stems' sum within atol 5e-5 of the
    pre-master bounce; the first 10 s of the stems of ``rows`` (a track of
    each chain) within relative RMS 1e-5 of the same finisher on the CPU;
    e2e (median of 3), K4 and the stems finisher (CUDA events), the
    readback (median of 3), peak memory."""
    import copy

    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.stems import _track_gains, render_stems

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stems, names = render_stems(session, RATE, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    dyn_launches = dynamics_cuda.dynamics_fused_launches
    check(launches == {"mix": 0, "auto": 0, "per_track": 1}, f"{name}: mix launches {launches} (want one K4)")
    check(casc > 0, f"{name}: the stems finisher never ran the cascade kernel")
    check((dyn_launches > 0 if kind == "generic" else dyn_launches == 0) and dynamics_cuda.dynamics_scan_launches == 0,
          f"{name}: {dyn_launches} fused and {dynamics_cuda.dynamics_scan_launches} unfused dynamics kernel "
          "launches (the generic stems' compressors run the fused one)")
    T, C, F = stems.shape
    check(T == len(session.tracks) == len(names) and np.isfinite(stems).all(), f"{name}: stems {stems.shape}")

    mix = bounce(_without_master(session), RATE, device="cuda").audio
    n = min(F, mix.shape[1])
    sum_err = float(np.abs(np.clip(stems.sum(axis=0, dtype=np.float64), -1.0, 1.0)[:, :n] - mix[:, :n]).max())
    check(sum_err <= 5e-5, f"{name}: the stems' sum {sum_err:.3g} off the pre-master bounce (atol 5e-5)")
    del mix

    pt, k4_ms = _k4_buffer(torch, session)
    tg = _track_gains(session, C, "cuda")
    f10 = int(STEMS_CPU_SECONDS * RATE)
    sub = copy.copy(session)
    sub.tracks = [session.tracks[t] for t in rows]
    t0 = time.perf_counter()
    on_cpu = _stems_finisher(sub, kind, tg[rows].cpu())(pt[rows, :, :f10].cpu()).numpy()
    cpu_s = time.perf_counter() - t0
    rr = max(rel_rms(stems[t, :, :f10], on_cpu[i]) for i, t in enumerate(rows))
    check(rr < GENERIC_REL_RMS, f"{name}: the stems' first 10 s {rr:.3g} off the CPU's")
    print(f"[{name}] render_stems(device='cuda'): {T} stems x {F} frames; K4 launches=1, cascade kernel "
          f"launches={casc}, fused dynamics kernel launches={dyn_launches}, peak memory {peak:.2f} GB; the stems' sum max abs {sum_err:.3g} off the "
          f"pre-master bounce (<= 5e-5); first 10 s of stems {rows} vs the CPU relative RMS max {rr:.3g} "
          f"(< {GENERIC_REL_RMS}; CPU {cpu_s:.1f} s)")
    del stems, on_cpu

    e2e_ms, e2e_all, _ = _wall_ms(torch, lambda: render_stems(session, RATE, device="cuda")[0].shape)
    finish = _stems_finisher(session, kind, tg)
    fin_ms, fin_all = _event_ms(torch, lambda: finish(pt), 3)
    dyn_stages = None
    if kind == "generic":
        names = {}
        _, parts = card_busy_ms(torch, lambda: finish(pt), names)
        dyn_stages = dynamics_stages(name, parts, names)
    out = finish(pt)
    read_ms, _, _ = _wall_ms(torch, lambda: out.cpu().shape)
    pinned = _pinned_readback(torch, out)
    stats = {"cell": name, "tracks": T, "audio_seconds": F / RATE, "frames": F,
             "e2e_ms_median": e2e_ms, "e2e_ms_all": e2e_all, "rtf_median": F / RATE / (e2e_ms / 1e3),
             "k4_ms": k4_ms, "stems_finish_ms": fin_ms, "stems_finish_ms_all": fin_all,
             "readback_ms": read_ms, "stems_gb": out.numel() * 4 / 1e9,
             "readback_gb_per_s": out.numel() * 4 / 1e9 / (read_ms / 1e3), **pinned, "peak_mem_gb": peak,
             "sum_max_abs": sum_err, "cpu_rel_rms_max": rr, "k4_launches": 1, "cascade_launches": casc,
             "dynamics_launches": dyn_launches, "dynamics_stage_ms": dyn_stages}
    print(f"[{name}] " + json.dumps(stats))
    del pt, out
    return stats


def phase_stems(torch) -> tuple[dict, dict]:
    """``stems_eq_128trk`` (config 5's chains: K4, then the scan's stems
    form through the cascade kernel) and ``stems_generic_128trk`` (config 6's
    chains on the flat mix: K4, then the generic stems form): one track of
    each chain signature against the CPU (the CPU's plain scans take
    seconds per track)."""
    eq = stems_cell(torch, "stems_eq_128trk", effects_eq_128trk(60.0), "eq", list(range(0, 128, 16)) + [127])
    generic = stems_cell(torch, "stems_generic_128trk", generic_fx_128trk(60.0), "generic", [0, 16, 48])
    return eq, generic


def phase_bus_stems(torch) -> dict:
    """``bus_stems_routed_128trk`` (config 6 exactly): ``render_bus_stems``
    with the launch counts reset just before (one K4 launch), the master
    chain over ``direct + bus.sum(0)`` within relative RMS 1e-5 of the
    routed bounce, the first 2 s within 1e-5 of the same finisher on the
    CPU; e2e, K4, finisher, readback and peak memory."""
    from whitebox_tpu_torch.ops import biquad_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.finisher import make_finisher, run
    from whitebox_tpu_torch.render.stems import _track_gains, render_bus_stems
    from whitebox_tpu_torch.session.session import Session

    name = "bus_stems_routed_128trk"
    session = routed_sidechain_128trk(60.0)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    direct, bus, names = render_bus_stems(session, RATE, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    check(launches == {"mix": 0, "auto": 0, "per_track": 1}, f"{name}: mix launches {launches} (want one K4)")
    B, C, F = bus.shape
    check(B == 8 and direct.shape == (C, F) and names == [b.name for b in session.buses], f"{name}: shapes")

    # the master chain over the pre-master parts, as a one-track session's
    # generic finisher (unity fader), against the routed bounce
    one = Session(bpm=session.bpm)
    one.add_track("sum")
    one.master_effects = session.master_effects
    total = torch.from_numpy(direct).cuda() + torch.from_numpy(bus).cuda().sum(dim=0)
    master = make_finisher("generic", one, RATE, torch.ones((1, C), device="cuda"), device="cuda")
    recon = run(master, total[None], F).out.cpu().numpy()
    mix = bounce(session, RATE, device="cuda").audio
    rr_mix = rel_rms(recon, mix)
    check(rr_mix < GENERIC_REL_RMS, f"{name}: master(direct + buses) {rr_mix:.3g} off the routed bounce")

    pt, k4_ms = _k4_buffer(torch, session)
    tg = _track_gains(session, C, "cuda")
    f2 = int(BUS_STEMS_CPU_SECONDS * RATE)
    t0 = time.perf_counter()
    d_cpu, b_cpu = run(make_finisher("routed", session, RATE, tg.cpu(), form="stems"), pt[..., :f2].cpu(),
                       f2).out
    cpu_s = time.perf_counter() - t0
    rr_cpu = max(rel_rms(direct[:, :f2], d_cpu.numpy()), rel_rms(bus[:, :, :f2], b_cpu.numpy()))
    check(rr_cpu < GENERIC_REL_RMS, f"{name}: the first 2 s {rr_cpu:.3g} off the CPU's")
    print(f"[{name}] render_bus_stems(device='cuda'): direct + {B} buses x {F} frames; K4 launches=1, "
          f"cascade kernel launches={casc}, peak memory {peak:.2f} GB; master(direct + buses) vs the routed "
          f"bounce relative RMS {rr_mix:.3g} (< {GENERIC_REL_RMS}); first 2 s vs the CPU {rr_cpu:.3g} "
          f"(CPU {cpu_s:.1f} s)")
    del direct, bus, recon, mix

    e2e_ms, e2e_all, _ = _wall_ms(torch, lambda: render_bus_stems(session, RATE, device="cuda")[1].shape)
    finish = make_finisher("routed", session, RATE, tg, form="stems", device="cuda")
    fin_ms, fin_all = _event_ms(torch, lambda: run(finish, pt, pt.shape[-1]), 3)
    d, b = run(finish, pt, pt.shape[-1]).out
    read_ms, _, _ = _wall_ms(torch, lambda: [t.cpu().shape for t in (d, b)])
    stats = {"cell": name, "tracks": len(session.tracks), "buses": B, "audio_seconds": F / RATE, "frames": F,
             "e2e_ms_median": e2e_ms, "e2e_ms_all": e2e_all, "rtf_median": F / RATE / (e2e_ms / 1e3),
             "k4_ms": k4_ms, "bus_finish_ms": fin_ms, "bus_finish_ms_all": fin_all, "readback_ms": read_ms,
             "peak_mem_gb": peak, "master_rel_rms": rr_mix, "cpu_rel_rms": rr_cpu,
             "k4_launches": 1, "cascade_launches": casc}
    print(f"[{name}] " + json.dumps(stats))
    return stats


def phase_loudness(torch) -> dict:
    """``loudness_headline``: ``bounce(loudness=True)`` of the headline
    session with the launch counts reset just before (one mix-kernel
    launch, one cascade launch for the K-weighting); the readings within
    0.02 LU (0.05 LU LRA, 0.05 dB true peak) of the f64 host reference on
    the 60 s output; the cascade at that shape against its plain version;
    ``normalize=("lufs", -14)`` within 0.2 LU and ``("peak", -1)`` within
    0.15 dB of the target; the measurement's time."""
    from whitebox_tpu_torch.ops import biquad_cuda, mix_cuda
    from whitebox_tpu_torch.ops.loudness import k_weighting_cascade, measure_loudness, measure_loudness_reference
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.demo import make_demo_session

    name = "loudness_headline"
    session = make_demo_session(n_tracks=128, duration_seconds=60.0, sample_rate=int(RATE), seed=7)
    reset_launches()
    res = bounce(session, RATE, device="cuda", loudness=True)
    k1, casc = mix_cuda.mix_kernel_launches, biquad_cuda.biquad_cascade_launches
    check(k1 == 1 and casc == 1, f"{name}: mix launches {k1}, cascade launches {casc} (want 1, 1)")
    t0 = time.perf_counter()
    ref = measure_loudness_reference(res.audio, RATE).as_dict()
    ref_s = time.perf_counter() - t0
    got = res.stats.loudness.as_dict()
    diffs = {k: abs(got[k] - ref[k]) for k in LOUDNESS_BARS}
    check(all(diffs[k] <= bar for k, bar in LOUDNESS_BARS.items()),
          f"{name}: card readings {got} off the f64 reference {ref}")
    x = torch.from_numpy(res.audio).cuda()
    coeffs = k_weighting_cascade(RATE, x.shape[0], "cuda")
    zeros = [torch.zeros((x.shape[0], 2), device="cuda") for _ in range(2)]
    casc_err, casc_abs = cascade_vs_plain("k_weighting_headline", torch, x, coeffs, zeros)
    casc_ms, _ = _event_ms(torch, lambda: biquad_cuda.biquad_cascade(x, coeffs, zeros), 10)
    casc_plain_ms, _ = _event_ms(torch, lambda: biquad_cuda.biquad_cascade_reference(x, coeffs, zeros), 3)
    targets = {}
    for mode, target, reading, bar in (("lufs", -14.0, "integrated_lufs", 0.2), ("peak", -1.0, "true_peak_dbtp", 0.15)):
        r = bounce(session, RATE, device="cuda", loudness=True, normalize=(mode, target))
        v = getattr(r.stats.loudness, reading)
        check(abs(v - target) < bar, f"{name}: normalize {mode} {target} read {v}")
        targets[mode] = v
    measure_ms, measure_all, _ = _wall_ms(torch, lambda: measure_loudness(res.audio, RATE, device="cuda"))
    stats = {"cell": name, "frames": int(res.audio.shape[1]), "readings": got, "f64_reference": ref,
             "reading_diffs": diffs, "f64_reference_s": ref_s, "normalized": targets,
             "measure_ms_median": measure_ms, "measure_ms_all": measure_all,
             "k_weighting_cascade_ms": casc_ms, "k_weighting_plain_ms": casc_plain_ms,
             "k_weighting_vs_plain_rel_rms": casc_err, "k_weighting_vs_plain_max_abs": casc_abs,
             "mix_launches": k1, "cascade_launches": casc}
    print(f"[{name}] bounce(loudness=True): {res.stats.summary()}; " + json.dumps(stats))
    return stats


def phase_stretch(torch) -> dict:
    """``stretch_60s``: ``time_stretch`` (ratio 1.25) and ``pitch_shift``
    (+3 semitones) of a seeded 60 s stereo programme on the card: bit-equal
    across runs, within relative RMS 1e-5 of the CPU's; medians of 3."""
    import numpy as np

    from whitebox_tpu_torch.ops.stretch import pitch_shift, time_stretch

    name = "stretch_60s"
    x = program_signal(60.0)
    stats = {"cell": name, "frames": int(x.shape[1])}
    for label, fn in (("time_stretch_1.25", lambda d: time_stretch(x, 1.25, device=d)),
                      ("pitch_shift_+3", lambda d: pitch_shift(x, 3.0, RATE, device=d))):
        ms, ms_all, outs = _wall_ms(torch, lambda: fn("cuda"))
        check(all(np.array_equal(o, outs[0]) for o in outs[1:]), f"{name}: {label} differs between card runs")
        t0 = time.perf_counter()
        cpu = fn("cpu")
        cpu_s = time.perf_counter() - t0
        rr = rel_rms(outs[0], cpu)
        check(outs[0].shape == cpu.shape and np.isfinite(outs[0]).all() and rr < 1e-5,
              f"{name}: {label} {rr:.3g} off the CPU's")
        busy_ms, _ = card_busy_ms(torch, lambda: fn("cuda"))
        stats[label] = {"ms_median": ms, "ms_all": ms_all, "card_busy_ms": busy_ms, "cpu_rel_rms": rr,
                        "cpu_s": cpu_s, "out_frames": int(outs[0].shape[1])}
    print(f"[{name}] bit-equal across 3 card runs; " + json.dumps(stats))
    return stats


def phase_peaks(torch) -> dict:
    """``peaks_10min``: ``build_mipmaps`` of a seeded 10-minute stereo sample
    in F32 and I16, "high" and "low", on the card: every level
    bit-identical to the C++ scalar walk; medians of 3."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.ops import peaks

    name = "peaks_10min"
    stats = {"cell": name, "frames": PEAKS_FRAMES, "channels": 2}
    for fmt in (AudioFormat.F32, AudioFormat.I16):
        sample = peaks_sample(fmt, PEAKS_FRAMES)
        data = torch.from_numpy(np.stack(sample.data)).cuda()
        mips = peaks.mip_levels_for(sample.count)
        for q in ("high", "low"):
            ms, ms_all, outs = _wall_ms(torch, lambda: peaks.build_mipmaps(sample, q, device="cuda"))
            # the pyramid alone, the sample already on the card
            pyr_ms, _ = _event_ms(torch, lambda: peaks._pyramid(peaks.quantize_codes_torch(data, fmt, q),
                                                                sample.count, mips), 5)
            t0 = time.perf_counter()
            check_mipmaps(outs[-1], sample, q)
            stats[f"{fmt.name}_{q}"] = {"ms_median": ms, "ms_all": ms_all, "pyramid_ms": pyr_ms,
                                        "levels": len(outs[-1].levels), "cpp_walk_s": time.perf_counter() - t0}
    print(f"[{name}] every level bit-identical to the C++ walk; " + json.dumps(stats))
    return stats


# ---------------------------------------------------------------- cache, preview, stream


def preview_session(n_tracks=32, duration=60.0):
    """The JAX package's benchmark config 8 (``benchmarks/run_all.py:509-``):
    32 tracks with fades (seed 2), a two-band EQ on every track, a volume
    lane on every track and a 25 Hz highpass on the master."""
    from whitebox_tpu_torch.effects import Biquad, EffectChain, ParametricEQ
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=n_tracks, duration_seconds=duration, sample_rate=48000, seed=2, fades=True)
    beats = duration / s.beat_duration
    for i, tr in enumerate(s.tracks):
        tr.effects = EffectChain([ParametricEQ([
            ("lowshelf", 100.0, 0.707, 2.0), ("peak", 1000.0 + 37.0 * i, 1.0, -1.5)])])
        tr.automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(beats, 0.6))
    s.master_effects = EffectChain([Biquad("highpass", 25.0)])
    return s


def takes_session(n_tracks=128, duration=60.0, seed=31):
    """A recording-shaped session: every track plays its own stereo take
    over the whole length (128 x 60 s: a 2.95 GB pool). The takes are one
    seeded noise rolled by a seeded offset each (drawing 2.95 GB of
    normals took ~14 s of the card machine's host)."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Sample, Session

    s = Session(bpm=120.0)
    rng = np.random.default_rng(seed)
    frames = int(duration * RATE)
    base = rng.standard_normal((2, frames), dtype=np.float32)
    base *= np.float32(0.02)
    for t, shift in enumerate(rng.integers(0, frames, n_tracks)):
        take = np.roll(base, int(shift), axis=1)
        a = s.sample_table.add_sample(Sample.from_planar(take, int(RATE), AudioFormat.F32, name=f"take{t}"),
                                      key=f"take{t}")
        s.add_audio_clip(s.add_track(f"t{t}"), f"take{t}", 0.0, duration / s.beat_duration, asset=a)
    return s


def cached_cell(torch, name: str, session, automated: bool) -> dict:
    """``SessionRenderCache`` on the card: the first ``render()`` (carve,
    plan, upload, one launch), the unchanged re-render (``render_device``
    synchronised, and ``render`` with its readback, medians of 20), a
    re-render after a clip-gain edit (the pool on the card kept: the same
    tensor) and after an edit that adds an asset (rebuilt); every render
    bit-equal to ``bounce`` on the card and one launch of K1 (K3 with
    lanes), counted; the edit stamp's own time; ``render``'s readback
    through a kept page-locked buffer, for comparison."""
    import numpy as np

    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.cached import SessionRenderCache
    from whitebox_tpu_torch.session import Sample

    kernel = "auto" if automated else "mix"
    want_launches = {"mix": 0, "auto": 0, "per_track": 0, kernel: 1}

    def checked(label, out):
        launches = mix_launches()
        check(launches == want_launches, f"{name}: {label} launches {launches}, want {want_launches}")
        ref = bounce(session, RATE, device="cuda").audio
        check(out.shape == ref.shape and np.array_equal(out, ref), f"{name}: {label} != bounce on the card")
        return launches[kernel]

    cache = SessionRenderCache(session, RATE)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cache.render()
    build_ms = (time.perf_counter() - t0) * 1e3
    launches = checked("first render", out)
    renderer = cache.renderer()

    def timed(fn, n=20):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts), min(ts)

    reset_launches()
    dev_ms, dev_best = timed(cache.render_device)
    check(mix_launches()[kernel] == 20 and cache.renderer() is renderer,
          f"{name}: 20 unchanged render_device calls gave {mix_launches()} launches or rebuilt")
    host_ms, host_best = timed(cache.render)
    # the readback through a kept page-locked buffer instead (the copy into
    # it, then a fresh array for the caller), for comparison
    frames = renderer.plan.total_frames
    pinned = torch.empty((renderer.plan.channels, frames), dtype=torch.float32, pin_memory=True)

    def via_pinned():
        session.edit_stamp()
        pinned.copy_(renderer.render_device()[:, :frames])
        return pinned.numpy().copy()

    pinned_ms, _ = timed(via_pinned)
    kernel_ms, _ = _event_ms(torch, renderer.render_device, 20)
    stamp_ms, _ = timed(session.edit_stamp)

    pool = cache._pool_dev
    session.tracks[0].clips[0].audio.gain *= 0.5
    reset_launches()
    t0 = time.perf_counter()
    out = cache.render()
    gain_edit_ms = (time.perf_counter() - t0) * 1e3
    checked("gain edit", out)
    check(cache._pool_dev is pool, f"{name}: a clip-gain edit re-uploaded the pool")

    rng = np.random.default_rng(5)
    extra = (rng.standard_normal((2, int(RATE))) * 0.1).astype(np.float32)
    a = session.sample_table.add_sample(Sample.from_planar(extra, int(RATE), AudioFormat.F32, name="added"),
                                        key="added")
    session.add_audio_clip(session.tracks[1], "added", 4.0, 6.0, asset=a)
    reset_launches()
    t0 = time.perf_counter()
    out = cache.render()
    asset_edit_ms = (time.perf_counter() - t0) * 1e3
    checked("new-asset edit", out)
    check(cache._pool_dev is not pool, f"{name}: a new asset kept the old pool")
    stats = {"cell": name, "kernel": "K3" if automated else "K1", "frames": int(out.shape[1]),
             "tracks": len(session.tracks), "launches_per_render": launches, "first_render_ms": build_ms,
             "render_device_ms_median": dev_ms, "render_device_ms_best": dev_best,
             "render_ms_median": host_ms, "render_ms_best": host_best,
             "render_pinned_ms_median": pinned_ms, "kernel_ms_median": kernel_ms,
             "edit_stamp_ms_median": stamp_ms, "gain_edit_render_ms": gain_edit_ms,
             "asset_edit_render_ms": asset_edit_ms, "pool_mb": pool.numel() * 4 / 1e6}
    print(f"[{name}] every render bit-equal to bounce on the card, one {stats['kernel']} launch each; "
          + json.dumps(stats))
    return stats


def phase_cached(torch) -> tuple[dict, dict]:
    from whitebox_tpu_torch.render.demo import make_demo_session

    headline = make_demo_session(n_tracks=128, duration_seconds=60.0, sample_rate=int(RATE), seed=7)
    return (cached_cell(torch, "cached_headline", headline, automated=False),
            cached_cell(torch, "cached_automation_tempo_128trk", automation_tempo_128trk(), automated=True))


def phase_preview(torch) -> dict:
    """``preview_32trk``: the JAX package's config 8 through
    ``PreviewStream`` (512-frame blocks, 64 blocks of lookahead) on the
    card with the launch counts reset just before: no mix-kernel launch,
    the cascade kernel launched; the first 10 s of blocks within relative
    RMS 1e-5 of ``bounce`` on the card; the cascade kernel against its
    plain version at the window's shapes, the states carried over two
    windows; then config 8's measures: the
    steady-state pull (5 windows of blocks) as a duty of the 10.67 ms
    block budget, the fenced window on the card (``fetch_window_device``
    + a synchronise, median of 5) per block, a seek and an edit
    (re-carve + re-render)."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda
    from whitebox_tpu_torch.ops.mix import pack_device_tables, render_chunk_per_track
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.finisher import make_finisher
    from whitebox_tpu_torch.render.preview import PreviewStream
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, bs, look = "preview_32trk", 512, 64
    s = preview_session()
    ref = bounce(s, RATE, device="cuda").audio
    reset_launches()
    t0 = time.perf_counter()
    ps = PreviewStream(s, RATE, buffer_size=bs, lookahead_blocks=look)
    build_ms = (time.perf_counter() - t0) * 1e3
    n10 = int(10.0 * RATE)
    blocks = [ps.next_block() for _ in range(-(-n10 // bs))]
    launches, casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    check(not any(launches.values()) and casc > 0,
          f"{name}: mix launches {launches}, cascade launches {casc} (want none, > 0)")
    gk = check_gather_launches(name, -(-n10 // ps.lookahead))  # a window of lookahead frames at a time
    head = np.concatenate(blocks, axis=1)[:, :n10]
    rr = rel_rms(head, ref[:, :n10])
    check(np.isfinite(head).all() and rr < 1e-5, f"{name}: first 10 s {rr:.3g} off the bounce")
    # the cascade kernel at this path's shapes against its plain version: the
    # tracks' rows [T*C, lookahead] and the master's [C, lookahead] over two
    # windows, the states carried from the first to the second
    table, pool = carve_session(s, RATE, buffer_size=bs, out_channels=2)
    tables = pack_device_tables(table, pool, s, channels=2).as_torch("cuda")
    pt = render_chunk_per_track(torch.from_numpy(pool.data).cuda(), tables, 0, 2 * ps.lookahead)
    scan = make_finisher("scan", s, RATE, torch.ones((len(s.tracks), 2), device="cuda"), device="cuda")
    coeffs, mcoeffs = scan.coeffs, scan.mcoeffs
    states, mstates = scan.init()
    vs_plain = {"tracks": cascade_vs_plain("preview_tracks_two_windows", torch, pt.reshape(-1, pt.shape[-1]),
                                       coeffs, states, pieces=(ps.lookahead,)),
                "master": cascade_vs_plain("preview_master_two_windows", torch, pt.sum(0), mcoeffs, mstates,
                                           pieces=(ps.lookahead,))}
    del pt, tables

    budget_ms = bs / RATE * 1e3
    n_blocks = look * 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        check(ps.next_block() is not None, f"{name}: the stream ended early")
    block_e2e_ms = (time.perf_counter() - t0) * 1e3 / n_blocks
    pos = ps.position_frames
    ps.fetch_window_device(pos)
    torch.cuda.synchronize()
    win_ms = []
    for k in range(5):
        t0 = time.perf_counter()
        ps.fetch_window_device(pos + (k + 1) * ps.lookahead)
        torch.cuda.synchronize()
        win_ms.append((time.perf_counter() - t0) * 1e3)
    window_ms = statistics.median(win_ms)
    busy_ms, _ = card_busy_ms(torch, lambda: ps.fetch_window_device(pos + 7 * ps.lookahead))
    t0 = time.perf_counter()
    ps.seek(1.0)
    check(ps.next_block() is not None, f"{name}: no block after the seek")
    seek_ms = (time.perf_counter() - t0) * 1e3
    s.tracks[0].volume_db = -3.0
    t0 = time.perf_counter()
    check(ps.next_block() is not None, f"{name}: no block after the edit")
    edit_ms = (time.perf_counter() - t0) * 1e3
    stats = {"cell": name, "tracks": len(s.tracks), "lookahead_blocks": look, "budget_ms": budget_ms,
             "build_ms": build_ms, "first_10s_rel_rms": rr, "mix_launches": launches, "cascade_launches": casc,
             "gather_launches": gk,
             "block_e2e_ms": block_e2e_ms, "duty_e2e_pct": 100.0 * block_e2e_ms / budget_ms,
             "window_device_ms": window_ms, "window_device_ms_all": win_ms,
             "block_device_ms": window_ms / look, "duty_device_pct": 100.0 * window_ms / look / budget_ms,
             "window_card_busy_ms": busy_ms, "seek_ms": seek_ms, "edit_ms": edit_ms,
             "cascade_vs_plain_rel_rms_max_abs": vs_plain}
    print(f"[{name}] 0 slot-plan kernel launches, gather-kernel launches {gk}, {casc} cascade launches; "
          + json.dumps(stats))
    return stats


def phase_stream(torch) -> dict:
    """``stream_takes_128trk``: ``bounce_streamed`` of 128 seeded 60 s
    takes (a 2.95 GB pool) under a 256 MiB cap in windows of 2^17 frames,
    with the launch counts reset just before: bit-equal to
    ``bounce(engine="xla")`` on the card, no mix-kernel launch, the peak
    allocated memory below the resident bounce's; e2e (median of 3), the
    host's window builds, the copies and the renders by CUDA events, the
    card's busy time (``torch.profiler``); then the same session with
    config 5's EQ chains through the cascade kernel, within relative RMS
    1e-5 of the resident bounce, and the cascade kernel against its plain
    version at the window's shapes, the states carried over two windows."""
    import numpy as np

    from whitebox_tpu_torch.effects import Biquad, EffectChain
    from whitebox_tpu_torch.ops import biquad_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.finisher import make_finisher
    from whitebox_tpu_torch.render.stream_pool import bounce_streamed

    name, cap, window = "stream_takes_128trk", 256 << 20, 1 << 17
    t0 = time.perf_counter()
    s = takes_session()
    data_s = time.perf_counter() - t0

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, (torch.cuda.max_memory_allocated() - base) / 1e9

    resident, resident_first_ms, resident_peak = peak_of(lambda: bounce(s, RATE, device="cuda", engine="xla").audio)
    _, resident_ms, _ = peak_of(lambda: bounce(s, RATE, device="cuda", engine="xla").audio)  # the pool built
    reset_launches()
    st = {}
    got, first_ms, stream_peak = peak_of(lambda: bounce_streamed(s, RATE, max_pool_bytes=cap,
                                                                 window_frames=window, stats=st))
    launches = mix_launches()
    check(not any(launches.values()), f"{name}: mix launches {launches} (want none)")
    gk = check_gather_launches(name, st["windows"])
    check(got.shape == resident.shape and np.array_equal(got, resident),
          f"{name}: streamed != bounce(engine='xla')")
    check(stream_peak < resident_peak, f"{name}: peak {stream_peak:.3f} GB not below the resident "
                                       f"{resident_peak:.3f} GB")
    runs = []
    for _ in range(3):
        st_i = {}
        _, ms, _ = peak_of(lambda: bounce_streamed(s, RATE, max_pool_bytes=cap, window_frames=window, stats=st_i))
        runs.append((ms, st_i))
    e2e_ms = statistics.median(r[0] for r in runs)
    mid = sorted(runs, key=lambda r: r[0])[1][1]
    busy_ms, _ = card_busy_ms(torch, lambda: bounce_streamed(s, RATE, max_pool_bytes=cap, window_frames=window))
    pool_gb = st["pool_bytes"] / 1e9
    takes_gb = sum(a.sample.count * a.sample.channels * 4 for a in s.sample_table.samples.values()) / 1e9

    add_eq_chains(s)
    s.master_effects = EffectChain([Biquad("highpass", 25.0)])
    eq_ref = bounce(s, RATE, device="cuda", engine="xla").audio
    reset_launches()
    eq_st = {}
    eq, eq_ms, eq_peak = peak_of(lambda: bounce_streamed(s, RATE, max_pool_bytes=cap, window_frames=window,
                                                         stats=eq_st))
    eq_launches, eq_casc = mix_launches(), biquad_cuda.biquad_cascade_launches
    check(not any(eq_launches.values()) and eq_casc > 0,
          f"{name}: EQ mix launches {eq_launches}, cascade launches {eq_casc} (want none, > 0)")
    eq_gk = check_gather_launches(f"{name} EQ", eq_st["windows"])
    eq_rr = rel_rms(eq, eq_ref)
    check(np.isfinite(eq).all() and eq_rr < 1e-5, f"{name}: EQ stream {eq_rr:.3g} off the resident bounce")
    # the cascade kernel at this path's shapes against its plain version: the
    # tracks' rows [T*C, window] (each track's take from frame 0, its clip's
    # per-track buffer) and the master's [C, window] over two windows, the
    # states carried from the first to the second
    x = torch.from_numpy(np.stack([ch[: 2 * window] for a in s.sample_table.samples.values()
                                   for ch in a.sample.data])).cuda()
    scan = make_finisher("scan", s, RATE, torch.ones((len(s.tracks), 2), device="cuda"), device="cuda")
    coeffs, mcoeffs = scan.coeffs, scan.mcoeffs
    states, mstates = scan.init()
    vs_plain = {"tracks": cascade_vs_plain("stream_tracks_two_windows", torch, x, coeffs, states, pieces=(window,)),
                "master": cascade_vs_plain("stream_master_two_windows", torch,
                                           x.view(len(s.tracks), 2, -1).sum(0), mcoeffs, mstates,
                                           pieces=(window,))}
    del x
    stats = {"cell": name, "tracks": len(s.tracks), "frames": int(got.shape[1]), "cap_mib": cap >> 20,
             "window_frames": window, "windows": st["windows"], "takes_gb": takes_gb,
             "pool_gb_copied": pool_gb, "data_s": data_s, "first_ms": first_ms, "e2e_ms_median": e2e_ms,
             "e2e_ms_all": [r[0] for r in runs], "host_build_ms": mid["host_build_s"] * 1e3,
             "copy_ms": mid["copy_s"] * 1e3, "copy_gb_per_s": pool_gb / mid["copy_s"] if mid["copy_s"] else None,
             "render_ms": mid["render_s"] * 1e3, "span_ms": mid["span_s"] * 1e3, "card_busy_ms": busy_ms,
             "peak_gb": stream_peak, "resident_peak_gb": resident_peak, "resident_first_ms": resident_first_ms,
             "resident_e2e_ms": resident_ms,
             "mix_launches": launches, "gather_launches": gk, "eq_gather_launches": eq_gk,
             "eq_ms": eq_ms, "eq_peak_gb": eq_peak, "eq_rel_rms": eq_rr,
             "eq_render_ms": eq_st["render_s"] * 1e3, "eq_cascade_launches": eq_casc,
             "cascade_vs_plain_rel_rms_max_abs": vs_plain}
    print(f"[{name}] bit-equal to bounce(engine='xla'), 0 slot-plan kernel launches, gather-kernel launches "
          f"{gk} for {st['windows']} windows, peak below the resident's; "
          + json.dumps(stats))
    return stats


# ---------------------------------------------------------------- the bench suite's other configs

#: frames of the peaks_1h cell: one hour at 48 kHz (``run_all.py::config4``)
PEAKS_1H_FRAMES = 48000 * 3600


def run_all_cell(torch, name: str, session, exact: bool) -> tuple[dict, int]:
    """One of the JAX package's ``benchmarks/run_all.py`` configs through
    ``bounce(device="cuda")`` with the launch counts reset just before (one
    summing-kernel launch, linear), held to ``render_segments_numpy`` over
    the whole render (bit-equal when ``exact``, else the resampling
    contract), then timed by :func:`measure_cell`."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

    reset_launches()
    res = bounce(session, RATE, device="cuda")
    launches = mix_launches()
    check(launches == {"mix": 1, "auto": 0, "per_track": 0} and mix_cuda.interp_launches["linear"] == 1,
          f"{name}: bounce must launch the summing kernel once (linear), got {launches} "
          f"{mix_cuda.interp_launches}")
    t0 = time.perf_counter()
    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    ref = render_segments_numpy(table, pool, session)
    ref_s = time.perf_counter() - t0
    check(res.audio.shape == ref.shape and np.isfinite(res.audio).all(), f"{name}: shape/finite")
    if exact:
        check(np.array_equal(res.audio, ref), f"{name}: bounce != render_segments_numpy")
        verdict = "bit-equal to"
    else:
        ok, ku, ka = ulp_contract(res.audio, ref)
        check(ok, f"{name}: {ku} ulp / {ka:.3g} abs off render_segments_numpy (contract {ULP_MAX} ulp "
                  f"or {ABS_TOL})")
        verdict = f"within {ULP_MAX} ulp or {ABS_TOL} abs (max {ku} ulp, {ka:.3g} abs) of"
    reverse = int((table.speed < 0).sum())
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; mix kernel launches={launches['mix']} "
          f"(linear); audio {res.audio.shape} {verdict} render_segments_numpy ({ref_s:.1f} s on the host; "
          f"{int((~table.fast).sum())} resampled rows, {reverse} reverse)")
    return measure_cell(torch, name, session, 60.0), launches["mix"]


def peaks_1h(torch) -> dict:
    """``peaks_1h`` (``run_all.py::config4``): the peak pyramid
    (``ops/peaks.py::_pyramid``, torch ops) over one hour of seeded int32
    codes already on the card, by CUDA events (median and best of 5), in
    Gsamples/s; every level bit-identical to the copied C++ walk
    (``io/native.py::peaks_level``, the levels walked in parallel)."""
    import numpy as np

    from whitebox_tpu_torch.io import native
    from whitebox_tpu_torch.ops import peaks

    name, n = "peaks_1h", PEAKS_1H_FRAMES
    codes_np = np.random.default_rng(0).integers(-32768, 32768, n).astype(np.int32)
    codes = torch.from_numpy(codes_np).cuda()[None]
    mips = peaks.mip_levels_for(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = peaks._pyramid(codes, n, mips)  # warm
    torch.cuda.synchronize()
    ms, ms_all = _event_ms(torch, lambda: peaks._pyramid(codes, n, mips), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    levels = [lv[0].cpu().numpy() for lv in outs]
    readback_ms = (time.perf_counter() - t0) * 1e3
    del outs
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        walks = list(ex.map(lambda m: native.peaks_level(codes_np, m, peaks.level_out_count(n, m)), mips))
    walk_s = time.perf_counter() - t0
    for mip, lv, walk in zip(mips, levels, walks):
        check(walk is not None, "peaks_1h: no native host library (no g++) for the scalar walk")
        check(np.array_equal(walk, lv), f"{name}: mip {mip} != the C++ walk")
    stats = {"cell": name, "frames": n, "channels": 1, "codes_mb": codes_np.nbytes / 1e6, "levels": len(mips),
             "pyramid_ms_median": ms, "pyramid_ms_best": min(ms_all), "pyramid_ms_all": ms_all,
             "gsamples_per_s_median": n / (ms * 1e-3) / 1e9, "gsamples_per_s_best": n / (min(ms_all) * 1e-3) / 1e9,
             "readback_ms": readback_ms, "readback_mb": sum(lv.nbytes for lv in levels) / 1e6,
             "peak_mem_gb": peak_gb, "cpp_walk_s": walk_s,
             # the codes read once, every level written once
             **least_ms(codes_np.nbytes + sum(lv.nbytes for lv in levels), 0)}
    print(f"[{name}] every level bit-identical to the C++ walk; " + json.dumps(stats))
    del codes
    torch.cuda.empty_cache()
    return stats


def phase_run_all(torch) -> dict:
    """The bench suite's configs the card had not run: config1_8trk (K1),
    config3_linear_128trk and reverse_bidir_128trk (K2-linear, the second
    with every clip ``LOOP_BIDIRECTIONAL``: reverse rows), peaks_1h."""
    from whitebox_tpu_torch.render.demo import make_demo_session
    from whitebox_tpu_torch.session.clip import ClipMode

    duration, out = 60.0, {}
    config1 = make_demo_session(n_tracks=8, duration_seconds=duration, sample_rate=48000, seed=1)
    out["config1_8trk"] = run_all_cell(torch, "config1_8trk", config1, exact=True)
    config3 = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=44100, seed=7,
                                clip_speeds=CONFIG3_SPEEDS)
    out["config3_linear_128trk"] = run_all_cell(torch, "config3_linear_128trk", config3, exact=False)
    for t in config3.tracks:
        for c in t.clips:
            if c.is_audio() and c.audio is not None:
                c.audio.mode = ClipMode.LOOP_BIDIRECTIONAL
    out["reverse_bidir_128trk"] = run_all_cell(torch, "reverse_bidir_128trk", config3, exact=False)
    out["peaks_1h"] = peaks_1h(torch)
    print("[run_all] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return out


# ---------------------------------------------------------------- feature checks and examples


def phase_verify(torch) -> dict:
    """The eleven feature checks of ``whitebox_tpu_torch/tools/verify.py``
    (the JAX package's ``tools/tpu_verify.py``) with ``device="cuda"``: one
    line each with its value, its bar and the kernels it launched; a miss
    or an exception fails the phase. -> the launches of each check."""
    from whitebox_tpu_torch.tools import verify

    out, failed = {}, []
    for name, _ in verify.CHECKS:
        res = verify.run_check(name, "cuda")
        print(f"[verify] {verify.format_line(name, res)}", flush=True)
        if not res["ok"]:
            failed.append(name)
            if "traceback" in res:
                print(res["traceback"], file=sys.stderr)
        out[name] = res.get("kernels", {})
    check(not failed, f"verify: {len(failed)} of {len(verify.CHECKS)} checks failed: {failed}")
    print(f"[verify] {len(verify.CHECKS)}/{len(verify.CHECKS)} checks passed on the card")
    return out


EXAMPLES = ("torch_mixdown", "torch_tempo_ramp", "torch_extending")


def phase_examples(torch) -> dict:
    """The port's examples (``examples/torch_*.py``) run on the card in this
    process; any assertion they make fails the phase. -> the launches of
    each (which mix kernel the lanes and chains went through)."""
    import tempfile

    from whitebox_tpu_torch.tools.verify import Launches

    out = {}
    with tempfile.TemporaryDirectory(prefix="wb_examples_") as tmp:
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            args = () if name == "torch_extending" else (os.path.join(tmp, f"{name}.wav"),)
            t0 = time.perf_counter()
            with Launches() as n:
                mod.main(*args, device="cuda")
            check(n.mix(), f"{name}: no mix-kernel launch on the card: {n.delta}")
            out[name] = n.delta
            print(f"[examples] {name} ran to its end on the card in {time.perf_counter() - t0:.2f} s; "
                  f"kernels={n.delta}", flush=True)
    return out


# ---------------------------------------------------------------- sharded render

#: the sharded render's bars, the JAX package's (tests/test_sharded.py:40,
#: tests/test_mesh_smoke.py:48): a 2-D mesh's plain mix, and chained or
#: routed sessions on any mesh, against the single-device gather bounce
SHARD_PLAIN_ATOL, SHARD_PLAIN_RTOL = 2e-6, 1e-5
SHARD_FX_ATOL, SHARD_FX_RTOL = 3e-6, 1e-4
#: ranks of the world that shares the card (gloo, host staging), its meshes
#: and the sessions each renders
SHARED_WORLD = 4
SHARED_CELLS = {(1, 4): ("headline", "generic_fx_128trk"), (2, 2): ("headline", "generic_fx_128trk")}


def headline_session():
    from whitebox_tpu_torch.render.demo import make_demo_session

    return make_demo_session(n_tracks=128, duration_seconds=60.0, sample_rate=int(RATE), seed=7)


SHARDED_SESSIONS = {"headline": headline_session, "generic_fx_128trk": generic_fx_128trk,
                    "routed_sidechain_128trk": routed_sidechain_128trk}


def _sharded_run(torch, mesh, name, session, keep_audio=True) -> dict:
    """``bounce_sharded`` of ``session`` on ``mesh`` with the cascade count
    and the staging counters reset just before -> a record: wall seconds,
    staged copies/bytes/seconds, peak memory, cascade launches, the audio's
    digest (and the audio)."""
    import hashlib

    from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda
    from whitebox_tpu_torch.parallel import bounce_sharded, collectives

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    collectives.reset_staging()
    t0 = time.perf_counter()
    audio = bounce_sharded(session, RATE, mesh)
    torch.cuda.synchronize()
    rec = {"mesh": f"{mesh.shape['tracks']}x{mesh.shape['frames']}", "name": name, "rank": mesh.rank,
           "backend": mesh.backend, "staged_host": mesh.staged, "wall_s": time.perf_counter() - t0,
           "staged_copies": collectives.staging["copies"], "staged_bytes": collectives.staging["bytes"],
           "staged_copy_s": collectives.staging["seconds"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "cascade_launches": biquad_cuda.biquad_cascade_launches,
           "dynamics_launches": dynamics_cuda.dynamics_scan_launches,
           "dynamics_fused_launches": dynamics_cuda.dynamics_fused_launches, "mix_launches": mix_launches(),
           "gather_launches": gather_counts(),
           "sha256": hashlib.sha256(audio.tobytes()).hexdigest()}
    if keep_audio:
        rec["audio"] = audio
    return rec


def sharded_rank(rank: int, cells: dict) -> list:
    """One rank of the world that shares the card: every mesh of ``cells``
    in turn, each session built here from its seed; rank 0 keeps the audio."""
    import torch

    from whitebox_tpu_torch.parallel import make_render_mesh

    sessions = {}
    out = []
    for (tp, fp), names in cells.items():
        mesh = make_render_mesh(tp, fp)
        for name in names:
            if name not in sessions:
                sessions[name] = SHARDED_SESSIONS[name]()
            out.append(_sharded_run(torch, mesh, name, sessions[name], keep_audio=rank == 0))
    return out


def _check_sharded(rec: dict, ref, plain_bar) -> str:
    """Hold one sharded render against the single-device bounce: bit-equal
    (``plain_bar`` None) or within its bar -> a note."""
    import numpy as np

    name = f"{rec['name']} {rec['mesh']}"
    got = rec["audio"]
    check(got.shape == ref.shape and np.isfinite(got).all(), f"{name}: shape {got.shape} != {ref.shape}")
    err = float(np.abs(got.astype(np.float64) - ref).max())
    if plain_bar is None:
        check(np.array_equal(got, ref), f"{name}: not bit-equal to bounce(engine='xla') (max abs {err:.3g})")
        return "bit-equal to bounce(engine='xla')"
    atol, rtol = plain_bar
    check(np.allclose(got, ref, atol=atol, rtol=rtol),
          f"{name}: max abs {err:.3g} off bounce(engine='xla') (atol {atol}, rtol {rtol})")
    return f"within atol {atol} / rtol {rtol} of bounce(engine='xla') (max abs {err:.3g})"


def _sharded_bar(name: str, mesh: str):
    if name == "headline":
        return None if mesh.startswith("1x") else (SHARD_PLAIN_ATOL, SHARD_PLAIN_RTOL)
    return (SHARD_FX_ATOL, SHARD_FX_RTOL)


def sharded_cascade_vs_plain(torch, L: int) -> dict:
    """The frame-sharded cascade at a shard's shape: 256 rows (config 5's
    three EQ sections on 128 stereo tracks) by ``L`` frames, shard 2 of
    three: the kernel from zero on shards 0 and 1, the f64 fold of their end
    states through ``Phi_L`` (``parallel/biquad_sharded.py``), the kernel
    again on shard 2 from the folded state; the same steps with the plain
    cascade; max row relative RMS within 5e-6 (``cascade_vs_plain``'s bar).
    Times both (CUDA events) and bounds the kernel's two passes."""
    import numpy as np

    from whitebox_tpu_torch.ops import biquad_cuda
    from whitebox_tpu_torch.ops.biquad import design_biquad
    from whitebox_tpu_torch.parallel.biquad_sharded import shard_transition

    dev = torch.device("cuda")
    chains = []
    for t in range(128):
        secs = [design_biquad("lowshelf", 100.0, RATE, 0.707, 2.0),
                design_biquad("peak", 1000.0 + 37.0 * t, RATE, 1.0, -1.5),
                design_biquad("highshelf", 8000.0, RATE, 0.707, 1.0)]
        chains += [secs, secs]
    coeffs = torch.from_numpy(cascade_rows(chains)).to(dev)
    B, S = coeffs.shape[2], coeffs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((3, B, L), generator=gen, device=dev) * 0.3
    zeros = [torch.zeros((B, 2), device=dev) for _ in range(S)]
    phi = shard_transition(coeffs, L)

    def shard2(cascade):
        ends = [torch.stack(cascade(x[j], coeffs, zeros)[1], dim=1).reshape(B, 2 * S) for j in (0, 1)]
        z = torch.zeros((B, 2 * S), dtype=torch.float64, device=dev)
        for e in ends:
            z = torch.einsum("bij,bj->bi", phi, z) + e.double()
        z_in = z.float().reshape(B, S, 2)
        return cascade(x[2], coeffs, [z_in[:, s].contiguous() for s in range(S)])[0]

    before = biquad_cuda.biquad_cascade_launches
    got = shard2(biquad_cuda.biquad_cascade)
    check(biquad_cuda.biquad_cascade_launches == before + 3, "sharded cascade: the kernel did not launch")
    ref = shard2(biquad_cuda.biquad_cascade_reference)
    torch.cuda.synchronize()
    rr = row_rel_rms(got, ref)
    max_abs = float((got - ref).abs().max())
    check(bool((rr <= CASCADE_REL_RMS).all()), f"sharded cascade: rows {rr.max():.3g} relative RMS off the "
          f"plain version (bar {CASCADE_REL_RMS})")

    def two_pass():  # one shard's work: from zero, then from its incoming state
        biquad_cuda.biquad_cascade(x[2], coeffs, zeros)
        biquad_cuda.biquad_cascade(x[2], coeffs, zeros)

    def two_pass_plain():
        biquad_cuda.biquad_cascade_reference(x[2], coeffs, zeros)
        biquad_cuda.biquad_cascade_reference(x[2], coeffs, zeros)

    ms, _ = _event_ms(torch, two_pass, 10)
    plain_ms, _ = _event_ms(torch, two_pass_plain, 1)
    n = B * L
    res = {"rows": B, "frames": L, "sections": S, "max_row_rel_rms": float(rr.max()), "max_abs_err": max_abs,
           "two_pass_ms": ms, "two_pass_plain_ms": plain_ms,
           **least_ms(2 * (2 * n * 4 + coeffs.numel() * 4), 2 * 15 * S * n)}
    print(f"[cascade-vs-plain] sharded_shard2_of_3: rows={B} frames={L} sections={S} max row relative RMS "
          f"{rr.max():.3g} (<= {CASCADE_REL_RMS}), max abs {max_abs:.3g}; " + json.dumps(res))
    del x, got, ref
    torch.cuda.empty_cache()
    return res


def phase_sharded(torch) -> dict:
    """The sharded render (``whitebox_tpu_torch/parallel``) on the card:

    1. a world of one rank over NCCL (``make_render_mesh()`` with no process
       group: a 1x1 mesh), the headline bit-equal to ``bounce(engine="xla")``
       on the card, ``generic_fx_128trk`` and ``routed_sidechain_128trk``
       within atol 3e-6 / rtol 1e-4 of it, the cascade kernel launched;
    2. a world of four ranks sharing the card over gloo with host staging
       (``parallel/launch.py::run_world``), 1x4 and 2x2: the headline
       bit-equal on 1x4 and within atol 2e-6 / rtol 1e-5 on 2x2,
       ``generic_fx_128trk`` within the bar of 1 on both, every rank the
       same audio; wall time, staged bytes and their copy time, and peak
       memory per rank (below a quarter of the card);
    3. the two-pass cascade at the 1x4 shard's shape against its plain
       version (:func:`sharded_cascade_vs_plain`)."""
    import torch.distributed as dist

    from whitebox_tpu_torch.parallel import make_render_mesh
    from whitebox_tpu_torch.parallel.launch import run_world
    from whitebox_tpu_torch.render.bounce import bounce

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    t_phase = time.perf_counter()
    refs, launches, dyn_launches, gather_launches, out = {}, {}, {}, {}, {}
    check(not dist.is_initialized(), "a process group is already initialised")
    mesh = make_render_mesh()
    check(mesh.backend == "nccl" and mesh.shape == {"tracks": 1, "frames": 1} and not mesh.staged,
          f"world of one: {mesh}")
    try:
        for name, build in SHARDED_SESSIONS.items():
            session = build()
            refs[name] = bounce(session, RATE, device="cuda", engine="xla").audio
            rec = _sharded_run(torch, mesh, name, session)
            note = _check_sharded(rec, refs[name], _sharded_bar(name, "1x1"))
            check(not any(rec["mix_launches"].values()), f"{name} 1x1: the sharded mix launched a mix kernel")
            check(rec["gather_launches"]["sum_unclipped" if name == "headline" else "per_track"] >= 1,
                  f"{name} 1x1: the sharded mix never launched the gather kernel ({rec['gather_launches']})")
            gather_launches[f"sharded_1x1_{name}"] = rec["gather_launches"]
            if name != "headline":
                check(rec["cascade_launches"] > 0, f"{name} 1x1: the cascade kernel never launched")
                check(rec["dynamics_launches"] > 0, f"{name} 1x1: the dynamics kernel never launched")
            launches[f"sharded_1x1_{name}"] = rec["cascade_launches"]
            dyn_launches[f"sharded_1x1_{name}"] = rec["dynamics_launches"]
            rec.pop("audio")
            out[f"1x1:{name}"] = rec
            print(f"[sharded_1x1_{name}] {smi}: bounce_sharded on a world of one (NCCL, 1x1) {note}; "
                  + json.dumps(rec))
    finally:
        dist.destroy_process_group()

    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    torch.cuda.empty_cache()  # the card's memory to the four ranks
    t0 = time.perf_counter()
    ranks = run_world(sharded_rank, SHARED_WORLD, device="cuda", timeout=600, args=(SHARED_CELLS,))
    world_s = time.perf_counter() - t0
    for i, rec in enumerate(ranks[0]):
        cell = f"sharded_{rec['mesh']}_{rec['name']}"
        per_rank = [r[i] for r in ranks]
        check(all(r["sha256"] == rec["sha256"] for r in per_rank), f"{cell}: the ranks' audio differs")
        check(all(r["backend"] == "gloo" and r["staged_host"] for r in per_rank),
              f"{cell}: not gloo with host staging")
        check(not any(v for r in per_rank for v in r["mix_launches"].values()), f"{cell}: a mix kernel launched")
        form = "sum_unclipped" if rec["name"] == "headline" else "per_track"
        check(all(r["gather_launches"][form] >= 1 for r in per_rank),
              f"{cell}: a rank never launched the gather kernel")
        gather_launches[cell] = [r["gather_launches"] for r in per_rank]
        if rec["name"] != "headline":
            check(all(r["cascade_launches"] > 0 for r in per_rank), f"{cell}: the cascade kernel never launched")
            check(all(r["dynamics_launches"] > 0 for r in per_rank), f"{cell}: the dynamics kernel never launched")
        peak = max(r["peak_gb"] for r in per_rank)
        check(peak < total_gb / SHARED_WORLD, f"{cell}: peak {peak:.2f} GB a rank, above a quarter of the card")
        note = _check_sharded(rec, refs[rec["name"]], _sharded_bar(rec["name"], rec["mesh"]))
        launches[cell] = rec["cascade_launches"]
        dyn_launches[cell] = rec["dynamics_launches"]
        stats = {"ranks": [{k: r[k] for k in ("rank", "wall_s", "staged_copies", "staged_bytes",
                                              "staged_copy_s", "peak_gb", "cascade_launches",
                                              "dynamics_launches", "gather_launches")}
                           for r in per_rank],
                 "wall_s_max": max(r["wall_s"] for r in per_rank), "peak_gb_max": peak,
                 "card_gb": total_gb}
        out[f"{rec['mesh']}:{rec['name']}"] = stats
        print(f"[{cell}] {smi}: {SHARED_WORLD} ranks share the card (gloo, host staging), every rank the "
              f"same audio, {note}; " + json.dumps(stats))
    print(f"[sharded_world] {smi}: the four-rank world took {world_s:.1f} s (spawn, CUDA init, "
          "session builds and both meshes)")

    L = -(-int(refs["headline"].shape[1]) // (SHARED_WORLD * 512)) * 512  # the 1x4 shard
    out["cascade"] = sharded_cascade_vs_plain(torch, L)
    print(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return {"cell_launches": launches, "dynamics_cell_launches": dyn_launches,
            "gather_cell_launches": gather_launches, **out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "whitebox_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port (whitebox_tpu_torch/) is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    t_start = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {fn.__name__.removeprefix('phase_')} {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    env = timed(phase_environment, torch)
    timed(phase_build)
    timed(phase_kernel_vs_plain)
    timed(phase_cascade_small, torch)
    timed(phase_dynamics_small, torch)
    linear, headline_xla, gather_forms = timed(phase_headline, torch)
    auto = timed(phase_automation, torch)
    effects = timed(phase_effects, torch)
    interp = timed(phase_interpolation, torch)
    run_all = timed(phase_run_all, torch)
    dense = timed(phase_gather_small, torch)
    timed(phase_gather_kernel, torch)
    generic = timed(phase_generic, torch)
    long = timed(phase_long, torch)
    timed(phase_routed_small, torch)
    routed = timed(phase_routed, torch)
    midi = timed(phase_midi, torch)
    stems_eq, stems_generic = timed(phase_stems, torch)
    bus_stems = timed(phase_bus_stems, torch)
    loud = timed(phase_loudness, torch)
    timed(phase_stretch, torch)
    timed(phase_peaks, torch)
    cached, cached_auto = timed(phase_cached, torch)
    preview = timed(phase_preview, torch)
    stream = timed(phase_stream, torch)
    checks = timed(phase_verify, torch)
    examples = timed(phase_examples, torch)
    sharded = timed(phase_sharded, torch)
    # launches of each verify check and example, by counter
    fx_launches = {**{f"verify_{k}": v for k, v in checks.items()}, **examples}

    def launched(counter):
        return {k: v[counter] for k, v in fx_launches.items() if v.get(counter)}

    # the gather kernel's forms, each with the launches of its main path's run
    sharded_gather = {k: v[0] if isinstance(v, list) else v for k, v in sharded["gather_cell_launches"].items()}
    gather_forms["per_track"]["launches"] = long["gather_kernel_launches"]["per_track"]
    gather_forms["sum_unclipped"]["launches"] = sharded_gather["sharded_1x1_headline"]["sum_unclipped"]
    for form, entry in gather_forms.items():
        check(entry["launches"] > 0, f"gather kernel ({form}): no launch on its main path")
    gather_cells = {
        "sum": {"headline_xla": gather_forms["sum"]["launches"],
                "stream_takes_128trk": stream["gather_launches"]["sum"]},
        "per_track": {"effects_eq_240s_128trk_6gib_rule": long["gather_kernel_launches"]["per_track"],
                      "routed_sidechain_128trk_xla": routed["xla_gather_launches"]["per_track"],
                      "midi_synth_128trk_xla": midi["xla_gather_launches"]["per_track"],
                      "preview_32trk": preview["gather_launches"]["per_track"],
                      "stream_takes_eq_128trk": stream["eq_gather_launches"]["per_track"],
                      **{k: v["per_track"] for k, v in sharded_gather.items() if v["per_track"]}},
        "sum_unclipped": {k: v["sum_unclipped"] for k, v in sharded_gather.items() if v["sum_unclipped"]},
    }
    gather_src = "whitebox_tpu_torch/csrc/gather_mix.cu"
    gather_replaces = ("whitebox_tpu/ops/mix.py:171-305 (render_chunk's gather mix: an XLA program there, "
                       "~100 torch ops a chunk in the port's plain version, not a TPU kernel)")
    check("jax" not in sys.modules and "whitebox_tpu" not in sys.modules,
          "the port loaded jax or the JAX package")
    print(f"[total] chip_smoke wall time {time.perf_counter() - t_start:.1f} s (limit 1200 s)")
    src = "whitebox_tpu_torch/csrc/mix_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "mix_linear", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:407", **linear,
         "cell_launches": {"headline_xla": headline_xla["mix"], "dense_overflow": dense["mix"],
                           "effects_eq_240s_128trk_6gib_rule": long["gather_launches"]["mix"],
                           "loudness_headline": loud["mix_launches"],
                           "cached_headline": cached["launches_per_render"],
                           "preview_32trk": preview["mix_launches"]["mix"],
                           "stream_takes_128trk": stream["mix_launches"]["mix"],
                           **{k: run_all[k][1] for k in ("config1_8trk", "config3_linear_128trk",
                                                         "reverse_bidir_128trk")},
                           **launched("mix")}},
        {"name": "mix_automation", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:384-460", **auto,
         "cell_launches": {"cached_automation_tempo_128trk": cached_auto["launches_per_render"],
                           "preview_32trk": preview["mix_launches"]["auto"], **launched("mix_auto")}},
        {"name": "mix_per_track", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:431-436,581-593,608-610", **effects["mix_per_track"],
         "cell_launches": {"generic_fx_128trk": generic["k4_launches"],
                           "effects_eq_240s_128trk": long["k4_launches"]["per_track"],
                           "effects_eq_240s_128trk_6gib_rule": long["gather_launches"]["per_track"],
                           "headline_xla": headline_xla["per_track"], "dense_overflow": dense["per_track"],
                           "routed_sidechain_128trk": routed["k4_launches"],
                           "routed_sidechain_128trk_xla": routed["xla_launches"]["per_track"],
                           "midi_synth_128trk": midi["k4_launches"],
                           "midi_synth_128trk_xla": midi["xla_launches"]["per_track"],
                           "stems_eq_128trk": stems_eq["k4_launches"],
                           "stems_generic_128trk": stems_generic["k4_launches"],
                           "bus_stems_routed_128trk": bus_stems["k4_launches"], **launched("mix_per_track")}},
        {"name": "mix_catmull", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:518-519,557-563", **interp["mix_catmull"]},
        {"name": "mix_poly", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:515-517,549-556", **interp["mix_poly"],
         "cell_launches": launched("interp_poly")},
        {"name": "mix_prerendered", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/timeline/prerender.py:737-752,818-828", **interp["mix_prerendered"],
         # the sinc checks mix over a prerendered pool extension
         "cell_launches": {k: v for k, v in launched("mix").items() if k.startswith("verify_sinc")}},
        {"name": "biquad_cascade", "route": "cuda", "source": "whitebox_tpu_torch/csrc/biquad_cascade.cu",
         "replaces": "whitebox_tpu/render/effects_pipeline.py:104-120 (finish_mix's scan cascade; "
                     "an XLA scan there and torch ops in the port, not a TPU kernel)",
         **effects["biquad_cascade"],
         "cell_launches": {"generic_fx_128trk": generic["cascade_launches"],
                           "effects_eq_240s_128trk": long["cascade_launches"],
                           "effects_eq_240s_128trk_6gib_rule": long["gather_cascade_launches"],
                           "routed_sidechain_128trk": routed["cascade_launches"],
                           "midi_synth_128trk": midi["cascade_launches"],
                           "stems_eq_128trk": stems_eq["cascade_launches"],
                           "loudness_headline": loud["cascade_launches"],
                           "preview_32trk": preview["cascade_launches"],
                           "stream_takes_eq_128trk": stream["eq_cascade_launches"],
                           **sharded["cell_launches"], **launched("biquad_cascade")}},
        {"name": "dynamics_fused", "route": "cuda", "source": "whitebox_tpu_torch/csrc/dynamics_scan.cu",
         "replaces": "whitebox_tpu/ops/dynamics.py:167,190,229 (compressor_process, limiter_process, "
                     "gate_process: XLA programs there, torch ops in the port, not a TPU kernel)",
         "launches": generic["dynamics_launches"],
         **{k: generic["dynamics_fused_full_width"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                                  "bound_by")},
         # no PyTorch call runs a compressor, limiter or gate
         "library_ms": None,
         "cell_launches": {"generic_fx_128trk": generic["dynamics_launches"],
                           "routed_sidechain_128trk": routed["dynamics_launches"],
                           "stems_generic_128trk": stems_generic["dynamics_launches"],
                           **launched("dynamics_fused")}},
        {"name": "dynamics_scan", "route": "cuda", "source": "whitebox_tpu_torch/csrc/dynamics_scan.cu",
         "replaces": "whitebox_tpu/ops/dynamics.py:53,79 (onepole_scan_t, maxdecay_scan_t: XLA Hillis scans "
                     "there, torch ops in the port, not a TPU kernel)",
         # the frame-sharded stages run the recurrences alone
         "launches": sharded["dynamics_cell_launches"]["sharded_1x1_generic_fx_128trk"],
         **{k: generic["dynamics_full_width"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         # no PyTorch call runs a max-decay or one-pole recurrence
         "library_ms": None,
         "cell_launches": {**sharded["dynamics_cell_launches"], **launched("dynamics_scan")}},
        *({"name": f"gather_mix_{form}", "route": "cuda", "source": gather_src, "replaces": gather_replaces,
           **{k: gather_forms[form][k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
           "cell_launches": gather_cells[form]} for form in GATHER_FORMS),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["device_count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
