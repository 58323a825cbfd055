#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Runs from the root of a checkout. It drives the port's main paths through
``bounce(device="cuda")``: the offline bounce of a 128-track, 60 s, 48 kHz
session through the hand-written CUDA mix kernel, automated sessions
through its automation variant (K3), and the same 128-track session with
an EQ on every track and a highpass on the master through its per-track
mode (K4) and the linear finishers. It checks the results by the repo's
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
   reference, and a constant-0 volume lane bit-equal to a muted track;
4. headline and headline_resampled: ``bounce(device="cuda")`` of the
   128-track session with the launch counts reset just before, bit-equal
   to the NumPy segment reference; then 5 warm carve+plan+upload+kernel
   iterations, the kernel's time by CUDA events and the plain version's;
5. automation_32trk and automation_tempo_128trk (the JAX package's
   benchmark configs 2 and 7): the same through the automation variant,
   held to relative RMS 1e-5 of the f64 host reference, lane packing
   counted in the host legs;
6. effects_eq_128trk (config 5): ``bounce(device="cuda")`` with
   ``effects_mode="fir"`` and ``"scan"``, per-track launches counted; the
   per-track buffers bit-equal to ``render_segments_per_track_numpy``
   track by track; both modes against an f64 reference (scipy ``sosfilt``)
   within relative RMS 2e-4 (fir) and 5e-5 (scan), and within 5e-4 of each
   other; 5 warm iterations with the IR preparation, the per-track kernel,
   both finishers and the plain per-track version timed;
7. one JSON line of kernels, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
port is not beside it, or when any phase fails.
"""

from __future__ import annotations

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
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


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


def host_reference(session):
    """The f64 host reference of an automated bounce: the per-track NumPy
    segment render + the finish stage's gains, sum and clip."""
    from whitebox_tpu_torch.render.effects_pipeline import reference_finish_mix
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    table, pool = carve_session(session, RATE, buffer_size=512)
    return reference_finish_mix(render_segments_per_track_numpy(table, pool), session, RATE)


def reset_launches() -> None:
    from whitebox_tpu_torch.ops import mix_cuda

    mix_cuda.mix_kernel_launches = 0
    mix_cuda.mix_auto_launches = 0
    mix_cuda.mix_per_track_launches = 0


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
    from whitebox_tpu_torch.effects import Biquad, EffectChain, ParametricEQ
    from whitebox_tpu_torch.render.demo import make_demo_session

    s = make_demo_session(n_tracks=128, duration_seconds=duration, sample_rate=48000, seed=7)
    for i, tr in enumerate(s.tracks):
        tr.effects = EffectChain([ParametricEQ([
            ("lowshelf", 100.0, 0.707, 2.0), ("peak", 1000.0 + 37.0 * i, 1.0, -1.5),
            ("highshelf", 8000.0, 0.707, 1.0),
        ])])
    s.master_effects = EffectChain([Biquad("highpass", 25.0)])
    return s


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


def kernel_vs_plain(name, session, tile=None):
    """Kernel vs plain version on the card, and vs the NumPy reference."""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda", tile=tile)
    p = r.plan
    got = r.render_device()
    plain = mix_cuda.mix_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"{name}: kernel != plain version "
          f"(max abs {float((got - plain).abs().max()):.3g})")
    out = got[:, : p.total_frames].cpu().numpy()
    ref = render_segments_numpy(table, pool, session)
    fast = bool(table.fast.all())
    if fast:
        check(np.array_equal(out, ref), f"{name}: kernel != render_segments_numpy at speed 1")
        ok, mu, ma = True, 0, 0.0
    else:
        ok, mu, ma = ulp_contract(out, ref)
        check(ok, f"{name}: {mu} ulp / {ma:.3g} abs off render_segments_numpy")
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent render")
    print(f"[kernel-vs-plain] {name}: tracks={p.num_tracks} tile={p.tile} n_tiles={p.n_tiles} "
          f"K={p.max_slots} slow_slots={int((p.is_slow * (p.me > p.ms)).sum())} "
          f"kernel==plain bit-equal; vs render_segments_numpy "
          f"{'bit-equal' if fast else f'max {mu} ulp / {ma:.3g} abs'}")


def per_track_vs_plain(name, session, tile=None):
    """The per-track kernel (K4) vs its plain version on the card, and vs
    the NumPy per-track segment reference: bit-equal at speed 1, within
    the resampling contract otherwise."""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda", tile=tile)
    p = r.plan
    before = mix_cuda.mix_per_track_launches
    got = r.render_device_per_track()
    check(mix_cuda.mix_per_track_launches == before + 1, f"{name}: the per-track kernel did not launch")
    plain = mix_cuda.mix_per_track_reference(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels)
    torch.cuda.synchronize()
    g, q = got.cpu().numpy(), plain.cpu().numpy()
    fast = bool(table.fast.all())
    if fast:
        check(np.array_equal(g, q), f"{name}: per-track kernel != plain version at speed 1")
    else:
        ok, mu, ma = ulp_contract(g, q)
        check(ok, f"{name}: per-track kernel {mu} ulp / {ma:.3g} abs off its plain version")
    out = g[:, :, : p.total_frames]
    ref = render_segments_per_track_numpy(table, pool)
    if fast:
        check(np.array_equal(out, ref), f"{name}: per-track kernel != render_segments_per_track_numpy")
        mu, ma = 0, 0.0
    else:
        ok, mu, ma = ulp_contract(out, ref)
        check(ok, f"{name}: per-track kernel {mu} ulp / {ma:.3g} abs off render_segments_per_track_numpy")
    check(not g[:, :, p.total_frames:].any(), f"{name}: per-track padding not silent")
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent per-track render")
    kp_ulps = int(np.abs(g.view(np.int32).astype(np.int64) - q.view(np.int32).astype(np.int64)).max())
    print(f"[kernel-vs-plain] {name}_per_track: tracks={p.num_tracks} tile={p.tile} "
          f"out={tuple(got.shape)} kernel vs plain max {kp_ulps} ulp; vs "
          f"render_segments_per_track_numpy {'bit-equal' if fast else f'max {mu} ulp / {ma:.3g} abs'}")


def auto_vs_plain(name, session, tile=None):
    """The automation variant vs its plain version on the card (atol/rtol),
    and vs the f64 host reference (relative RMS)."""
    import numpy as np
    import torch

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
    from whitebox_tpu_torch.timeline.carve import carve_session

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda", tile=tile,
                                 auto_tables=prepare_automation_tables_host(session, RATE))
    p = r.plan
    before = mix_cuda.mix_auto_launches
    got = r.render_device()
    check(mix_cuda.mix_auto_launches == before + 1, f"{name}: the automation kernel did not launch")
    plain = mix_cuda.mix_auto_reference(r.pool_device, r.tables, r.auto, p.n_tiles, p.tile, p.channels)
    torch.cuda.synchronize()
    g, q = got.cpu().numpy(), plain.cpu().numpy()
    ulps = int(np.abs(g.view(np.int32).astype(np.int64) - q.view(np.int32).astype(np.int64)).max())
    max_abs = float(np.abs(g.astype(np.float64) - q).max())
    check(np.allclose(g, q, atol=AUTO_ATOL, rtol=AUTO_RTOL),
          f"{name}: automation kernel vs plain max abs {max_abs:.3g} ({ulps} ulp)")
    out = g[:, : p.total_frames]
    rr = rel_rms(out, host_reference(session))
    check(rr < AUTO_REL_RMS, f"{name}: relative RMS {rr:.3g} off the f64 host reference")
    check(float(np.abs(out).max()) > 0.01, f"{name}: silent render")
    print(f"[kernel-vs-plain] {name}: tracks={p.num_tracks} tile={p.tile} P={r.auto['vxs'].shape[1]} "
          f"automated={int(r.auto['use'].sum())} kernel vs plain max {ulps} ulp / {max_abs:.3g} abs "
          f"(atol {AUTO_ATOL}, rtol {AUTO_RTOL}); vs f64 host reference relative RMS {rr:.3g}")


def phase_kernel_vs_plain() -> None:
    import numpy as np

    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
    from whitebox_tpu_torch.ops import mix_cuda
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


def bound(plan, pool_bytes: int, table_bytes: int, auto=None, per_track: bool = False) -> dict:
    """The least time the card could take for one mix of ``plan``: the
    larger of the bytes it must move (each input read once, the output
    written once) over HBM bandwidth and the f32 operations this run's data
    needs over the f32 peak. Operations counted per covered (slot, frame,
    channel): 5 for a speed-1 slot (gain, 2 envelope multiplies, track
    gain, the add; 4 in the per-track mode, which has no track gain), 25
    for a resampled one (+ the double-single phase and the lerp); per
    automated (track, frame) covered by a slot: 2 lane evaluations of 3
    (divide and lerp), 2 for the pan position, and per channel a sine
    counted as 1 plus 3 multiplies. The per-track mode writes ``[T, C, F]``."""
    import numpy as np

    act = plan.me > plan.ms
    span = np.where(act, plan.me - plan.ms, 0).astype(np.int64)
    slow = plan.is_slow == 1
    C = plan.channels
    ops = C * ((4 if per_track else 5) * int(span.sum()) + 20 * int(span[slow].sum()))
    if auto is not None:
        use = auto["use"].cpu().numpy().astype(bool)
        ops += (3 * 2 + 2 + 4 * C) * int(span[:, use].sum())
    out_bytes = (plan.num_tracks if per_track else 1) * C * plan.n_tiles * plan.tile * 4
    bytes_ = out_bytes + pool_bytes + table_bytes
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": bytes_, "bound_ops": ops}


def measure_cell(torch, name: str, session, duration: float, automated: bool = False) -> dict:
    """5 warm carve+(lane packing)+plan+upload+kernel iterations (samples
    resident on the card, as bench.py keeps them), the kernel's and the
    plain version's device times by CUDA events, and kernel vs plain at
    full size (bit-equal without lanes, atol/rtol with them)."""
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
    from whitebox_tpu_torch.timeline.carve import carve_session

    def lanes():
        return prepare_automation_tables_host(session, RATE) if automated else None

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda", auto_tables=lanes())
    rows = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_, p_ = carve_session(session, RATE, buffer_size=512, pool=pool, slow_emit="runs")
        t1 = time.perf_counter()
        auto_tables = lanes()
        t2 = time.perf_counter()
        plan = build_plan(t_, p_, session)
        t3 = time.perf_counter()
        r = mix_cuda.CudaMixRenderer(t_, p_, session, device="cuda", plan=plan,
                                     pool_device=warm.pool_device, auto_tables=auto_tables)
        t4 = time.perf_counter()
        r.render_device()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0))
    carve_s, lanes_s, plan_s, upload_s, launch_s, e2e_med = (statistics.median(c) for c in zip(*rows))
    e2e_best = min(row[-1] for row in rows)
    p = warm.plan
    args = (warm.pool_device, warm.tables, p.n_tiles, p.tile, p.channels)
    if automated:
        def kernel():
            return mix_cuda.mix_auto_cuda(warm.pool_device, warm.tables, warm.auto, *args[2:])

        def plain():
            return mix_cuda.mix_auto_reference(warm.pool_device, warm.tables, warm.auto, *args[2:])
    else:
        def kernel():
            return mix_cuda.mix_cuda(*args)

        def plain():
            return mix_cuda.mix_reference(*args)
    kernel_ms, kernel_all = _event_ms(torch, kernel, 20)
    plain_ms, _ = _event_ms(torch, plain, 3)
    got, ref = kernel(), plain()
    max_abs = float((got - ref).abs().max())
    if automated:
        check(torch.allclose(got, ref, atol=AUTO_ATOL, rtol=AUTO_RTOL),
              f"{name}: automation kernel vs plain max abs {max_abs:.3g}")
    else:
        check(torch.equal(got, ref), f"{name}: kernel != plain version (max abs {max_abs:.3g})")
    table_bytes = sum(t.numel() * t.element_size() for t in warm.tables.values())
    if automated:
        table_bytes += sum(t.numel() * t.element_size() for t in warm.auto.values())
    stats = {
        "cell": name, "tracks": p.num_tracks, "audio_seconds": duration,
        "frames": int(p.total_frames), "tile": p.tile, "n_tiles": p.n_tiles, "K": p.max_slots,
        "active_slots": int((p.me > p.ms).sum()),
        "slow_slots": int(((p.me > p.ms) & (p.is_slow == 1)).sum()),
        "pool_mb": pool.data.nbytes / 1e6,
        "e2e_ms_median": e2e_med * 1e3, "e2e_ms_best": e2e_best * 1e3,
        "rtf_median": duration / e2e_med, "rtf_best": duration / e2e_best,
        "carve_ms": carve_s * 1e3, "lanes_ms": lanes_s * 1e3, "plan_ms": plan_s * 1e3,
        "upload_ms": upload_s * 1e3,
        "launch_to_sync_ms": launch_s * 1e3,
        "kernel_ms_median": kernel_ms, "kernel_ms_min": min(kernel_all), "plain_ms_median": plain_ms,
        "output_gb_per_s": got.numel() * 4 / (kernel_ms * 1e-3) / 1e9,
        "kernel_vs_plain_max_abs": max_abs,
        **bound(p, pool.data.nbytes, table_bytes, warm.auto),
    }
    if automated:
        stats["lane_points"] = int(warm.auto["vxs"].shape[1])
    print(f"[{name}] " + json.dumps(stats))
    return stats


def _kernel_entry(cell: dict, launches: int) -> dict:
    return {"launches": launches, "max_abs_err": cell["kernel_vs_plain_max_abs"],
            "ms": cell["kernel_ms_median"], "plain_ms": cell["plain_ms_median"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
            # no single PyTorch call computes the slot mix
            "library_ms": None}


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

    k = measure_cell(torch, "headline", session, duration)
    print("[headline] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                              "temperature.gpu", "--format=csv,noheader"]))

    # the same session with linear-resampled clips (a 44.1 kHz source in a
    # 48 kHz session): the plan's slow path and the kernel's phase + lerp
    resampled = make_demo_session(n_tracks=n_tracks, duration_seconds=duration,
                                  sample_rate=int(RATE), seed=7, clip_speeds=(1.0, 44100 / 48000))
    measure_cell(torch, "headline_resampled", resampled, duration)
    return _kernel_entry(k, launches)


def automation_cell(torch, name: str, session, duration: float) -> tuple[dict, int]:
    """``bounce(device="cuda")`` of an automated session with the launch
    counts reset just before, held to the f64 host reference, then timed."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce

    reset_launches()
    res = bounce(session, RATE, device="cuda")
    launches = mix_cuda.mix_auto_launches
    check(launches > 0, f"{name}: bounce never launched the automation kernel")
    check(mix_cuda.mix_kernel_launches == 0, f"{name}: an automated session took the plain kernel")
    t0 = time.perf_counter()
    ref = host_reference(session)
    ref_s = time.perf_counter() - t0
    check(res.audio.shape == ref.shape and np.isfinite(res.audio).all(), f"{name}: shape/finite")
    rr = rel_rms(res.audio, ref)
    check(rr < AUTO_REL_RMS, f"{name}: relative RMS {rr:.3g} off the f64 host reference")
    check(float(np.abs(res.audio).max()) > 0.01, f"{name}: silent render")
    print(f"[{name}] bounce(device='cuda'): {res.stats.summary()}; automation kernel "
          f"launches={launches}; vs f64 host reference relative RMS {rr:.3g} "
          f"(reference {ref_s:.1f} s on the host)")
    return measure_cell(torch, name, session, duration, automated=True), launches


def phase_automation(torch) -> dict:
    automation_cell(torch, "automation_32trk", automation_32trk(), 60.0)
    k, launches = automation_cell(torch, "automation_tempo_128trk", automation_tempo_128trk(), 60.0)
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


def phase_effects(torch) -> dict:
    """``effects_eq_128trk`` (config 5): ``bounce(device="cuda")`` in "fir"
    and in "scan" mode with the launch counts reset just before each, both
    held to the f64 reference; then 5 warm carve+plan+upload+IR+K4+FIR
    iterations, the per-track kernel, the finishers and the plain per-track
    version timed by CUDA events."""
    import numpy as np

    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan
    from whitebox_tpu_torch.render.bounce import _effects_finisher, bounce
    from whitebox_tpu_torch.render.effects_fir import prepare_fir_finish
    from whitebox_tpu_torch.timeline.carve import carve_session

    name, duration = "effects_eq_128trk", 60.0
    session = effects_eq_128trk(duration)
    runs = {}
    for mode in ("fir", "scan"):
        reset_launches()
        res = bounce(session, RATE, device="cuda", effects_mode=mode)
        n = mix_cuda.mix_per_track_launches
        check(n > 0, f"{name} ({mode}): bounce never launched the per-track kernel")
        check(mix_cuda.mix_kernel_launches == 0 and mix_cuda.mix_auto_launches == 0,
              f"{name} ({mode}): an effects session took a summing kernel")
        check(np.isfinite(res.audio).all(), f"{name} ({mode}): non-finite output")
        runs[mode] = (res, n)
        print(f"[{name}] bounce(device='cuda', effects_mode={mode!r}): {res.stats.summary()}; "
              f"finisher {res.stats.finish_seconds * 1e3:.3f} ms; per-track kernel launches={n}")
    launches = runs["fir"][1]

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
    p = warm.plan
    pt = warm.render_device_per_track()
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
          f"{p.num_tracks} tracks; vs f64 reference (sosfilt) relative RMS scan {rr_scan:.3g} "
          f"(< {SCAN_REL_RMS}), fir {rr_fir:.3g} (< {FIR_REL_RMS}); scan vs fir max abs "
          f"{scan_fir:.3g} (<= {SCAN_FIR_ATOL}); reference {ref_s:.1f} s on the host")

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
        finish = prepare_fir_finish(session, RATE, r.tables["track_gain"], None, p.channels,
                                    device="cuda")
        t4 = time.perf_counter()
        finish(r.render_device_per_track())
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0))
    carve_s, plan_s, upload_s, ir_s, launch_s, e2e_med = (statistics.median(c) for c in zip(*rows))
    e2e_best = min(row[-1] for row in rows)

    args = (warm.pool_device, warm.tables, p.n_tiles, p.tile, p.channels)
    fir_finish = prepare_fir_finish(session, RATE, warm.tables["track_gain"], None, p.channels,
                                    device="cuda")
    scan_finish = _effects_finisher(session, warm, p, RATE, p.channels, "scan", False,
                                    torch.device("cuda"))
    kernel_ms, kernel_all = _event_ms(torch, lambda: mix_cuda.mix_per_track_cuda(*args), 20)
    fir_ms, _ = _event_ms(torch, lambda: fir_finish(pt), 5)
    scan_ms, _ = _event_ms(torch, lambda: scan_finish(pt), 1)
    plain_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_per_track_reference(*args), 1)
    got, plain = mix_cuda.mix_per_track_cuda(*args), mix_cuda.mix_per_track_reference(*args)
    max_abs = float((got - plain).abs().max())
    check(torch.equal(got, plain), f"{name}: per-track kernel != plain version (max abs {max_abs:.3g})")
    del got, plain
    table_bytes = sum(t.numel() * t.element_size() for t in warm.tables.values())
    stats = {
        "cell": name, "tracks": p.num_tracks, "audio_seconds": duration,
        "frames": int(p.total_frames), "tile": p.tile, "n_tiles": p.n_tiles, "K": p.max_slots,
        "active_slots": int((p.me > p.ms).sum()), "pool_mb": pool.data.nbytes / 1e6,
        "per_track_gb": p.num_tracks * p.channels * p.n_tiles * p.tile * 4 / 1e9,
        "e2e_ms_median": e2e_med * 1e3, "e2e_ms_best": e2e_best * 1e3,
        "rtf_median": duration / e2e_med, "rtf_best": duration / e2e_best,
        "carve_ms": carve_s * 1e3, "plan_ms": plan_s * 1e3, "upload_ms": upload_s * 1e3,
        "ir_ms": ir_s * 1e3, "launch_to_sync_ms": launch_s * 1e3,
        "kernel_ms_median": kernel_ms, "kernel_ms_min": min(kernel_all), "plain_ms_median": plain_ms,
        "fir_finish_ms": fir_ms, "scan_finish_ms": scan_ms,
        "output_gb_per_s": p.num_tracks * p.channels * p.n_tiles * p.tile * 4 / (kernel_ms * 1e-3) / 1e9,
        "kernel_vs_plain_max_abs": max_abs, "scan_rel_rms": rr_scan, "fir_rel_rms": rr_fir,
        "scan_vs_fir_max_abs": scan_fir, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **bound(p, pool.data.nbytes, table_bytes, per_track=True),
    }
    print(f"[{name}] " + json.dumps(stats))
    print(f"[{name}] " + sh(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                             "temperature.gpu", "--format=csv,noheader"]))
    return _kernel_entry(stats, launches)


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

    env = phase_environment(torch)
    phase_build()
    phase_kernel_vs_plain()
    linear = phase_headline(torch)
    auto = phase_automation(torch)
    per_track = phase_effects(torch)
    check("jax" not in sys.modules and "whitebox_tpu" not in sys.modules,
          "the port loaded jax or the JAX package")
    src = "whitebox_tpu_torch/csrc/mix_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "mix_linear", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:407", **linear},
        {"name": "mix_automation", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:384-460", **auto},
        {"name": "mix_per_track", "route": "cuda", "source": src,
         "replaces": "whitebox_tpu/ops/mix_pallas.py:431-436,581-593,608-610", **per_track},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["device_count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
