#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Runs from the root of a checkout. It drives the port's main path — the
offline bounce of a 128-track, 60 s, 48 kHz session through the
hand-written CUDA mix kernel — and checks the result by the repo's own
references. It imports no JAX and reads no ``.wb`` project. Phases, one or
more lines each:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, and whether ninja and triton are present;
2. build: the CUDA kernel from ``whitebox_tpu_torch/csrc`` with nvcc;
3. kernel vs plain version on small sessions: bit-equal to the plain
   PyTorch mix on the card; against the NumPy segment reference bit-equal
   at speed 1 and within the resampling contract (<= 2 ulp or <= 2.4e-7)
   otherwise; an 8-track speed-1 bounce bit-equal to the NumPy oracle;
4. headline: ``bounce(device="cuda")`` of the 128-track session with the
   kernel's launch count reset just before, bit-equal to the NumPy
   segment reference; then 5 warm carve+plan+upload+kernel iterations,
   the kernel's time by CUDA events and the plain version's time;
5. one JSON line per kernel, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
repo is not beside it, or when any phase fails.
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATE = 48000.0
ULP_MAX, ABS_TOL = 2, 2.4e-7  # the JAX package's resampling contract (tests/test_bounce.py)


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


def native_carve_usable() -> bool:
    """The tracked native objects are built with -march=native: probe the
    native carve in a child process so an illegal instruction cannot kill
    this one. False selects the bit-identical NumPy carve."""
    code = ("from whitebox_tpu.timeline.carve import carve_session\n"
            "from whitebox_tpu_torch.render.demo import make_demo_session\n"
            "s = make_demo_session(n_tracks=2, duration_seconds=2.0, seed=1)\n"
            "carve_session(s, 48000.0, buffer_size=512)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    if r.returncode < 0:
        return False
    check(r.returncode == 0, f"native carve probe failed:\n{r.stderr}")
    return True


# ---------------------------------------------------------------- sessions


def _sample(rng, fmt, channels, n):
    import numpy as np

    from whitebox_tpu.core.formats import AudioFormat
    from whitebox_tpu.session.sample import Sample

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

    from whitebox_tpu.core.formats import AudioFormat
    from whitebox_tpu.session import Session

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

    from whitebox_tpu.core.formats import AudioFormat
    from whitebox_tpu.session import Session
    from whitebox_tpu.session.clip import ClipMode

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
        "ninja": shutil.which("ninja") is not None,
        "triton": importlib.util.find_spec("triton") is not None,
        "smi": smi,
    }
    print("[env] " + json.dumps(env))
    return env


def phase_build() -> None:
    from whitebox_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.load()
    print(f"[build] {cuda_build.build_dir() / cuda_build.LIB_NAME}: nvcc "
          f"{cuda_build.last_build_seconds:.2f} s, build+load {time.perf_counter() - t0:.2f} s "
          f"({' '.join(cuda_build.NVCC_FLAGS)})")


def kernel_vs_plain(name, session, tile=None):
    """Kernel vs plain version on the card, and vs the NumPy reference."""
    import numpy as np
    import torch

    from whitebox_tpu.timeline.carve import carve_session, render_segments_numpy
    from whitebox_tpu_torch.ops import mix_cuda

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


def phase_kernel_vs_plain() -> None:
    import numpy as np

    from whitebox_tpu.timeline.oracle import OracleRenderer
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.demo import make_demo_session

    kernel_vs_plain("speed1_i16_i24_f32_fades", int_formats_session())
    kernel_vs_plain("speed1_i16_i24_f32_fades_tile1024", int_formats_session(), tile=1024)
    kernel_vs_plain("mixed_speeds_fades", make_demo_session(
        n_tracks=8, duration_seconds=10.0, seed=3, fades=True,
        clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37)))
    kernel_vs_plain("reverse_bidirectional", reverse_session())

    s = make_demo_session(n_tracks=8, duration_seconds=10.0, seed=5)
    oracle = OracleRenderer(s, RATE, buffer_size=512).render()
    got = bounce(s, RATE, device="cuda").audio
    n = min(oracle.shape[1], got.shape[1])
    check(n > 0 and np.array_equal(got[:, :n], oracle[:, :n]), "8-track bounce != OracleRenderer")
    print(f"[kernel-vs-plain] oracle_8trk_10s: bounce(device='cuda') bit-equal to OracleRenderer "
          f"over {n} frames")


def _event_ms(torch, fn, iters):
    """Median device ms of ``fn`` over ``iters`` calls, CUDA events around each."""
    from whitebox_tpu_torch.render.metrics import DeviceTimer

    ts = []
    for _ in range(iters):
        with DeviceTimer(torch.device("cuda")) as t:
            fn()
        ts.append(t.seconds * 1e3)
    return statistics.median(ts), ts


def measure_cell(torch, name: str, session, duration: float) -> dict:
    """5 warm carve+plan+upload+kernel iterations (samples resident on the
    card, as bench.py keeps them), the kernel's and the plain version's
    device times by CUDA events, and kernel == plain at full size."""
    from whitebox_tpu.timeline.carve import carve_session
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.ops.mix_plan import build_plan

    table, pool = carve_session(session, RATE, buffer_size=512, slow_emit="runs")
    warm = mix_cuda.CudaMixRenderer(table, pool, session, device="cuda")
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
        r.render_device()
        torch.cuda.synchronize()
        rows.append((t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3, time.perf_counter() - t0))
    carve_s, plan_s, upload_s, launch_s, e2e_med = (statistics.median(c) for c in zip(*rows))
    e2e_best = min(row[4] for row in rows)
    p = warm.plan
    args = (warm.pool_device, warm.tables, p.n_tiles, p.tile, p.channels)
    kernel_ms, kernel_all = _event_ms(torch, lambda: mix_cuda.mix_cuda(*args), 20)
    plain_ms, _ = _event_ms(torch, lambda: mix_cuda.mix_reference(*args), 3)
    got = mix_cuda.mix_cuda(*args)
    plain = mix_cuda.mix_reference(*args)
    max_abs = float((got - plain).abs().max())
    check(torch.equal(got, plain), f"{name}: kernel != plain version (max abs {max_abs:.3g})")
    stats = {
        "cell": name, "tracks": p.num_tracks, "audio_seconds": duration,
        "frames": int(p.total_frames), "tile": p.tile, "n_tiles": p.n_tiles, "K": p.max_slots,
        "active_slots": int((p.me > p.ms).sum()),
        "slow_slots": int(((p.me > p.ms) & (p.is_slow == 1)).sum()),
        "pool_mb": pool.data.nbytes / 1e6,
        "e2e_ms_median": e2e_med * 1e3, "e2e_ms_best": e2e_best * 1e3,
        "rtf_median": duration / e2e_med, "rtf_best": duration / e2e_best,
        "carve_ms": carve_s * 1e3, "plan_ms": plan_s * 1e3, "upload_ms": upload_s * 1e3,
        "launch_to_sync_ms": launch_s * 1e3,
        "kernel_ms_median": kernel_ms, "kernel_ms_min": min(kernel_all), "plain_ms_median": plain_ms,
        "output_gb_per_s": got.numel() * 4 / (kernel_ms * 1e-3) / 1e9,
        "kernel_vs_plain_max_abs": max_abs,
    }
    print(f"[{name}] " + json.dumps(stats))
    return stats


def phase_headline(torch) -> dict:
    import numpy as np

    from whitebox_tpu.timeline.carve import carve_session, render_segments_numpy
    from whitebox_tpu_torch.ops import mix_cuda
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.demo import make_demo_session

    duration, n_tracks = 60.0, 128
    session = make_demo_session(n_tracks=n_tracks, duration_seconds=duration,
                                sample_rate=int(RATE), seed=7)

    # the main path, through the entry point a user calls
    mix_cuda.mix_kernel_launches = 0
    res = bounce(session, RATE, device="cuda")
    launches = mix_cuda.mix_kernel_launches
    check(launches > 0, "bounce never launched the CUDA mix kernel")
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
    return {"launches": launches, "max_abs_err": k["kernel_vs_plain_max_abs"],
            "ms": k["kernel_ms_median"], "plain_ms": k["plain_ms_median"]}


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
    if not (ROOT / "whitebox_tpu_torch" / "csrc").is_dir() or not (ROOT / "whitebox_tpu").is_dir():
        print(f"chip_smoke: the repo's packages are not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    env = phase_environment(torch)
    if not native_carve_usable():
        os.environ["WBTPU_NO_NATIVE"] = "1"
        print("[env] native carve library died in a probe; using the NumPy carve (WBTPU_NO_NATIVE=1)")
    phase_build()
    phase_kernel_vs_plain()
    k = phase_headline(torch)
    check("jax" not in sys.modules, "the port loaded jax")
    print(json.dumps({"kernels": [{
        "name": "mix_linear", "route": "cuda", "source": "whitebox_tpu_torch/csrc/mix_kernel.cu",
        "replaces": "whitebox_tpu/ops/mix_pallas.py:407", **k}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["device_count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
