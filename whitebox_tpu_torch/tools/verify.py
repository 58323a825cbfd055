"""Verification of the feature surface on a device, check by check.

    python -m whitebox_tpu_torch.tools.verify [--device cuda|cpu] [--json PATH] [--only NAME[,NAME]]

The port's counterpart of the JAX package's ``tools/tpu_verify.py``: the
same eleven checks (:data:`CHECKS`), each on the same session, at the same
seeds, sizes and bars, through the port's own entry points: the routed
finisher (buses, post/pre sends, a sidechain compressor, a master limiter)
and its PDC under a latent linear-phase bus, tempo maps (a speed-1 render
bit-exact against the oracle, a resampled clip within 2.4e-7), the EBU
R128 reading against the f64 host reference, a linear-phase EQ against
the f64 generic finish, track freeze, the phase vocoder's identity, a
sinc render of a rational and an irrational speed in one bounce, reverse
and bidirectional runs through the sinc prerender, and a streamed
recording take.

Each check takes ``device`` (default ``None``: the CUDA card; ``"cpu"``
runs the plain PyTorch versions) and returns its value beside its bar and
the kernels it launched; a miss raises :class:`CheckFailed`. Where the JAX
check passes ``engine="pallas"`` the port's does too, and on the card it
also requires a launch of the mix kernel (the summing kernel, its
automation variant or the per-track kernel) and, where a cascade stage
sits in the path (the routed chains, freeze's lowpass, the K-weighting),
a launch of the biquad cascade kernel: a render that went to the gather
mix fails. The sinc checks require the mix kernel on the card as well,
and ``sinc_partial`` reports whether its irrational rows rode the pool
extension or the 4x oversampled pool.

The sessions come from :func:`random_session` and :func:`mono_asset`,
copies of the JAX package's test helpers that consume NumPy's generator
in the same order, so a seed builds the same session.

Prints one ``PASS``/``FAIL`` line per check and a JSON summary; exits 1
on any failure. ``--json PATH`` also writes the summary to ``PATH``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import time
import traceback

import numpy as np
import torch

from whitebox_tpu_torch.core.formats import AudioFormat
from whitebox_tpu_torch.device import resolve_device
from whitebox_tpu_torch.ops import biquad_cuda, dynamics_cuda, mix_cuda
from whitebox_tpu_torch.session import Session
from whitebox_tpu_torch.session.sample import Sample

RATE = 48000.0


class CheckFailed(AssertionError):
    """A check's value missed its bar; ``result`` holds what it measured."""

    def __init__(self, msg: str, result: dict) -> None:
        super().__init__(msg)
        self.result = result


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))


def random_session(seed, *, rate, bpm, n_tracks, formats=(AudioFormat.F32,), speeds=(1.0,), n_clips=3,
                   playhead=0.0, src_rates=None) -> Session:
    """A seeded session of ``n_tracks`` tracks, one sample each, with
    ``n_clips`` clips of random length, offset, gain and speed (drawn from
    ``speeds``); the generator is consumed in the order of the JAX
    package's ``tests/test_carve.py::random_session``."""
    rng = np.random.default_rng(seed)
    s = Session(bpm=bpm)
    s.set_playhead_position(playhead)

    for t in range(n_tracks):
        fmt = formats[int(rng.integers(len(formats)))]
        n = int(rng.integers(500, 4000))
        if fmt == AudioFormat.F32:
            data = (rng.standard_normal((int(rng.integers(1, 3)), n)) * 0.3).astype(np.float32)
        elif fmt == AudioFormat.I16:
            data = rng.integers(-32768, 32768, size=(1, n)).astype(np.int16)
        elif fmt == AudioFormat.I24:
            data = rng.integers(-(1 << 23), 1 << 23, size=(1, n)).astype(np.int32)
        else:
            data = rng.integers(-(1 << 31), 1 << 31, size=(2, n)).astype(np.int32)
        src_rate = int(rng.choice(src_rates)) if src_rates else int(rate)
        sample = Sample.from_planar(data, src_rate, fmt, name=f"s{t}")
        asset = s.sample_table.add_sample(sample, key=f"s{t}")

        tr = s.add_track(
            f"t{t}",
            volume_db=float(rng.uniform(-12, 3)),
            pan=float(rng.uniform(-1, 1)),
            mute=bool(rng.random() < 0.1),
        )
        pos = float(rng.uniform(0, 2))
        for c in range(n_clips):
            length = float(rng.uniform(0.2, 3.0))
            speed = float(speeds[int(rng.integers(len(speeds)))])
            start_offset = float(int(rng.integers(0, max(n // 2, 1))))
            s.add_audio_clip(
                tr, f"c{c}", pos, pos + length,
                start_offset=start_offset, asset=asset,
                gain=float(rng.uniform(0.2, 1.2)), speed=speed,
            )
            pos += length + float(rng.uniform(0.0, 1.0))
    return s


def mono_asset(s: Session, n=6000, seed=0, key="a", src_rate=48000):
    """A seeded mono F32 noise sample of ``n`` frames registered in ``s``
    (the JAX package's ``tests/test_tempo_session.py::_mono_asset``)."""
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((1, n)) * 0.4).astype(np.float32)
    return s.sample_table.add_sample(
        Sample.from_planar(data, src_rate, AudioFormat.F32, name=key), key=key)


# ---------------------------------------------------------------- launches


def launch_counts() -> dict:
    """The kernels' launch counters as they stand: the summing mix kernel
    (K1/K2), its automation variant (K3), the per-track kernel (K4), each
    variant's launches by interpolation mode, the biquad cascade and the
    dynamics kernel, fused (a compressor, limiter or gate call) and unfused
    (the recurrences alone)."""
    return {"mix": mix_cuda.mix_kernel_launches, "mix_auto": mix_cuda.mix_auto_launches,
            "mix_per_track": mix_cuda.mix_per_track_launches,
            **{f"interp_{k}": v for k, v in mix_cuda.interp_launches.items()},
            "biquad_cascade": biquad_cuda.biquad_cascade_launches,
            "dynamics_fused": dynamics_cuda.dynamics_fused_launches,
            "dynamics_scan": dynamics_cuda.dynamics_scan_launches}


class Launches:
    """The launches made inside a ``with`` block, by counter (only those
    that rose)."""

    def __enter__(self) -> "Launches":
        self._before = launch_counts()
        self.delta: dict = {}
        return self

    def __exit__(self, *exc) -> None:
        after = launch_counts()
        self.delta = {k: after[k] - v for k, v in self._before.items() if after[k] != v}

    def mix(self) -> int:
        return sum(self.delta.get(k, 0) for k in ("mix", "mix_auto", "mix_per_track"))


def _result(metric: str, value, bar, ok: bool, dev: torch.device, launches: Launches, *,
            mix: bool = False, cascade: bool = False, **extra) -> dict:
    """The check's result; raises :class:`CheckFailed` on a miss, or where
    on the card a required kernel (``mix``, ``cascade``) was not launched."""
    res = {"metric": metric, "value": value, "bar": bar, "kernels": launches.delta, **extra}
    misses = [] if ok else [f"{metric} {value!r} misses its bar {bar!r}"]
    if dev.type == "cuda":
        if mix and not launches.mix():
            misses.append(f"no mix-kernel launch (the render went to the gather mix): {launches.delta}")
        if cascade and not launches.delta.get("biquad_cascade"):
            misses.append(f"no biquad cascade launch: {launches.delta}")
    res["ok"] = not misses
    if misses:
        raise CheckFailed("; ".join(misses), res)
    return res


# ---------------------------------------------------------------- sessions and references


def _routed_session(seed=11, sidechain=True, latent=False) -> Session:
    from whitebox_tpu_torch.effects import (
        Biquad, Compressor, EffectChain, Gain, Limiter, LinearPhaseEQ, ParametricEQ,
    )

    s = random_session(seed, rate=RATE, bpm=120.0, n_tracks=6, formats=(AudioFormat.F32,), n_clips=2)
    drums = s.add_bus("drums", volume_db=-2.0, pan=0.2)
    fxb = s.add_bus("fx", volume_db=-6.0)
    drums.effects = EffectChain([ParametricEQ([
        ("lowshelf", 120.0, 0.707, 2.5), ("peak", 2500.0, 1.2, -2.0)])])
    if sidechain:
        fxb.effects = EffectChain([Compressor(-24.0, 4.0, sidechain=True)])
    else:
        fxb.effects = EffectChain([Biquad("highpass", 300.0), Gain(-1.5)])
    if latent:
        drums.effects = EffectChain([LinearPhaseEQ([("lowshelf", 120.0, 0.707, 2.5)], taps=255)])
    s.set_track_output(0, 0)
    s.set_track_output(1, 0)
    s.add_send(2, 1, gain_db=-3.0, sidechain=sidechain)
    s.add_send(3, 1, gain_db=-4.5, pre_fader=True)
    s.master_effects = EffectChain([Biquad("highpass", 30.0), Limiter(-0.5)])
    return s


def _per_track_reference(s: Session) -> np.ndarray:
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy

    table, pool = carve_session(s, RATE, buffer_size=512)
    return render_segments_per_track_numpy(table, pool)


def _rel_rms(got, ref) -> float:
    n = min(got.shape[1], ref.shape[1])
    return rms(got[:, :n] - ref[:, :n]) / max(rms(ref), 1e-9)


# ---------------------------------------------------------------- checks


def check_routed_sidechain(device=None) -> dict:
    """Buses + post/pre sends + sidechain compressor + master limiter,
    against the f64 routed finish: relative RMS < 5e-5."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.routing import reference_routed_finish

    dev = resolve_device(device)
    s = _routed_session(sidechain=True)
    with Launches() as n:
        res = bounce(s, RATE, device=dev, engine="pallas", chunk_frames=8192, effects_mode="routed")
    err = _rel_rms(res.audio, reference_routed_finish(_per_track_reference(s), s, RATE, 2))
    return _result("rel_rms", err, 5e-5, err < 5e-5, dev, n, mix=True, cascade=True)


def check_routed_pdc(device=None) -> dict:
    """PDC fetch-ahead + head trim under a latent linear-phase bus chain,
    against the f64 routed finish with PDC: relative RMS < 5e-5."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.routing import reference_routed_finish

    dev = resolve_device(device)
    s = _routed_session(seed=13, sidechain=False, latent=True)
    with Launches() as n:
        res = bounce(s, RATE, device=dev, engine="pallas", chunk_frames=8192, effects_mode="routed",
                     pdc=True)
    err = _rel_rms(res.audio, reference_routed_finish(_per_track_reference(s), s, RATE, 2, pdc=True))
    return _result("rel_rms", err, 5e-5, err < 5e-5, dev, n, mix=True, cascade=True)


def check_tempo_step_ramp(device=None) -> dict:
    """A tempo-mapped speed-1 carve (a linear ramp, then steps) through the
    mix: bit-exact against the oracle."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline.oracle import OracleRenderer

    dev = resolve_device(device)
    s = Session(bpm=128.0)
    s.set_tempo_point(0.0, 128.0, curve="linear")
    s.set_tempo_point(6.0, 64.0)
    s.set_tempo_point(10.0, 150.0)
    a = mono_asset(s, 12000, seed=3)
    tr = s.add_track("t", volume_db=-3.0, pan=0.3)
    s.add_audio_clip(tr, "c0", 0.25, 3.0, asset=a)
    s.add_audio_clip(tr, "c1", 5.0, 9.0, asset=a, gain=0.5)
    s.add_audio_clip(tr, "c2", 9.5, 12.0, asset=a, gain=0.8)
    oracle = OracleRenderer(s, RATE, buffer_size=512).render()
    with Launches() as n:
        res = bounce(s, RATE, device=dev, engine="pallas", buffer_size=512)
    m = min(res.audio.shape[1], oracle.shape[1])
    diff = int(np.count_nonzero(res.audio[:, :m] != oracle[:, :m]))
    return _result("samples_off_oracle", diff, 0, diff == 0, dev, n, mix=True)


def check_tempo_resampled(device=None) -> dict:
    """A resampled clip under a tempo step: max abs error against the
    oracle <= 2.4e-7 (the blockwise resampling contract)."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline.oracle import OracleRenderer

    dev = resolve_device(device)
    s = Session(bpm=100.0)
    s.set_tempo_point(2.0, 140.0)
    a = mono_asset(s, 20000, seed=5, src_rate=44100)
    tr = s.add_track("t")
    s.add_audio_clip(tr, "c", 0.5, 6.0, asset=a, speed=1.25)
    oracle = OracleRenderer(s, RATE, buffer_size=512).render()
    with Launches() as n:
        res = bounce(s, RATE, device=dev, engine="pallas", buffer_size=512)
    m = min(res.audio.shape[1], oracle.shape[1])
    d = float(np.abs(res.audio[:, :m].astype(np.float64) - oracle[:, :m]).max())
    return _result("max_abs", d, 2.4e-7, d <= 2.4e-7, dev, n, mix=True)


def check_loudness(device=None) -> dict:
    """BS.1770-4 K-filter, gating and true peak on ``device`` against the
    host f64 reading: |dLUFS| < 1e-3, |dTP| < 1e-3 dB, |dLRA| < 1e-2 LU."""
    from whitebox_tpu_torch.ops.loudness import measure_loudness

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    m = int(RATE * 8)
    t = np.arange(m) / RATE
    sig = np.stack([
        0.3 * np.sin(2 * np.pi * 997.0 * t) * (t < 5.0),
        0.25 * np.sin(2 * np.pi * 1409.0 * t),
    ]) + 0.01 * rng.standard_normal((2, m))
    sig = sig.astype(np.float32)
    with Launches() as n:
        got = measure_loudness(sig, RATE, device=dev)
    host = measure_loudness(sig, RATE, device=False)
    d = {"d_lufs": abs(got.integrated_lufs - host.integrated_lufs),
         "d_true_peak": abs(got.true_peak_dbtp - host.true_peak_dbtp),
         "d_lra": abs(got.lra_lu - host.lra_lu)}
    bar = {"d_lufs": 1e-3, "d_true_peak": 1e-3, "d_lra": 1e-2}
    return _result("loudness_deltas", d, bar, all(d[k] < bar[k] for k in d), dev, n, cascade=True)


def check_linphase(device=None) -> dict:
    """A linear-phase EQ through the generic pipeline against the f64
    generic finish: relative RMS < 5e-5."""
    from whitebox_tpu_torch.effects import EffectChain, LinearPhaseEQ
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.render.effects_generic import reference_generic_finish

    dev = resolve_device(device)
    s = random_session(21, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=2)
    eq = LinearPhaseEQ([("lowshelf", 150.0, 0.707, 3.0), ("peak", 3000.0, 1.0, -2.5)], taps=511)
    s.tracks[0].effects = EffectChain([eq])
    with Launches() as n:
        res = bounce(s, RATE, device=dev, engine="pallas", chunk_frames=8192)
    err = _rel_rms(res.audio, reference_generic_finish(_per_track_reference(s), s, RATE, 2))
    return _result("rel_rms", err, 5e-5, err < 5e-5, dev, n, mix=True)


def check_freeze(device=None) -> dict:
    """``freeze_track`` on ``device``: the frozen bounce within 3e-6 (max
    abs) of the live bounce."""
    from whitebox_tpu_torch.effects import Biquad, EffectChain
    from whitebox_tpu_torch.render.bounce import bounce

    dev = resolve_device(device)
    s = random_session(31, rate=RATE, bpm=120.0, n_tracks=3, formats=(AudioFormat.F32,), n_clips=2)
    s.tracks[1].effects = EffectChain([Biquad("lowpass", 5000.0)])
    with Launches() as n:
        live = bounce(s, RATE, device=dev, engine="pallas", chunk_frames=8192).audio
        s.freeze_track(1, RATE, engine="pallas", device=dev)
        frozen = bounce(s, RATE, device=dev, engine="pallas", chunk_frames=8192).audio
    m = min(live.shape[1], frozen.shape[1])
    d = float(np.abs(live[:, :m] - frozen[:, :m]).max())
    return _result("max_abs", d, 3e-6, d < 3e-6, dev, n, mix=True, cascade=True)


def check_stretch(device=None) -> dict:
    """The phase vocoder at ratio 1 reconstructs a 440 Hz tone: RMS error
    < 2e-4 away from the edges."""
    from whitebox_tpu_torch.ops.stretch import time_stretch

    dev = resolve_device(device)
    t = np.arange(int(RATE * 2)) / RATE
    sig = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None]
    with Launches() as n:
        out = np.asarray(time_stretch(sig, 1.0, device=dev))
    m = min(sig.shape[1], out.shape[1])
    lo, hi = 4096, m - 4096
    err = rms(out[:, lo:hi] - sig[:, lo:hi])
    return _result("identity_rms", err, 2e-4, err < 2e-4, dev, n)


def check_sinc_partial(device=None) -> dict:
    """A rational (160/147) and an irrational (2^(1/12)) speed in one sinc
    render: SNR of the mix against both expected sines > 70 dB."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.timeline.carve import carve_session
    from whitebox_tpu_torch.timeline.prerender import plan_prerender

    dev = resolve_device(device)
    s = Session(bpm=120.0)
    m = 48000 * 2
    t = np.arange(m) / 48000.0
    sine = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)[None]
    a = s.sample_table.add_sample(Sample.from_planar(sine, 48000, AudioFormat.F32, name="sine"), key="s")
    tr = s.add_track("rat")
    s.add_audio_clip(tr, "c", 0.0, 3.0, asset=a, speed=160.0 / 147.0)
    tr2 = s.add_track("irr")
    s.add_audio_clip(tr2, "c", 0.0, 3.0, asset=a, speed=float(2 ** (1 / 12)))
    with Launches() as n:
        res = bounce(s, RATE, device=dev, interpolation="sinc", chunk_frames=1 << 16)
    audio = np.asarray(res.audio, np.float64)
    x = audio[:, 4096:48000].sum(axis=0)
    # project out both expected sines at once; the residue is the resampling error
    cols = []
    for sp in (160.0 / 147.0, float(2 ** (1 / 12))):
        ph = 2 * np.pi * 997.0 * sp * np.arange(x.shape[0]) / RATE
        cols += [np.cos(ph), np.sin(ph)]
    basis = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    snr = 20 * np.log10(max(rms(x), 1e-12) / max(rms(x - basis @ coef), 1e-12))
    # which path the resampled rows took: the pool extension (prerendered
    # runs, rational or Taylor) or the 4x oversampled pool (uncovered rows)
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    plan = plan_prerender(table, pool, partial=True)
    uncovered = 0 if plan is None or plan.uncovered_rows is None else len(plan.uncovered_rows)
    path = ("none prerendered" if plan is None else
            "extension" if not uncovered else f"extension + oversample ({uncovered} rows)")
    groups = [] if plan is None else sorted({g[0] for g in plan.groups})
    return _result("snr_db", float(snr), 70.0, snr > 70.0, dev, n, mix=True, resampled_rows=path,
                   prerender_groups=groups, mix_path=res.stats.mix_path)


def check_sinc_reverse(device=None) -> dict:
    """Reverse and bidirectional runs through the sinc prerender (mirrored
    forward ramps, backward reads at speed -1): the render within 3e-6
    (max abs) of the host mirror of the same rewrite."""
    from whitebox_tpu_torch.render.bounce import bounce
    from whitebox_tpu_torch.session.clip import ClipMode
    from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_per_track_numpy
    from whitebox_tpu_torch.timeline.prerender import apply_prerender_host, plan_prerender

    dev = resolve_device(device)
    s = random_session(15, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=2,
                       speeds=(0.5, float(2 ** (1 / 12))), src_rates=(48000.0,))
    for c in s.tracks[0].clips:
        c.audio.mode = ClipMode.LOOP_BIDIRECTIONAL
    table, pool = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    plan = plan_prerender(table, pool, partial=True)
    if plan is None or plan.uncovered_rows is not None:
        raise CheckFailed("the prerender must cover every run of this session", {"ok": False})
    if not any(p.rev for p in plan.runs):
        raise CheckFailed("the session must exercise reverse runs", {"ok": False})
    t2, p2 = apply_prerender_host(table, pool, plan)
    pt = render_segments_per_track_numpy(t2, p2)
    ref = np.zeros((2, pt.shape[2]))
    for t, tr in enumerate(s.tracks):
        vol = np.float32(0.0) if tr.mute else tr.volume_linear
        pan = tr.pan_coeffs
        for ch in range(2):
            ref[ch] += pt[t][ch] * float(np.float32(vol * np.float32(pan[ch])))
    ref = np.clip(ref, -1, 1)
    with Launches() as n:
        res = bounce(s, RATE, device=dev, interpolation="sinc", engine="pallas")
    audio = np.asarray(res.audio, np.float64)
    m = min(ref.shape[1], audio.shape[1])
    err = float(np.max(np.abs(audio[:, :m] - ref[:, :m])))
    return _result("max_abs", err, 3e-6, err < 3e-6, dev, n, mix=True,
                   reverse_runs=sum(1 for p in plan.runs if p.rev))


def check_record_preview(device=None) -> dict:
    """A streamed take (``Session.start_recording``) of five blocks:
    ``finalize`` registers exactly the concatenated blocks."""
    dev = resolve_device(device)
    s = random_session(41, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,), n_clips=1)
    tr = s.add_track("rec")
    rng = np.random.default_rng(0)
    with Launches() as n:
        take = s.start_recording(tr, 48000.0, at_beat=0.0, channels=1)
        chunks = [rng.standard_normal((1, 4801)).astype(np.float32) * 0.2 for _ in range(5)]
        for c in chunks:
            take.append(c)
        clip = take.finalize()
    full = np.concatenate(chunks, axis=1)
    got = np.asarray(clip.audio.asset.sample.data)
    same = got.shape == full.shape and bool((got == full).all())
    return _result("frames_equal", int(full.shape[1]) if same else 0, int(full.shape[1]), same, dev, n)


#: the checks by name, in the JAX package's order
CHECKS = [
    ("routed_sidechain", check_routed_sidechain),
    ("routed_pdc", check_routed_pdc),
    ("tempo_step_ramp", check_tempo_step_ramp),
    ("tempo_resampled", check_tempo_resampled),
    ("loudness_r128", check_loudness),
    ("linphase_eq", check_linphase),
    ("freeze", check_freeze),
    ("stretch", check_stretch),
    ("sinc_partial", check_sinc_partial),
    ("sinc_reverse", check_sinc_reverse),
    ("record_ingest", check_record_preview),
]


def run_check(name: str, device=None) -> dict:
    """Run the check ``name`` -> its result with ``ok`` and ``seconds``; an
    exception is a miss (``ok`` False, ``error`` its repr)."""
    fn = dict(CHECKS)[name]
    t0 = time.perf_counter()
    try:
        res = fn(device)
    except CheckFailed as e:
        res = {**e.result, "ok": False, "error": str(e)}
    except Exception as e:  # noqa: BLE001 - any fault of a check is a miss, never a pass
        res = {"ok": False, "error": repr(e), "traceback": traceback.format_exc()}
    return {**res, "seconds": time.perf_counter() - t0}


def format_line(name: str, res: dict) -> str:
    verdict = "PASS" if res["ok"] else "FAIL"
    line = f"{verdict} {name} ({res['seconds']:.1f}s)"
    if "metric" in res:
        line += f" {res['metric']}={res['value']!r} (bar {res['bar']!r}) kernels={res['kernels']}"
    extra = {k: v for k, v in res.items()
             if k not in ("ok", "seconds", "metric", "value", "bar", "kernels", "error", "traceback")}
    if extra:
        line += f" {extra}"
    if not res["ok"]:
        line += f": {res.get('error', '')}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m whitebox_tpu_torch.tools.verify",
                                 description="The feature surface's checks on a device.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", metavar="PATH", default=None, help="also write the summary JSON to PATH")
    ap.add_argument("--only", metavar="NAME[,NAME]", default=None, help="run only these checks")
    args = ap.parse_args(argv)

    names = [n for n, _ in CHECKS]
    if args.only:
        names = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = sorted(set(names) - set(dict(CHECKS)))
        if unknown:
            ap.error(f"unknown checks {unknown}; known: {[n for n, _ in CHECKS]}")
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({kind})", flush=True)
    results, failed = {}, []
    for name in names:
        res = run_check(name, dev)
        print(format_line(name, res), flush=True)
        if not res["ok"]:
            failed.append(name)
            if "traceback" in res:
                print(res["traceback"], file=sys.stderr)
        results[name] = {k: v for k, v in res.items() if k != "traceback"}
    print(json.dumps(results, default=str))
    if args.json:
        summary = {
            "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            "device": str(dev), "kind": kind, "n_checks": len(names),
            "n_pass": len(names) - len(failed), "failed": failed, "checks": results,
        }
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1, default=str)
        print(f"wrote {args.json}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
