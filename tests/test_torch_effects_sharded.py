"""whitebox_tpu_torch's frame-sharded effect chains (``parallel/effects_sharded.py``)
on a world of four CPU processes over gloo, frames-only (1x4).

One world serves the module (a fixture; ``tests/torch_parallel_worlds.py``
runs the jobs). The reference is the port's single-device chain: each
effect's ``process`` over the whole signal from its initial state, or the
chunked stream. Bars (``tests/test_effects_sharded.py:109,134,147``):

- chorus/flanger: bit-equal (pure gathers, the dry tail and the LFO phase
  carried exactly);
- convolution reverb: within atol 2e-6 of the chunked stream with the
  shard as the chunk (the same overlap-add partials, added in another
  order);
- the card's chunked form of the recurrences (``SHARD_CHUNK``, here 512
  frames of a 4096-frame shard) within relative 5e-5 of the single-device
  chain, as the whole-shard form;
- every effect kind (the slow tier): relative 5e-5 of the single-device
  one-shot.
"""

import copy
import zlib

import numpy as np
import pytest
import torch

import whitebox_tpu.effects as jfx
from tests.test_carve import random_session
from tests.torch_parallel_worlds import run_jobs, same_on_every_rank
from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu_torch.effects import (
    Biquad, Chorus, Compressor, ConvolutionReverb, Delay, Flanger, Gain, Limiter, NoiseGate,
    ParametricEQ, Saturator, StereoWidth,
)
from whitebox_tpu_torch.parallel.launch import run_world
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference

RATE = 48000.0
F = 16384  # 4 shards x 4096 frames
CHUNK = 512


def _noise(seed, C=2, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((C, F)) * scale).astype(np.float32)


def _single(effs, x):
    """The single-device one-shot: each effect's ``process`` from its
    initial state over the whole signal."""
    y = torch.from_numpy(x)
    for e in copy.deepcopy(effs):
        e.prepare(RATE, x.shape[0])
        y, _ = e.process(y, e.init_state(x.shape[0]))
    return y.numpy()


def _rel(got, ref):
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-6)


def _reverb():
    return ConvolutionReverb(np.exp(-np.arange(3000) / 500.0).astype(np.float32) * 0.2, wet=0.5)


CASES = [
    ("compressor-peak", [Compressor(-18.0, 4.0, attack_s=0.004, release_s=0.08)]),
    ("compressor-rms", [Compressor(-22.0, 6.0, detector="rms")]),
    ("limiter-lookahead", [Limiter(-4.0, lookahead_s=0.002)]),
    ("gate", [NoiseGate(-26.0, release_s=0.05)]),
    ("delay-stereo", [Delay(1500 / RATE, 0.55, wet=0.5)]),
    ("delay-short", [Delay(600 / RATE, 0.7, wet=0.4)]),
    ("delay-pingpong", [Delay(1100 / RATE, 0.5, mode="pingpong")]),
    ("delay-negative-fb", [Delay(900 / RATE, -0.6, wet=0.5)]),
    ("chorus", [Chorus(rate_hz=1.1, voices=3)]),
    ("flanger", [Flanger()]),
    ("reverb-short", [ConvolutionReverb(np.exp(-np.arange(1200) / 300.0).astype(np.float32) * 0.2, wet=0.4)]),
    ("reverb-multihop", [ConvolutionReverb(np.exp(-np.arange(5000) / 900.0).astype(np.float32) * 0.15,
                                           wet=0.4)]),
    ("saturator", [Saturator(9.0, mix=0.7)]),
    ("width", [StereoWidth(1.5)]),
    ("gain+biquad", [Gain(-3.0), Biquad("lowpass", 3000.0)]),
    ("eq", [ParametricEQ([("lowshelf", 120.0, 0.707, 3.0), ("peak", 2000.0, 1.0, -2.0)])]),
    ("full-chain", [NoiseGate(-40.0), Compressor(-20.0, 3.0), Delay(800 / RATE, 0.4, wet=0.3),
                    Saturator(6.0, mix=0.5), Biquad("highpass", 40.0)]),
]
CHUNKED = ["full-chain", "compressor-rms", "limiter-lookahead", "delay-pingpong", "reverb-multihop", "eq"]


def _lanes_session():
    """A biquad frequency lane (the time-varying scan) and a compressor
    threshold lane on a frames-only mesh."""
    s = random_session(12, rate=48000, bpm=120.0, n_tracks=3, n_clips=1)
    s.tracks[0].effects = jfx.EffectChain([jfx.Biquad("lowpass", 7000.0, 1.0)])
    s.tracks[0].automation = TrackAutomation(
        effects={(0, "freq_hz"): AutomationLane().add(0.0, 7000.0).add(2.0, 500.0)})
    s.tracks[1].effects = jfx.EffectChain([jfx.Compressor(-20.0, 3.0)])
    s.tracks[1].automation = TrackAutomation(
        effects={(0, "threshold_db"): AutomationLane().add(0.0, -30.0).add(3.0, -10.0)})
    return from_reference(s)


@pytest.fixture(scope="module")
def world():
    cases = dict(CASES)
    jobs = {"chorus_exact": ("chain", {"x": _noise(42), "effects": [Chorus(rate_hz=0.7, voices=2)],
                                       "tp": 1, "fp": 4}),
            "reverb_exact": ("chain", {"x": _noise(7), "effects": [_reverb()], "tp": 1, "fp": 4})}
    for name in CHUNKED:
        jobs[f"chunked:{name}"] = ("chain", {"x": _noise(zlib.crc32(name.encode()) % 1000),
                                             "effects": copy.deepcopy(cases[name]), "tp": 1, "fp": 4,
                                             "chunk": CHUNK})
    lanes = _lanes_session()
    for chunk in (None, CHUNK):
        jobs[f"lanes:{chunk}"] = ("bounce", {"session": lanes, "tp": 1, "fp": 4, "chunk": chunk})
    res = same_on_every_rank(run_world(run_jobs, 4, device="cpu", timeout=240, args=(list(jobs.values()),)))
    return dict(zip(jobs, res)), lanes


def _ok(r):
    assert r[0] == "ok", r
    return r[1]


def test_chorus_sharded_is_exact(world):
    """Pure gathers + the previous shard's dry tail: not just close, exact."""
    res, _ = world
    np.testing.assert_array_equal(_ok(res["chorus_exact"]), _single([Chorus(rate_hz=0.7, voices=2)], _noise(42)))


def test_reverb_sharded_is_exact_vs_chunked(world):
    """The FIR spill reaching the next shard equals the chunked stream
    (chunks of the shard length), both summing the same overlap-add
    partials."""
    res, _ = world
    x = _noise(7)
    eff = _reverb()
    eff.prepare(RATE, 2)
    st = eff.init_state(2)
    chunks = []
    for a in range(0, F, F // 4):
        yc, st = eff.process(torch.from_numpy(x[:, a:a + F // 4]), st)
        chunks.append(yc.numpy())
    np.testing.assert_allclose(_ok(res["reverb_exact"]), np.concatenate(chunks, -1), atol=2e-6)


@pytest.mark.parametrize("name", CHUNKED)
def test_chunked_recurrences_match_single(world, name):
    """The card's form: each shard's recurrences (one-pole, max-decay, the
    combs, the overlap-add, the cascade) run 512 frames at a time with the
    state carried, the summaries exchanged once a recurrence."""
    res, _ = world
    effs = dict(CASES)[name]
    x = _noise(zlib.crc32(name.encode()) % 1000)
    err = _rel(_ok(res[f"chunked:{name}"]), _single(effs, x))
    assert err < 5e-5, f"{name}: chunked shards vs single rel err {err:.2e}"


@pytest.mark.parametrize("chunk", [None, CHUNK])
def test_effect_lanes_sharded(world, chunk):
    """Effect lanes at the shard's global frames: a biquad frequency lane
    (the time-varying scan: span transitions exchanged, the scan run again
    from the incoming state) and a compressor threshold lane, whole shards
    and 512-frame chunks, within atol 3e-6 / rtol 1e-4 of the single-device
    bounce."""
    res, lanes = world
    got = _ok(res[f"lanes:{chunk}"])
    single = bounce(lanes, RATE, engine="xla", chunk_frames=4096, device="cpu").audio
    n = min(single.shape[1], got.shape[1])
    np.testing.assert_allclose(got[:, :n], single[:, :n], atol=3e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def every_kind():
    jobs = [("chain", {"x": _noise(zlib.crc32(n.encode()) % 1000), "effects": copy.deepcopy(e), "tp": 1, "fp": 4})
            for n, e in CASES]
    jobs.append(("chain", {"x": _noise(3), "tp": 1, "fp": 4,
                           "effects": [NoiseGate(-45.0), Compressor(-20.0, 3.0), Delay(700 / RATE, 0.5, wet=0.35)]}))
    return same_on_every_rank(run_world(run_jobs, 4, device="cpu", timeout=600, args=(jobs,)))


@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_sharded_matches_single(every_kind, i):
    """Every effect kind of ``tests/test_effects_sharded.py:70-91``: the
    sharded chain within relative 5e-5 of the single-device one-shot."""
    name, effs = CASES[i]
    err = _rel(_ok(every_kind[i]), _single(effs, _noise(zlib.crc32(name.encode()) % 1000)))
    assert err < 5e-5, f"{name}: sharded vs single rel err {err:.2e}"


@pytest.mark.slow
def test_apply_chain_sharded_wrapper(every_kind):
    """The user-facing ``[C, F]`` master-bus entry point (3e-5)."""
    effs = [NoiseGate(-45.0), Compressor(-20.0, 3.0), Delay(700 / RATE, 0.5, wet=0.35)]
    assert _rel(_ok(every_kind[-1]), _single(effs, _noise(3))) < 3e-5
