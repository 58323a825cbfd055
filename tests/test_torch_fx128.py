"""The ``fx128`` configuration of the benchmark (``wbbench/configs/fx128.json``:
config 6's group chains, compressors on half the tracks and a lookahead
limiter on the master) on the CPU.

- The benchmark's f64 references of the ``compressor`` and ``limiter``
  entries (``wbbench/reference/fx/``), run chunk by chunk over odd chunk
  lengths, against the JAX package's sequential f64 ``compressor_ref`` and
  ``limiter_ref``.
- The port's ``bounce`` of a small session of that configuration against
  the benchmark's ``Reference.mixes``, within the cell's limits
  (``wbbench/limits/fx128.export.json``); the reference's dynamics act on
  it (the level is what makes them act); the bounce's ``RenderStats`` says
  that the generic finisher ran with its dynamics stages. The session has
  32 tracks: 8 sum to about -3 dBFS, below the limiter's ceiling, where the
  cell's 128 sum well above it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from wbbench.lib import chains
from wbbench.lib.check import Reference, compare
from wbbench.lib.spec import part

ROOT = Path(__file__).resolve().parents[1]
RATE = 48000.0
#: the small session: the configuration at 32 tracks of 3 s, 16 assets of 0.25 s
SMALL = {"tracks": 32, "seconds": 3.0, "assets": 16, "asset_seconds": 0.25, "break_beats": 0.25}
SEED = 0
#: chunk lengths that straddle the lookahead (240 frames) and the release blocks
CHUNKS = (1, 7, 239, 241, 1000, 1512)

COMPRESSOR = part("reference/fx", "compressor")
LIMITER = part("reference/fx", "limiter")


def _signal(frames: int = sum(CHUNKS)) -> np.ndarray:
    """``[2, frames]`` f64 of f32 samples: noise under a swelling envelope, so
    that the level crosses the knee and the ceiling both ways."""
    rng = np.random.default_rng(11)
    env = 1.2 * np.sin(np.arange(frames) / 400.0) ** 2
    x = rng.standard_normal((2, frames)) * 0.3 * env
    return x.astype(np.float32).astype(np.float64)


def _chunked(entry, params, x) -> np.ndarray:
    out, state, f0 = [], None, 0
    for n in CHUNKS:
        y, state = entry.process(params, x[:, f0:f0 + n], state, RATE)
        out.append(y)
        f0 += n
    return np.concatenate(out, axis=-1)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("threshold_db, ratio", [(-24.0, 4.0), (-18.0, 3.0)])
def test_compressor_reference_matches_the_sequential_one(threshold_db, ratio):
    from whitebox_tpu.ops import dynamics as jdyn

    x = _signal()
    params = COMPRESSOR.resolve({"threshold_db": threshold_db, "ratio": ratio}, 0)
    want = jdyn.compressor_ref(x, threshold_db=threshold_db, ratio=ratio, knee_db=6.0,
                               attack=float(jdyn.time_coef(0.005, RATE)), release=float(jdyn.time_coef(0.1, RATE)))
    got = _chunked(COMPRESSOR, params, x)
    assert _rel(got, want) <= 1e-12
    assert _rel(want, x) > 1e-2  # the compressor acted


@pytest.mark.parametrize("lookahead_s, frames", [(0.0, 0), (0.005, 240)])
def test_limiter_reference_matches_the_sequential_one(lookahead_s, frames):
    from whitebox_tpu.ops import dynamics as jdyn

    x = _signal()
    params = LIMITER.resolve({"ceiling_db": -6.0, "lookahead_s": lookahead_s}, 0)
    assert LIMITER.lookahead_frames(params, RATE) == frames
    want = jdyn.limiter_ref(x, ceiling_db=-6.0, attack=float(jdyn.time_coef(0.001, RATE)),
                            release=float(jdyn.time_coef(0.05, RATE)), lookahead=frames)
    got = _chunked(LIMITER, params, x)
    assert _rel(got, want) <= 1e-12
    assert np.abs(want).max() < np.abs(x).max() * 0.9  # the limiter acted


@pytest.fixture(scope="module")
def small():
    """The small session's description, its reference and the port's bounce of it."""
    from whitebox_tpu_torch.render.bounce import bounce

    with open(ROOT / "wbbench" / "configs" / "fx128.json") as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    desc = part("sessions", "clips").generate(cfg, SEED)
    res = bounce(part("program", "clips").build(desc), RATE, device="cpu")
    return desc, Reference(desc, part("reference", "clips")), res


def test_small_bounce_agrees_with_the_reference(small):
    desc, ref, res = small
    with open(ROOT / "wbbench" / "limits" / "fx128.export.json") as f:
        limits = json.load(f)
    got = compare(res.audio, ref.mixes([desc])[0], tuple(limits))
    assert all(got[k] <= lim for k, lim in limits.items()), (got, limits)


def test_the_level_makes_the_dynamics_act(small):
    """Every compressor reduces its track by more than 1 dB on a quarter of
    its audible frames (above -60 dBFS) or more; the master limiter reduces
    the mix by more than 0.1 dB on 5 % of its frames or more."""
    desc, ref, _ = small
    compressed = 0
    for t, tr in enumerate(desc.tracks):
        (kind, entry), = tr.chain
        assert kind == "by_group"
        if entry["type"] != "compressor":
            continue
        x = ref.render.signal(desc, t, 0, ref.F).astype(np.float64)
        reduction, _ = COMPRESSOR.reduction(entry["params"], x, None, RATE)
        audible = np.max(np.abs(x), axis=0) > 10.0 ** (-60.0 / 20.0)
        assert np.mean(reduction[audible] > 1.0) >= 0.25, t
        compressed += 1
    assert compressed == len(desc.tracks) // 2
    highpass, (kind, params) = desc.master_chain
    assert kind == "limiter"
    mix, _ = chains.process((highpass,), ref._sum(desc, list(range(len(desc.tracks)))), None, RATE)
    reduction, _ = LIMITER.reduction(params, mix, None, RATE)
    assert np.mean(reduction > 0.1) >= 0.05


def test_small_bounce_runs_the_generic_finisher_with_dynamics(small):
    _, _, res = small
    st = res.stats
    assert st.finisher == "generic"
    assert st.finish_chunks >= 1
    # a compressor group and the master limiter each chunk
    assert st.dynamics_calls >= 2 * st.finish_chunks
    assert "finisher generic" in st.summary()
