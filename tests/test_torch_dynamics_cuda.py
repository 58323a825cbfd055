"""The dynamics kernel's tiles and look-back, modelled on the host (CPU).

The CUDA kernel ``whitebox_tpu_torch/csrc/dynamics_scan.cu`` runs a whole
compressor, limiter or gate stage in one pass: detector, curve, the release
(max-decay) and attack (one-pole) and the RMS detector's one-pole, each
resolved over tiles of ``32 l`` frames (each lane's walk from zero, a warp
scan, a look-back over the row's tiles) with f64 states, then the gain.
``ops/dynamics_cuda.py::ballistics_model`` is that algorithm in torch, and
``stage_model`` the fused stages on it. Here, on seeded rows with per-row
and per-frame coefficients, states carried in and out, keys, silent keys,
the gate's floor and hysteresis and the limiter's lookahead:

- the model equals itself with the look-back stopping at every depth, bit
  for bit, and the sequential f64 recurrence to 1e-7 relative RMS per row;
- the fused stages on the model meet the f64 references ``compressor_ref``,
  ``limiter_ref`` and ``gate_ref`` of ``ops/dynamics.py`` within the
  finisher's bars (5e-5; 2e-4 with per-frame lanes), and the JAX package's
  processors within relative RMS 5e-6 per row plus the JAX scans' own
  distance from the f64 oracle (the processors with the scans in f64);
- it is within 5e-6 per row of the JAX package's scans and of the port's
  plain version (the f32 Hillis scans), plus those scans' own distance from
  the exact recurrence, and states hand over between the model and the
  plain scans; its products over a row are ``_product``'s (the sharded
  stages' summaries);
- on the CPU the processors and ``ballistics``/``onepole`` are the plain
  versions, a silent key is an explicit zero key bit for bit, and the
  card's wrappers refuse malformed arguments. The kernel's constants and
  argument struct match the wrapper's.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whitebox_tpu.ops import dynamics as jdyn
from whitebox_tpu_torch.ops import dynamics as dyn
from whitebox_tpu_torch.ops import dynamics_cuda as dc
from whitebox_tpu_torch.render import effects_generic as gen

RATE = 48000.0
BAR = 5e-6  # the kernel (and its model) against the exact recurrence, per row
L = 32      # the model's sub-block here: tiles of 1,024 frames, several on short rows
SRC = Path(dc.__file__).parent.parent / "csrc" / "dynamics_scan.cu"


def _tc(seconds):
    return float(dyn.time_coef(seconds, RATE))


def _targets(B, F, seed):
    """Gain reductions in dB (>= 0): runs of over-threshold levels, zeros between."""
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((B, F))) * 6.0 * (rng.random((B, F)) < 0.3)).astype(np.float32)


def _lane(B, F, lo, hi, seed):
    return np.random.default_rng(seed).uniform(lo, hi, (B, F)).astype(np.float32)


def sequential(v, rho, a, e0, y0, floor=None, max_decay=True):
    """The recurrences one frame at a time in f64 (numpy), ``(1 - a) * h``
    formed in f32 from ``h = max(f32(e), floor)`` as the kernel and the plain
    scans form it -> (y, e_last, y_last)."""
    B, F = v.shape

    def at(c, n):
        c = np.broadcast_to(np.asarray(c, np.float32), (B, F) if np.ndim(c) and np.shape(c)[-1] == F else (B, 1))
        return c[:, n if c.shape[1] == F else 0]
    e = np.broadcast_to(np.asarray(e0, np.float64), (B,)).copy()
    y = np.broadcast_to(np.asarray(y0, np.float64), (B,)).copy()
    out = np.empty((B, F))
    for n in range(F):
        h = v[:, n]
        if max_decay:
            e = np.maximum(at(rho, n).astype(np.float64) * e, v[:, n].astype(np.float64))
            h = e.astype(np.float32)
            if floor is not None:
                h = np.maximum(h, at(floor, n))
        an = at(a, n)
        y = an.astype(np.float64) * y + ((np.float32(1.0) - an) * h).astype(np.float64)
        out[:, n] = y
    return out, (e if max_decay else None), y


def row_rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).mean(axis=-1)) / np.maximum(np.sqrt((b ** 2).mean(axis=-1)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_states(got, ref, exact):
    """A state out of the model against a reference's (the JAX scans, the
    plain version): within the bar of the exact recurrence, and off the
    reference by at most the bar plus the reference's own distance from it
    (a single value shows the f32 scans' drift undiluted)."""
    got, ref, exact = (np.asarray(t, np.float64) for t in (got, ref, exact))
    np.testing.assert_allclose(got, exact, rtol=BAR, atol=1e-6)
    assert (np.abs(got - ref) <= np.abs(ref - exact) + BAR * np.abs(exact) + 1e-6).all()


def _case(kind, B=3, F=1500, seed=0):
    """(v, rho, a, e0, y0, floor) numpy, of one kind of stage."""
    rng = np.random.default_rng(seed + 100)
    v = _targets(B, F, seed)
    e0 = rng.uniform(0.0, 3.0, B).astype(np.float32)
    y0 = rng.uniform(0.0, 3.0, B).astype(np.float32)
    rho = np.array([[_tc(0.1)], [_tc(0.02)], [0.0]], np.float32)[:B]
    a = np.array([[_tc(0.005)], [_tc(0.03)], [_tc(0.0005)]], np.float32)[:B]
    floor = None
    if kind == "lanes":  # automation lanes: every coefficient per frame
        rho, a = _lane(B, F, _tc(0.01), _tc(0.5), seed + 1), _lane(B, F, _tc(0.001), _tc(0.05), seed + 2)
    elif kind == "gate":
        v = np.clip(np.random.default_rng(seed + 3).random((B, F)) * 1.3, 0.05, 1.0).astype(np.float32)
        floor = np.array([[0.1], [0.3], [0.05]], np.float32)[:B]
    elif kind == "gate_lanes":
        v = np.clip(np.random.default_rng(seed + 3).random((B, F)) * 1.3, 0.05, 1.0).astype(np.float32)
        floor = _lane(B, F, 0.05, 0.3, seed + 4)
        a = _lane(B, F, _tc(0.001), _tc(0.05), seed + 2)
    elif kind == "zero_states":
        e0, y0 = np.zeros(B, np.float32), np.zeros(B, np.float32)
    return v, rho, a, e0, y0, floor


def _model(v, rho, a, e0, y0, floor=None, l=L, **kw):
    return dc.ballistics_model(_t(v), None if rho is None else _t(rho), _t(a), _t(e0), _t(y0),
                               None if floor is None else _t(floor), l=l, **kw)


KINDS = ["constants", "lanes", "gate", "gate_lanes", "zero_states"]


@pytest.mark.parametrize("kind", KINDS)
def test_host_model_equals_the_sequential_f64_recurrence(kind):
    v, rho, a, e0, y0, floor = _case(kind)
    y, e_last, y_last, (p_rho, p_a) = _model(v, rho, a, e0, y0, floor)
    want, want_e, want_y = sequential(v, rho, a, e0, y0, floor)
    assert y.dtype == torch.float32 and y.shape == v.shape
    assert (row_rel_rms(y, want) < 1e-7).all()
    np.testing.assert_allclose(e_last.numpy(), want_e, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y_last.numpy(), want_y, rtol=1e-6, atol=1e-7)
    # the look-back's products: prod rho and prod a over the frames, in f64
    np.testing.assert_allclose(p_rho.numpy(), np.prod(np.broadcast_to(rho.astype(np.float64), v.shape), axis=1),
                               rtol=1e-12)
    np.testing.assert_allclose(p_a.numpy(), np.prod(np.broadcast_to(a.astype(np.float64), v.shape), axis=1),
                               rtol=1e-12)


@pytest.mark.parametrize("F", [1, 63, 64, 700])
def test_onepole_model_equals_the_sequential_f64_recurrence(F):
    rng = np.random.default_rng(F)
    x = (rng.standard_normal((2, F)) ** 2).astype(np.float32)
    a = np.array([[_tc(0.03)], [_tc(0.001)]], np.float32)
    y0 = np.array([0.2, 1.5], np.float32)
    y, e_last, y_last, _ = _model(x, None, a, np.zeros(2, np.float32), y0, max_decay=False)
    want, _, want_y = sequential(x, None, a, None, y0, max_decay=False)
    assert e_last is None
    assert (row_rel_rms(y, want) < 1e-7).all()
    np.testing.assert_allclose(y_last.numpy(), want_y, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_scans():
    """The JAX package's scans on numpy inputs -> numpy (one compile each shape)."""
    def ballistics(v, rho, a, e0, y0, floor):
        e, e_last = jdyn.maxdecay_scan(jnp.asarray(v), jnp.asarray(rho), jnp.asarray(e0))
        h = e if floor is None else jnp.maximum(e, jnp.asarray(floor))
        y, y_last = jdyn.onepole_scan(h, jnp.asarray(a), jnp.asarray(y0))
        return np.asarray(y), np.asarray(e_last), np.asarray(y_last)
    return ballistics


@pytest.mark.parametrize("kind", KINDS)
def test_host_model_is_within_the_bar_of_the_jax_scans_and_the_plain_version(kind, jax_scans):
    v, rho, a, e0, y0, floor = _case(kind, F=2048, seed=5)
    fl = None if floor is None else _t(floor)
    y, e_last, y_last, _ = _model(v, rho, a, e0, y0, floor)
    jy, je, jyl = jax_scans(v, rho, a, e0, y0, floor)
    py, pe, pyl = dc.ballistics_reference(_t(v), _t(rho), _t(a), _t(e0), _t(y0), fl)
    exact, exact_e, exact_y = sequential(v, rho, a, e0, y0, floor)
    assert (row_rel_rms(y, exact) < BAR).all()
    for ref, ref_e, ref_y in ((jy, je, jyl), (py.numpy(), pe.numpy(), pyl.numpy())):
        # the f32 scans' own distance from the exact recurrence, row by row
        assert (row_rel_rms(y, ref) <= row_rel_rms(ref, exact) + BAR).all()
        assert_states(e_last, ref_e, exact_e)
        assert_states(y_last, ref_y, exact_y)


def test_states_hand_over_between_model_and_plain_scans():
    v, rho, a, e0, y0, _ = _case("lanes", F=3000, seed=7)
    whole, whole_e, whole_y = dc.ballistics_reference(_t(v), _t(rho), _t(a), _t(e0), _t(y0))
    y1, e, yl, _ = _model(v[:, :1000], rho[:, :1000], a[:, :1000], e0, y0)
    y2, e, yl = dc.ballistics_reference(_t(v[:, 1000:2100]), _t(rho[:, 1000:2100]), _t(a[:, 1000:2100]), e, yl)
    y3, e, yl, _ = _model(v[:, 2100:], rho[:, 2100:], a[:, 2100:], e.numpy(), yl.numpy(), l=64)
    assert (row_rel_rms(torch.cat([y1, y2, y3], dim=1), whole) < BAR).all()
    _, exact_e, exact_y = sequential(v, rho, a, e0, y0)
    assert_states(e, whole_e, exact_e)
    assert_states(yl, whole_y, exact_y)


@pytest.mark.parametrize("kind", ["constants", "gate_lanes"])
def test_f64_oracle_equals_the_sequential_recurrence(kind):
    v, rho, a, e0, y0, floor = _case(kind, F=1200, seed=9)
    y, e_last, y_last = dc.ballistics_f64(_t(v), _t(rho), _t(a), _t(e0), _t(y0),
                                          None if floor is None else _t(floor))
    want, want_e, want_y = sequential(v, rho, a, e0, y0, floor)
    assert y.dtype == torch.float64
    assert (row_rel_rms(y, want) < 1e-12).all()
    np.testing.assert_allclose(e_last.numpy(), want_e, rtol=1e-12)
    np.testing.assert_allclose(y_last.numpy(), want_y, rtol=1e-12)


def test_plain_scans_drift_from_the_oracle_where_the_model_does_not():
    """Over 2^15 frames at a 50 ms attack and 500 ms release the f32 Hillis
    scans round in a tree of products and sums; the model's f64 walk stays
    on the oracle. (On the card the kernel is held to the oracle.)"""
    F = 1 << 15
    v = _targets(1, F, 11)
    rho, a = np.float32(_tc(0.5)), np.float32(_tc(0.05))
    oracle = dc.ballistics_f64(_t(v), float(rho), float(a), 0.0, 0.0)[0]
    model = dc.ballistics_model(_t(v), float(rho), float(a), 0.0, 0.0, l=64)[0]
    plain = dc.ballistics_reference(_t(v), float(rho), float(a), 0.0, 0.0)[0]
    assert row_rel_rms(model, oracle)[0] < 1e-7
    assert row_rel_rms(plain, oracle)[0] > 10 * row_rel_rms(model, oracle)[0]


# ------------------------------------------------------------------ fused stages


def _signal(C, F, seed):
    """Noise swelling from quiet to loud: every curve's regions are crossed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, F)) * np.linspace(0.02, 1.5, F)).astype(np.float32)


def _stage(case, F=3000, C=2, seed=13):
    """-> (kind, x [C, F], params (torch), state (torch), process kwargs, the
    f64 reference's output, its bar) of one named case."""
    x = _signal(C, F, seed)
    zero = torch.zeros(())
    lanes = case.endswith("lanes")
    key = (_signal(C, F, seed + 1) * 0.7) if "key" in case and "silent" not in case else None
    kw, ref_key = {}, key
    if key is not None:
        kw["key"] = _t(key)
    if "silent" in case:
        kw["silent_key"] = True
        ref_key = np.zeros_like(x)
    if case.startswith("compressor"):
        det = "rms" if "rms" in case else "peak"
        thr = np.linspace(-6.0, -30.0, F).astype(np.float32) if lanes else np.float32(-20.0)
        rel = _lane(1, F, _tc(0.05), _tc(0.2), seed + 2)[0] if lanes else np.float32(_tc(0.1))
        p = {"threshold_db": _t(np.asarray(thr)), "ratio": torch.tensor(4.0), "knee_db": torch.tensor(6.0),
             "attack": torch.tensor(_tc(0.005)), "release": _t(np.asarray(rel)), "makeup_db": torch.tensor(1.0),
             "det_avg": torch.tensor(_tc(0.03))}
        ref = dyn.compressor_ref(x, threshold_db=thr, ratio=4.0, knee_db=6.0, attack=_tc(0.005), release=rel,
                                 makeup_db=1.0, detector=det, det_avg=_tc(0.03), key=ref_key)
        return "compressor", x, p, {"red": zero, "att": zero, "det": zero}, dict(kw, detector=det), ref, \
            2e-4 if lanes else 5e-5
    if case.startswith("limiter"):
        look = 240 if "lookahead" in case else 0
        ceil_ = np.linspace(-2.0, -8.0, F).astype(np.float32) if lanes else np.float32(-3.0)
        p = {"ceiling_db": _t(np.asarray(ceil_)), "attack": torch.tensor(_tc(0.001)),
             "release": torch.tensor(_tc(0.05))}
        state = {"red": zero, "att": zero, "look": torch.zeros(look), "xdelay": torch.zeros((C, look))}
        ref = dyn.limiter_ref(x, ceiling_db=ceil_, attack=_tc(0.001), release=_tc(0.05), lookahead=look)
        return "limiter", x, p, state, {"lookahead": look}, ref, 2e-4 if lanes else 5e-5
    hyst = 6.0 if "hysteresis" in case else 0.0
    rng_db = _lane(1, F, 20.0, 60.0, seed + 3)[0] if lanes else np.float32(40.0)
    p = {"threshold_db": torch.tensor(-12.0), "range_db": _t(np.asarray(rng_db)), "hyst_db": torch.tensor(hyst),
         "attack": torch.tensor(_tc(0.001)), "release": torch.tensor(_tc(0.1))}
    ref = dyn.gate_ref(x, threshold_db=-12.0, range_db=rng_db, attack=_tc(0.001), release=_tc(0.1),
                       hysteresis_db=hyst, key=ref_key)
    return "gate", x, p, {"open": zero, "att": zero}, kw, ref, 2e-4 if lanes else 5e-5


STAGES = ["compressor_peak", "compressor_rms", "compressor_lanes", "limiter", "gate"]


def _rr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(((y - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean()))


@pytest.mark.parametrize("stage", STAGES)
def test_processors_on_the_model_meet_the_f64_references(stage):
    kind, x, p, state, kw, ref, bar = _stage(stage)
    y, _ = dc.stage_model(kind, _t(x), p, state, l=L, **kw)
    assert _rr(y.numpy(), ref) < bar


FUSED = ["compressor_peak_key", "compressor_peak_silent_key", "compressor_rms_key", "compressor_rms_silent_key",
         "limiter_lookahead", "limiter_lookahead_lanes", "gate_hysteresis", "gate_key", "gate_silent_key",
         "gate_lanes"]


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", FUSED)
def test_fused_model_meets_the_f64_references(case, C):
    kind, x, p, state, kw, ref, bar = _stage(case, F=2500, C=C, seed=17 + C)
    y, _ = dc.stage_model(kind, _t(x), p, state, l=L, **kw)
    assert y.shape == x.shape and _rr(y.numpy(), ref) < bar
    # equal to the plain version within the kernel's bar and the plain scans' drift
    plain, _ = dc.stage_torch(kind, _t(x), p, state, **kw)
    oracle, _ = dc.stage_torch(kind, _t(x), p, state, dc.oracle_scans(), **kw)
    assert _rr(y, oracle) < BAR and _rr(y, plain) <= _rr(plain, oracle) + BAR


def _batch(case, B=3, C=2, F=2100, seed=29):
    """A stage on B rows with per-row parameters [B, 1] and states [B]."""
    kind, x, p, state, kw, _, _ = _stage(case, F=F, C=C, seed=seed)
    xs = np.stack([_signal(C, F, seed + 10 * b) for b in range(B)])
    scale = torch.linspace(0.8, 1.2, B)[:, None]
    # per-row parameters: dB values scaled, time coefficients raised to the
    # scale (their time constants divided by it)
    pb = {k: (v.expand(B, 1) if v.dim() == 0 else v.expand(B, -1)) for k, v in p.items()}
    pb = {k: v ** scale if k in ("attack", "release", "det_avg") else v * scale for k, v in pb.items()}
    sb = {k: (torch.rand(B, generator=torch.Generator().manual_seed(seed)) if v.dim() == 0
              else torch.zeros((B,) + tuple(v.shape))) for k, v in state.items()}
    if "key" in kw:
        kw["key"] = _t(np.stack([_signal(C, F, seed + 10 * b + 5) for b in range(B)]))
    return kind, _t(xs), pb, sb, kw


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX package's processors (jit) on numpy inputs -> numpy."""
    def run(kind, x, p, state, kw):
        pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        sj = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
        key = kw.get("key")
        if kw.get("silent_key"):
            key = torch.zeros_like(x)
        jkey = None if key is None else jnp.asarray(key.numpy())
        if kind == "compressor":
            y, _ = jdyn.compressor_process(jnp.asarray(x.numpy()), pj, sj, detector=kw["detector"], key=jkey)
        elif kind == "limiter":
            y, _ = jdyn.limiter_process(jnp.asarray(x.numpy()), pj, sj, lookahead=kw["lookahead"])
        else:
            y, _ = jdyn.gate_process(jnp.asarray(x.numpy()), pj, sj, key=jkey)
        return np.asarray(y)
    return run


@pytest.mark.parametrize("case", ["compressor_peak", "compressor_rms_key", "compressor_peak_silent_key",
                                  "limiter_lookahead", "gate_hysteresis"])
def test_fused_model_against_the_jax_processors(case, jax_stages):
    kind, x, p, state, kw = _batch(case)
    y, _ = dc.stage_model(kind, x, p, state, l=L, **kw)
    jy = jax_stages(kind, x, p, state, kw)
    oracle, _ = dc.stage_torch(kind, x, p, state, dc.oracle_scans(), **kw)
    B = x.shape[0]
    rows = (lambda t: np.asarray(t, np.float64).reshape(B, -1))
    assert (row_rel_rms(rows(y), rows(jy)) <= row_rel_rms(rows(jy), rows(oracle)) + BAR).all()


@pytest.mark.parametrize("case", ["compressor_rms_lanes", "limiter_lookahead", "gate_hysteresis"])
def test_fused_model_carries_states_over_two_chunks(case):
    kind, x, p, state, kw = _batch(case, F=2600)
    cut = 1100

    def part(t, a, b):
        return t[..., a:b] if torch.is_tensor(t) and t.dim() and t.shape[-1] == x.shape[-1] else t
    whole, _ = dc.stage_torch(kind, x, p, state, dc.oracle_scans(), **kw)
    ys, st = [], state
    for a, b in ((0, cut), (cut, x.shape[-1])):
        pk = {k: part(v, a, b) for k, v in p.items()}
        kk = {k: part(v, a, b) for k, v in kw.items()}
        y, st = dc.stage_model(kind, x[..., a:b], pk, st, l=L, **kk)
        ys.append(y)
    B = x.shape[0]
    got = torch.cat(ys, dim=-1).reshape(B, -1)
    assert (row_rel_rms(got, whole.reshape(B, -1)) < BAR).all()


@pytest.mark.parametrize("kind", ["constants", "lanes", "gate_lanes", "onepole"])
def test_model_is_the_same_at_every_look_back_depth(kind):
    """A look-back that stops at any earlier inclusive prefix, every tile at
    its own depth, gives the same numbers bit for bit: the kernel's results
    do not depend on timing."""
    v, rho, a, e0, y0, floor = _case("lanes" if kind == "onepole" else kind, F=5000, seed=19)
    kw = {"max_decay": False} if kind == "onepole" else {}
    if kind == "onepole":
        rho = floor = None
    want = _model(v, rho, a, e0, y0, floor, **kw)
    nk = -(-v.shape[1] // (32 * L))
    depths = list(range(1, nk + 1)) + [list(np.random.default_rng(3).integers(1, nk + 1, nk))]
    for depth in depths:
        got = _model(v, rho, a, e0, y0, floor, depth=depth, **kw)
        for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
            assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("kind", ["constants", "lanes"])
def test_model_products_are_the_shard_summaries(kind):
    """``model_scans``' products (what ``parallel/effects_sharded.py`` folds)
    equal ``_product`` over the frames, and a row shorter than a tile."""
    for F in (700, 4000):
        v, rho, a, e0, y0, _ = _case(kind, F=F, seed=23)
        ball, onep = dc.model_scans(L)
        *_, (p_rho, p_a) = ball(_t(v), _t(rho), _t(a), _t(e0), _t(y0), products=True)
        *_, p_one = onep(_t(v), _t(a), _t(y0), products=True)
        np.testing.assert_allclose(p_rho.numpy(), dc._product(_t(rho), _t(v)).numpy(), rtol=1e-12)
        np.testing.assert_allclose(p_a.numpy(), dc._product(_t(a), _t(v)).numpy(), rtol=1e-12)
        np.testing.assert_array_equal(p_one.numpy(), p_a.numpy())


@pytest.mark.parametrize("stage", ["compressor_peak", "compressor_rms", "gate"])
def test_silent_key_equals_an_explicit_zero_key(stage):
    """The generic finisher's sidechain stages with nothing routed: the
    silent-key flag gives the output of an explicit tensor of zeros, bit for
    bit, on the CPU."""
    kind, x, p, state, kw, _, _ = _stage(stage, F=1800)
    xt = _t(x)[None]
    params = {k: v.reshape(1) for k, v in p.items()}  # one value a row
    static = (kw.get("detector", "peak"), True) if kind == "compressor" else (True,)
    st = {k: v.reshape(1) for k, v in state.items()}
    silent, s_state = gen._apply_stage(kind, static, params, xt, st, 0, RATE)
    zeros, z_state = gen._apply_stage(kind, static, params, xt, st, 0, RATE, key=torch.zeros_like(xt))
    assert torch.equal(silent, zeros)
    for k in s_state:
        assert torch.equal(s_state[k], z_state[k])


def test_cpu_dispatch_is_the_plain_version_and_refuses_bad_arguments():
    v, rho, a, e0, y0, floor = _case("gate_lanes", F=900, seed=15)
    args = (_t(v), _t(rho), _t(a), _t(e0), _t(y0), _t(floor))
    before = (dc.dynamics_scan_launches, dc.dynamics_fused_launches)
    got = dc.ballistics(*args)
    want = dc.ballistics_reference(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the processors' scans on the CPU are the plain scans, bit for bit
    e, e_last = dyn.maxdecay_scan(args[0], args[1], args[3])
    y, y_last = dyn.onepole_scan(torch.maximum(e, args[5]), args[2], args[4])
    np.testing.assert_array_equal(got[0].numpy(), y.numpy())
    yo, ylo = dc.onepole(args[0], args[2], args[4])
    np.testing.assert_array_equal(yo.numpy(), dyn.onepole_scan(args[0], args[2], args[4])[0].numpy())
    # products: prod rho, prod a over the frames
    *_, (p_rho, p_a) = dc.ballistics(*args, products=True)
    np.testing.assert_allclose(p_a.numpy(), np.prod(a.astype(np.float64), axis=1), rtol=1e-12)
    # the fused processors on the CPU are their torch forms with the plain scans
    for case in ("compressor_rms_key", "limiter_lookahead", "gate_silent_key"):
        kind, x, p, state, kw, _, _ = _stage(case, F=1300)
        y1, s1 = {"compressor": dyn.compressor_process, "limiter": dyn.limiter_process,
                  "gate": dyn.gate_process}[kind](_t(x), p, state, **kw)
        y2, s2 = dc.stage_torch(kind, _t(x), p, state, **kw)
        assert torch.equal(y1, y2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert (dc.dynamics_scan_launches, dc.dynamics_fused_launches) == before  # the CPU launches nothing
    with pytest.raises(ValueError, match="device"):
        dc.ballistics(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="device"):
        dc.onepole(args[0].to("meta"), args[2].to("meta"), args[4].to("meta"))
    kind, x, p, state, kw, _, _ = _stage("compressor_peak_key", F=1300)
    with pytest.raises(ValueError, match="device"):
        dyn.compressor_process(_t(x).to("meta"), p, state)
    # what the card's path checks before it launches (the wrappers build the
    # call on any device; only calling it launches)
    with pytest.raises(ValueError, match="float32"):
        dc.prepare_scan(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="does not broadcast"):
        dc.prepare_scan(args[0], args[1], args[2][:, :7], *args[3:])
    with pytest.raises(ValueError, match="does not broadcast"):
        dc.prepare_scan(args[0], None, args[2], None, torch.zeros(5), max_decay=False)
    with pytest.raises(ValueError, match="float32"):
        dc.prepare_stage(kind, _t(x).double(), p, state, **kw)
    with pytest.raises(ValueError, match="silent key"):
        dc.prepare_stage(kind, _t(x), p, state, key=kw["key"], silent_key=True)
    with pytest.raises(ValueError, match="does not broadcast"):
        dc.prepare_stage(kind, _t(x), p, state, key=kw["key"][:1, :5])
    with pytest.raises(ValueError, match="shared memory"):
        dc.prepare_stage("limiter", _t(x), {"ceiling_db": -1.0, "attack": 0.9, "release": 0.99},
                         {"red": 0.0, "att": 0.0, "look": torch.zeros(20000), "xdelay": torch.zeros((2, 20000))},
                         lookahead=20000)
    call = dc.prepare_stage(kind, _t(x), p, state, **kw)
    assert call.fused and call.args.kind == dc.KINDS["compressor"] and call.args.key_mode == 1
    assert call.results[0].shape == x.shape


def test_kernel_constants_are_the_wrappers():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kLanes") == dc.LANES and const("kPad") == dc.PAD and const("kSmemBytes") == dc.SMEM_BYTES
    assert const("kParams") == len(dc.PARAM_SLOTS) and const("kStreams") == 4  # release, attack, floor, det
    kinds = re.findall(r"(k[A-Z]\w+) = (\d)", re.search(r"enum \{ (kOnePole = 0[^}]*)\}", src)[1])
    assert [int(v) for _, v in kinds] == list(dc.KINDS.values())
    assert [n.lower() for n, _ in kinds] == ["k" + k for k in dc.KINDS]
    slots = re.search(r"enum \{ (pRelease[^}]*)\}", src)[1]
    assert [s.strip()[1:].lower() for s in slots.split(",")] == \
        [n.replace("_db", "").replace("_", "") for n in dc.PARAM_SLOTS]
    # the C entry is the one cuda_build declares, with its two arguments
    entry = re.search(r'extern "C" int (wb_\w+)\(([^)]*)\)', src)
    build = (SRC.parent.parent / "ops" / "cuda_build.py").read_text()
    assert entry[1] == "wb_dynamics" and len(entry[2].split(",")) == 2
    assert "lib.wb_dynamics.argtypes = [vp, vp]" in build
    # the argument struct, field for field, is the ctypes Structure
    body = re.search(r"struct WbDynArgs \{(.*?)\n\};", src, re.S)[1]
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        m = re.match(r"(const float\*|float\*|double\*|int\*|long long|int|WbParam) (\w+)(\[\d+\])?$", decl)
        assert m, decl
        fields.append((m[2], m[1]))
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    assert [n for n, _ in fields] == [n for n, _ in dc.WbDynArgs._fields_]
    for (_, c), (_, t) in zip(fields, dc.WbDynArgs._fields_):
        want = ctype.get(c, ctypes.c_void_p if c.endswith("*") else dc.WbParam * len(dc.PARAM_SLOTS))
        assert t is want or (t._type_ is dc.WbParam and t._length_ == len(dc.PARAM_SLOTS))
    assert ctypes.sizeof(dc.WbParam) == 24 and dc.WbDynArgs.prm.size == 24 * len(dc.PARAM_SLOTS)
    # the shared memory of a compressor tile at l = 32 on stereo: values, x
    assert dc.warp_bytes("compressor", 2, 32) == 4 * (32 * 36 + 2 * 1024)
    assert all(l in (32, 64, 128) for l in dc.SUB_FRAMES) and dc.sub_frames(1, 1 << 18) == 32
    assert -(-(1 << 18) // (32 * dc.sub_frames(1, 1 << 18))) >= 64  # a one-row 2^18 call: 64 tiles or more
