"""The dynamics kernel's blocked recurrences, modelled on the host (CPU).

The CUDA kernel ``whitebox_tpu_torch/csrc/dynamics_scan.cu`` runs the
compressor's, limiter's and gate's release (max-decay) and attack
(one-pole), and the RMS detector's one-pole, in blocks of frames walked in
order with f64 states and two f64 carries between blocks.
``ops/dynamics_cuda.py::ballistics_blocked`` is that algorithm in torch.
Here, on seeded rows with per-row and per-frame coefficients, states
carried in and out and the gate's floor:

- the model equals the sequential f64 recurrence to 1e-7 relative RMS per
  row, and, inside the processors, the f64 references ``compressor_ref``,
  ``limiter_ref`` and ``gate_ref`` of ``ops/dynamics.py`` within the
  finisher's bars (5e-5; 2e-4 with per-frame lanes);
- it is within relative RMS 5e-6 per row of the JAX package's
  ``onepole_scan``/``maxdecay_scan`` and of the port's plain version (the
  f32 Hillis scans), plus those scans' own distance from the exact
  recurrence (up to ~1e-5 on a 2,048-frame gate row), and states hand over
  between the model and the plain scans;
- the f64 oracle ``ballistics_f64`` (the plain scans in f64) equals the
  sequential recurrence; the f32 Hillis scans drift from it over long rows
  at slow time constants, which is why the card holds the kernel to it;
- on the CPU ``ballistics``/``onepole`` are the plain versions, and they
  refuse malformed arguments. The kernel's constants match the wrapper's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whitebox_tpu.ops import dynamics as jdyn
from whitebox_tpu_torch.ops import dynamics as dyn
from whitebox_tpu_torch.ops import dynamics_cuda as dc

RATE = 48000.0
BAR = 5e-6  # the kernel (and its model) against the exact recurrence, per row
L = 64      # the model's block length here: many blocks on short rows


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


KINDS = ["constants", "lanes", "gate", "gate_lanes", "zero_states"]


@pytest.mark.parametrize("kind", KINDS)
def test_host_model_equals_the_sequential_f64_recurrence(kind):
    v, rho, a, e0, y0, floor = _case(kind)
    y, e_last, y_last, (p_rho, p_a) = dc.ballistics_blocked(
        _t(v), _t(rho), _t(a), _t(e0), _t(y0), None if floor is None else _t(floor), L)
    want, want_e, want_y = sequential(v, rho, a, e0, y0, floor)
    assert y.dtype == torch.float32 and y.shape == v.shape
    assert (row_rel_rms(y, want) < 1e-7).all()
    np.testing.assert_allclose(e_last.numpy(), want_e, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y_last.numpy(), want_y, rtol=1e-6, atol=1e-7)
    # the carries' products: prod rho and prod a over the frames, in f64
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
    y, e_last, y_last, _ = dc.ballistics_blocked(_t(x), None, _t(a), 0.0, _t(y0), None, L, max_decay=False)
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
    y, e_last, y_last, _ = dc.ballistics_blocked(_t(v), _t(rho), _t(a), _t(e0), _t(y0), fl, L)
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
    y1, e, yl, _ = dc.ballistics_blocked(_t(v[:, :1000]), _t(rho[:, :1000]), _t(a[:, :1000]), _t(e0), _t(y0), None, L)
    y2, e, yl = dc.ballistics_reference(_t(v[:, 1000:2100]), _t(rho[:, 1000:2100]), _t(a[:, 1000:2100]), e, yl)
    y3, e, yl, _ = dc.ballistics_blocked(_t(v[:, 2100:]), _t(rho[:, 2100:]), _t(a[:, 2100:]), e, yl, None, 128)
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
    model = dc.ballistics_blocked(_t(v), float(rho), float(a), 0.0, 0.0, None, 1024)[0]
    plain = dc.ballistics_reference(_t(v), float(rho), float(a), 0.0, 0.0)[0]
    assert row_rel_rms(model, oracle)[0] < 1e-7
    assert row_rel_rms(plain, oracle)[0] > 10 * row_rel_rms(model, oracle)[0]


def _processor_with_model(monkeypatch):
    """``ops/dynamics.py``'s processors with the kernel's host model in place
    of the CPU's plain scans."""
    def ballistics(v, rho, a, e0, y0, floor=None, products=False):
        F = v.shape[-1]
        B = v.numel() // F
        rows = (lambda c: None if c is None else dc._coef(c, v, "c")[0])
        y, e, yl, _ = dc.ballistics_blocked(v.reshape(B, F), rows(rho), rows(a), dc._state(e0, v, "e0"),
                                            dc._state(y0, v, "y0"), rows(floor), L)
        return y.reshape(v.shape), e.reshape(v.shape[:-1]), yl.reshape(v.shape[:-1])

    def onepole(x, a, y0, products=False):
        F = x.shape[-1]
        B = x.numel() // F
        y, _, yl, _ = dc.ballistics_blocked(x.reshape(B, F), None, dc._coef(a, x, "a")[0], 0.0,
                                            dc._state(y0, x, "y0"), None, L, max_decay=False)
        return y.reshape(x.shape), yl.reshape(x.shape[:-1])
    monkeypatch.setattr(dc, "ballistics", ballistics)
    monkeypatch.setattr(dc, "onepole", onepole)


@pytest.mark.parametrize("stage", ["compressor_peak", "compressor_rms", "compressor_lanes", "limiter", "gate"])
def test_processors_on_the_model_meet_the_f64_references(stage, monkeypatch):
    _processor_with_model(monkeypatch)
    rng = np.random.default_rng(13)
    F = 3000
    x = (rng.standard_normal((2, F)) * np.linspace(0.05, 1.5, F)).astype(np.float32)
    zero = torch.zeros(())
    bar = 5e-5
    if stage.startswith("compressor"):
        thr = -20.0 if stage != "compressor_lanes" else np.linspace(-6.0, -30.0, F).astype(np.float32)
        det = "rms" if stage == "compressor_rms" else "peak"
        p = {"threshold_db": _t(np.asarray(thr, np.float32)), "ratio": torch.tensor(4.0),
             "knee_db": torch.tensor(6.0), "attack": torch.tensor(_tc(0.005)), "release": torch.tensor(_tc(0.1)),
             "makeup_db": torch.tensor(1.0), "det_avg": torch.tensor(_tc(0.03))}
        y, _ = dyn.compressor_process(_t(x), p, {"red": zero, "att": zero, "det": zero}, detector=det)
        ref = dyn.compressor_ref(x, threshold_db=thr, ratio=4.0, knee_db=6.0, attack=_tc(0.005),
                                 release=_tc(0.1), makeup_db=1.0, detector=det, det_avg=_tc(0.03))
        if stage == "compressor_lanes":
            bar = 2e-4
    elif stage == "limiter":
        p = {"ceiling_db": torch.tensor(-3.0), "attack": torch.tensor(_tc(0.001)),
             "release": torch.tensor(_tc(0.05))}
        state = {"red": zero, "att": zero, "look": torch.zeros(0), "xdelay": torch.zeros((2, 0))}
        y, _ = dyn.limiter_process(_t(x), p, state)
        ref = dyn.limiter_ref(x, ceiling_db=-3.0, attack=_tc(0.001), release=_tc(0.05))
    else:
        p = {"threshold_db": torch.tensor(-12.0), "range_db": torch.tensor(40.0), "hyst_db": torch.tensor(0.0),
             "attack": torch.tensor(_tc(0.001)), "release": torch.tensor(_tc(0.1))}
        y, _ = dyn.gate_process(_t(x), p, {"open": zero, "att": zero})
        ref = dyn.gate_ref(x, threshold_db=-12.0, range_db=40.0, attack=_tc(0.001), release=_tc(0.1))
    rr = float(np.sqrt(((y.numpy() - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean()))
    assert rr < bar


def test_cpu_dispatch_is_the_plain_version_and_refuses_bad_arguments():
    v, rho, a, e0, y0, floor = _case("gate_lanes", F=900, seed=15)
    args = (_t(v), _t(rho), _t(a), _t(e0), _t(y0), _t(floor))
    before = dc.dynamics_scan_launches
    got = dc.ballistics(*args)
    want = dc.ballistics_reference(*args)
    assert dc.dynamics_scan_launches == before  # the CPU takes the plain version
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
    with pytest.raises(ValueError, match="device"):
        dc.ballistics(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="device"):
        dc.onepole(args[0].to("meta"), args[2].to("meta"), args[4].to("meta"))
    # what the card's path checks before it launches
    with pytest.raises(ValueError, match="float32"):
        dc._launch(1, args[0].double(), *args[1:], False)
    with pytest.raises(ValueError, match="does not broadcast"):
        dc._launch(1, args[0], args[1], args[2][:, :7], *args[3:], False)
    with pytest.raises(ValueError, match="does not broadcast"):
        dc._launch(0, args[0], None, args[2], None, torch.zeros(5), None, False)


def test_kernel_constants_are_the_wrappers():
    src = (Path(dc.__file__).parent.parent / "csrc" / "dynamics_scan.cu").read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", src)[1])
    assert dc.BLOCK_FRAMES % tile == 0 and dc.BLOCK_FRAMES >= tile
    assert int(re.search(r"constexpr int kStreams = (\d+);", src)[1]) == 4  # v, rho, a, floor
    # the entry point's argument list is the one cuda_build declares
    entry = re.search(r'extern "C" int wb_dynamics_scan\(([^)]*)\)', src)[1]
    assert len([a for a in entry.split(",") if a.strip()]) == 6 + 9 + 8
