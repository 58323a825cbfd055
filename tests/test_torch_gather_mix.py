"""whitebox_tpu_torch's chunked gather mix (``ops/mix.py``) and the bounce's
gather path (CPU).

The same sessions, carved the same way, go through the JAX package's
``ops/mix.py`` (jitted XLA on the CPU) and the port's torch ops:

- the packed tables are equal array for array;
- at speed 1 the chunk is bit-equal to the JAX package's and to the port's
  NumPy oracle;
- resampled rows (the ``slow_emit="blocks"`` carve) stay within 2 ulp or
  2.4e-7 in linear and 3e-6 in Catmull-Rom, polynomial taps and the direct
  sinc bank, the tolerances ROADMAP.md gives for XLA:CPU's fused chains;
- ``strict_order=False`` within 1e-6 of the ordered sum;
- ``bounce(engine="xla")`` and the two ``engine="auto"`` fallbacks
  against the JAX package's bounce of the same session.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rel_rms
from tests.test_carve import random_session
from tests.test_torch_mix import assert_ulp_contract
from tests.test_torch_mix_plan import make_case
from whitebox_tpu.ops import mix as jmix
from whitebox_tpu.ops.resample import design_sinc_bank as jax_sinc_bank
from whitebox_tpu.render.bounce import bounce as jax_bounce
from whitebox_tpu.timeline.carve import carve_session as jax_carve
from whitebox_tpu.timeline.oversample import resolve_interpolation as jax_resolve
from whitebox_tpu_torch.ops import mix
from whitebox_tpu_torch.ops.resample import design_sinc_bank
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oracle import OracleRenderer
from whitebox_tpu_torch.timeline.oversample import resolve_interpolation

RATE = 48000.0
INTERP_ATOL = 3e-6


def _both(js, rate=RATE, interpolation="linear"):
    """(JAX tables + pool, port tables + pool, port session) of a blocks carve."""
    s = from_reference(js)
    jt, jp = jax_carve(js, rate, buffer_size=512, slow_emit="blocks")
    pt, pp = carve_session(s, rate, buffer_size=512, slow_emit="blocks")
    jinterp = pinterp = "linear"
    if interpolation != "linear":
        jt, jp, jinterp = jax_resolve(jt, jp, interpolation)
        pt, pp, pinterp = resolve_interpolation(pt, pp, interpolation)
    jd = jmix.pack_device_tables(jt, jp, js)
    pd = mix.pack_device_tables(pt, pp, s)
    return (jd, jp, jinterp), (pd, pp, pinterp), s


def _chunks(fn, F, chunk):
    return np.concatenate([fn(start)[:, :min(chunk, F - start)] for start in range(0, F, chunk)], axis=1)


@pytest.mark.parametrize("name", ["speed1", "mixed_speeds", "loop_reverse"])
def test_pack_device_tables_equals_jax(name):
    js, rate = (random_session(3, rate=48000, bpm=120.0, n_tracks=3), RATE) if name == "speed1" \
        else make_case(name)[:2]
    (jd, _, _), (pd, _, _), _ = _both(js, rate)
    for f in ("dst_start", "length", "src_base", "frac_hi", "frac_lo", "speed_hi", "speed_lo", "gain",
              "fast", "clamp", "fin_start", "fin_inv", "fout_end", "fout_inv", "track_gain"):
        a, b = getattr(pd, f), getattr(jd, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (pd.total_frames, pd.num_tracks, pd.channels) == (jd.total_frames, jd.num_tracks, jd.channels)
    t = pd.as_torch()
    assert t["src_base"].dtype == torch.int64 and t["dst_start"].dtype == torch.int32


def test_render_chunk_speed1_bit_equal_to_jax_and_oracle():
    js = random_session(1, rate=48000, bpm=120.0, n_tracks=4)
    (jd, jp, _), (pd, pp, _), s = _both(js)
    F, chunk = pd.total_frames, 1 << 14
    jt, jpool = jd.as_jax(), jnp.asarray(jp.data)
    tt, tpool = pd.as_torch(), torch.from_numpy(pp.data)
    got = _chunks(lambda a: mix.render_chunk(tpool, tt, a, chunk).numpy(), F, chunk)
    want = _chunks(lambda a: np.asarray(jmix.render_chunk(jpool, jt, jnp.int32(a), frames=chunk)), F, chunk)
    np.testing.assert_array_equal(got, want)
    oracle = OracleRenderer(s, RATE, buffer_size=512).render()
    np.testing.assert_array_equal(got[:, :oracle.shape[1]], oracle)
    np.testing.assert_array_equal(mix.render_timeline(*carve_session(s, RATE, buffer_size=512), s,
                                                      chunk_frames=5000, device="cpu"), got)


def test_render_timeline_defaults_to_the_card(monkeypatch):
    """``device=None`` means the CUDA card: without one it raises the
    ``resolve_device`` error rather than rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = from_reference(random_session(2, rate=48000, bpm=120.0, n_tracks=1, n_clips=1))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mix.render_timeline(*carve_session(s, RATE, buffer_size=512), s)


@pytest.mark.parametrize("mode", ["linear", "catmull", pytest.param("sinc", marks=pytest.mark.slow),
                                  pytest.param("sinc_bank", marks=pytest.mark.slow)])
def test_render_chunk_resampled_meets_contract(mode):
    """Resampled rows against the JAX package's chunk: linear within 2 ulp
    or 2.4e-7; Catmull-Rom, the polynomial taps over the oversampled pool
    ("sinc") and the direct sinc bank within 3e-6; per track as well."""
    js, rate, _ = make_case("mixed_speeds")
    (jd, jp, jinterp), (pd, pp, pinterp), _ = _both(js, rate, "linear" if mode == "sinc_bank" else mode)
    assert not pd.fast.all()
    F, chunk = min(pd.total_frames, 3 << 13), 1 << 13  # three chunks hold every kind of row
    jbank = pbank = None
    if mode == "sinc_bank":
        ratio = float(np.abs(pd.speed_hi[~pd.fast]).max())
        np.testing.assert_array_equal(design_sinc_bank(ratio), jax_sinc_bank(ratio))
        jbank, pbank = jnp.asarray(jax_sinc_bank(ratio)), torch.from_numpy(design_sinc_bank(ratio))
    jt, jpool = jd.as_jax(), jnp.asarray(jp.data)
    tt, tpool = pd.as_torch(), torch.from_numpy(pp.data)
    got = _chunks(lambda a: mix.render_chunk(tpool, tt, a, chunk, sinc_bank=pbank, interp=pinterp).numpy(),
                  F, chunk)
    want = _chunks(lambda a: np.asarray(jmix.render_chunk(jpool, jt, jnp.int32(a), frames=chunk,
                                                          sinc_bank=jbank, interp=jinterp)), F, chunk)
    if mode == "linear":
        assert_ulp_contract(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=INTERP_ATOL, rtol=0)
    ppt = mix.render_chunk_per_track(tpool, tt, 0, chunk, sinc_bank=pbank, interp=pinterp).numpy()
    jpt = np.asarray(jmix.render_chunk_per_track(jpool, jt, jnp.int32(0), frames=chunk, sinc_bank=jbank,
                                                 interp=jinterp))
    np.testing.assert_allclose(ppt, jpt, atol=INTERP_ATOL if mode != "linear" else 2.4e-7, rtol=0)


def test_fast_sum_within_1e6_of_ordered_sum():
    js = random_session(2, rate=48000, bpm=120.0, n_tracks=6)
    _, (pd, pp, _), _ = _both(js)
    tt, tpool = pd.as_torch(), torch.from_numpy(pp.data)
    a = mix.render_chunk(tpool, tt, 0, 1 << 15).numpy()
    b = mix.render_chunk(tpool, tt, 0, 1 << 15, strict_order=False).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    assert float(np.abs(a).max()) > 0.01


@pytest.mark.parametrize("interpolation", ["linear", pytest.param("sinc", marks=pytest.mark.slow)])
def test_bounce_xla_matches_jax_with_ragged_chunks(interpolation):
    """engine="xla" with a chunk length that does not divide the timeline:
    speed 1 bit-equal to the JAX bounce, the direct sinc within 3e-6."""
    js, rate, _ = make_case("mixed_speeds") if interpolation == "sinc" else (
        random_session(5, rate=48000, bpm=120.0, n_tracks=3), RATE, None)
    got = bounce(from_reference(js), rate, device="cpu", engine="xla", chunk_frames=10007,
                 interpolation=interpolation)
    want = jax_bounce(js, rate, engine="xla", chunk_frames=10007, interpolation=interpolation).audio
    assert got.stats.mix_path == "gather" and got.audio.shape == want.shape
    assert got.audio.shape[1] % 10007 != 0
    if interpolation == "linear":
        np.testing.assert_array_equal(got.audio, want)
    else:
        np.testing.assert_allclose(got.audio, want, atol=INTERP_ATOL, rtol=0)
    terms = got.stats.cost.terms
    assert set(terms) == {"mix.pool_read", "mix.out_write"}


def test_bounce_auto_dense_session_takes_gather_path():
    """The dense session of tests/test_torch_bounce.py (12 runs in one
    1024-frame tile overflow the 8 slots): auto takes the gather path in
    both packages, within the resampling contract of each other."""
    from tests.test_torch_mix_plan import dense_session

    js = dense_session()
    for i, c in enumerate(js.tracks[0].clips):
        c.min_time, c.max_time = i * 0.003, i * 0.003 + 0.0025
    got = bounce(from_reference(js), RATE, device="cpu")
    want = jax_bounce(js, RATE).audio
    assert got.stats.mix_path == "gather"
    assert_ulp_contract(got.audio, want)


@pytest.mark.slow
def test_gather_path_with_meters_and_lanes_matches_jax(monkeypatch):
    """The per-track guard forced low: volume/pan lanes, EQ chains and
    meters through the gather path and the streaming scan finisher, against
    the JAX package's gather path (relative RMS 1e-5, meters rtol 1e-5)."""
    from tests.test_torch_effects import _add_chains
    from whitebox_tpu.ops.automation import AutomationLane, TrackAutomation
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    js = _add_chains(random_session(8, rate=48000, bpm=480.0, n_tracks=3, n_clips=1))
    js.tracks[2].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(1.0, 0.2),
                                              pan=AutomationLane().add(0.0, -0.5).add(2.0, 0.7))
    monkeypatch.setattr(bounce_mod, "PER_TRACK_LIMIT_BYTES", 1 << 10)
    got = bounce(from_reference(js), RATE, device="cpu", meters=True, chunk_frames=1 << 12)
    want = jax_bounce(js, RATE, engine="xla", meters=True, chunk_frames=1 << 12)
    assert got.stats.mix_path == "gather"
    assert rel_rms(got.audio, want.audio) < 1e-5
    for f in ("track_peak", "track_rms", "output_peak", "output_rms"):
        np.testing.assert_allclose(getattr(got.stats, f), getattr(want.stats, f), rtol=1e-5, atol=1e-7,
                                   err_msg=f)


@pytest.mark.parametrize("flags", [["--engine", "xla"], ["--engine", "xla", "--chunk-frames", "10007"],
                                   ["--engine", "xla", "--fast-sum"]],
                         ids=["engine", "chunk_frames", "fast_sum"])
def test_cli_gather_flags_match_jax_cli(tmp_path, capsys, flags):
    """cli render --engine/--chunk-frames/--fast-sum against the JAX CLI
    on the same .wb: speed 1 bit-equal in order, the relaxed sum within 1e-6."""
    from tests.test_torch_bounce import _jax_and_port_cli

    js = random_session(23, rate=48000, bpm=120.0, n_tracks=3, n_clips=2)
    want, got, _, _ = _jax_and_port_cli(tmp_path, capsys, js, flags)
    assert got.shape == want.shape and float(np.abs(want).max()) > 0.01
    if "--fast-sum" in flags:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_per_track_limit_off_the_card_is_the_jax_figure():
    """Off the card the per-track limit is the JAX package's 6 GiB
    (``whitebox_tpu/render/bounce.py:314``), so both packages choose the
    same mix on the CPU; on the card it follows the card's free memory
    (``tests/test_torch_cuda.py``)."""
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    assert bounce_mod.per_track_limit_bytes(torch.device("cpu")) == 6 << 30
