"""The CUDA mix kernel on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which such a
machine need not have; nothing here imports JAX or the JAX package.) The
checks are ``chip_smoke.py``'s: the kernel bit-equal to its plain PyTorch
version on the card, and to the NumPy references under the repo's
contract; the automation variant within atol 3e-6 / rtol 1e-5 of its
plain version and within relative RMS 1e-5 of the f64 host reference; the
per-track kernel (K4) against its plain version and the NumPy per-track
reference, and an EQ bounce in both effects modes against the f64 host
reference (relative RMS 5e-5 scan, 2e-4 fir) and the CPU bounce; the
Catmull-Rom and polynomial-tap modes of all three variants against their
plain versions (the resampling contract; 0 ulp expected) and the NumPy
references (atol 3e-6); the sinc prerender's extension against the host's
(1e-6) and the sinc bounce against the CPU bounce (3e-6), one mix launch;
the summing kernel's staged walk in its other shapes (one and three
channels, a tile that ends inside a block, a kept list that two staging
passes fill) 0 ulp from the plain version; the per-track kernel (K4) in
every interpolation mode for one, two and three channels, with a ragged
tile and with (block, track) cells it fills with zeros; the biquad cascade
kernel within relative RMS 5e-6 per row of its plain version (EQ bands,
the 25 Hz highpass, FIR and identity rows, states over two calls, two
section groups), a finisher stream that alternates kernel and plain
states, and the scan and metered bounces through it (no Hillis scan); the
routed finisher on the card against the CPU and the f64 reference, the
synth bit-equal to its NumPy spec, and a routed and a MIDI bounce with
one K4 launch each; the export deliverables on the card against the CPU:
stems (one K4 launch, the cascade kernel) and bus stems within relative
RMS 1e-5, the loudness readings within 0.02 LU / 0.05 dB, the vocoder
within 1e-5 and bit-equal across two runs, the peak pyramid bit-identical
to the C++ scalar walk; the render cache (one K1 / K3 launch per render,
bit-equal to ``bounce``, the pool kept across a gain edit), the preview
(no mix-kernel launch, the cascade kernel, within 1e-5 of the bounce and
the CPU's preview) and the streamed bounce (bit-equal to the card's
gather bounce; with EQ chains within 1e-5); the sharded render on a world
of one over NCCL (bit-equal plain, chains within atol 3e-6 / rtol 1e-4,
the cascade kernel launched) and on two ranks sharing the card over gloo;
the eleven feature checks of ``whitebox_tpu_torch/tools/verify.py``; the
gather kernel (``csrc/gather_mix.cu``) bit-equal to its plain version in
every form and interpolation mode, the bounce through ``engine="xla"``
launching it once a chunk and no slot-plan kernel, a failed build raising;
the staged readback (``ops/readback.py``) giving the bytes of
``.cpu().numpy()`` in stems and bounce, kept exports independent, one ring
allocation, and the size threshold; the resident pool
(``ops/mix_cuda.py::resident_pool``): after an edit that keeps the asset
set, ``bounce`` and ``render_stems`` take the same tensor, bit-equal to a
fresh upload's output, and a miss never leaves two pools on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from whitebox_tpu_torch.ops import biquad_cuda, mix_cuda, mix_plan
from whitebox_tpu_torch.ops.resample import design_poly_interp
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.demo import make_demo_session
from whitebox_tpu_torch.render.effects_pipeline import prepare_automation_tables_host
from whitebox_tpu_torch.timeline.carve import carve_session
from whitebox_tpu_torch.timeline.oracle import OracleRenderer

pytestmark = pytest.mark.cuda

SESSIONS = {
    "speed1_int_formats_fades": lambda: chip_smoke.int_formats_session(n_tracks=4),
    "mixed_speeds_fades": lambda: make_demo_session(
        n_tracks=4, duration_seconds=4.0, seed=3, fades=True, clip_speeds=(1.0, 0.5, 44100 / 48000, 1.37)),
    "reverse_bidirectional": chip_smoke.reverse_session,
}

AUTO_SESSIONS = {
    "linear_lanes": chip_smoke.auto_session,
    "nine_curves": lambda: chip_smoke.auto_session(seed=4, curves=True),
    "fades": lambda: chip_smoke.auto_session(seed=5, fades=True),
    "muted_automated_track": lambda: chip_smoke.auto_session(seed=6, mute_first=True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("tile", [None, 1024])
@pytest.mark.parametrize("name", list(SESSIONS))
def test_kernel_matches_plain_and_reference(card, name, tile):
    chip_smoke.kernel_vs_plain(name, SESSIONS[name](), tile=tile)


@pytest.mark.parametrize("tile", [None, 1024])
@pytest.mark.parametrize("name", list(SESSIONS))
def test_per_track_kernel_matches_plain_and_reference(card, name, tile):
    chip_smoke.per_track_vs_plain(name, SESSIONS[name](), tile=tile)


@pytest.mark.parametrize("tile", [None, 1024])
@pytest.mark.parametrize("name", list(AUTO_SESSIONS))
def test_automation_kernel_matches_plain_and_reference(card, name, tile):
    chip_smoke.auto_vs_plain(name, AUTO_SESSIONS[name](), tile=tile)


@pytest.mark.parametrize("mode", ["catmull", "poly"])
@pytest.mark.parametrize("name", ["mixed_speeds_fades", "reverse_bidirectional"])
def test_interp_kernels_match_plain_and_reference(card, name, mode):
    chip_smoke.kernel_vs_plain(name, SESSIONS[name](), mode=mode)
    chip_smoke.per_track_vs_plain(name, SESSIONS[name](), tile=1024, mode=mode)


@pytest.mark.parametrize("mode", ["catmull", "poly"])
def test_interp_automation_kernel_matches_plain_and_reference(card, mode):
    chip_smoke.auto_vs_plain("fades", AUTO_SESSIONS["fades"](), mode=mode)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("mode", ["linear", "catmull", "poly"])
def test_kernel_for_one_and_three_channels(card, mode, channels):
    # 0 ulp from the plain version: a pair of channels and a single one per launch
    assert chip_smoke.kernel_vs_plain("mixed_speeds_fades", SESSIONS["mixed_speeds_fades"](),
                                      mode=mode, channels=channels) == 0.0


@pytest.mark.parametrize("channels", [1, 3])
def test_automation_and_per_track_kernels_for_one_and_three_channels(card, channels):
    chip_smoke.auto_vs_plain("nine_curves", AUTO_SESSIONS["nine_curves"](), channels=channels)
    chip_smoke.per_track_vs_plain("reverse_bidirectional", SESSIONS["reverse_bidirectional"](),
                                  channels=channels)


@pytest.mark.parametrize("mode", ["linear", "catmull", "poly"])
def test_kernel_with_a_tile_that_ends_inside_a_block(card, mode):
    assert chip_smoke.kernel_vs_plain("mixed_speeds_fades", SESSIONS["mixed_speeds_fades"](),
                                      tile=1152, mode=mode) == 0.0
    chip_smoke.auto_vs_plain("fades", AUTO_SESSIONS["fades"](), tile=1152, mode=mode)


def test_general_polynomial_path_matches_plain(card):
    # a 4 x 4 table: not the 6 x 6 shape the kernels unroll
    chip_smoke.variants_vs_plain("fades", AUTO_SESSIONS["fades"](),
                                 coeffs=design_poly_interp(4, taps=4, degree=3))


def test_kept_list_that_spans_two_staging_passes(card):
    plan = chip_smoke.variants_vs_plain("many_tracks", chip_smoke.many_tracks_session())
    assert chip_smoke.staging_passes(plan) > 1


@pytest.mark.parametrize("name", ["mixed_speeds_fades", "reverse_bidirectional"])
def test_sinc_prerender_on_the_card(card, name):
    chip_smoke.sinc_small(name, SESSIONS[name]())


def test_sinc_sine_snr_on_the_card(card):
    chip_smoke.sinc_sine_snr()


@pytest.mark.parametrize("kw,mode", [({"interpolation": "catmull"}, "catmull"),
                                     ({"interpolation": "sinc"}, "linear"),
                                     ({"interpolation": "sinc", "prerender": False}, "poly")])
def test_interp_bounce_counts_one_launch_and_matches_cpu(card, kw, mode):
    s = SESSIONS["mixed_speeds_fades"]()
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card, **kw)
    assert mix_cuda.mix_kernel_launches == 1
    assert mix_cuda.interp_launches == {**dict.fromkeys(mix_cuda.interp_launches, 0), mode: 1}
    assert (got.stats.prerender_seconds > 0) == (kw == {"interpolation": "sinc"})
    cpu = bounce(s, 48000.0, device="cpu", **kw).audio
    assert np.abs(got.audio - cpu).max() < chip_smoke.INTERP_ATOL


def test_poly_kernel_refuses_a_table_it_cannot_hold(card):
    s = SESSIONS["mixed_speeds_fades"]()
    r, _, _, _ = chip_smoke.make_renderer(s, "poly")
    p = r.plan
    before = dict(mix_cuda.interp_launches)
    wide = ("poly", tuple((0.1,) * 9 for _ in range(4)))
    with pytest.raises(ValueError, match="interp"):
        mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, interp=wide)
    assert mix_cuda.interp_launches == before
    # two coefficient tables are two different launches of one configuration
    a = mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, interp=r.interp)
    half = ("poly", tuple(tuple(v * 0.5 for v in row) for row in r.interp[1]))
    b = mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels, interp=half)
    assert torch.equal(a, mix_cuda.mix_cuda(r.pool_device, r.tables, p.n_tiles, p.tile, p.channels,
                                            interp=r.interp))
    assert float((a - b).abs().max()) > 1e-3


def test_automation_kernel_with_more_tracks_than_default_shared_memory_holds(card):
    # 600 tracks x 32 B of per-track rows: more dynamic shared memory than
    # fits beside the kernel's static buffers without asking for it
    from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation

    s = make_demo_session(n_tracks=600, duration_seconds=1.0, seed=21, sample_seconds=0.5)
    s.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(2.0, 0.2))
    s.tracks[599].automation = TrackAutomation(pan=AutomationLane().add(0.0, -1.0).add(2.0, 1.0))
    chip_smoke.auto_vs_plain("600_tracks", s)


def test_automated_bounce_counts_one_automation_launch(card):
    s = chip_smoke.auto_session(seed=7, curves=True)
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card).audio
    assert (mix_cuda.mix_auto_launches, mix_cuda.mix_kernel_launches) == (1, 0)
    assert chip_smoke.rel_rms(got, chip_smoke.host_reference(s)) < chip_smoke.AUTO_REL_RMS


def test_automation_kernel_rejects_malformed_lanes(card):
    s = chip_smoke.auto_session(seed=8)
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="runs")
    r = mix_cuda.CudaMixRenderer(table, pool, s, device=card,
                                 auto_tables=prepare_automation_tables_host(s, 48000.0))
    p = r.plan
    before = mix_cuda.mix_auto_launches
    for bad in (dict(r.auto, vys=r.auto["vys"].cpu()), dict(r.auto, use=r.auto["use"][:-1].contiguous()),
                dict(r.auto, pcv=r.auto["pcv"].to(torch.float32))):
        with pytest.raises(ValueError):
            mix_cuda.mix_auto_cuda(r.pool_device, r.tables, bad, p.n_tiles, p.tile, p.channels)
    assert mix_cuda.mix_auto_launches == before


def test_bounce_counts_one_launch_and_matches_oracle(card):
    s = make_demo_session(n_tracks=4, duration_seconds=4.0, seed=5)
    before = mix_cuda.mix_kernel_launches
    got = bounce(s, 48000.0, device=card).audio
    assert mix_cuda.mix_kernel_launches == before + 1
    ref = OracleRenderer(s, 48000.0, buffer_size=512).render()
    n = min(ref.shape[1], got.shape[1])
    np.testing.assert_array_equal(got[:, :n], ref[:, :n])


def _eq_session():
    from whitebox_tpu_torch.effects import Biquad, EffectChain, Gain, ParametricEQ

    s = make_demo_session(n_tracks=4, duration_seconds=4.0, seed=9, clip_speeds=(1.0, 44100 / 48000))
    s.tracks[0].effects = EffectChain([Biquad("lowpass", 2000.0), Gain(-3.0)])
    s.tracks[1].effects = EffectChain([ParametricEQ([("lowshelf", 120.0, 0.707, 4.0),
                                                     ("peak", 1500.0, 1.2, -3.0)])])
    s.master_effects = EffectChain([Biquad("highpass", 30.0)])
    return s


@pytest.mark.parametrize("mode", ["scan", "fir"])
def test_eq_bounce_counts_one_per_track_launch(card, mode):
    s = _eq_session()
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card, effects_mode=mode).audio
    assert (mix_cuda.mix_per_track_launches, mix_cuda.mix_kernel_launches,
            mix_cuda.mix_auto_launches) == (1, 0, 0)
    bar = chip_smoke.SCAN_REL_RMS if mode == "scan" else chip_smoke.FIR_REL_RMS
    assert chip_smoke.rel_rms(got, chip_smoke.host_reference(s)) < bar
    # the same session on the CPU: the plain per-track mix and finisher
    cpu = bounce(s, 48000.0, device="cpu", effects_mode=mode).audio
    assert chip_smoke.rel_rms(got, cpu) < 1e-5


def test_kernel_rejects_malformed_tables(card):
    s = make_demo_session(n_tracks=2, duration_seconds=2.0, seed=6)
    table, pool = carve_session(s, 48000.0, buffer_size=512)
    r = mix_cuda.CudaMixRenderer(table, pool, s, device=card)
    p = r.plan
    before = mix_cuda.mix_kernel_launches
    with pytest.raises(ValueError):
        mix_cuda.mix_cuda(r.pool_device, dict(r.tables, ms=r.tables["ms"].cpu()), p.n_tiles, p.tile, p.channels)
    with pytest.raises(ValueError):
        mix_cuda.mix_cuda(r.pool_device.cpu(), r.tables, p.n_tiles, p.tile, p.channels)
    assert mix_cuda.mix_kernel_launches == before


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("mode", ["linear", "catmull", "poly"])
def test_per_track_kernel_in_every_mode_and_channel_count(card, mode, channels):
    chip_smoke.per_track_vs_plain("mixed_speeds_fades", SESSIONS["mixed_speeds_fades"](), mode=mode,
                                  channels=channels)


@pytest.mark.parametrize("mode", ["linear", "catmull", "poly"])
def test_per_track_kernel_with_a_ragged_tile(card, mode):
    chip_smoke.per_track_vs_plain("mixed_speeds_fades_tile1152", SESSIONS["mixed_speeds_fades"](),
                                  tile=1152, mode=mode)


def test_per_track_kernel_zero_fills_cells_without_slots(card):
    s = chip_smoke.int_formats_session(n_tracks=4)
    r, _, _, _ = chip_smoke.make_renderer(s)
    p = r.plan
    empty = ~mix_plan.per_track_block_slots(p).any(axis=3)  # [n_tiles, n_blocks, T]
    assert empty.any() and not empty.all()
    got = r.render_device_per_track().cpu().reshape(p.num_tracks, p.channels, p.n_tiles, -1)
    block = mix_plan.PER_TRACK_FRAMES_PER_BLOCK
    for ti, b, t in zip(*np.nonzero(empty)):
        assert not got[t, :, ti, b * block:(b + 1) * block].any()
    chip_smoke.per_track_vs_plain("int_formats_empty_cells", s)


# ---------------------------------------------------------------- the cascade


def test_cascade_kernel_on_small_rows(card):
    chip_smoke.phase_cascade_small(torch)


def test_dynamics_kernel_on_small_rows(card):
    """The dynamics kernel against the f64 oracle and its plain versions:
    the recurrences alone on 1, 2, 7, 64 and 256 rows, ragged tiles, lanes,
    states over two calls, the gate's floor and the RMS detector; the fused
    compressor, limiter and gate at the paths' shapes and on the small
    cases (``chip_smoke.phase_dynamics_small``)."""
    chip_smoke.phase_dynamics_small(torch)


#: fused dynamics cases: kind, rows, channels, frames, inputs, checks
FUSED_CASES = {
    "compressor_rms_key_two_chunks": ("compressor", 4, 2, 20000, {"detector": "rms", "key": True},
                                      {"pieces": (7000,), "ref_rows": (0,)}),
    "compressor_peak_silent_key": ("compressor", 3, 2, 9000, {"silent_key": True}, {"ref_rows": (1,)}),
    "compressor_rms_silent_key": ("compressor", 2, 2, 9000, {"detector": "rms", "silent_key": True},
                                  {"ref_rows": (0,)}),
    "compressor_lanes": ("compressor", 3, 2, 30000, {"lanes": ("threshold_db", "release", "det_avg"),
                                                     "detector": "rms"}, {"ref_rows": (2,), "ref_bar": 2e-4}),
    "limiter_lookahead_two_chunks": ("limiter", 2, 2, 50000, {"lookahead": 240},
                                     {"pieces": (20000,), "ref_rows": (1,)}),
    "limiter_lookahead_longer_than_a_tile": ("limiter", 1, 2, 9000, {"lookahead": 2500}, {"ref_rows": (0,)}),
    "limiter_no_lookahead": ("limiter", 5, 1, 12000, {}, {"ref_rows": (4,)}),
    "gate_hysteresis_two_chunks": ("gate", 8, 2, 30000, {"hyst": 6.0}, {"pieces": (9999,), "ref_rows": (7,)}),
    "gate_key_range_lane": ("gate", 3, 2, 20000, {"key": True, "lanes": ("range_db", "attack")},
                            {"ref_rows": (1,), "ref_bar": 2e-4}),
    "mono_row_shorter_than_a_tile": ("compressor", 2, 1, 700, {"detector": "rms"}, {"ref_rows": (0, 1)}),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_dynamics_kernel(card, case):
    """One fused launch a compressor, limiter or gate call against its f64
    oracle (5e-6 a row), its plain version (5e-6 plus the plain scans' own
    distance), its host model (1e-6), the f64 sequential references (5e-5,
    2e-4 with lanes); two runs bit-equal."""
    kind, B, C, F, inputs, opts = FUSED_CASES[case]
    x, params, state, kw = chip_smoke.dynamics_inputs(torch, kind, B, C, F, 7, **inputs)
    chip_smoke.fused_vs_plain(case, torch, kind, x, params, state, host_model=True, time_it=False, **opts, **kw)


@pytest.mark.parametrize("kind", ["compressor", "gate"])
def test_silent_key_on_the_card_is_an_explicit_zero_key(card, kind):
    """The generic finisher's sidechain stage with nothing routed: the
    silent-key flag gives the output of a key of zeros, bit for bit."""
    from whitebox_tpu_torch.ops import dynamics_cuda
    from whitebox_tpu_torch.render import effects_generic as gen

    x, params, state, _ = chip_smoke.dynamics_inputs(torch, kind, 3, 2, 30000, 11, detector="rms")
    flat = {k: v[:, 0] for k, v in params.items()}  # one value a row, as the finisher holds them
    static = ("rms", True) if kind == "compressor" else (True,)
    before = dynamics_cuda.dynamics_fused_launches
    silent, s_state = gen._apply_stage(kind, static, flat, x, state, 0, 48000.0)
    zeros, z_state = gen._apply_stage(kind, static, flat, x, state, 0, 48000.0, key=torch.zeros_like(x))
    assert dynamics_cuda.dynamics_fused_launches == before + 2
    assert torch.equal(silent, zeros) and all(torch.equal(s_state[k], z_state[k]) for k in s_state)


def test_the_card_launches_the_kernel_or_raises(card):
    """A CUDA tensor never falls back to torch ops: a launch the kernel
    refuses raises, and so does a call its wrapper cannot prepare."""
    from whitebox_tpu_torch.ops import dynamics_cuda

    x, params, state, kw = chip_smoke.dynamics_inputs(torch, "compressor", 2, 2, 5000, 13)
    call = dynamics_cuda.prepare_stage("compressor", x, params, state, **kw)
    call.args.l = 48  # not a sub-block length the kernel takes
    with pytest.raises(RuntimeError, match="cudaError_t"):
        call()
    with pytest.raises(ValueError, match="shared memory"):
        dynamics_cuda.prepare_stage("limiter", x, {"ceiling_db": -1.0, "attack": 0.9, "release": 0.99},
                                    {"red": 0.0, "att": 0.0, "look": torch.zeros(30000, device="cuda"),
                                     "xdelay": torch.zeros((2, 30000), device="cuda")}, lookahead=30000)


def _dynamics_session():
    from whitebox_tpu_torch.effects import Compressor, EffectChain, Limiter, NoiseGate

    s = make_demo_session(n_tracks=6, duration_seconds=3.0, seed=9)
    chains = [[Compressor(-20.0, 4.0)], [Compressor(-30.0, 3.0, detector="rms")], [NoiseGate(-30.0)],
              [Limiter(-6.0)], [], [Compressor(-18.0, 2.0, attack_s=0.05, release_s=0.5)]]
    for tr, chain in zip(s.tracks, chains):
        tr.effects = EffectChain(chain)
    s.master_effects = EffectChain([Limiter(-0.5)])
    return s


@pytest.mark.parametrize("kind", ["generic", "routed"])
def test_bounces_run_the_dynamics_kernel(card, kind):
    """A generic bounce (compressors, an RMS detector, a gate, limiters) and
    the routed small session (a ducking bus, a master limiter) on the card:
    the fused dynamics kernel launched (the unfused kinds not), within
    relative RMS 1e-5 of the same bounce on the CPU (the finishers' bar)."""
    from whitebox_tpu_torch.ops import dynamics_cuda

    s = _dynamics_session() if kind == "generic" else chip_smoke.routed_small()
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device="cuda")
    assert dynamics_cuda.dynamics_fused_launches > 0 and dynamics_cuda.dynamics_scan_launches == 0
    want = bounce(s, 48000.0, device="cpu")
    assert got.audio.shape == want.audio.shape
    assert chip_smoke.rel_rms(got.audio, want.audio) < chip_smoke.GENERIC_REL_RMS


def test_finisher_stream_alternates_kernel_and_plain_states(card):
    from whitebox_tpu_torch.render.finisher import make_finisher, run

    s = _eq_session()
    T, C, F, chunk = len(s.tracks), 2, 40000, 8192
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((T, C, F)) * 0.2).astype(np.float32))
    tg = torch.from_numpy(np.random.default_rng(4).uniform(0.2, 1.2, (T, C)).astype(np.float32))
    whole = run(make_finisher("scan", s, 48000.0, tg, chunk=chunk), x, F).out
    cpu = torch.device("cpu")
    fins = {d: make_finisher("scan", s, 48000.0, tg.to(d), chunk=chunk, device=d) for d in (card, cpu)}
    states, mstates = fins[cpu].init()
    before = biquad_cuda.biquad_cascade_launches
    parts = []
    for i, start in enumerate(range(0, F, chunk)):
        dev = card if i % 2 == 0 else cpu
        states, mstates = [q.to(dev) for q in states], [q.to(dev) for q in mstates]
        out, (states, mstates), _ = fins[dev].step(x[..., start:start + chunk].to(dev), (states, mstates), start)
        parts.append(out.cpu())
    assert biquad_cuda.biquad_cascade_launches == before + 2 * 3  # tracks and master, chunks 0, 2, 4
    assert chip_smoke.rel_rms(torch.cat(parts, dim=1).numpy(), whole.numpy()) < chip_smoke.CASCADE_REL_RMS


@pytest.mark.parametrize("kw", [{"effects_mode": "scan"}, {"meters": True}], ids=["scan", "meters"])
def test_scan_and_metered_bounces_run_the_cascade_kernel(card, kw):
    from whitebox_tpu_torch.ops import biquad as biquad_mod

    s = _eq_session()
    chip_smoke.reset_launches()
    scans = []
    plain_scan = biquad_mod.hillis_scan
    biquad_mod.hillis_scan = lambda *a, **k: scans.append(1) or plain_scan(*a, **k)
    try:
        got = bounce(s, 48000.0, device=card, **kw)
    finally:
        biquad_mod.hillis_scan = plain_scan
    assert biquad_cuda.biquad_cascade_launches > 0 and not scans
    assert mix_cuda.mix_per_track_launches == 1
    cpu = bounce(s, 48000.0, device="cpu", **kw)
    assert chip_smoke.rel_rms(got.audio, cpu.audio) < 1e-5
    if "meters" in kw:
        for f in ("track_peak", "track_rms", "output_peak", "output_rms"):
            np.testing.assert_allclose(getattr(got.stats, f), getattr(cpu.stats, f), rtol=1e-5, atol=1e-7,
                                       err_msg=f)


GATHER_CASES = {
    "speed1_int_formats": (lambda: chip_smoke.int_formats_session(n_tracks=4), {}),
    "resampled_fades": (SESSIONS["mixed_speeds_fades"], {}),
    "resampled_catmull": (SESSIONS["mixed_speeds_fades"], {"interpolation": "catmull"}),
    "resampled_sinc_bank": (SESSIONS["mixed_speeds_fades"], {"interpolation": "sinc"}),
    "reverse_ragged_chunks": (chip_smoke.reverse_session, {"chunk_frames": 10007}),
    "dense_overflow_auto": (chip_smoke.dense_session, {"engine": "auto"}),
}


@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gather_path_on_the_card(card, name):
    """The gather mix on the card: no mix-kernel launch, bit-equal to the
    CPU's, and to the NumPy references under the repo's contract."""
    make, kw = GATHER_CASES[name]
    chip_smoke.gather_vs_reference(name, make(), **kw)


@pytest.mark.parametrize("kind", list(chip_smoke._kind_chains()))
def test_generic_stage_kind_on_the_card(card, kind):
    """Each generic stage kind: the finisher on the card within relative
    RMS 1e-5 of the CPU's and 5e-5 (2e-4 with lanes) of the f64 oracle;
    static biquad/EQ stages through the cascade kernel."""
    chain, lanes = chip_smoke._kind_chains()[kind]
    chip_smoke.generic_kind_vs_cpu_and_f64(torch, kind, chain, lanes)


def test_long_session_fallback_matches_the_per_track_path(card, monkeypatch):
    """Per-track buffers over the card's limit (its share forced to 0): the
    gather path with the streaming cascade finisher, no mix-kernel launch,
    within relative RMS 1e-5 of the K4 path."""
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    s = _eq_session()
    k4 = bounce(s, 48000.0, device=card)
    monkeypatch.setattr(bounce_mod, "PER_TRACK_CARD_SHARE", 0.0)
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card)
    assert got.stats.mix_path == "gather" and not any(chip_smoke.mix_launches().values())
    assert biquad_cuda.biquad_cascade_launches > 0
    assert chip_smoke.rel_rms(got.audio, k4.audio) < 1e-5


def test_per_track_limit_follows_the_cards_memory(card):
    """On the card the per-track limit is a share of the memory the process
    can still allocate, not the JAX package's 6 GiB: a 240 s 128-track
    stereo session (11.8 GB of buffers) rides K4 on an 80 GB card."""
    bounce_mod = importlib.import_module("whitebox_tpu_torch.render.bounce")

    dev = torch.device(card)
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    limit = bounce_mod.per_track_limit_bytes(dev)
    assert abs(limit - (free + cached) * bounce_mod.PER_TRACK_CARD_SHARE) <= 64 << 20
    if torch.cuda.get_device_properties(dev).total_memory > 64e9:
        assert limit > 128 * 2 * 240 * 48000 * 4


def test_routed_finisher_on_the_card_matches_the_cpu(card):
    """The routed finisher (groups, post/pre/sidechain sends, a ducking bus,
    a generic bus with a fader lane, PDC) on the card within relative RMS
    1e-5 of the CPU's and 5e-5 of the f64 reference_routed_finish; its
    bounce one K4 launch, the gather path none."""
    chip_smoke.phase_routed_small(torch)


def test_synth_on_the_card_bit_equal_to_numpy(card):
    """The synth of stacked MIDI tracks on the card, in pieces, bit-equal
    to render_synth_numpy."""
    from whitebox_tpu_torch.render.bounce import _add_synth, _prepare_synth_tables

    s = chip_smoke.midi_small()
    F = 3 * 48000
    synth = _prepare_synth_tables(s, 48000.0, 512, F // 512, card)
    want = chip_smoke.synth_rows_numpy(s, F // 512 * 512)
    rows = _add_synth(torch.zeros((len(s.tracks), 1, F), device=card), synth, 0, F)
    assert sorted(want) == synth["rows"]
    for t in synth["rows"]:
        np.testing.assert_array_equal(rows[t, 0, :len(want[t])].cpu().numpy(), want[t])


@pytest.mark.parametrize("kind", ["routed", "midi"])
def test_routed_and_midi_bounces_count_one_k4_launch(card, kind):
    """A routed and a MIDI bounce on the card: one K4 launch each, equal to
    the CPU's (routed: relative RMS 1e-5; MIDI: bit-equal)."""
    s = chip_smoke.routed_small() if kind == "routed" else chip_smoke.midi_small()
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card)
    assert got.stats.mix_path == "kernel" and chip_smoke.mix_launches() == {"mix": 0, "auto": 0, "per_track": 1}
    cpu = bounce(s, 48000.0, device="cpu").audio
    if kind == "midi":
        np.testing.assert_array_equal(got.audio, cpu)
    else:
        assert chip_smoke.rel_rms(got.audio, cpu) < 1e-5


def test_stems_on_the_card_match_the_cpu(card):
    """Stems of an EQ session: one K4 launch, the cascade kernel, within
    relative RMS 1e-5 of the CPU's per stem; bus stems of the small routed
    session within 1e-5 of the CPU's."""
    from whitebox_tpu_torch.render.stems import render_bus_stems, render_stems

    s = make_demo_session(n_tracks=6, duration_seconds=3.0, seed=4)
    chip_smoke.add_eq_chains(s)
    chip_smoke.reset_launches()
    got, names = render_stems(s, 48000.0, device=card)
    assert chip_smoke.mix_launches() == {"mix": 0, "auto": 0, "per_track": 1}
    assert biquad_cuda.biquad_cascade_launches > 0
    want, _ = render_stems(s, 48000.0, device="cpu")
    assert got.shape == want.shape and len(names) == 6
    for t in range(6):
        assert chip_smoke.rel_rms(got[t], want[t]) < 1e-5
    r = chip_smoke.routed_small()
    for g, w in zip(render_bus_stems(r, 48000.0, device=card)[:2], render_bus_stems(r, 48000.0, device="cpu")[:2]):
        assert g.shape == w.shape and chip_smoke.rel_rms(g, w) < 1e-5


def _eq_session(seed=4):
    s = make_demo_session(n_tracks=6, duration_seconds=3.0, seed=seed)
    chip_smoke.add_eq_chains(s)
    return s


@pytest.fixture
def fresh_ring(monkeypatch):
    """``ops/readback.py`` with no ring yet, 1 MiB pieces (so a small
    session's stems take several), and the staging threshold at 0."""
    from whitebox_tpu_torch.ops import readback

    monkeypatch.setattr(readback, "_RINGS", {})
    monkeypatch.setattr(readback, "PIECE_BYTES", 1 << 20)
    monkeypatch.setattr(readback, "STAGE_MIN_BYTES", 0)
    return readback


def test_staged_readback_gives_the_pageable_bytes(card, fresh_ring, monkeypatch):
    """``render_stems`` and ``bounce`` on an EQ session: the staged readback
    returns the bytes of ``.cpu().numpy()``, with its dtype and shape."""
    from whitebox_tpu_torch.render.stems import render_stems

    s = _eq_session()
    before = fresh_ring.staged_readbacks
    staged = (render_stems(s, 48000.0, device=card)[0], bounce(s, 48000.0, device=card).audio)
    assert fresh_ring.staged_readbacks == before + 2
    monkeypatch.setattr(fresh_ring, "STAGE_MIN_BYTES", 1 << 62)
    plain = (render_stems(s, 48000.0, device=card)[0], bounce(s, 48000.0, device=card).audio)
    assert fresh_ring.staged_readbacks == before + 2
    assert staged[0].nbytes > 2 * fresh_ring.PIECE_BYTES
    for got, want in zip(staged, plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_staged_stems_exports_stay_independent(card, fresh_ring):
    """Three stems exports in a row through one ring, all three arrays kept:
    each is the caller's own (no memory shared with another or with the
    staging), an earlier one is unchanged by a later export, and the ring
    was allocated once."""
    from whitebox_tpu_torch.render.stems import render_stems

    allocations = fresh_ring.staging_allocations
    outs = [render_stems(_eq_session(seed), 48000.0, device=card)[0] for seed in (4, 5, 4)]
    assert fresh_ring.staging_allocations == allocations + 1
    kept = outs[0].copy()
    np.testing.assert_array_equal(outs[2].view(np.int32), kept.view(np.int32))
    assert not np.array_equal(outs[1], kept)
    (ring,) = fresh_ring._RINGS.values()
    for i, a in enumerate(outs):
        assert a.flags.writeable
        assert not any(np.shares_memory(a, slot.numpy()) for slot in ring.slots)
        assert not any(np.shares_memory(a, b) for b in outs[i + 1:])


def test_readback_threshold_on_the_card(card):
    """Below ``STAGE_MIN_BYTES`` a CUDA tensor takes ``.cpu().numpy()``; at
    it, the ring."""
    from whitebox_tpu_torch.ops import readback

    small = torch.arange(readback.STAGE_MIN_BYTES // 4 - 1, dtype=torch.float32, device=card)
    large = torch.arange(readback.STAGE_MIN_BYTES // 4, dtype=torch.float32, device=card)
    before = (readback.staged_readbacks, readback.staged_bytes)
    np.testing.assert_array_equal(readback.to_host(small), small.cpu().numpy())
    assert (readback.staged_readbacks, readback.staged_bytes) == before
    np.testing.assert_array_equal(readback.to_host(large), large.cpu().numpy())
    assert (readback.staged_readbacks, readback.staged_bytes) == (before[0] + 1, before[1] + large.numel() * 4)
    assert readback.RING_SLOTS * readback.PIECE_BYTES <= 256 << 20


def test_loudness_on_the_card_matches_the_cpu_and_f64(card):
    from whitebox_tpu_torch.ops.loudness import measure_loudness, measure_loudness_reference

    x = chip_smoke.program_signal(8.0)
    got = measure_loudness(x, 48000.0, device=card).as_dict()
    for want in (measure_loudness(x, 48000.0, device="cpu").as_dict(),
                 measure_loudness_reference(x, 48000.0).as_dict()):
        for k, bar in chip_smoke.LOUDNESS_BARS.items():
            assert abs(got[k] - want[k]) <= bar, k


def test_vocoder_on_the_card_matches_the_cpu_and_repeats(card):
    from whitebox_tpu_torch.ops.stretch import pitch_shift, time_stretch

    x = chip_smoke.program_signal(4.0)
    a = time_stretch(x, 1.25, device=card)
    np.testing.assert_array_equal(a, time_stretch(x, 1.25, device=card))
    assert chip_smoke.rel_rms(a, time_stretch(x, 1.25, device="cpu")) < 1e-5
    p = pitch_shift(x, 3.0, 48000.0, device=card)
    assert chip_smoke.rel_rms(p, pitch_shift(x, 3.0, 48000.0, device="cpu")) < 1e-5


@pytest.mark.parametrize("fmt", ["F32", "I16"])
def test_peaks_on_the_card_bit_identical_to_the_scalar_walk(card, fmt):
    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.ops.peaks import build_mipmaps

    sample = chip_smoke.peaks_sample(AudioFormat[fmt], 200_001)
    for q in ("low", "high"):
        chip_smoke.check_mipmaps(build_mipmaps(sample, q, device=card), sample, q)


def test_render_cache_on_the_card(card):
    """``SessionRenderCache`` on the card: one K1 launch per render (K3 for
    an automation-only session), bit-equal to ``bounce``; the pool on the
    card kept across a gain edit."""
    from whitebox_tpu_torch.render.cached import SessionRenderCache

    for s, kernel in ((make_demo_session(n_tracks=6, duration_seconds=3.0, seed=4), "mix"),
                      (chip_smoke.auto_session(curves=True, fades=True), "auto")):
        cache = SessionRenderCache(s, 48000.0)
        chip_smoke.reset_launches()
        out = cache.render()
        assert chip_smoke.mix_launches() == {"mix": 0, "auto": 0, "per_track": 0, kernel: 1}
        np.testing.assert_array_equal(out, bounce(s, 48000.0, device=card).audio)
        pool = cache._pool_dev
        s.tracks[0].clips[0].audio.gain *= 0.5
        np.testing.assert_array_equal(cache.render(), bounce(s, 48000.0, device=card).audio)
        assert cache._pool_dev is pool


def _pool_heavy_session(seed, frames=2_000_000):
    """One track of three short clips over three stereo assets of
    ``frames`` frames: a ~48 MB pool beside a ~0.6 MB mix."""
    from whitebox_tpu_torch.core.formats import AudioFormat
    from whitebox_tpu_torch.session import Session
    from whitebox_tpu_torch.session.sample import Sample

    rng = np.random.default_rng(seed)
    s = Session(bpm=120.0)
    tr = s.add_track("t")
    for i in range(3):
        data = (rng.standard_normal((2, frames)) * 0.1).astype(np.float32)
        a = s.sample_table.add_sample(Sample.from_planar(data, 48000, AudioFormat.F32, name=f"p{i}"), key=f"p{i}")
        s.add_audio_clip(tr, f"c{i}", float(i), i + 0.9, asset=a)
    return s


def _resident_render(kind, s, dev):
    from whitebox_tpu_torch.render.stems import render_stems

    return render_stems(s, 48000.0, device=dev)[0] if kind == "stems" else bounce(s, 48000.0, device=dev).audio


@pytest.mark.parametrize("kind", ["bounce", "eq_bounce", "stems"])
def test_resident_pool_hits_after_an_edit_on_the_card(card, kind):
    """A fader and clip move keep the asset set: the next ``bounce`` (K1;
    K4 and the scan with EQ) or ``render_stems`` takes the same resident
    pool tensor, and its output is bit-equal to a render whose pool was
    uploaded anew."""
    s = make_demo_session(n_tracks=6, duration_seconds=3.0, seed=4)
    if kind != "bounce":
        chip_smoke.add_eq_chains(s)
    first = _resident_render(kind, s, card)
    _, held = mix_cuda._RESIDENT_POOLS[f"cuda:{torch.cuda.current_device()}"]
    s.tracks[0].volume_db += 1.5
    s.move_clip(s.tracks[1], s.tracks[1].clips[1], 0.05)
    hits, misses = mix_cuda.resident_pool_hits, mix_cuda.resident_pool_misses
    got = _resident_render(kind, s, card)
    assert (mix_cuda.resident_pool_hits, mix_cuda.resident_pool_misses) == (hits + 1, misses)
    assert mix_cuda._RESIDENT_POOLS[f"cuda:{torch.cuda.current_device()}"][1] is held
    mix_cuda._RESIDENT_POOLS.clear()
    want = _resident_render(kind, s, card)
    assert mix_cuda.resident_pool_misses == misses + 1
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, first)


def test_a_resident_pool_miss_holds_one_pool_on_the_card(card):
    """Two sessions on different assets bounced in turn (a, b, a): each
    bounce misses, drops the old resident pool before it uploads its own,
    so the card never holds two (the peak stays under 1.5 pools above the
    start), and after each it holds at most one pool more than before the
    first."""
    from whitebox_tpu_torch.timeline.pool import build_sample_pool

    a, b = _pool_heavy_session(1), _pool_heavy_session(2)
    nbytes = max(build_sample_pool(x).data.nbytes for x in (a, b))
    mix_cuda._RESIDENT_POOLS.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    for s in (a, b, a):
        misses = mix_cuda.resident_pool_misses
        torch.cuda.reset_peak_memory_stats(card)
        bounce(s, 48000.0, device=card)
        torch.cuda.synchronize()
        assert mix_cuda.resident_pool_misses == misses + 1
        assert torch.cuda.memory_allocated(card) - base <= nbytes + (1 << 20)
        assert torch.cuda.max_memory_allocated(card) - base < 1.5 * nbytes


def test_preview_on_the_card(card):
    """Config 8 in small through ``PreviewStream``: no mix-kernel launch,
    the cascade kernel launched, within relative RMS 1e-5 of the card's
    bounce and of the CPU's preview."""
    from whitebox_tpu_torch.render.preview import PreviewStream

    s = chip_smoke.preview_session(n_tracks=4, duration=3.0)
    full = bounce(s, 48000.0, device=card).audio
    chip_smoke.reset_launches()
    got = np.concatenate(list(PreviewStream(s, 48000.0, lookahead_blocks=8)), axis=1)[:, :full.shape[1]]
    assert not any(chip_smoke.mix_launches().values()) and biquad_cuda.biquad_cascade_launches > 0
    assert chip_smoke.rel_rms(got, full) < 1e-5
    cpu = np.concatenate(list(PreviewStream(s, 48000.0, lookahead_blocks=8, device="cpu")), axis=1)
    assert chip_smoke.rel_rms(got, cpu[:, :full.shape[1]]) < 1e-5


def test_streamed_bounce_on_the_card(card):
    """``bounce_streamed`` of seeded takes under a cap a quarter of the
    pool: bit-equal to ``bounce(engine="xla")`` on the card; with EQ
    chains through the cascade kernel, within relative RMS 1e-5."""
    from whitebox_tpu_torch.render.stream_pool import bounce_streamed

    s = chip_smoke.takes_session(n_tracks=6, duration=4.0)
    cap = 6 * 2 * int(4.0 * 48000) * 4 // 4
    stats = {}
    got = bounce_streamed(s, 48000.0, max_pool_bytes=cap, window_frames=1 << 14, stats=stats)
    np.testing.assert_array_equal(got, bounce(s, 48000.0, device=card, engine="xla").audio)
    assert stats["windows"] > 1 and stats["copy_s"] > 0.0
    chip_smoke.add_eq_chains(s)
    chip_smoke.reset_launches()
    eq = bounce_streamed(s, 48000.0, max_pool_bytes=cap, window_frames=1 << 14)
    assert not any(chip_smoke.mix_launches().values()) and biquad_cuda.biquad_cascade_launches > 0
    assert chip_smoke.rel_rms(eq, bounce(s, 48000.0, device=card, engine="xla").audio) < 1e-5


def _sharded_session(chained: bool):
    """Six tracks of 3 s; chained: config 6's chain kinds (EQ groups, a
    compressor, a master highpass and lookahead limiter)."""
    from whitebox_tpu_torch.effects import Biquad, Compressor, EffectChain, Limiter, ParametricEQ

    s = make_demo_session(n_tracks=6, duration_seconds=3.0, seed=3)
    if chained:
        for t, tr in enumerate(s.tracks):
            tr.effects = EffectChain([Compressor(-24.0, 4.0)] if t % 2 else
                                     [ParametricEQ([("lowshelf", 90.0, 0.707, 1.5), ("peak", 900.0, 1.0, -2.0)])])
        s.master_effects = EffectChain([Biquad("highpass", 25.0), Limiter(-0.5)])
    return s


@pytest.mark.parametrize("chained", [False, True], ids=["plain", "chained"])
def test_sharded_world_of_one_over_nccl(card, chained):
    """``make_render_mesh()`` with no process group starts a world of one
    over NCCL (a 1x1 mesh); ``bounce_sharded`` there is the gather bounce on
    the card: bit-equal for a plain mix, within atol 3e-6 / rtol 1e-4 with
    chains, the static sections through the cascade kernel."""
    import torch.distributed as dist

    from whitebox_tpu_torch.parallel import bounce_sharded, make_render_mesh

    s = _sharded_session(chained)
    ref = bounce(s, 48000.0, device=card, engine="xla").audio
    chip_smoke.reset_launches()
    mesh = make_render_mesh()
    try:
        assert mesh.backend == "nccl" and mesh.shape == {"tracks": 1, "frames": 1} and not mesh.staged
        got = bounce_sharded(s, 48000.0, mesh)
    finally:
        dist.destroy_process_group()
    assert not any(chip_smoke.mix_launches().values())
    assert chip_smoke.gather_counts()["per_track" if chained else "sum_unclipped"] >= 1
    if chained:
        assert biquad_cuda.biquad_cascade_launches > 0
        np.testing.assert_allclose(got, ref, atol=3e-6, rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, ref)


def test_sharded_two_ranks_share_the_card(card):
    """Two ranks on one card over gloo, the collectives staged through
    page-locked host memory: a plain mix on 1x2 bit-equal to the card's
    gather bounce, chains on 1x2 and 2x1 within atol 3e-6 / rtol 1e-4."""
    # by its own name (pytest puts tests/ on the path): an installed
    # package named ``tests`` shadows the repo's ``tests`` namespace
    from torch_parallel_worlds import run_jobs, same_on_every_rank
    from whitebox_tpu_torch.parallel.launch import run_world

    plain, chained = _sharded_session(False), _sharded_session(True)
    jobs = [("bounce", {"session": plain, "tp": 1, "fp": 2}), ("bounce", {"session": chained, "tp": 1, "fp": 2}),
            ("bounce", {"session": chained, "tp": 2, "fp": 1})]
    res = same_on_every_rank(run_world(run_jobs, 2, device="cuda", timeout=300, args=(jobs, "cuda")))
    assert all(r[0] == "ok" for r in res), res
    np.testing.assert_array_equal(res[0][1], bounce(plain, 48000.0, device=card, engine="xla").audio)
    ref = bounce(chained, 48000.0, device=card, engine="xla").audio
    for r in res[1:]:
        np.testing.assert_allclose(r[1], ref, atol=3e-6, rtol=1e-4)


def test_verify_checks_pass_on_the_card(card):
    """The eleven feature checks (``tools/verify.py``) on the card at the
    JAX package's bars, each requiring its mix-kernel and cascade launches."""
    from whitebox_tpu_torch.tools import verify

    assert verify.main(["--device", "cuda"]) == 0


@pytest.mark.parametrize("case", list(chip_smoke.gather_kernel_cases()))
def test_gather_kernel_bit_equal_to_plain(card, case):
    """Every form (per-track, summed, summed unclipped) bit-equal to the
    plain torch ops on the card chunk by chunk, a chunk past the end +0.0,
    a track subset, strict_order=False within 1e-6."""
    build, interpolation, chunk, channels = chip_smoke.gather_kernel_cases()[case]
    chip_smoke.gather_kernel_vs_plain(torch, case, build(), interpolation, chunk, channels)


def test_gather_kernel_many_tracks(card):
    """300 tracks: two staging passes of the row ranges; strict_order=False
    within the reordering bound of 300 terms."""
    chip_smoke.gather_kernel_vs_plain(torch, "tracks_300", chip_smoke.many_tracks_gather_session(),
                                      chunk=1 << 15, fast_sum_atol=None)


def test_bounce_xla_launches_the_gather_kernel(card):
    """``engine="xla"``: the gather path, no slot-plan kernel, the gather
    kernel at least once a chunk, bit-equal to the slot-plan kernel's bounce."""
    s = make_demo_session(n_tracks=8, duration_seconds=4.0, seed=7)
    k = bounce(s, 48000.0, device=card)
    chip_smoke.reset_launches()
    got = bounce(s, 48000.0, device=card, engine="xla", chunk_frames=50000)
    assert got.stats.mix_path == "gather" and not any(chip_smoke.mix_launches().values())
    assert got.stats.gather_chunks == -(-k.frames // 50000)
    assert chip_smoke.gather_counts() == {"per_track": 0, "sum": got.stats.gather_chunks, "sum_unclipped": 0}
    np.testing.assert_array_equal(got.audio, k.audio)


def test_gather_kernel_has_no_fallback(card, monkeypatch):
    """A failed build or a malformed argument raises on the card; nothing
    renders through the torch ops instead."""
    from whitebox_tpu_torch.ops import cuda_build, gather_cuda
    from whitebox_tpu_torch.ops import mix as mix_mod

    s = make_demo_session(n_tracks=2, duration_seconds=1.0, seed=7)
    table, pool = carve_session(s, 48000.0, buffer_size=512, slow_emit="blocks")
    tables = mix_mod.pack_device_tables(table, pool, s).as_torch(card)
    pool_dev = torch.from_numpy(pool.data).to(card)
    with pytest.raises(ValueError, match="pool must be"):
        mix_mod.render_chunk(pool_dev.double(), tables, 0, 4096)

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(cuda_build, "load", broken)
    monkeypatch.setattr(mix_mod, "gather_plain", lambda *a, **k: pytest.fail("fell back to the torch ops"))
    before = gather_cuda.gather_launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        mix_mod.render_chunk_per_track(pool_dev, tables, 0, 4096)
    assert gather_cuda.gather_launches == before


@pytest.mark.parametrize("shape", [(1, 5), (7, 3, 1001), (128, 2, (1 << 18) + 3), (300, 2, 4096)],
                         ids=["one_row", "odd", "chunk_128trk", "tracks_300"])
def test_ordered_sum_kernel_bit_equal_to_the_adds(card, shape):
    """``csrc/ordered_sum.cu``: one launch, bit-equal to ``total + y[t]`` in
    track order from +0.0, with -0.0, Inf and NaN among the inputs."""
    from whitebox_tpu_torch.ops import sum_cuda

    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    y = (torch.randn(shape, generator=g) * 10.0 ** torch.randint(-6, 6, shape, generator=g)).to(card)
    flat = y.view(shape[0], -1)
    flat[:, :4] = -0.0
    flat[shape[0] // 2, 1] = float("inf")
    flat[0, 2] = float("nan")
    want = torch.zeros(shape[1:], device=card)
    for t in range(shape[0]):
        want = want + y[t]
    before = sum_cuda.ordered_sum_launches
    got = sum_cuda.ordered_sum_cuda(y)
    assert sum_cuda.ordered_sum_launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_generic_bounce_sums_in_one_launch_a_chunk(card):
    """The generic finisher (compressors, the lookahead limiter) sums each
    chunk's tracks with one ordered-sum launch, and renders as the CPU does."""
    from whitebox_tpu_torch.ops import sum_cuda

    s = chip_smoke.generic_fx_128trk(duration=3.0)
    before = sum_cuda.ordered_sum_launches
    got = bounce(s, 48000.0, device=card)
    assert got.stats.finisher == "generic"
    assert sum_cuda.ordered_sum_launches - before == got.stats.finish_chunks
    cpu = bounce(s, 48000.0, device="cpu")
    assert chip_smoke.rel_rms(got.audio, cpu.audio) < chip_smoke.GENERIC_REL_RMS
