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
the eleven feature checks of ``whitebox_tpu_torch/tools/verify.py``.
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


def test_finisher_stream_alternates_kernel_and_plain_states(card):
    from whitebox_tpu_torch.render import effects_pipeline as pipe

    s = _eq_session()
    T, C, F, chunk = len(s.tracks), 2, 40000, 8192
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((T, C, F)) * 0.2).astype(np.float32))
    tg = torch.from_numpy(np.random.default_rng(4).uniform(0.2, 1.2, (T, C)).astype(np.float32))
    (S, pc), (Sm, pm) = pipe.prepare_effect_tables(s, 48000.0, C)
    whole = pipe.finish_mix(x, pc, pm, tg, T=T, C=C, S=S, Sm=Sm, chunk=chunk)
    states, mstates = pipe.init_effect_states(T, C, S, Sm)
    before = biquad_cuda.biquad_cascade_launches
    parts = []
    for i, start in enumerate(range(0, F, chunk)):
        dev = card if i % 2 == 0 else torch.device("cpu")
        states, mstates = [q.to(dev) for q in states], [q.to(dev) for q in mstates]
        out, states, mstates = pipe.finish_mix_chunk(
            x[..., start:start + chunk].to(dev), pc.to(dev), pm.to(dev), tg.to(dev), states, mstates,
            start, T=T, C=C, S=S, Sm=Sm)
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
