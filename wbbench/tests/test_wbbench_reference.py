"""The frozen reference held to ground truth, on the CPU: the mix against the
JAX package's parity oracle (``whitebox_tpu/timeline/oracle.py``, the
engine's block-sequential f32 mix; it plays no fades) and, with fades,
against the JAX package's segment renderer (``render_segments_numpy``,
whose fade envelope the carve defines), bit-equal at speed 1; the RBJ
formulas against the JAX package's coefficients. ``run.py`` never imports
this file; it is the only benchmark file that imports the JAX package.
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from wbbench.lib.check import Reference  # noqa: E402
from wbbench.lib.spec import part  # noqa: E402
from wbbench.reference import rbj  # noqa: E402

clips = part("sessions", "clips")
KIND = part("reference", "clips")
Edits, generate = clips.Edits, clips.generate
SMALL = {"name": "ground", "session": "clips", "tracks": 5, "sample_rate": 48000, "buffer_size": 512, "channels": 2, "bpm": 120.0,
         "seconds": 8.0, "assets": 10, "asset_seconds": 1.0, "assets_per_track": 2, "asset_amplitude": 0.3,
         "fade_share": 0.1, "break_beats": 1.25, "track_chain": [], "master_chain": []}


def jax_session(desc):
    """The JAX package's ``Session`` of a benchmark description."""
    from whitebox_tpu.core.formats import AudioFormat
    from whitebox_tpu.session import Session
    from whitebox_tpu.session.sample import Sample

    s = Session(bpm=desc.bpm)
    assets = [s.sample_table.add_sample(Sample.from_planar(a, desc.sample_rate, AudioFormat.F32, name=f"a{i}"),
                                        key=f"a{i}") for i, a in enumerate(desc.assets)]
    for t, tr in enumerate(desc.tracks):
        track = s.add_track(f"t{t}", volume_db=float(tr.volume_db), pan=float(tr.pan))
        for i in np.argsort(tr.min_beat, kind="stable"):
            s.add_audio_clip(track, f"c{i}", float(tr.min_beat[i]), float(tr.max_beat[i]),
                             start_offset=float(tr.offset[i]), asset=assets[int(tr.asset[i])],
                             gain=float(tr.gain[i]), fade_start=float(tr.fade_in[i]), fade_end=float(tr.fade_out[i]))
    return s


def _config(**kw):
    cfg = dict(SMALL)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("seed", [0, 1, 2147483901, 987654321012])
def test_mix_bit_equal_to_the_oracle_without_fades(seed):
    from whitebox_tpu.timeline.oracle import OracleRenderer

    base = generate(_config(fade_share=0.0), seed)
    edits = Edits(base, seed, 2)
    for desc in [base, edits[0].desc, edits[1].desc]:
        ref = Reference(base, KIND).mixes([desc])[0]
        want = OracleRenderer(jax_session(desc), float(desc.sample_rate), desc.buffer_size, desc.channels).render()
        assert ref.shape == want.shape
        np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("seed", [3, 4, 2147483902])
def test_mix_bit_equal_to_the_segment_renderer_with_fades(seed):
    from whitebox_tpu.timeline.carve import carve_session, render_segments_numpy

    base = generate(_config(), seed)
    edits = Edits(base, seed, 2)
    for desc in [base, edits[0].desc, edits[1].desc]:
        s = jax_session(desc)
        table, pool = carve_session(s, float(desc.sample_rate), buffer_size=desc.buffer_size,
                                    out_channels=desc.channels)
        want = render_segments_numpy(table, pool, s, desc.channels)
        ref = Reference(base, KIND).mixes([desc])[0]
        assert ref.shape == want.shape
        np.testing.assert_array_equal(ref, want)


def test_track_gains_match_the_jax_package():
    from whitebox_tpu.session.track import Track

    for tr in generate(_config(tracks=16), 5).tracks:
        jt = Track(volume_db=tr.volume_db, pan=tr.pan)
        want = np.array([jt.volume_linear * np.float32(jt.pan_coeffs[c]) for c in range(2)], np.float32)
        np.testing.assert_array_equal(KIND.track_gain(tr, 2), want)


@pytest.mark.parametrize("ftype", ["lowpass", "highpass", "bandpass", "notch", "allpass", "peak", "lowshelf",
                                   "highshelf"])
@pytest.mark.parametrize("freq, q, gain", [(25.0, 0.7071067811865476, 0.0), (100.0, 0.707, 2.0),
                                           (1000.0 + 37.0 * 127, 1.0, -1.5), (8000.0, 0.707, 1.0)])
def test_rbj_formulas_equal_the_jax_package(ftype, freq, q, gain):
    from whitebox_tpu.ops.biquad import design_biquad

    c = design_biquad(ftype, freq, 48000.0, q, gain)
    sos = rbj.design(ftype, freq, q, gain, 48000.0)
    np.testing.assert_array_equal(sos, [c.b0, c.b1, c.b2, 1.0, c.a1, c.a2])


def test_rbj_filter_matches_the_sequential_ground_truth():
    from whitebox_tpu.ops.biquad import biquad_sequential, design_biquad

    x = np.random.default_rng(0).standard_normal((2, 3000))
    bands = (("lowshelf", 100.0, 0.707, 2.0), ("peak", 1037.0, 1.0, -1.5))
    y = rbj.run(rbj.sections(bands, 48000.0), x)
    want = x
    for b in bands:
        want, _ = biquad_sequential(want, design_biquad(b[0], b[1], 48000.0, b[2], b[3]))
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-13)
