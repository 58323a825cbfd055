"""The port's ``render/cached.py::SessionRenderCache`` against the JAX
package's and the NumPy segment reference (CPU).

The cases of ``tests/test_render_cache.py`` on the port: an unchanged
re-render reuses the resident renderer; any edit (direct field mutations
included) rebuilds; the pool on the device survives edits that keep the
asset set and is dropped by one that adds an asset; an automation-only
session takes the automation variant; sessions with effects, routing or
MIDI raise. Speed-1 renders are bit-equal to the JAX package's cache and
to ``render_segments_numpy``; linear-resampled ones within 2 ulp or
2.4e-7 of the JAX package's (its interpret-mode lerp may fuse) and
bit-equal to the NumPy reference. The JAX cache renders once per case, in
a module fixture (one Pallas interpret-mode compile per shape).
"""

import numpy as np
import pytest
import torch

from tests.test_carve import random_session
from tests.test_torch_mix import assert_ulp_contract
from whitebox_tpu.core.formats import AudioFormat
from whitebox_tpu.render.cached import SessionRenderCache as JaxCache
from whitebox_tpu_torch.ops.automation import AutomationLane, TrackAutomation
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.cached import SessionRenderCache
from whitebox_tpu_torch.session.convert import from_reference
from whitebox_tpu_torch.session.sample import Sample
from whitebox_tpu_torch.timeline.carve import carve_session, render_segments_numpy

RATE = 48000.0


def _plain(seed=3):
    return random_session(seed, rate=RATE, bpm=120.0, n_tracks=3, formats=(AudioFormat.F32,), n_clips=2)


def _resampled():
    return random_session(9, rate=RATE, bpm=120.0, n_tracks=3, n_clips=2,
                          speeds=(1.0, 0.5, 1.088435374149660), src_rates=(44100.0,))


def _numpy_render(s):
    t, p = carve_session(s, RATE, buffer_size=512, slow_emit="runs")
    return render_segments_numpy(t, p, s)


def _cache(s):
    return SessionRenderCache(s, RATE, device="cpu")


@pytest.fixture(scope="module")
def jax_renders():
    return {"plain": JaxCache(_plain(), RATE).render(), "resampled": JaxCache(_resampled(), RATE).render()}


def test_unchanged_session_reuses_renderer(jax_renders):
    s = from_reference(_plain())
    cache = _cache(s)
    r1 = cache.renderer()
    out = cache.render()
    assert cache.renderer() is r1  # no rebuild without an edit
    np.testing.assert_array_equal(out, jax_renders["plain"])
    np.testing.assert_array_equal(out, _numpy_render(s))
    dev = cache.render_device()
    assert dev.shape == (2, r1.plan.n_tiles * r1.plan.tile) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev[:, :out.shape[1]].numpy(), out)


def test_resampled_session_meets_contract(jax_renders):
    s = from_reference(_resampled())
    out = _cache(s).render()
    assert_ulp_contract(out, jax_renders["resampled"])
    np.testing.assert_array_equal(out, _numpy_render(s))


def test_direct_field_edit_invalidates():
    s = from_reference(_plain(4))
    cache = _cache(s)
    r1 = cache.renderer()
    before = cache.render()
    s.tracks[0].clips[0].audio.gain *= 0.5  # direct mutation, no API
    r2 = cache.renderer()
    assert r2 is not r1
    after = cache.render()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, _numpy_render(s))


def test_pool_survives_non_asset_edit():
    s = from_reference(_plain(5))
    cache = _cache(s)
    cache.render()
    dev = cache._pool_dev
    s.tracks[1].volume_db = -4.5
    np.testing.assert_array_equal(cache.render(), _numpy_render(s))
    assert cache._pool_dev is dev  # big upload reused


def test_new_asset_edit_rebuilds_pool():
    s = from_reference(random_session(6, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,),
                                      n_clips=1))
    cache = _cache(s)
    cache.render()
    dev = cache._pool_dev
    data = (np.sin(np.linspace(0, 40, 3000)) * 0.4).astype(np.float32)[None]
    a = s.sample_table.add_sample(Sample.from_planar(data, int(RATE), AudioFormat.F32, name="new"), key="new")
    s.add_audio_clip(s.tracks[0], "n", 12.0, 13.0, asset=a)
    out = cache.render()  # must not KeyError on the stale pool
    assert cache._pool_dev is not dev
    np.testing.assert_array_equal(out, _numpy_render(s))


def test_automation_only_session_uses_the_automation_variant():
    s = from_reference(random_session(7, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,),
                                      n_clips=2))
    s.tracks[0].automation = TrackAutomation(volume=AutomationLane().add(0.0, 1.0).add(3.0, 0.3))
    cache = _cache(s)
    out = cache.render()
    assert cache.renderer().auto is not None
    ref = bounce(s, RATE, device="cpu", engine="pallas").audio
    n = min(out.shape[1], ref.shape[1])
    np.testing.assert_array_equal(out[:, :n], ref[:, :n])
    # editing the lane (direct mutation) invalidates: a zero point at
    # beat 0.5 silences early material, so the render MUST change
    s.tracks[0].automation.volume.add(0.5, 0.0)
    out2 = cache.render()
    assert not np.array_equal(out, out2)
    np.testing.assert_array_equal(out2[:, :n], bounce(s, RATE, device="cpu", engine="pallas").audio[:, :n])


def _with_effects(s):
    from whitebox_tpu_torch.effects import Biquad, EffectChain

    s.tracks[0].effects = EffectChain([Biquad("lowpass", 4000.0)])


def _with_routing(s):
    s.add_bus("b")
    s.set_track_output(0, 0)


def _with_midi(s):
    from whitebox_tpu_torch.midi.notes import MidiNote, MidiNoteBuffer

    s.add_midi_clip(s.tracks[0], "m", 0.0, 2.0,
                    asset=s.midi_table.create_midi(MidiNoteBuffer([MidiNote(0.0, 1.0, key=60, velocity=0.8)])))


@pytest.mark.parametrize("edit", [_with_effects, _with_routing, _with_midi], ids=["effects", "routing", "midi"])
def test_out_of_scope_sessions_raise(edit):
    s = from_reference(random_session(8, rate=RATE, bpm=120.0, n_tracks=2, formats=(AudioFormat.F32,),
                                      n_clips=1))
    edit(s)
    with pytest.raises(ValueError, match="render.bounce"):
        _cache(s).render()


@pytest.mark.parametrize("entry", ["cache", "preview", "stream"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """``device=None`` is the CUDA card: with none, each entry point raises
    ``resolve_device``'s error instead of rendering on the CPU."""
    from whitebox_tpu_torch.render.preview import PreviewStream
    from whitebox_tpu_torch.render.stream_pool import bounce_streamed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = from_reference(_plain())
    call = {"cache": lambda: SessionRenderCache(s, RATE), "preview": lambda: PreviewStream(s, RATE),
            "stream": lambda: bounce_streamed(s, RATE)}[entry]
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        call()
