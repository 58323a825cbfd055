"""The port's host-leg spans (``render/metrics.py::span``) on the CPU.

A span always times its block by the host clock and adds the seconds to
the legs of the call that collects them (``bounce``: ``RenderStats.host_legs``);
it opens a ``torch.profiler`` range only while a profiler records. Under a
profiler, ``bounce`` and ``render_stems`` emit their legs as
``user_annotation`` events nested under the call's own span, and the
finishers' per-stage ranges keep their names.
"""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from chip_smoke import add_midi_tracks
from whitebox_tpu_torch.effects import Biquad, Compressor, EffectChain, ParametricEQ
from whitebox_tpu_torch.render import metrics
from whitebox_tpu_torch.render.bounce import bounce
from whitebox_tpu_torch.render.demo import make_demo_session
from whitebox_tpu_torch.render.stems import render_stems
from whitebox_tpu_torch.timeline import pool

RATE = 48000.0


def _session(seed=3):
    return make_demo_session(n_tracks=2, duration_seconds=0.5, sample_rate=48000, seed=seed,
                             n_unique_samples=2, sample_seconds=0.25)


def _eq(seed=3):
    s = _session(seed)
    for t in s.tracks:
        t.effects = EffectChain([ParametricEQ([("lowshelf", 120.0, 0.707, 4.0), ("peak", 1500.0, 1.2, -3.0)])])
    s.master_effects = EffectChain([Biquad("highpass", 30.0)])
    return s


def _generic():
    s = add_midi_tracks(_session(), 1, 5, 0.5)
    s.tracks[0].effects = EffectChain([Compressor(-24.0, 4.0, attack_s=0.002, release_s=0.05)])
    s.master_effects = EffectChain([Biquad("highpass", 30.0)])
    return s


def _routed():
    s = _generic()
    s.add_bus("bus", effects=EffectChain([Biquad("lowpass", 3000.0)]))
    s.set_track_output(1, 0)
    s.add_send(0, 0, gain_db=-6.0)
    return s


def _trace(fn, tmp_path) -> list:
    """``(name, start, end)`` of each ``wb.`` range that ``fn()`` opened
    under a CPU profiler, read from the Chrome trace as a viewer reads it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("wb."))


def _parents(spans) -> list:
    """``(name, innermost enclosing span's name or None)`` of each span."""
    out = []
    for name, s, e in spans:
        enclosing = [(s2, n2) for n2, s2, e2 in spans if (s2, e2) != (s, e) and s2 <= s and e <= e2]
        out.append((name, max(enclosing)[1] if enclosing else None))
    return out


@pytest.fixture(autouse=True)
def _fresh_pool_cache(monkeypatch):
    monkeypatch.setattr(pool, "_POOL_CACHE", {})


def test_span_opens_no_range_unless_a_profiler_records(monkeypatch):
    opened = []
    real = metrics.record_function
    monkeypatch.setattr(metrics, "record_function", lambda name: opened.append(name) or real(name))
    legs = {}
    with metrics.collect_legs(legs):
        with metrics.span("wb.x") as sp:
            assert sp.elapsed() >= 0
        res = bounce(_routed(), RATE, device="cpu")  # every range of the routed and generic finishers
    assert opened == []
    # the bounce collects its own legs; the enclosing collector sees the call
    assert legs == {"wb.x": sp.seconds, "wb.bounce": legs["wb.bounce"]} and sp.seconds >= 0
    assert {"wb.gains", "wb.synth", "wb.track.compressor"} <= set(res.stats.host_legs)
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("wb.x"):
            pass
    assert opened == ["wb.x"]


@pytest.mark.parametrize("path", ["bounce", "stems"])
def test_export_emits_its_legs_nested(path, tmp_path):
    s = _eq()
    export = bounce if path == "bounce" else render_stems
    call = lambda: export(s, RATE, device="cpu")  # noqa: E731
    top = f"wb.{path}"
    legs = {"wb.carve": top, "wb.pool.flatten": "wb.carve", "wb.plan": top, "wb.upload": top,
            "wb.fx.prepare": top, "wb.mix": top, "wb.readback": top, top: None,
            "wb.finish": "wb.mix" if path == "bounce" else top}
    got = _parents(_trace(call, tmp_path))
    assert set(got) == set(legs.items())
    assert [n for n, _ in got].count(top) == 1
    # the pool of the unchanged session comes from the cache: no flatten
    again = dict(_parents(_trace(call, tmp_path)))
    assert "wb.pool.flatten" not in again and again["wb.carve"] == top


def test_host_legs_split_the_host_time():
    st = bounce(_eq(), RATE, device="cpu").stats
    legs = st.host_legs
    assert set(legs) == {"wb.carve", "wb.pool.flatten", "wb.plan", "wb.upload", "wb.fx.prepare", "wb.mix",
                         "wb.finish", "wb.readback"}
    assert all(v >= 0 for v in legs.values())
    assert legs["wb.pool.flatten"] <= legs["wb.carve"] and legs["wb.finish"] <= legs["wb.mix"]
    assert legs["wb.readback"] == st.readback_seconds
    # the legs that nest in no other leg: the host legs lie inside carve_seconds
    outer = sum(v for k, v in legs.items() if k not in ("wb.pool.flatten", "wb.finish"))
    assert outer <= st.carve_seconds + legs["wb.mix"] + st.readback_seconds
    assert "host legs pool.flatten" in st.summary()


@pytest.mark.parametrize("path, names", [
    ("generic", {"wb.synth", "wb.track.compressor", "wb.master.biquad", "wb.gains_sum"}),
    ("routed", {"wb.synth", "wb.track.compressor", "wb.bus.biquad", "wb.gains", "wb.route.matmul",
                "wb.bus.fader", "wb.master.biquad"}),
])
def test_finisher_ranges_keep_their_names(path, names, tmp_path):
    s = _generic() if path == "generic" else _routed()
    got = _parents(_trace(lambda: bounce(s, RATE, device="cpu"), tmp_path))
    assert names <= {n for n, _ in got}
    assert {p for n, p in got if n in names - {"wb.synth"}} == {"wb.finish"}
