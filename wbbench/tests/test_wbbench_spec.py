"""Discovery by name: every cell of ``BENCHMARK.json`` finds its
configuration, kind of session, loop, limits and metric readers as files of
their own, and a new cell, loop or effect comes in as new files alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from wbbench.lib import roofline, spec
from wbbench.lib.check import Reference

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
#: every reader, those of cells left out of the benchmark too
METRICS = sorted({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
                 | {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")})


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert hasattr(c.loop, "Loop")
    for folder in ("sessions", "program", "reference"):
        assert spec.part(folder, c.config["session"])
    assert c.limits and set(c.limits) <= {"max_abs_err", "rel_rms_err", "max_ulp_err"}
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(spec.metric_reader(name))


@pytest.mark.parametrize("name", ["export_rtf", "host_prep_ms.export", "a-b_c.d", "0x"])
def test_names_pass(name):
    assert spec.check_name(name) == name


@pytest.mark.parametrize("name", ["", "../x", "a/b", "a b", ".hidden", "x" * 65, "é"])
def test_names_refused(name):
    with pytest.raises(ValueError):
        spec.check_name(name)


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's folder that the harness finds its files in."""
    d = tmp_path / "wbbench"
    shutil.copytree(spec.BENCH_DIR, d, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    monkeypatch.setattr(spec, "BENCH_DIR", d)
    return d


def test_a_new_cell_needs_only_new_files(bench_copy):
    """A cell added by files and entries alone: a new configuration file,
    traffic file, loop, limits file and metric reader, found by name."""
    cfg = json.loads((ROOT / "wbbench/configs/mix128.json").read_text())
    cfg.update(name="mix64", tracks=64)
    (bench_copy / "configs" / "mix64.json").write_text(json.dumps(cfg))
    (bench_copy / "traffic" / "ping.json").write_text(json.dumps({"loop": "ping", "every": 4}))
    (bench_copy / "loops" / "ping.py").write_text('"""A loop."""\n\n\nclass Loop:\n    deliverable = "mix"\n')
    (bench_copy / "limits" / "mix64.ping.json").write_text(json.dumps({"max_abs_err": 0.0}))
    (bench_copy / "metrics" / "pings.py").write_text('"""A reader."""\n\n\ndef read(run):\n    return 1.0\n')
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{"name": "mix64", "source": "s",
                                            "file": str(bench_copy / "configs" / "mix64.json"),
                                            "reduced": [], "why": "w"}]
    bench["workloads"] = BENCH["workloads"] + [{"name": "mix64.ping", "config": "mix64", "traffic": "ping",
                                                "chips": 1, "why": "w"}]
    (bench_copy / "bench.json").write_text(json.dumps(bench))
    c = spec.load_cell("mix64.ping", bench_copy / "bench.json", bench_copy)
    assert c.config["tracks"] == 64 and c.traffic["every"] == 4
    assert c.loop.Loop.deliverable == "mix"
    assert spec.metric_reader("pings")(None) == 1.0
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]


GAIN = '''"""A plain gain, for the test."""


def resolve(params, track):
    return dict(params)


def process(params, x, state, sample_rate):
    return x * params["factor"], state


def ops_per_frame(params):
    return 1
'''


def test_a_new_effect_needs_only_new_files(bench_copy):
    """A chain entry of a type no configuration uses yet, by its reference
    file alone: the generator resolves it, the reference runs it, the
    roofline counts it."""
    (bench_copy / "reference" / "fx" / "gain.py").write_text(GAIN)
    cfg = json.loads((ROOT / "wbbench/configs/mix128.json").read_text())
    cfg.update(tracks=3, seconds=6.0, assets=6, asset_seconds=1.0)
    kinds = spec.part("sessions", cfg["session"])
    kind = spec.part("reference", cfg["session"])
    plain = kinds.generate(cfg, 11)
    halved = kinds.generate({**cfg, "track_chain": [{"type": "gain", "factor": 0.5}]}, 11)
    assert halved.tracks[0].chain == (("gain", {"factor": 0.5}),)
    want = Reference(plain, kind).mixes([plain])[0].astype(np.float64) * 0.5
    got = Reference(halved, kind).mixes([halved])[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    _, ops_plain = roofline.count(plain, "mix", kind)
    _, ops_halved = roofline.count(halved, "mix", kind)
    render = kind.Render(plain)
    F, C = render.frames, plain.channels
    played = [render.work(plain, t)[1] for t in range(len(plain.tracks))]
    # each track's rows run over every frame, with one more operation a row and frame
    assert ops_halved - ops_plain == sum(C * F * 1 + C * (F - p) * 2 for p in played)
