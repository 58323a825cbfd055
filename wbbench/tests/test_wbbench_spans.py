"""The readers of the program's host-leg spans (``lib/spans.py`` and the
five ``metrics/*_ms.export.py`` that use it), on synthetic traces worked
by hand, and on a traced small run of each cell that lists them."""

from __future__ import annotations

import pytest

import wbbench.run as run_mod
from wbbench.lib.loop import Unit
from wbbench.lib.rundata import RunData
from wbbench.lib.spans import self_seconds
from wbbench.lib.spec import metric_reader
from wbbench.lib.trace import TraceData

SEED = 2147483923
READERS = ("pool_flatten_ms.export", "carve_ms.export", "plan_ms.export", "upload_ms.export",
           "fx_prep_ms.export")


def _run(spans, exports=2):
    """A traced run of ``exports`` exports whose trace holds ``spans`` ((name, start_us, end_us))."""
    units = [Unit(i, float(i), i + 0.9, 180.0) for i in range(exports)]
    return RunData(cell="c", config={}, traffic={}, units=units, setup_s=1.0, traced=units,
                   trace=TraceData(spans=list(spans), start_us=0.0, end_us=2e6))


# two exports: the first flattens its pool inside its carve, the second finds it cached
SPANS = [("wb.window", 0, 2_000_000),
         ("wb.bounce", 0, 900_000), ("wb.carve", 10_000, 610_000), ("wb.pool.flatten", 50_000, 550_000),
         ("wb.plan", 610_000, 630_000), ("wb.upload", 630_000, 700_000), ("wb.fx.prepare", 700_000, 740_000),
         ("wb.bounce", 1_000_000, 1_300_000), ("wb.carve", 1_010_000, 1_070_000),
         ("wb.plan", 1_070_000, 1_080_000), ("wb.upload", 1_080_000, 1_150_000),
         ("wb.fx.prepare", 1_150_000, 1_200_000)]


def test_self_time_leaves_out_the_nested_span():
    # carves of 600 ms and 60 ms, 500 ms of flatten inside the first
    assert self_seconds(SPANS, "wb.carve", minus=("wb.pool.flatten",)) == pytest.approx(0.16)
    assert self_seconds(SPANS, "wb.carve") == pytest.approx(0.66)
    # overlapping children count once; a child reaching past its parent is clipped
    spans = [("p", 0, 100), ("c", 10, 40), ("c", 30, 60), ("c", 90, 150)]
    assert self_seconds(spans, "p", minus=("c",)) == pytest.approx(40e-6)  # 100 less [10, 60] and [90, 100]


@pytest.mark.parametrize("name, want", [
    ("pool_flatten_ms.export", 250.0),  # 500 ms in the first export, 0 in the second
    ("carve_ms.export", 80.0),  # (100 + 60) / 2
    ("plan_ms.export", 15.0),
    ("upload_ms.export", 70.0),
    ("fx_prep_ms.export", 45.0),
])
def test_readers_give_the_mean_per_traced_export(name, want):
    assert metric_reader(name)(_run(SPANS)) == pytest.approx(want)
    # the same spans over four traced exports: half the mean
    assert metric_reader(name)(_run(SPANS, exports=4)) == pytest.approx(want / 2)


def test_an_export_without_a_flatten_reads_zero():
    cached = [sp for sp in SPANS if sp[0] != "wb.pool.flatten"]
    assert metric_reader("pool_flatten_ms.export")(_run(cached)) == 0.0
    assert metric_reader("carve_ms.export")(_run(cached)) == pytest.approx(330.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    untraced = _run(SPANS)
    untraced.trace = None
    assert metric_reader(name)(untraced) is None
    assert metric_reader(name)(_run(SPANS, exports=0)) is None
    # a program without spans: only the benchmark's own in the trace
    assert metric_reader(name)(_run([("wb.window", 0, 2_000_000), ("export.call", 0, 900_000)])) is None


@pytest.mark.parametrize("cell, names", [
    ("small_eq128.export", READERS),
    ("small_mix128.export", READERS[:4]),
    ("small_eq128.stems", READERS),
])
def test_traced_small_run_reports_the_host_legs(small_bench, monkeypatch, cell, names):
    from wbbench.lib import guard

    monkeypatch.setattr(guard, "forbidden_modules", lambda modules=None: [])
    res = run_mod.execute(cell, SEED, 0.3, True, device="cpu", bench_path=small_bench / "bench.json",
                          base_dir=small_bench)
    assert res["correct"]
    got = {n: res["metrics"][n]["value"] for n in names}
    assert all(v >= 0 for v in got.values()) and got["carve_ms.export"] > 0
    assert set(res["metrics"]) & set(READERS) == set(names)
