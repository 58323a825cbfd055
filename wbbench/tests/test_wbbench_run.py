"""The harness end to end on the CPU at a small size: sound runs come out
correct with every metric they report; the bfloat16 control and a broken
timed path come out not correct against the cells' own limits.

The faults are planted in what the window calls (the program's entry in
``loops/<loop>.py``), never in the reference: an export or pull that returns its earlier result
unchanged, half the tracks left out, one answer altered where it is made.
The cells run on one card, so there is no exchange between cards to leave
out. The card itself is needed only by ``test_run_on_the_card``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import wbbench.run as run_mod
from conftest import small_cells
from wbbench.lib.check import judge
from wbbench.lib.loop import Context
from wbbench.lib.rundata import RunData
from wbbench.lib.spec import load_cell, metric_reader

ROOT = Path(__file__).resolve().parents[2]
SEED = 2147483917
SMALL_CELLS = small_cells()


@pytest.fixture(autouse=True)
def _no_guard(monkeypatch):
    """The ground-truth tests load the JAX package into this pytest process;
    the guard itself is tested in a process of its own (test_wbbench_guard)."""
    from wbbench.lib import guard

    monkeypatch.setattr(guard, "forbidden_modules", lambda modules=None: [])


def _execute(small_bench, cell, trace=False, seconds=0.3):
    return run_mod.execute(cell, SEED, seconds, trace, device="cpu", bench_path=small_bench / "bench.json",
                           base_dir=small_bench)


@pytest.mark.parametrize("cell", SMALL_CELLS)
def test_sound_run_is_correct(small_bench, cell):
    res = _execute(small_bench, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    c = load_cell(cell, small_bench / "bench.json", small_bench)
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(res)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("cell", ["small_eq128.export", "small_eq128.preview"])
def test_traced_run_reports_its_layers(small_bench, cell):
    res = _execute(small_bench, cell, trace=True)
    assert res["correct"]
    assert "window_s" in res["device"] and "breakdown" in res
    # on the CPU nothing runs on a device: the device-trace metrics have nothing to read
    host = {"host_prep_ms.export", "mix_kernel_ms.export", "finisher_ms.export", "pull_median_ms.preview",
            "render_roofline"}
    c = load_cell(cell, small_bench / "bench.json", small_bench)
    assert {m["name"] for m in c.per_layer} & host <= set(res["metrics"])


def _window(small_bench, cell, seconds=0.3, trace=False):
    c = load_cell(cell, small_bench / "bench.json", small_bench)
    loop = c.loop.Loop(Context(c.config, c.traffic, SEED, "cpu"))
    loop.warm()
    tracer = None
    if trace:
        from wbbench.lib.trace import Tracer

        tracer = Tracer()
    return c, loop, loop.run(seconds, tracer)


@pytest.mark.parametrize("cell", SMALL_CELLS)
def test_bf16_control_is_not_correct(small_bench, cell):
    c, loop, w = _window(small_bench, cell)
    readings = loop.check(w, tuple(c.limits), control=True)
    worst, failed = judge(readings, c.limits)
    assert failed == len(readings) > 0, worst


def test_preview_metrics_read_the_pulls(small_bench):
    """The preview's readers (its cell is left out of ``BENCHMARK.json``) on a traced small window."""
    c, loop, w = _window(small_bench, "small_eq128.preview", trace=True)
    run = RunData(cell=c.name, config=c.config, traffic=c.traffic, units=w.units, setup_s=1.0, traced=w.traced,
                  trace=w.trace, loop=loop)
    assert metric_reader("preview_pull_p99_ms")(run) >= metric_reader("pull_median_ms.preview")(run) > 0
    # on the CPU no kernel runs: the device reader has nothing to read
    assert metric_reader("window_device_ms.preview")(run) is None


def _stale(fn):
    """Every call after the first returns the first call's result."""
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        out, st = first[0]
        return out.copy(), st
    return wrapped


def _half(fn):
    """The odd tracks left out of the render (muted while it runs)."""
    def wrapped(session, *a, **k):
        odd = session.tracks[1::2]
        for tr in odd:
            tr.mute = True
        try:
            return fn(session, *a, **k)
        finally:
            for tr in odd:
                tr.mute = False
    return wrapped


def _alteration(limits) -> float:
    """Twice the cell's ``max_abs_err`` limit, or 1e-3 where it compares ulps."""
    return 2 * limits["max_abs_err"] if "max_abs_err" in limits else 1e-3


def _altered(fn, by):
    """One sample of every answer moved by ``by``."""
    def wrapped(*a, **k):
        out, st = fn(*a, **k)
        out = out.copy()
        out[(0,) * (out.ndim - 1) + (out.shape[-1] // 2,)] += by
        return out, st
    return wrapped


class _StaleStream:
    """A stream whose every fourth pull returns the block before it again."""

    def __init__(self, inner):
        self.inner, self.last, self.n = inner, None, 0

    def next_block(self):
        self.n += 1
        if self.last is not None and self.n % 4 == 0:
            self.inner.next_block()
            return self.last.copy()
        self.last = self.inner.next_block()
        return self.last


class _AlteredStream(_StaleStream):
    def __init__(self, inner, by):
        super().__init__(inner)
        self.by = by

    def next_block(self):
        b = self.inner.next_block()
        if b is not None:
            b = b.copy()
            b[0, 100] += self.by
        return b


def _one_track_altered(fn, by):
    """One sample of the last track's stem moved by ``by``."""
    def wrapped(*a, **k):
        out, st = fn(*a, **k)
        out = out.copy()
        out[-1, 0, out.shape[-1] // 2] += by
        return out, st
    return wrapped


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in ["small_eq128.export", "small_mix128.export", "small_eq128.stems"]
    for fault in ["stale", "half", "altered"]] + [("small_eq128.stems", "one_track")])
def test_broken_export_is_not_correct(small_bench, monkeypatch, cell, fault):
    c = load_cell(cell, small_bench / "bench.json", small_bench)
    loop = c.loop
    by = _alteration(c.limits)
    wrap = {"stale": _stale, "half": _half, "altered": lambda f: _altered(f, by),
            "one_track": lambda f: _one_track_altered(f, by)}[fault]
    monkeypatch.setattr(loop, "export", wrap(loop.export))
    res = _execute(small_bench, cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_preview_is_not_correct(small_bench, monkeypatch, fault):
    c = load_cell("small_eq128.preview", small_bench / "bench.json", small_bench)
    limits, loop = c.limits, c.loop
    make = loop.stream

    def patched(session, *a, **k):
        if fault == "half":
            for tr in session.tracks[1::2]:
                tr.mute = True
        s = make(session, *a, **k)
        if fault == "stale":
            return _StaleStream(s)
        if fault == "altered":
            return _AlteredStream(s, _alteration(limits))
        return s

    monkeypatch.setattr(loop, "stream", patched)
    res = _execute(small_bench, "small_eq128.preview")
    assert not res["correct"], res["checks"]


def test_rates_follow_the_units(small_bench):
    res = _execute(small_bench, "small_mix128.export")
    assert res["metrics"]["export_rtf"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result():
    """Without a CUDA card the command exits with another code than 0 and prints nothing on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "wbbench/run.py", "--workload", "eq128.export", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_run_on_the_card():
    """One short run of a cell on the card: exit 0 and a correct result line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    out = subprocess.run([sys.executable, "wbbench/run.py", "--workload", "mix128.export", "--seed", "5",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["export_rtf"]["value"])
