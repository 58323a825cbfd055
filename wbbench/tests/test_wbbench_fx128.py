"""The ``fx128`` configuration on the CPU: faults planted in the program's
dynamics ops make ``small_fx128.export`` come out not correct, and the
``by_group`` entry gives each track the chain that
``chip_smoke.py::generic_fx_128trk`` gives its group (track ``t`` in group
``t % 8`` here, ``t // 16`` there).

The faults are planted in ``whitebox_tpu_torch/ops/dynamics_cuda.py``'s
entries (the CPU's path to ``ops/dynamics.py``'s torch ops), never in the
reference: the compressor stage bypassed, the limiter's lookahead delay
dropped (the gain of the lookahead window on the audio as it comes), the
attack smoother skipped (an attack coefficient of 0).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import wbbench.run as run_mod
from wbbench.lib import chains, dynamics_count, roofline
from wbbench.lib.loop import Context, Unit
from wbbench.lib.rundata import RunData
from wbbench.lib.spec import load_cell, metric_reader, part
from wbbench.lib.trace import TraceData

ROOT = Path(__file__).resolve().parents[2]
SEED = 2147483929
CELL = "small_fx128.export"


@pytest.fixture(autouse=True)
def _no_guard(monkeypatch):
    """Other tests load the JAX package into this pytest process; the guard
    itself is tested in a process of its own (test_wbbench_guard)."""
    from wbbench.lib import guard

    monkeypatch.setattr(guard, "forbidden_modules", lambda modules=None: [])


def _bypassed(real):
    return lambda x, params, state, **kw: (x, state)


def _undelayed(real):
    def limiter(x, params, state, *, lookahead=0):
        return real(x, params, dict(state, xdelay=state["xdelay"][..., :0]), lookahead=lookahead)
    return limiter


def _no_attack(real):
    def ballistics(v, rho, a, e0, y0, floor=None, products=False):
        return real(v, rho, 0.0, e0, y0, floor, products)
    return ballistics


@pytest.mark.parametrize("target, fault", [("compressor", _bypassed), ("limiter", _undelayed),
                                           ("ballistics_reference", _no_attack)])
def test_planted_dynamics_fault_is_not_correct(small_bench, monkeypatch, target, fault):
    from whitebox_tpu_torch.ops import dynamics_cuda

    sound = run_mod.execute(CELL, SEED, 0.3, False, device="cpu", bench_path=small_bench / "bench.json",
                            base_dir=small_bench)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(dynamics_cuda, target, fault(getattr(dynamics_cuda, target)))
    res = run_mod.execute(CELL, SEED, 0.3, False, device="cpu", bench_path=small_bench / "bench.json",
                          base_dir=small_bench)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def _signature(effect) -> tuple:
    """An unprepared effect's class and settings."""
    return type(effect).__name__, {k: v for k, v in vars(effect).items() if k not in ("sample_rate", "coeffs")}


def test_by_group_resolves_config_6_chains():
    import chip_smoke

    with open(ROOT / "wbbench" / "configs" / "fx128.json") as f:
        cfg = json.load(f)
    session = chip_smoke.generic_fx_128trk(duration=1.0)
    program = part("program", "clips")
    for t, track in enumerate(session.tracks):
        mine = program.effect_chain(chains.resolve(cfg["track_chain"], t % 8 * 16 + t // 16))
        assert [_signature(e) for e in mine.effects] == [_signature(e) for e in track.effects.effects], t
    master = program.effect_chain(chains.resolve(cfg["master_chain"], 0))
    assert [_signature(e) for e in master.effects] == [_signature(e) for e in session.master_effects.effects]


def test_dynamics_readers_read_the_kernel(small_bench):
    """``dynamics_ms.export`` and ``dynamics_roofline`` on a made-up trace: the
    ``dyn_kernel`` launches' time against the count of the compressor rows and
    the master limiter's; nothing to read without such a kernel or a trace."""
    c = load_cell(CELL, small_bench / "bench.json", small_bench)
    loop = c.loop.Loop(Context(c.config, c.traffic, SEED, "cpu"))
    units = [Unit(0, 0.0, 1.0, 6.0), Unit(1, 1.0, 2.0, 6.0)]
    kernel = "void (anonymous namespace)::dyn_kernel<2, false>(WbDynArgs, (anonymous namespace)::Layout)"
    ops = [(kernel, 0.0, 300.0, "kernel"), ("void cascade_kernel<2>(Params)", 300.0, 900.0, "kernel"),
           (kernel.replace("<2,", "<3,"), 900.0, 1000.0, "kernel")]

    def run(trace):
        return RunData(cell=CELL, config=c.config, traffic=c.traffic, units=units, setup_s=1.0, traced=units,
                       trace=trace, loop=loop)

    traced = run(TraceData(ops=ops, start_us=0.0, end_us=2000.0))
    assert metric_reader("dynamics_ms.export")(traced) == pytest.approx(0.2)
    desc = loop.variant(0).desc
    n_bytes, n_ops = dynamics_count.count(desc, part("reference", "clips"))
    F = part("reference", "clips").Render(desc).frames
    compressed = sum(1 for tr in desc.tracks if tr.chain[0][1]["type"] == "compressor")
    assert compressed == 2 and n_bytes == (compressed + 1) * 8 * desc.channels * F and n_ops > 0
    least = sum(roofline.least_seconds(*dynamics_count.count(loop.variant(u.index).desc, part("reference", "clips")))
                for u in units)
    assert metric_reader("dynamics_roofline")(traced) == pytest.approx(100.0 * least / 400e-6)
    bare = run(TraceData(ops=ops[1:2], start_us=0.0, end_us=2000.0))
    for name in ("dynamics_ms.export", "dynamics_roofline"):
        assert metric_reader(name)(bare) is None
        assert metric_reader(name)(run(None)) is None
