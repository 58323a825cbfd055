"""Fixtures of the benchmark's CPU tests: a small copy of the benchmark's
cells (4 tracks of 6 s, 16 assets of 1 s; the same kinds of session,
chains, loops and limits as the real cells), run through the same harness
on the CPU.

The small copy of cell ``w`` is ``small_<w>``, of configuration ``c``
``small_<c>``. Beside the cells of ``BENCHMARK.json`` it holds every pair
of a configuration and a traffic mix that has a limits file but no cell
(a cell built and left out, whose files stay for a later PR), reporting
``setup_s`` alone.

Run them from the repository root: ``python -m pytest wbbench/tests -q``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "wbbench"
#: the small configuration each real one becomes
SMALL = {"tracks": 4, "seconds": 6.0, "assets": 16, "asset_seconds": 1.0}


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def small(name: str) -> str:
    return f"small_{name}"


def all_cells() -> list:
    """The cells of ``BENCHMARK.json``, and a cell for each pair of a
    configuration and a traffic mix with a limits file (``<c>.<m>``) but no cell."""
    bench = _load(ROOT / "BENCHMARK.json")
    cells = list(bench["workloads"])
    have = {w["name"] for w in cells}
    for c in bench["configs"]:
        for t in sorted((BENCH / "traffic").glob("*.json")):
            name = f"{c['name']}.{t.stem}"
            if name not in have and (BENCH / "limits" / f"{name}.json").exists():
                cells.append({"name": name, "config": c["name"], "traffic": t.stem, "chips": 1, "why": "left out"})
    return cells


def small_cells() -> list:
    return [small(w["name"]) for w in all_cells()]


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory) -> Path:
    """A directory holding ``bench.json``, ``configs/``, ``traffic/`` and
    ``limits/`` of the small cells: the real limits, the real traffic with
    two variants and the first two exports checked."""
    d = tmp_path_factory.mktemp("small_bench")
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    bench = _load(ROOT / "BENCHMARK.json")
    small_cfgs = []
    for c in bench["configs"]:
        cfg = _load(ROOT / c["file"])
        cfg.update(SMALL, name=small(c["name"]))
        path = d / "configs" / f"{small(c['name'])}.json"
        path.write_text(json.dumps(cfg))
        small_cfgs.append({**c, "name": small(c["name"]), "file": str(path)})
    for p in (BENCH / "traffic").glob("*.json"):
        t = _load(p)
        if "variants" in t:
            t.update(variants=2, check_exports=2, check_among=2, warm=1)
        (d / "traffic" / p.name).write_text(json.dumps(t))
    workloads = []
    for w in all_cells():
        workloads.append({**w, "name": small(w["name"]), "config": small(w["config"])})
        (d / "limits" / f"{small(w['name'])}.json").write_text((BENCH / "limits" / f"{w['name']}.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [small(w) for w in m["workloads"]]
    bench.update(configs=small_cfgs, workloads=workloads)
    (d / "bench.json").write_text(json.dumps(bench))
    return d
