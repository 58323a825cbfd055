"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``c``: ``configs/<c>.json`` (the ``file`` of its entry); its
  ``"session"`` names the kind of session it describes, ``k``:
  ``sessions/<k>.py`` (the description from the seed, and its edits),
  ``program/<k>.py`` (the program's session of a description) and
  ``reference/<k>.py`` (the plain per-track render of a description);
- a chain entry's ``"type"`` ``e`` in a configuration: ``program/fx/<e>.py``
  (the program's effect) and ``reference/fx/<e>.py`` (its plain reference
  and its count of operations);
- a traffic mix ``m``: ``traffic/<m>.json``, parameters; its ``"loop"`` ``l``
  names ``loops/<l>.py``, the set-up, window and check that read them;
- the limits of a cell ``w``: ``limits/<w>.json``, each compared number with
  its limit (``lib/check.py``);
- a metric ``n`` (end-to-end or per-layer): ``metrics/<n>.py``, whose
  ``read(run)`` returns the value or None when the run holds nothing to read.

Adding a cell, configuration, kind of session, effect, mix, loop or metric
adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_MODULES: dict = {}


def check_name(name: str) -> str:
    """``name`` if it is a benchmark name (letters, digits, ``_``, ``.``, ``-``); raises otherwise."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark by path, loaded once (names may hold
    dots and dashes, so not by import)."""
    path = Path(path).resolve()
    if path not in _MODULES:
        modname = f"wbbench_file_{re.sub(r'[^A-Za-z0-9_]', '_', name)}_{len(_MODULES)}"
        spec = importlib.util.spec_from_file_location(modname, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod  # dataclasses look their module up there
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def part(folder: str, name: str):
    """``wbbench/<folder>/<name>.py``: a loop, a kind of session's generator,
    program side or reference, or an effect's program side or reference."""
    return load_module(BENCH_DIR / folder / f"{check_name(name)}.py", f"{folder}/{name}")


def metric_reader(name: str):
    return part("metrics", name).read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end

    @property
    def loop(self):
        """The module of the cell's loop (``loops/<traffic's loop>.py``)."""
        return part("loops", self.traffic["loop"])


def load_cell(workload: str, bench_path: Path | None = None, base_dir: Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or ``bench_path``) with its
    configuration, traffic mix (``<base_dir>/traffic``), limits
    (``<base_dir>/limits``) and the metrics it reports."""
    base_dir = base_dir or BENCH_DIR
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(base_dir / "traffic" / f"{check_name(w['traffic'])}.json")
    limits = load_json(base_dir / "limits" / f"{check_name(workload)}.json")
    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)], limits=limits)
