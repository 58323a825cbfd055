"""The JAX import guard, and the reference's imports."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from wbbench.lib.guard import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("whitebox_tpu", True), ("whitebox_tpu.timeline.oracle", True),
    ("whitebox_tpu_torch", False), ("whitebox_tpu_torch.render.bounce", False), ("jaxtyping", False),
    ("numpy", False), ("torch", False), ("wbbench.lib.guard", False),
])
def test_guard_compares_whole_top_level_names(name, bad):
    assert forbidden_modules({name: None, "numpy": None}) == ([name] if bad else [])


def test_the_harness_and_the_entry_points_load_no_forbidden_module():
    code = ("import wbbench.run, wbbench.lib.loop, wbbench.lib.check, wbbench.lib.trace, wbbench.lib.chains\n"
            "from wbbench.lib.spec import BENCH_DIR, part\n"
            "for folder in ('loops', 'sessions', 'program', 'program/fx', 'reference', 'reference/fx', 'metrics'):\n"
            "    for p in sorted((BENCH_DIR / folder).glob('*.py')):\n"
            "        if p.stem != '__init__':\n"
            "            part(folder, p.stem)\n"
            "import whitebox_tpu_torch.render.bounce, whitebox_tpu_torch.render.stems\n"
            "import whitebox_tpu_torch.render.preview\n"
            "from wbbench.lib.guard import forbidden_modules\n"
            "print(','.join(forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


#: the reference's code: its folder, and the harness files it runs through
REFERENCE = sorted(BENCH.glob("reference/**/*.py")) + [BENCH / "lib" / "check.py", BENCH / "lib" / "chains.py"]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_neither_jax_nor_either_package(path):
    assert not _imports(path) & (FORBIDDEN | {"whitebox_tpu_torch"})


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
