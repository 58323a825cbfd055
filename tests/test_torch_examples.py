"""The port's examples (``examples/torch_*.py``) on the CPU.

Each runs as a script with ``--device cpu`` in a fresh process and must
reach its end with its own assertions holding. The ``slow`` cases hold
``torch_mixdown`` and ``torch_tempo_ramp`` against their JAX originals
(``examples/mixdown.py``, ``examples/tempo_ramp.py``), run in this process
with ``bounce`` wrapped to keep each render: ``tempo_ramp``'s mix within
3.0e-8 (max abs); ``mixdown``'s F32 mix before the dither within 1e-6 (max
abs) and its dithered I16 file within 1 LSB. They are slow because the
JAX examples compile their scans and take tens of seconds on a CPU.
"""

import importlib.util
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

#: example -> (arguments besides --device, lines its output must hold)
EXAMPLES = {
    "torch_mixdown": (["out.wav"], ["rendered 192000 frames", "loudness: I -14.00 LUFS"]),
    "torch_tempo_ramp": (["ramp.wav"], ["drop lands at 8.0855 s", "wrote "]),
    "torch_extending": ([], ["custom-effect render:", "recorded take: 10240 frames",
                             "post-punch-in render:"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_port_example_runs_on_cpu(name, tmp_path):
    args, want = EXAMPLES[name]
    r = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"),
                        *[str(tmp_path / a) for a in args], "--device", "cpu"],
                       cwd=tmp_path, env={**os.environ, "TMPDIR": str(tmp_path)},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    for line in want:
        assert line in r.stdout, r.stdout
    for a in args:
        assert (tmp_path / a).stat().st_size > 44


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_keeping_renders(path: Path, out: Path, **kw) -> list:
    """Run the example at ``path`` writing ``out``; -> the results of the
    ``bounce`` calls it made."""
    mod = _load(path, f"_example_{path.stem}")
    kept, inner = [], mod.bounce

    def bounce(*a, **k):
        kept.append(inner(*a, **k))
        return kept[-1]

    mod.bounce = bounce
    mod.main(str(out), **kw)
    return kept


def _i16(path: Path) -> np.ndarray:
    with wave.open(str(path)) as w:
        assert w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.int32)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["mixdown", "tempo_ramp"])
def test_port_example_matches_jax_original(name, tmp_path):
    jax_res = _run_keeping_renders(REPO / "examples" / f"{name}.py", tmp_path / "jax.wav")
    port_res = _run_keeping_renders(REPO / "examples" / f"torch_{name}.py", tmp_path / "port.wav",
                                    device="cpu")
    assert len(jax_res) == len(port_res) == 1
    a, b = np.asarray(jax_res[0].audio, np.float64), np.asarray(port_res[0].audio, np.float64)
    assert a.shape == b.shape
    d = float(np.abs(a - b).max())
    if name == "tempo_ramp":
        assert d <= 3.0e-8, d
    else:
        assert d <= 1e-6, d
        ja, pa = _i16(tmp_path / "jax.wav"), _i16(tmp_path / "port.wav")
        assert ja.shape == pa.shape and int(np.abs(ja - pa).max()) <= 1
