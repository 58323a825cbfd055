"""Content-keyed builds of the port's native sources.

The port has two native libraries, both compiled at first use and bound
with ctypes (no PyTorch headers, no ninja):

- the CUDA kernels, ``csrc/*.cu`` with ``nvcc`` (``ops/cuda_build.py``);
- the host carve walk and plan expansion, ``csrc/host/*.cpp`` with ``g++``
  (``io/native.py``).

Each lands in ``build/<kind>/<hash of the flags and sources>/`` beside the
package (``build/`` is git-ignored), so an edited source builds anew and an
unchanged one is reused. A failed compile raises with the compiler's
stderr; there is no retry and no fallback here.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"


def content_dir(kind: str, flags, sources) -> Path:
    """``build/<kind>/<hash>``: the hash covers the flags, names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / kind / h.hexdigest()[:16]


def build_shared(compiler: str, flags, sources, kind: str, lib_name: str,
                 headers=()) -> tuple[Path, float]:
    """Compile ``sources`` into a shared library unless this exact set is
    built already -> (path, seconds spent compiling, 0.0 on reuse).
    ``headers`` enter the hash but not the command line."""
    out_dir = content_dir(kind, flags, [*sources, *headers])
    so = out_dir / lib_name
    if so.is_file():
        return so, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib_name}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", str(tmp), *[str(s) for s in sources]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial library
    return so, time.perf_counter() - t0
