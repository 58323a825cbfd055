"""Content-keyed builds of the port's native sources.

The port has three native libraries, all compiled at first use and bound
with ctypes (no PyTorch headers, no ninja):

- the CUDA kernels, ``csrc/*.cu`` with ``nvcc`` (``ops/cuda_build.py``);
- the host carve walk, plan expansion and peak walk, ``csrc/host/*.cpp``
  with ``g++`` (``io/native.py``), and the codec ``csrc/host/codec/wb_codec.cpp``
  on its own, linked against the system's libav libraries (``io/codec.py``).

Each lands in ``build/<kind>/<hash of the flags and sources>/`` beside the
package (``build/`` is git-ignored), so an edited source builds anew and an
unchanged one is reused. Each source compiles to an object in its own
compiler process, all started together, then one link makes the library.
A failed compile raises with the compiler's stderr; there is no retry and
no fallback here.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"


def content_dir(kind: str, flags, sources) -> Path:
    """``build/<kind>/<hash>``: the hash covers the flags, names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / kind / h.hexdigest()[:16]


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")


def build_shared(compiler: str, flags, sources, kind: str, lib_name: str,
                 headers=(), libs=()) -> tuple[Path, float]:
    """Compile ``sources`` into a shared library unless this exact set is
    built already -> (path, seconds spent compiling, 0.0 on reuse).
    ``flags`` hold ``-shared`` for the link; each source compiles with the
    others (``-c``), one process each, in parallel. ``headers`` enter the
    hash but not the command line; ``libs`` (``-l...``) follow the objects
    on the link line."""
    out_dir = content_dir(kind, [*flags, *libs], [*sources, *headers])
    so = out_dir / lib_name
    if so.is_file():
        return so, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f".{lib_name}.{tag}"
    compile_flags = [f for f in flags if f != "-shared"]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max(len(sources), 1)) as ex:
            for f in [ex.submit(_run, [compiler, *compile_flags, "-c", "-o", str(o), str(src)])
                      for src, o in zip(sources, objs)]:
                f.result()
        _run([compiler, *flags, "-o", str(tmp), *[str(o) for o in objs], *libs])
        os.replace(tmp, so)  # atomic: a concurrent build never sees a partial library
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return so, time.perf_counter() - t0
