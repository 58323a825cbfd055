"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``whitebox_tpu/io/native.py:23-110``, the repo's make +
ctypes idiom for native code: the sources are compiled at first use by
``nvcc`` into a shared library with a plain C interface and loaded with
ctypes. Nothing includes PyTorch's headers, so a build takes seconds.

- The library lands in ``build/kernels/<hash of the sources and flags>/``
  beside the package (``build/`` is git-ignored), so an edited source
  builds anew and an unchanged one is reused.
- A failed ``nvcc`` raises with its stderr. There is no retry and no
  fallback: on a CUDA device the mix goes through the kernel or raises.
- Importing this module needs no ``nvcc``; :func:`load` is the first call
  that does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libwbtorch_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # pin f32 rounding: no FMA contraction, no denormal flush
    "--fmad=false", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB: ctypes.CDLL | None = None
#: seconds the last :func:`load` spent compiling (0.0 when it reused a build)
last_build_seconds = 0.0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``, or ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact source set is built already."""
    global last_build_seconds
    out_dir = build_dir()
    so = out_dir / LIB_NAME
    if so.is_file():
        last_build_seconds = 0.0
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial library
    last_build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C ABI."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wb_mix_linear.restype = ci
    # 17 pointers, 5 ints (n_tiles, T, K, C, tile), the stream
    lib.wb_mix_linear.argtypes = [vp] * 17 + [ci] * 5 + [vp]
    _LIB = lib
    return _LIB
