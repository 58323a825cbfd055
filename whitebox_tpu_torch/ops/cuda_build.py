"""Build and bind the port's CUDA kernels (``csrc/*.cu``: the mix kernel,
the biquad cascade).

Counterpart of ``whitebox_tpu/io/native.py:23-110``, the repo's make +
ctypes idiom for native code: the sources are compiled at first use by
``nvcc`` into a shared library with a plain C interface and loaded with
ctypes. Nothing includes PyTorch's headers, so a build takes seconds.

- The library lands in ``build/kernels/<hash of the sources and flags>/``
  beside the package (``buildlib.build_shared``), so an edited source
  builds anew and an unchanged one is reused.
- One ``nvcc`` per source, all started together, then one link.
- A failed ``nvcc`` raises with its stderr. There is no retry and no
  fallback: on a CUDA device the mix goes through the kernel or raises.
- Importing this module needs no ``nvcc``; :func:`load` is the first call
  that does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from whitebox_tpu_torch import buildlib

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
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


def _sources() -> tuple[list[Path], list[Path]]:
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


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
    srcs, headers = _sources()
    return buildlib.content_dir("kernels", NVCC_FLAGS, [*srcs, *headers])


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact source set is built already."""
    global last_build_seconds
    srcs, headers = _sources()
    so, last_build_seconds = buildlib.build_shared(find_nvcc(), NVCC_FLAGS, srcs, "kernels",
                                                   LIB_NAME, headers=headers)
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C ABI."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # every entry ends with the interpolation (code, host coefficient table
    # [taps][ncoef] f32 or null, taps, ncoef) and the stream
    interp = [ci, vp, ci, ci, vp]
    # wb_mix: 17 pointers, 5 ints (n_tiles, T, K, C, tile)
    lib.wb_mix.restype = ci
    lib.wb_mix.argtypes = [vp] * 17 + [ci] * 5 + interp
    # wb_mix_auto: the same, then 10 lane-table pointers (volume xs/ys/cv/tn,
    # pan xs/ys/cv/tn, mute, use) and the points per lane P
    lib.wb_mix_auto.restype = ci
    lib.wb_mix_auto.argtypes = [vp] * 17 + [ci] * 5 + [vp] * 10 + [ci] + interp
    # wb_mix_per_track (K4): wb_mix's arguments; out is [T, C, n_tiles*tile]
    lib.wb_mix_per_track.restype = ci
    lib.wb_mix_per_track.argtypes = [vp] * 17 + [ci] * 5 + interp
    # wb_biquad_cascade: x, x_stride (int64), y, B, F, L, coeffs, S, phi,
    # state_in, state_out, ends, starts, stream
    lib.wb_biquad_cascade.restype = ci
    lib.wb_biquad_cascade.argtypes = [vp, ctypes.c_longlong, vp, ci, ci, ci, vp, ci] + [vp] * 6
    _LIB = lib
    return _LIB
