"""ctypes bindings for the port's native host library (carve walk, plan,
peaks).

Counterpart of ``whitebox_tpu/io/native.py``, limited to the entry points
the port calls: the carve walk (``csrc/host/wb_carve.cpp``, bit-equal to
the Python walk in ``timeline/carve.py``), the speed-1 plan row expansion
(``csrc/host/wb_plan.cpp``, used by ``ops/mix_plan.py::build_plan``) and
the peak summarize of one mip level (``csrc/host/wb_peaks.cpp``, the
scalar oracle of ``ops/peaks.py::build_mipmaps``).

The library is built at first use with ``g++`` into
``build/host/<hash of the sources and flags>/`` (``buildlib``). The flags
carry no ``-march``: the library's f64 carve arithmetic is pinned by
``-ffp-contract=off`` alone and the result runs on any x86-64 host. When
no ``g++`` is found, :func:`load` returns None and every caller takes its
NumPy path, which gives the same tables. A failed compile raises.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from whitebox_tpu_torch import buildlib

HOST_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
LIB_NAME = "libwbtorch_host.so"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")
ABI_VERSION = 3

_LIB: ctypes.CDLL | None = None
_TRIED = False
#: seconds the first :func:`load` spent compiling (0.0 when it reused a build)
last_build_seconds = 0.0


def load() -> ctypes.CDLL | None:
    """Build if needed and load once per process; None without ``g++``."""
    global _LIB, _TRIED, last_build_seconds
    if _TRIED:
        return _LIB
    _TRIED = True
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    so, last_build_seconds = buildlib.build_shared(
        cxx, CXX_FLAGS, sorted(HOST_DIR.glob("*.cpp")), "host", LIB_NAME)
    lib = ctypes.CDLL(str(so))
    if lib.wb_native_version() != ABI_VERSION:
        raise RuntimeError(f"{so}: ABI version {lib.wb_native_version()}, want {ABI_VERSION}")

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.wb_build_mix_plan.restype = ctypes.c_int32
    lib.wb_build_mix_plan.argtypes = [
        ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, f32p, u8p, i32p, f32p, i32p, f32p,
        i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f32p, i32p, i32p, f32p, i32p, f32p, i32p,
    ]
    # the carve takes host-precomputed per-clip event positions
    # (tempo-map-aware; timeline/carve_native.py computes them)
    lib.wb_carve_audio.restype = ctypes.c_void_p
    lib.wb_carve_audio.argtypes = [
        f64p, f64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p,
        f64p, f64p, f64p, f64p, f64p, f64p, f64p, f64p, f32p,
        i32p, i32p, i32p, u8p, u8p,
        i64p, f64p, i64p, f64p, f64p, i64p, i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.wb_carve_copy.restype = None
    lib.wb_carve_copy.argtypes = [ctypes.c_void_p] + [
        i32p, i32p, i32p, i32p, i32p, f64p, f64p, f32p, u8p, u8p, i32p,
        i32p, f32p, i32p, f32p,
    ] + [
        i32p, i32p, i32p, i32p, i32p, f64p, f64p, f32p, i32p,
        i32p, f32p, i32p, f32p,
    ]
    lib.wb_carve_free.restype = None
    lib.wb_carve_free.argtypes = [ctypes.c_void_p]
    lib.wb_peaks_level.restype = None
    lib.wb_peaks_level.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int64]
    _LIB = lib
    return _LIB


def has_carve() -> bool:
    return load() is not None


def carve_audio(P, S, num_blocks, bs, rate, bd, runs, clip_begin, ci0, cols):
    """Native timeline carve (``csrc/host/wb_carve.cpp``). ``cols`` is the
    dict of flattened per-clip column arrays incl. the host-precomputed
    event positions. Returns (fast_cols, slow_cols) tuples matching the
    Python carve's assembly layout, or None on fallback (library absent or
    an unknown clip mode)."""
    lib = load()
    if lib is None:
        return None
    n_fast = ctypes.c_int64(0)
    n_slow = ctypes.c_int64(0)
    h = lib.wb_carve_audio(
        P, S, int(num_blocks), int(bs), float(rate), float(bd), int(bool(runs)),
        int(clip_begin.shape[0] - 1), clip_begin, ci0,
        cols["min_time"], cols["max_time"], cols["start_offset"], cols["clip_speed"],
        cols["fade_start"], cols["fade_end"], cols["count"], cols["srate"],
        cols["gain"], cols["mode"], cols["clip_id"], cols["sid"],
        cols["clampf"], cols["skip"],
        cols["ev_ka"], cols["ev_so_start"], cols["ev_ke"], cols["ev_so_stop"],
        cols["pos0"], cols["elapsed0"], cols["clip_frames"],
        cols["fin_frames"], cols["fout_frames"],
        ctypes.byref(n_fast), ctypes.byref(n_slow),
    )
    if not h:
        return None
    try:
        nf, ns = n_fast.value, n_slow.value
        fa = (
            np.empty(nf, np.int32), np.empty(nf, np.int32), np.empty(nf, np.int32),
            np.empty(nf, np.int32), np.empty(nf, np.int32), np.empty(nf, np.float64),
            np.empty(nf, np.float64), np.empty(nf, np.float32),
            np.empty(nf, np.uint8), np.empty(nf, np.uint8), np.empty(nf, np.int32),
            np.empty(nf, np.int32), np.empty(nf, np.float32),
            np.empty(nf, np.int32), np.empty(nf, np.float32),
        )
        sa = (
            np.empty(ns, np.int32), np.empty(ns, np.int32), np.empty(ns, np.int32),
            np.empty(ns, np.int32), np.empty(ns, np.int32), np.empty(ns, np.float64),
            np.empty(ns, np.float64), np.empty(ns, np.float32), np.empty(ns, np.int32),
            np.empty(ns, np.int32), np.empty(ns, np.float32),
            np.empty(ns, np.int32), np.empty(ns, np.float32),
        )
        lib.wb_carve_copy(h, *fa, *sa)
    finally:
        lib.wb_carve_free(h)
    return fa, sa


def peaks_level(codes: np.ndarray, mip: int, out_count: int) -> np.ndarray | None:
    """One mip level of occurrence-ordered (min, max) pairs over the int32
    ``codes`` (``csrc/host/wb_peaks.cpp``) -> [out_count] int32, or None
    without the library. ``out_count`` is ``ops/peaks.py::level_out_count``."""
    lib = load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if out_count % 2 or mip < 1:
        raise ValueError(f"out_count must be even and mip >= 1, got {out_count}, {mip}")
    out = np.zeros(out_count, dtype=np.int32)
    lib.wb_peaks_level(codes, codes.shape[0], int(mip), out, out_count)
    return out


def build_mix_plan(table, pool, channels: int, tile: int, n_tiles: int, T: int, K: int):
    """Native row expansion of speed-1 rows for ``ops/mix_plan.build_plan``
    -> (row_al, delta, ms, me, gain, clampf, fis, fii, foe, foi), or None
    on fallback (library absent, empty table, or a slot overflow)."""
    lib = load()
    if lib is None or len(table) == 0:
        return None
    nt, t_, k_ = n_tiles, T, K
    row_al = np.zeros((nt, t_, k_, channels), dtype=np.int32)
    delta = np.zeros((nt, t_, k_, channels), dtype=np.int32)
    ms = np.zeros((nt, t_, k_), dtype=np.int32)
    me = np.zeros((nt, t_, k_), dtype=np.int32)
    gain = np.zeros((nt, t_, k_), dtype=np.float32)
    clampf = np.zeros((nt, t_, k_), dtype=np.int32)
    fis = np.full((nt, t_, k_), -(1 << 30), dtype=np.int32)
    fii = np.ones((nt, t_, k_), dtype=np.float32)
    foe = np.full((nt, t_, k_), 1 << 30, dtype=np.int32)
    foi = np.ones((nt, t_, k_), dtype=np.float32)
    cursor = np.zeros(nt * t_, dtype=np.int32)

    rc = lib.wb_build_mix_plan(
        len(table),
        np.ascontiguousarray(table.track, np.int32),
        np.ascontiguousarray(table.dst_start, np.int32),
        np.ascontiguousarray(table.length, np.int32),
        np.ascontiguousarray(table.sample_id, np.int32),
        np.ascontiguousarray(table.src_int, np.int32),
        np.ascontiguousarray(table.gain, np.float32),
        np.ascontiguousarray(table.clamp, np.uint8),
        np.ascontiguousarray(table.fin_start, np.int32),
        np.ascontiguousarray(table.fin_inv, np.float32),
        np.ascontiguousarray(table.fout_end, np.int32),
        np.ascontiguousarray(table.fout_inv, np.float32),
        np.ascontiguousarray(pool.channel_base[:, :channels], np.int32), channels,
        tile, nt, t_, k_,
        row_al.reshape(-1), delta.reshape(-1), ms.reshape(-1), me.reshape(-1),
        gain.reshape(-1), clampf.reshape(-1),
        fis.reshape(-1), fii.reshape(-1), foe.reshape(-1), foi.reshape(-1),
        cursor,
    )
    if rc != 0:
        return None
    return row_al, delta, ms, me, gain, clampf, fis, fii, foe, foi
