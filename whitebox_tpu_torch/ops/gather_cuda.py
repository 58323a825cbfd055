"""The gather mix on the card: the wrapper of ``csrc/gather_mix.cu`` and the
host model of its row search.

One launch renders a chunk of ``ops/mix.py``'s gather mix from the padded
segment tables (``pack_device_tables(...).as_torch(device)``): the row
search, the double-single phase, the interpolation (linear, Catmull-Rom,
polynomial taps over an oversampled pool, or the direct windowed-sinc
bank), the fades, the clip gain, and in the summed forms track
volume*pan, the track sum in index order from +0.0 and the hard clip.

- :func:`gather_mix_cuda` launches it on CUDA tensors in one of
  :data:`FORMS` and counts the launch (:data:`gather_launches`,
  :data:`form_launches`). A malformed argument raises ``ValueError``; a
  failed build or launch raises ``RuntimeError``. Nothing falls back to
  the torch ops.
- ``ops/mix.py::render_chunk``/``render_chunk_per_track`` dispatch here on a
  CUDA pool and to the plain torch ops (``mix.gather_plain``) on the CPU.
- :func:`block_rows_model` is the host model of the kernel's row search:
  each block of :data:`FRAMES_PER_BLOCK` frames bisects a track's rows for
  its first and last frame, and each frame bisects inside that range.

Not a TPU kernel: the JAX package runs the gather mix as an XLA program
(``whitebox_tpu/ops/mix.py:171-305``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from whitebox_tpu_torch.ops import cuda_build

#: launches of the gather kernel in this process, any form;
#: :func:`gather_mix_cuda` adds one per launch and nothing else touches it
#: (callers may reset it to 0)
gather_launches = 0
#: the same launches by form
form_launches = {"per_track": 0, "sum": 0, "sum_unclipped": 0}

#: frames (and threads) of a block (the kernel's ``kFrames``)
FRAMES_PER_BLOCK = 256
#: channels a thread of the summed forms accumulates (``kChanPair``)
CHAN_PAIR = 2
#: interpolation codes (``kLinear`` .. ``kSinc``)
INTERP = {"linear": 0, "catmull": 1, "poly": 2, "sinc": 3}
#: output forms (``kPerTrack``, ``kSum``, ``kSumNoClip``)
FORMS = {"per_track": 0, "sum": 1, "sum_unclipped": 2}
#: the largest polynomial table (``kMaxPolyTaps`` x ``kMaxPolyCoeffs``)
MAX_POLY_TAPS = MAX_POLY_COEFFS = 8
POLY_SLOTS = 64

#: the tables the kernel reads, with their dtypes; each [T, S], src_base
#: [T, S, C], track_gain [T, C] (bool tables are read as bytes)
TABLE_DTYPES = {
    "dst_start": torch.int32, "length": torch.int32, "src_base": torch.int64,
    "frac_hi": torch.float32, "frac_lo": torch.float32, "speed_hi": torch.float32, "speed_lo": torch.float32,
    "gain": torch.float32, "fast": torch.bool, "clamp": torch.bool,
    "fin_start": torch.int32, "fin_inv": torch.float32, "fout_end": torch.int32, "fout_inv": torch.float32,
    "track_gain": torch.float32,
}


class WbGatherArgs(ctypes.Structure):
    """``csrc/gather_mix.cu::WbGatherArgs``, field for field."""
    _fields_ = ([("pool", ctypes.c_void_p), ("P", ctypes.c_longlong)]
                + [(n, ctypes.c_void_p) for n in TABLE_DTYPES]
                + [("sinc_bank", ctypes.c_void_p), ("out", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("T", "S", "C", "frames", "chunk_start", "form", "interp",
                                               "phases", "taps", "ncoef")]
                + [("poly", ctypes.c_float * POLY_SLOTS)])


def check_tables(pool: torch.Tensor, tables: dict) -> tuple[int, int, int]:
    """Validate the pool and the tables for the kernel -> (T, S, C)."""
    if pool.dtype != torch.float32 or pool.dim() != 1 or not pool.is_contiguous() or pool.numel() < 2:
        raise ValueError("pool must be a contiguous 1-D float32 tensor of 2 samples or more")
    if tables["src_base"].dim() != 3:
        raise ValueError(f"table src_base: want [T, S, C], got {tuple(tables['src_base'].shape)}")
    T, S, C = tables["src_base"].shape
    for name, dtype in TABLE_DTYPES.items():
        x = tables[name]
        want = (T, S, C) if name == "src_base" else (T, C) if name == "track_gain" else (T, S)
        if tuple(x.shape) != want or x.dtype != dtype or x.device != pool.device or not x.is_contiguous():
            raise ValueError(f"table {name}: want contiguous {dtype} {want} on {pool.device}, "
                             f"got {'' if x.is_contiguous() else 'non-contiguous '}{x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if S < 1 or C < 1 or T > 65535:
        raise ValueError(f"tables of {T} tracks, {S} rows, {C} channels: want S, C >= 1 and T <= 65535")
    return T, S, C


def _poly_table(coeffs) -> tuple[int, int, list]:
    """(taps, ncoef, the f32 values row-major) of a polynomial table. They
    travel in the launch's parameter block, so no device copy is made."""
    taps, ncoef = len(coeffs), len(coeffs[0])
    if not (1 <= taps <= MAX_POLY_TAPS and 1 <= ncoef <= MAX_POLY_COEFFS) or any(len(r) != ncoef for r in coeffs):
        raise ValueError(f"polynomial table of {taps} x {ncoef}: the kernel takes up to "
                         f"{MAX_POLY_TAPS} x {MAX_POLY_COEFFS}")
    return taps, ncoef, [float(np.float32(c)) for row in coeffs for c in row]


def interp_args(interp, sinc_bank, device) -> tuple[str, int, int, int, list, torch.Tensor | None]:
    """-> (mode, phases, taps, ncoef, poly values, bank) for ``interp``
    ("linear", "catmull" or ("poly", coeffs)) or a sinc bank (which wins,
    as in the plain version: a contiguous f32 ``[phases + 1, taps]`` tensor
    on ``device``, which ``bounce`` uploads once a render); anything else
    raises ValueError."""
    if sinc_bank is not None:
        if not (torch.is_tensor(sinc_bank) and sinc_bank.device == device and sinc_bank.dtype == torch.float32
                and sinc_bank.dim() == 2 and sinc_bank.is_contiguous()
                and sinc_bank.shape[0] >= 2 and sinc_bank.shape[1] >= 1):
            raise ValueError(f"sinc_bank must be a contiguous 2-D float32 tensor [phases + 1, taps] on {device}")
        return "sinc", sinc_bank.shape[0] - 1, sinc_bank.shape[1], 0, [], sinc_bank
    if isinstance(interp, tuple) and len(interp) == 2 and interp[0] == "poly":
        taps, ncoef, values = _poly_table(interp[1])
        return "poly", 0, taps, ncoef, values, None
    if isinstance(interp, str) and interp in ("linear", "catmull"):
        return interp, 0, 0, 0, [], None
    raise ValueError(f"unknown interpolation {interp!r}: want 'linear', 'catmull' or ('poly', coeffs)")


def gather_mix_cuda(pool: torch.Tensor, tables: dict, chunk_start: int, frames: int, form: str = "sum",
                    sinc_bank=None, interp="linear") -> torch.Tensor:
    """One launch of the gather kernel on CUDA tensors -> ``[T, C, frames]``
    (``form="per_track"``) or ``[C, frames]`` (``"sum"``: clipped;
    ``"sum_unclipped"``). Launches on the current stream; does not
    synchronise."""
    global gather_launches
    if pool.device.type != "cuda":
        raise ValueError(f"gather_mix_cuda needs CUDA tensors, got {pool.device}")
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}: want one of {tuple(FORMS)}")
    T, S, C = check_tables(pool, tables)
    mode, phases, taps, ncoef, poly, bank = interp_args(interp, sinc_bank, pool.device)
    chunk_start, frames = int(chunk_start), int(frames)
    if frames < 0 or chunk_start < -(1 << 31) or chunk_start + frames > (1 << 31) - 1:
        raise ValueError(f"frames [{chunk_start}, {chunk_start + frames}) outside int32")
    shape = (T, C, frames) if form == "per_track" else (C, frames)
    if frames == 0 or T == 0:
        return torch.zeros(shape, dtype=torch.float32, device=pool.device)
    out = torch.empty(shape, dtype=torch.float32, device=pool.device)
    a = WbGatherArgs()
    a.pool, a.P = pool.data_ptr(), pool.numel()
    for name in TABLE_DTYPES:
        setattr(a, name, tables[name].data_ptr())
    a.sinc_bank = None if bank is None else bank.data_ptr()
    a.out = out.data_ptr()
    a.T, a.S, a.C, a.frames, a.chunk_start = T, S, C, frames, chunk_start
    a.form, a.interp, a.phases, a.taps, a.ncoef = FORMS[form], INTERP[mode], phases, taps, ncoef
    a.poly[:len(poly)] = poly
    lib = cuda_build.load()
    with torch.cuda.device(pool.device):
        rc = lib.wb_gather_mix(ctypes.addressof(a), torch.cuda.current_stream(pool.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError_t {rc}")
    gather_launches += 1
    form_launches[form] += 1
    return out


# ------------------------------------------------------------ the host model


def _bisect(ds: np.ndarray, lo: int, n: int, g: int) -> int:
    """``bisect`` of the kernel: the last row in (lo, lo + n] with
    ``ds <= g``, else ``lo``."""
    idx = lo
    while n > 0:
        half = n >> 1
        m = idx + 1 + half
        if ds[m] <= g:
            idx, n = m, n - half - 1
        else:
            n = half
    return idx


def block_rows_model(dst_start: np.ndarray, chunk_start: int, frames: int,
                     block: int = FRAMES_PER_BLOCK) -> np.ndarray:
    """The kernel's row search on the host -> ``[T, frames]`` int64: each
    block's ``[lo, hi]`` from the rows of its first and last frame
    (``block_rows``), then each frame's bisection inside it (``find_row``).
    It equals ``searchsorted(dst_start[t], g, right=True) - 1``."""
    ds = np.asarray(dst_start)
    T, S = ds.shape
    out = np.empty((T, frames), dtype=np.int64)
    for t in range(T):
        for f0 in range(0, frames, block):
            g0, g1 = chunk_start + f0, chunk_start + min(frames, f0 + block) - 1
            lo = _bisect(ds[t], -1, S, g0)
            hi = _bisect(ds[t], lo, S - 1 - lo, g1)
            for f in range(f0, min(frames, f0 + block)):
                out[t, f] = _bisect(ds[t], lo, hi - lo, chunk_start + f)
    return out
